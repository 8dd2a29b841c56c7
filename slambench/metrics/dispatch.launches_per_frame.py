"""Device kernels a frame in the traced window (the profiler's kernel
events over the frames)."""


def read(run):
    t = run["trace"]
    if not t or not t["kernels"]:
        return None
    return t["kernels"] / run["frames"]
