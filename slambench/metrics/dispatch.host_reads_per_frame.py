"""Host waits on the device a frame in the traced window: the profiler's
blocking CUDA runtime calls (stream, device and event synchronisations,
blocking copies) outside the harness's own synchronisations, over the
frames."""


def read(run):
    t = run["trace"]
    if not t or not t["kernels"]:
        return None
    return t["host_reads"] / run["frames"]
