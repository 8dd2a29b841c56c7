"""Mean host ms of the three renders and their synchronise over every
traced frame (0 on the frames that do not render)."""


def read(run):
    t = run["stage_s"]["rendering"]
    return 1e3 * sum(t) / len(t) if t else None
