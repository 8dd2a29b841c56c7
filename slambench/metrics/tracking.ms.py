"""Mean host ms of the tracking stage over every traced frame (the host clock
from the stage call to the synchronise after it, as
``DenseSLAMSystem.step_staged`` times it)."""


def read(run):
    t = run["stage_s"]["tracking"]
    return 1e3 * sum(t) / len(t) if t else None
