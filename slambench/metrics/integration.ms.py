"""Mean host ms of the integration stage over every traced frame (the host clock
from the stage call to the synchronise after it, as
``DenseSLAMSystem.step_staged`` times it)."""


def read(run):
    t = run["stage_s"]["integration"]
    return 1e3 * sum(t) / len(t) if t else None
