"""Host ms of the raycasting stage (``se.raycasting.stage``: the scan
plan, the read view's pack, the three launches and their wrappers) less
its host reads, a mean over the traced lap's frames
(``slambench/spans.py``)."""

from slambench import spans

STAGE = "se.raycasting.stage"


def read(run):
    s = spans.lap()
    if s is None:
        return None
    stage = sum(r.ns for r in s if r.path[-1] == STAGE)
    reads = sum(r.ns for r in s if spans.is_read(r) and STAGE in r.path)
    return spans.ms_per_frame(s, stage - reads)
