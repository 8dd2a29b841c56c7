"""Host ms of the allocation march (``se.integration.march``: the band
march's request mask and the slot assignment, its host reads included), a
mean over the traced lap's frames that march (``slambench/spans.py``)."""

from slambench import spans

MARCH = "se.integration.march"


def read(run):
    s = spans.lap()
    if s is None:
        return None
    march = [r.ns for r in s if r.path[-1] == MARCH]
    return 1e-6 * sum(march) / len(march) if march else None
