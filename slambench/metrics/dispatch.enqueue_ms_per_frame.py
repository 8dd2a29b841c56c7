"""Host ms a frame of the traced lap spent in the port's top-level spans
(the uploads, the four stages and the renders) less the host reads inside
them: the Python and launch cost of a frame (``slambench/spans.py``)."""

from slambench import spans


def read(run):
    s = spans.lap()
    if s is None:
        return None
    top = sum(r.ns for r in s if len(r.path) == 1)
    reads = sum(r.ns for r in s if spans.is_read(r))
    return spans.ms_per_frame(s, top - reads)
