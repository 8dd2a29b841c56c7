"""Host ms a frame of the traced lap spent in the port's host reads (its
``se.read.<site>`` spans: reads of device values and synchronising
copies), the host's wait on the card (``slambench/spans.py``)."""

from slambench import spans


def read(run):
    s = spans.lap()
    if s is None:
        return None
    return spans.ms_per_frame(s, sum(r.ns for r in s if spans.is_read(r)))
