"""The port's own spans of a traced lap, for the per-layer metrics that
read them (``metrics/dispatch.enqueue_ms_per_frame.py`` and the like).

The port (``supereight_tpu_torch/utils/perfstats.py``) traces its spans
while a ``torch.profiler`` records, and the profiler's first span starts
its record anew, so a ``--trace 1`` run's lap, and only the lap, is the
record that the port's ``Stats`` exports: a span ``se.<layer>.<part>``
round each stage and its parts, ``se.read.<site>`` round each host read,
each with its path of open spans and its host ns.  The lap runs under the
profiler, so the spans' host times hold the profiler's cost of each
operation the port calls inside them.  A frame runs one
``se.preprocessing.stage``: their count is the frames the spans saw.
"""

from __future__ import annotations

from typing import List, Optional

READ = "se.read."
FRAME = "se.preprocessing.stage"


def lap() -> Optional[List]:
    """The spans the port recorded (``SpanRecord`` s: ``path``, ``ns``,
    ``self_ns``), or None where the port has no spans (a checkout from
    before them) or saw no frame."""
    try:
        from supereight_tpu_torch.utils.perfstats import Stats
    except ImportError:
        return None
    export = getattr(Stats, "export", None)
    if export is None:
        return None
    spans = export()
    return spans if frames(spans) else None


def frames(spans) -> int:
    return sum(r.path[-1] == FRAME for r in spans)


def is_read(r) -> bool:
    return r.path[-1].startswith(READ)


def ms_per_frame(spans, ns: int) -> float:
    return 1e-6 * ns / frames(spans)
