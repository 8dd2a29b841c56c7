"""PerfStats: named time-series performance samples (a copy of
`supereight_tpu/utils/perfstats.py`), and the port's spans and host-read
counters.

Reference: `se_shared/perfstats.h:32-139` (typed samples, mean/min/max/sum,
table dump) and the TICK/TOCK macros (`se_shared/timings.h:7-15`).

Spans (:meth:`PerfStats.span`) mark the port's own work on the host: a span
named ``se.<layer>.<part>`` round each stage and its parts, and
``se.read.<site>`` (:meth:`PerfStats.host_read`) round each place where the
host waits for the card (a read of a device value, a synchronising copy).
Tracing is off unless :meth:`PerfStats.tracing` holds it on; off, a span is
one shared no-op object.  On, each span keeps its path (the names of the
spans open round it), its host nanoseconds and its self nanoseconds (less
the spans inside it) in the record, and adds its seconds to the samples
under its name.  Each ``tracing()`` block starts a record of its own.

The benchmark's traced lap runs under a ``torch.profiler`` and cannot call
``tracing()``, so a recording profiler turns the spans on too: its first
span starts a record of its own, and each span records a CPU operation of
its name (PyTorch's ``_RecordFunctionFast``: no copy on the device's
timeline, so a traced device's kernels and busy time stay what they were)
on the timeline the trace shares with the device.  Nothing is written out
during a frame: :meth:`PerfStats.export` hands the record over afterwards.
"""

from __future__ import annotations

import functools
import time
from collections import OrderedDict
from contextlib import contextmanager
from enum import Enum
from typing import List, NamedTuple, Optional, Tuple

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast


class SampleType(Enum):
    TIME = "time"
    COUNT = "count"
    FRAME = "frame"
    DISTANCE = "distance"
    POWER = "power"
    ENERGY = "energy"
    UNDEFINED = "undefined"


class SpanRecord(NamedTuple):
    """One span that ran: ``path`` the names from the outermost open span
    to its own, its host ns and its self ns (less its child spans')."""
    path: Tuple[str, ...]
    ns: int
    self_ns: int

    @property
    def name(self) -> str:
        return self.path[-1]

    @property
    def parent(self) -> Optional[str]:
        return self.path[-2] if len(self.path) > 1 else None


class _NoSpan:
    """The span of tracing off: enters and exits doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
#: the prefix of a host read's span name
READ = "se.read."


class _Span:
    __slots__ = ("stats", "name", "path", "t0", "child_ns", "rf")

    def __init__(self, stats: "PerfStats", name: str):
        self.stats, self.name = stats, name

    def __enter__(self):
        open_ = self.stats._open
        self.path = (open_[-1].path + (self.name,)) if open_ \
            else (self.name,)
        open_.append(self)
        self.child_ns = 0
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        st = self.stats
        st._open.pop()
        if st._open:
            st._open[-1].child_ns += ns
        st._spans.append((self.path, ns, ns - self.child_ns))
        st.sample(self.name, ns * 1e-9, SampleType.TIME)
        return False


class PerfStats:
    def __init__(self):
        self.results: "OrderedDict[str, dict]" = OrderedDict()
        self._last_frame_start = None
        #: the record: the spans of the latest ``tracing()`` block or
        #: profiler, in the order they ended, as SpanRecord's fields (a
        #: NamedTuple costs more to make than the rest of a span)
        self._spans: List[tuple] = []
        self._tracing = False
        #: whether the latest span asked for ran under a profiler
        self._profiled = False
        self._open: List[_Span] = []

    # ---- spans and host reads ----

    def span(self, name: str):
        """A context manager round the port's work ``name``
        (``se.<layer>.<part>``): a no-op unless tracing is on (see the
        module's docstring)."""
        if self._tracing:
            return _Span(self, name)
        if _profiler._is_profiler_enabled:
            if not self._profiled:           # a profiler's first span
                self._profiled, self._spans = True, []
            return _Span(self, name)
        self._profiled = False
        return _NO_SPAN

    def host_read(self, site: str):
        """The span ``se.read.<site>`` round a place where the host waits
        for the device: a site's reads are the count of its spans."""
        return self.span(READ + site)

    def spanned(self, name: str):
        """A decorator: the function's every call inside ``span(name)``."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*args, **kw):
                with self.span(name):
                    return fn(*args, **kw)
            return call
        return wrap

    @contextmanager
    def tracing(self):
        """Tracing on inside the block (and back to what it was after),
        with a record of its own: yields the list that holds, once the
        block ends, the spans (:class:`SpanRecord`) recorded inside it.  A
        block inside another starts a record of its own."""
        was, self._tracing = self._tracing, True
        self._spans = mine = []
        try:
            yield mine
        finally:
            self._tracing, self._profiled = was, False
            mine[:] = [SpanRecord(*r) for r in mine]

    def export(self) -> List[SpanRecord]:
        """A copy of the record: the spans of the latest ``tracing()``
        block or profiler."""
        return [SpanRecord(*r) for r in self._spans]

    def sample(self, key: str, value: float,
               type: SampleType = SampleType.UNDEFINED):
        entry = self.results.get(key)
        if entry is None:
            entry = self.results[key] = {"data": [], "type": type}
        entry["data"].append(float(value))

    @contextmanager
    def timer(self, key: str):
        """TICK/TOCK equivalent: times the with-block in seconds."""
        t0 = time.perf_counter()
        yield
        self.sample(key, time.perf_counter() - t0, SampleType.TIME)

    # ---- aggregates (perfstats.h:70-91) ----

    def get_last_data(self, key):
        return self.results[key]["data"][-1]

    def get_sample_time(self, key):
        return sum(self.results[key]["data"])

    def mean(self, key):
        d = self.results[key]["data"]
        return sum(d) / len(d) if d else 0.0

    def min(self, key):
        return min(self.results[key]["data"])

    def max(self, key):
        return max(self.results[key]["data"])

    # ---- dumps ----

    def header(self) -> str:
        return "\t".join(self.results.keys())

    def print_latest(self) -> str:
        return "\t".join(f"{e['data'][-1]:.8f}" if e["data"] else "nan"
                         for e in self.results.values())

    def print_all_data(self) -> str:
        """Full table: one row per sample index (perfstats.h:113-137)."""
        n = max((len(e["data"]) for e in self.results.values()), default=0)
        lines = [self.header()]
        for i in range(n):
            row = []
            for e in self.results.values():
                row.append(f"{e['data'][i]:.8f}" if i < len(e["data"]) else "")
            lines.append("\t".join(row))
        return "\n".join(lines)

    def summary(self) -> str:
        lines = [f"{'kernel':<28}{'count':>8}{'mean(ms)':>12}"
                 f"{'min(ms)':>12}{'max(ms)':>12}{'total(s)':>12}"]
        for k, e in self.results.items():
            d = e["data"]
            if not d:
                continue
            lines.append(f"{k:<28}{len(d):>8}{1e3 * sum(d) / len(d):>12.3f}"
                         f"{1e3 * min(d):>12.3f}{1e3 * max(d):>12.3f}"
                         f"{sum(d):>12.3f}")
        return "\n".join(lines)


#: global instance, like the reference's ``PerfStats Stats`` (perfstats.h:386)
Stats = PerfStats()
