"""PerfStats: named time-series performance samples (a copy of
`supereight_tpu/utils/perfstats.py`).

Reference: `se_shared/perfstats.h:32-139` (typed samples, mean/min/max/sum,
table dump) and the TICK/TOCK macros (`se_shared/timings.h:7-15`).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from enum import Enum


class SampleType(Enum):
    TIME = "time"
    COUNT = "count"
    FRAME = "frame"
    DISTANCE = "distance"
    POWER = "power"
    ENERGY = "energy"
    UNDEFINED = "undefined"


class PerfStats:
    def __init__(self):
        self.results: "OrderedDict[str, dict]" = OrderedDict()
        self._last_frame_start = None

    def sample(self, key: str, value: float,
               type: SampleType = SampleType.UNDEFINED):
        entry = self.results.setdefault(
            key, {"data": [], "type": type})
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
