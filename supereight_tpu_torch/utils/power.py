"""Power telemetry sampling (a copy of `supereight_tpu/utils/power.py`).

Reference: `se_apps/include/PowerMonitor.h:12-38` reads ODROID hwmon sensor
files (A7/A15/GPU/DRAM rails) into PerfStats every frame.  Generic hosts
expose power through `/sys/class/hwmon` or RAPL (`/sys/class/powercap`);
this monitor samples whatever is present and does nothing when nothing
is (a container often exposes neither).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

from .perfstats import PerfStats, SampleType, Stats


def _discover() -> List[Tuple[str, str, float]]:
    """Returns (name, path, scale_to_watts) triples."""
    found = []
    for hw in glob.glob("/sys/class/hwmon/hwmon*"):
        try:
            name = open(os.path.join(hw, "name")).read().strip()
        except OSError:
            continue
        for p in glob.glob(os.path.join(hw, "power*_input")):
            found.append((f"{name}:{os.path.basename(p)}", p, 1e-6))
    for rapl in glob.glob("/sys/class/powercap/intel-rapl:*"):
        e = os.path.join(rapl, "energy_uj")
        if os.path.exists(e):
            try:
                name = open(os.path.join(rapl, "name")).read().strip()
            except OSError:
                name = os.path.basename(rapl)
            found.append((f"rapl:{name}", e, 1e-6))   # energy, not power
    return found


class PowerMonitor:
    """Samples available power/energy rails into a PerfStats instance
    (PowerMonitor::sample parity)."""

    def __init__(self, stats: PerfStats = Stats):
        self.stats = stats
        self.sensors = _discover()

    @property
    def available(self) -> bool:
        return bool(self.sensors)

    def sample(self):
        for name, path, scale in self.sensors:
            try:
                val = float(open(path).read().strip()) * scale
            except (OSError, ValueError):
                continue
            self.stats.sample(name, val, SampleType.POWER)
