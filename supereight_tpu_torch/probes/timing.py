"""Device time of a callable by CUDA events."""

from __future__ import annotations

from typing import Callable, List

import torch

SLEEP_CYCLES = 200_000_000      # ~0.1 s of a sleeping kernel at ~2 GHz


def device_times_ms(fn: Callable[[], object], runs: int) -> List[float]:
    """Per-run device time of ``fn`` in ms, by CUDA events around each run.
    One warm-up run first; then all runs are queued behind a sleeping kernel,
    so that host launch overhead does not show up as device idle time
    between the events (unless enqueueing the runs outlasts the sleep)."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]
