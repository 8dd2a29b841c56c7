"""Reads a ``torch.profiler`` trace of the traced window into the numbers
the per-layer metrics take: device busy time, kernel launches, host reads
and the breakdown of device operations and idle gaps.

The harness marks its spans with ``record_function``: ``slambench.window``
round the traced frames, ``slambench.<stage>`` round each stage call and
``slambench.sync`` round its own synchronisations, which are not the
program's host reads.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: CUDA runtime calls that make the host wait for the device
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")
STAGES = ("preprocessing", "tracking", "integration", "raycasting",
          "rendering")


class Event(NamedTuple):
    name: str
    kind: str
    start: int      # ns
    end: int
    on_device: bool


def _kind(e) -> str:
    """The event's kind: the profiler's activity type where this PyTorch
    gives it, else told from the device and the name (the harness's spans
    have a copy on the device's timeline, which is no device work)."""
    name = e.name()
    if name.startswith("slambench."):
        return "user_annotation"
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    if "CUDA" in str(e.device_type()):
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def events(prof) -> List[Event]:
    """The profiler's events as (name, kind, start, end) in ns."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        out.append(Event(e.name(), _kind(e), s, s + e.duration_ns(),
                         "CUDA" in str(e.device_type())))
    return out


def _union(iv):
    merged = []
    for s, e in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _inside(starts, spans, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def summarize(evs: List[Event]) -> dict:
    """busy_s, window_s, kernels, host_reads, device_ops (the 10 costliest
    device operations by name, seconds summed) and idle_gaps (the 10
    longest gaps in device activity, each named by the stage span the host
    was in at its middle, or ``harness``); None where the window span is
    missing."""
    spans = [e for e in evs if e.kind == "user_annotation"
             and not e.on_device]
    win = [e for e in spans if e.name == "slambench.window"]
    if not win:
        return None
    w0, w1 = win[0].start, win[0].end
    dev = [e for e in evs if e.kind in DEVICE_KINDS
           and e.start >= w0 and e.end <= w1]
    busy = _union([(e.start, e.end) for e in dev])
    syncs = _union([(e.start, e.end) for e in spans
                    if e.name == "slambench.sync"])
    sync_starts = [s for s, _ in syncs]
    reads = sum(1 for e in evs if e.kind in ("cuda_runtime", "cuda_driver")
                and e.name in BLOCKING and w0 <= e.start <= w1
                and not _inside(sync_starts, syncs, e.start))
    per_name = defaultdict(int)
    for e in dev:
        per_name[e.name] += e.end - e.start
    stages = sorted((e.start, e.end, e.name.split(".", 1)[1]) for e in spans
                    if e.name.split(".", 1)[1] in STAGES)
    starts = [s for s, _, _ in stages]
    gaps = []
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = stages[i][2] if i >= 0 and mid <= stages[i][1] else "harness"
        gaps.append((b - a, name))
    gaps.sort(reverse=True)
    return dict(
        busy_s=sum(b - a for a, b in busy) * 1e-9,
        window_s=(w1 - w0) * 1e-9,
        kernels=sum(1 for e in dev if e.kind == "kernel"),
        host_reads=reads,
        device_ops=[[n, t * 1e-9] for n, t in sorted(
            per_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[n, g * 1e-9] for g, n in gaps[:10]])
