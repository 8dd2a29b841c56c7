"""One run of one cell: set-up, warm-up, the measured (or traced) window,
the check against the plain reference, and the result line.

A cell ``<config>.<mix>`` is found through ``BENCHMARK.json``'s
``workloads`` entry of that name: ``configs/<config>.json`` holds the
system's knobs, the camera and the check's limits, ``traffic/<mix>.json``
the stream's parameters, and each per-layer metric that ``BENCHMARK.json``
gives the cell is read by ``metrics/<name>.py``.  Nothing here names a
cell, a mix or a metric.

The frame loop is the one of the port's ``apps/benchmark.py`` and upstream's
``benchmark.cpp``: ``DenseSLAMSystem.step`` on the host ``uint16`` frame as
a reader hands it, a synchronise, and on every ``rendering_rate``-th frame
the three renders and a synchronise.  A frame's time runs from handing over
its frame to the last synchronise.  The traced run drives the same frame as
``DenseSLAMSystem.step_staged`` times it, through the system's per-stage
calls with a synchronise after each, inside the harness's spans.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from slambench import check, streams, trace, work

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "supereight_tpu")
#: knobs the plain reference follows; every other knob must keep the
#: port's default
REFERENCE_KNOBS = ("volume_resolution", "volume_size", "mu",
                   "compute_size_ratio", "tracking_rate", "integration_rate",
                   "pyramid", "icp_threshold", "bilateral_filter",
                   "block_capacity", "bootstrap_frames", "raycast_from_frame",
                   "raycast_span_factor", "raycast_scan_stride",
                   "raycast_w2_budget", "initial_pos_factor", "field_type",
                   "raycast_near_rescue", "raycast_normals",
                   "ofusion_sigma_floor")
#: the values of the knobs the reference follows in part
REFERENCE_VALUES = {"field_type": ("sdf", "ofusion"),
                    "raycast_normals": ("volume", "exact")}
#: window frames the check samples from, and how many
SAMPLE_SPAN, N_SAMPLES = 96, 4
#: warm-up frames the check also samples: the first frame (from the empty
#: map), the first that tracks against a model raycast, and a later one
START_SAMPLES = (0, 4, 8)


@dataclasses.dataclass
class Cell:
    name: str
    mix: dict
    system: object          # the port's SlamConfig
    k: tuple
    H: int
    W: int
    size: int
    dim: float
    rendering_rate: int
    chips: int
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its
    configuration, mix and metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    here = os.path.join(root, "slambench")
    with open(os.path.join(here, "configs", entry["config"] + ".json")) as f:
        cfg = json.load(f)
    mix = streams.load_mix(entry["traffic"], here)
    from supereight_tpu_torch.config import SlamConfig
    knobs = {**cfg["system"], **mix.get("system", {})}
    knobs = {k: tuple(v) if isinstance(v, list) else v
             for k, v in knobs.items()}
    system = SlamConfig(**knobs)
    default = SlamConfig()
    odd = [f.name for f in dataclasses.fields(SlamConfig)
           if f.name not in REFERENCE_KNOBS
           and getattr(system, f.name) != getattr(default, f.name)]
    odd += [f"{k}={getattr(system, k)!r}" for k, v in REFERENCE_VALUES.items()
            if getattr(system, k) not in v]
    if odd or system.compute_size_ratio != 1:
        raise SystemExit(f"{name}: the reference does not follow {odd}")
    H, W = cfg["input_size"]
    applies = lambda m: name in m.get("workloads", [name])
    return Cell(name=name, mix=mix, system=system,
                k=tuple(cfg["k"]), H=H, W=W,
                size=system.volume_resolution[0],
                dim=float(system.volume_size[0]),
                rendering_rate=cfg["rendering_rate"], chips=entry["chips"],
                limits=cfg["limits"],
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def read_metric(name: str, run: dict, root: str = ROOT) -> Optional[float]:
    """``metrics/<name>.py``'s ``read(run)``: a number, or None where the
    run holds nothing for it to read."""
    path = os.path.join(root, "slambench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "slambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def pin_cpus(device: torch.device) -> List[int]:
    """Pin this process to the CPUs local to the card's NUMA node (as far
    as it may run on them); returns the CPUs it runs on."""
    allowed = os.sched_getaffinity(0)
    try:
        bus = subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=30).stdout.strip().lower()
        dom, rest = bus.split(":", 1)
        with open(f"/sys/bus/pci/devices/{dom[-4:]}:{rest}/local_cpulist") \
                as f:
            local = set()
            for part in f.read().strip().split(","):
                a, _, b = part.partition("-")
                local |= set(range(int(a), int(b or a) + 1))
        if local & allowed:
            os.sched_setaffinity(0, local & allowed)
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return sorted(os.sched_getaffinity(0))


def card_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def sample_frames(cell: Cell, seed: int, w0: int, lap: int) -> List[int]:
    """The window frames (offsets from its first, ``w0``) the check
    samples, drawn from the seed among the first SAMPLE_SPAN: half of them
    frames that integrate and render, the rest any others."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    span = min(SAMPLE_SPAN, lap)
    every = math.lcm(cell.system.integration_rate,
                     max(cell.rendering_rate, 1))
    full = [j for j in range(span) if (w0 + j) % every == 0]
    pick = list(rng.choice(full, N_SAMPLES // 2, replace=False))
    rest = [j for j in range(span) if j not in pick]
    pick += list(rng.choice(rest, N_SAMPLES - len(pick), replace=False))
    return sorted(int(j) for j in pick)


class Runner:
    """The port's system on one device, driven over a stream."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 cache_dir=streams.CACHE_DIR):
        from supereight_tpu_torch.pipeline.system import DenseSLAMSystem
        self.cell = cell
        self.stream = streams.Stream(cell.mix, cell.k, cell.H, cell.W, seed,
                                     device, cache_dir)
        self.slam = DenseSLAMSystem((cell.H, cell.W), cell.system, device)
        self.slam.setPose(self.stream.pose(0))
        self.samples: Dict[int, dict] = {}

    def _snap(self, images=None) -> dict:
        return check.snapshot(self.slam.state, self.cell.size, self.cell.dim,
                              images)

    def _renders(self, i: int):
        rr = self.cell.rendering_rate
        if rr <= 0 or i % rr:
            return None
        s = self.slam
        return s.renderDepth(), s.renderTrack(), s.renderVolume()

    def frame(self, i: int, sample: bool = False) -> float:
        """Frame ``i`` as the app runs it; returns its seconds (a sampled
        frame's state is kept outside its time)."""
        before = self._snap() if sample else None
        depth = self.stream.frame(i)
        t0 = time.perf_counter()
        st = self.slam.step(depth, self.cell.k, i)
        self.slam.synchronize()
        images = self._renders(i)
        if images is not None:
            self.slam.synchronize()
        dt = time.perf_counter() - t0
        if sample:
            self.samples[i] = dict(before=before, frame=i, depth=depth,
                                   after=self._snap(images))
        self.tracked = st.tracked
        return dt

    def staged_frame(self, i: int, times: Dict[str, List[float]],
                     sample: bool = False) -> None:
        """Frame ``i`` through the system's per-stage calls, each in its
        span and timed on the host clock up to its synchronise."""
        from torch.profiler import record_function
        before = self._snap() if sample else None
        depth, k, s = self.stream.frame(i), self.cell.k, self.slam
        calls = (("preprocessing", lambda: s.preprocessing(depth)),
                 ("tracking", lambda: s.tracking(k, i)),
                 ("integration", lambda: s.integration(k, i)),
                 ("raycasting", lambda: s.raycasting(k, i)))
        for name, fn in calls:
            with record_function("slambench." + name):
                t0 = time.perf_counter()
                fn()
                with record_function("slambench.sync"):
                    s.synchronize()
                times[name].append(time.perf_counter() - t0)
        images, dt = None, 0.0
        if self.cell.rendering_rate > 0 and i % self.cell.rendering_rate == 0:
            with record_function("slambench.rendering"):
                t0 = time.perf_counter()
                images = self._renders(i)
                with record_function("slambench.sync"):
                    s.synchronize()
                dt = time.perf_counter() - t0
        times["rendering"].append(dt)
        if sample:
            self.samples[i] = dict(before=before, frame=i, depth=depth,
                                   after=self._snap(images))
        self.tracked = s.state.tracked


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_process: float, root: str = ROOT,
        cache_dir=streams.CACHE_DIR, control: Optional[str] = None,
        cpus=(), log=sys.stderr) -> dict:
    """One run; returns the result line's object (with ``check`` last).
    ``control``: also read the control's numbers (the study that sets the
    limits; a benchmark run never does)."""
    runner = Runner(cell, seed, device, cache_dir)
    lap = runner.stream.n
    w0 = runner.stream.hold + lap            # the window's first frame
    offsets = sample_frames(cell, seed, w0, lap)
    wanted = {w0 + j for j in offsets} | {j for j in START_SAMPLES
                                           if j < w0}
    for i in range(w0):                       # the still start, one lap
        runner.frame(i, sample=i in wanted)
    attempted = failed = 0
    result: dict = {}
    gc.collect()
    gc.freeze()             # the set-up's objects are never scanned again
    if not traced:
        times: List[float] = []
        t0 = time.perf_counter()
        setup_s = t0 - t_process
        i, end = w0, w0 + max(offsets) + 1
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        ends = []
        while True:
            times.append(runner.frame(i, sample=i in wanted))
            failed += not runner.tracked
            i += 1
            t1 = time.perf_counter()
            ends.append(t1 - t0)
            if t1 - t0 >= seconds and i >= end:
                break
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        attempted = len(times)
        per_s = np.bincount(np.minimum(np.array(ends, int), int(seconds)))
        print(f"window: frames a second {per_s.tolist()}; cpu user "
              f"{ru1.ru_utime - ru0.ru_utime:.3f} s system "
              f"{ru1.ru_stime - ru0.ru_stime:.3f} s; context switches "
              f"{ru1.ru_nvcsw - ru0.ru_nvcsw} voluntary "
              f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary", file=log)
        values = {"frames_per_s": attempted / (t1 - t0),
                  "frame_ms_p95": 1e3 * float(np.percentile(times, 95)),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        summary = None
    else:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        stage_times = {n: [] for n in trace.STAGES}
        integrated = []
        with profile(activities=acts) as prof:
            with record_function("slambench.window"):
                for i in range(w0, w0 + lap):                # one whole lap
                    runner.staged_frame(i, stage_times, sample=i in wanted)
                    integrated.append(runner.slam.state.integrated)
                    failed += not runner.tracked
        attempted = lap
        summary = trace.summarize(trace.events(prof))
        del prof
    device_info = card_info(device)
    power = device_info.pop("power_limit", None)
    if device.type == "cuda":
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    samples = [runner.samples[i] for i in sorted(runner.samples)]
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, rows, work_rows, ctl = check.check_samples(samples, cell,
                                                        control=control)
    if traced:
        fused = [w["fused_blocks"] for w in work_rows if "fused_blocks" in w]
        hits = [w["hit_blocks"] for w in work_rows if "hit_blocks" in w]
        nodes = [w["nodes"] for w in work_rows if "nodes" in w]
        fused = float(np.mean(fused)) if fused else 0.0
        hits = float(np.mean(hits)) if hits else 0.0
        nodes = float(np.mean(nodes)) if nodes else 0.0
        rr = cell.rendering_rate
        total = sum(work.frame_bytes(
            cell, i, integrated[i - w0], rr > 0 and i % rr == 0, fused,
            hits, cell.system.bilateral_filter, nodes)
            for i in range(w0, w0 + lap))
        ctx = dict(frames=lap, stage_s=stage_times, trace=summary,
                   least_s=total / work.PEAK_BYTES_S)
        result["metrics"] = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx, root)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary["busy_s"]
            device_info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    correct = check.verdict(numbers, cell.limits)
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=result["metrics"], device=device_info,
                  **({"breakdown": result["breakdown"]}
                     if "breakdown" in result else {}))
    if ctl is not None:
        result["control"] = ctl
    result["check"] = {n: {"value": numbers[n], "limit": cell.limits[n]}
                       for n in check.NUMBERS}
    print(f"cell {cell.name} seed {seed} card {device_info['kind']} "
          f"power limit {power} cpus {list(cpus)}", file=log)
    for r, j in zip(rows, sorted(wanted)):
        print(f"frame {j}: " + " ".join(f"{n} {r[n]:.6g}"
                                        for n in check.NUMBERS), file=log)
    if ctl is not None:
        print("control " + " ".join(f"{n} {ctl[n]:.6g}"
                                    for n in check.NUMBERS), file=log)
    for n in check.NUMBERS:
        print(f"check {n} {numbers[n]:.6g} limit {cell.limits[n]:.6g}",
              file=log)
    return result

