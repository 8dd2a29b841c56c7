"""Median host time of each stage of a frame, for every preset and phase
G's sharded runs, for the package at a given checkout root.

Run on a CUDA device from the root of this checkout, once for each checkout
to compare, in turns within one machine (for example the parent, this one,
this one, the parent):

    python -m supereight_tpu_torch.probes.stage_times --root DIR \\
        [--runs headline,ofusion,...,G1,G2] [--out FILE]

``DIR`` is the root of a checkout whose ``supereight_tpu_torch`` runs
(built from its own sources); the runs are ``chip_smoke.py``'s, from this
checkout: each preset of ``chip_smoke.RUNS`` at its size over the 96
frames of its cached sequence through ``DenseSLAMSystem.step_staged``
(host clock, the device synchronised after each stage), and G1 / G2 of
``chip_smoke.G_RUNS`` (2 ranks sharing the card over gloo, rank 0's
stages).  Of the other checkout's package only ``DenseSLAMSystem``,
``step_staged``, ``config.apply_preset`` and ``parallel.multihost``'s
``frames`` job are assumed (any checkout with the multi-device map has
them).  Prints one
JSON object: the card's name and power limit, and per run the median ms
of each stage and of their total over the frames after the first 16;
for a preset also ``run``: a second run's ``step`` median (the device
synchronised after each frame) and its tracked frames, ATE, blocks and
overflow.

The stages' parts are the port's own spans (``utils/perfstats.py``):
``chip_smoke.print_stage_times`` prints their medians from a run with
tracing on (:func:`span_medians`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PKG = "supereight_tpu_torch"
#: frames before the medians start (warm-up, the bootstrap)
SKIP = 16


def staged_run(slam, depths, k):
    """Every frame through ``step_staged``: the stages' medians (ms) over
    the frames after the first SKIP."""
    rows = []
    for f in range(len(depths)):
        _, stage_s = slam.step_staged(depths[f], k, f)
        if f >= SKIP:
            rows.append(stage_s)
    return _medians(rows)


def span_medians(records):
    """{span name: (median host ms, median self ms, spans)} of the
    ``utils.perfstats.SpanRecord`` s ``records``, in the order each name
    first ended."""
    by = {}
    for r in records:
        by.setdefault(r.name, []).append(r)
    return {n: (1e-6 * statistics.median(r.ns for r in rs),
                1e-6 * statistics.median(r.self_ns for r in rs), len(rs))
            for n, rs in by.items()}


def _medians(rows):
    out = {k: 1e3 * statistics.median(r[k] for r in rows) for k in rows[0]}
    out["total"] = 1e3 * statistics.median(sum(r.values()) for r in rows)
    return out


def step_run(slam, depths, poses, k, ate) -> dict:
    """Every frame through ``step``, the device synchronised after each:
    the median ms after the first SKIP frames, and the run's outcome
    (tracked frames, ATE in cm by ``ate(estimates, poses)``, blocks,
    overflow)."""
    import time
    import numpy as np
    ms, est, tracked = [], [], 0
    for f in range(len(depths)):
        t0 = time.perf_counter()
        st = slam.step(depths[f], k, f)
        slam.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        est.append(st.pose.cpu().numpy())
        tracked += bool(st.tracked)
    return dict(step=statistics.median(ms[SKIP:]), tracked=tracked,
                ate_cm=100 * ate(np.stack(est), poses[:len(depths)]),
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow))


def preset_stages(smoke, name: str, dev) -> dict:
    """A preset's stage medians (ms) over its sequence, and its ``step``
    median and outcome from a second run."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    sequence = smoke.RUNS[name][0]
    depths, poses = smoke.load_sequence(sequence)
    runs = [DenseSLAMSystem((240, 320), smoke.preset_config(name), dev)
            for _ in range(2)]
    for slam in runs:
        slam.setPose(poses[0])
    stages = staged_run(runs[0], depths, smoke.K)
    del runs[0]
    return dict(stages, run=step_run(runs[0], depths, poses, smoke.K,
                                     smoke.ate_rmse))


def sharded_stages(smoke, name: str, device: str = "cuda") -> dict:
    """Rank 0's stage medians (ms) of a phase-G run, ranks sharing the
    card over gloo."""
    from supereight_tpu_torch.parallel import multihost
    preset, ranks, max_visible, n_frames = smoke.G_RUNS[name]
    job = dict(kind="frames", preset=preset, config=smoke.BASE,
               frames=smoke.FRAMES, n_frames=n_frames,
               max_visible=max_visible, timed=True)
    res = multihost.launch_jobs(ranks, [job], device=device,
                                backend="gloo", timeout=smoke.G_TIMEOUT,
                                group_timeout=smoke.G_GROUP_TIMEOUT)[0]
    return _medians(res[0]["stages"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--runs", default=None,
                    help="comma-separated presets and G runs (default: "
                         "every preset, then G1 and G2)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("stage_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    runs = args.runs.split(",") if args.runs else \
        list(smoke.RUNS) + [g for g in smoke.G_RUNS if g != "G3"]
    # the package under ``--root`` in place of this one
    for name in [m for m in sys.modules if m.split(".")[0] == PKG]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.root))

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(root=args.root, card=smi, ms={})
    for name in runs:
        res["ms"][name] = sharded_stages(smoke, name) \
            if name in smoke.G_RUNS else preset_stages(smoke, name, dev)
        torch.cuda.empty_cache()
        print(f"# {args.root} {name}: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["ms"][name].items()
            if k != "run"), flush=True)
        if "run" in res["ms"][name]:
            print(f"# {args.root} {name} step run: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in res["ms"][name]["run"].items()), flush=True)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
