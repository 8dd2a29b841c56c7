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
of each stage and of their total over the frames after the first 16.

A preset's run also cuts the tracking stage of each of those frames in
the four parts of :data:`PARTS` (:func:`track_parts`), each timed alone
from the state the stage starts from, on the host clock and by CUDA
events; their medians are the run's ``parts``.  Of the other checkout
these also take ``preprocessing.build_pyramid``, ``camera.camera_matrix``,
``core.numerics.inv`` and ``tracking.track_levels``.
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


#: the tracking stage's parts: the pyramid (``build_pyramid``), the view
#: (``camera_matrix(k) @ inv(raycast_pose)``, the host LU), the level
#: loops (``track_levels``) and the divergence test with its ``bool(ok)``
#: read
PARTS = ("pyramid", "view", "loops", "read")


def track_parts(slam, depth_mm, k, frame: int):
    """The tracking stage of ``frame`` in its four parts (:data:`PARTS`),
    from the state the stage would start from (this frame's preprocessing
    on ``slam.state``), each part with the device synchronised before and
    after it: {part: (host ms, device ms by CUDA events)}; on the CPU the
    device ms are None.  The state is left as it was.  None where the
    frame runs no ICP."""
    import time
    import torch
    from supereight_tpu_torch.core.numerics import inv
    from supereight_tpu_torch.pipeline import (camera, preprocessing, system,
                                               tracking)
    from supereight_tpu_torch.pipeline.constants import TRACK_THRESHOLD
    cfg = slam.config
    if frame % cfg.tracking_rate != 0:
        return None
    kd, neg_y = slam._k(k)
    st = system.preprocessing_stage(slam.state, slam._depth(depth_mm), cfg)
    sym = cfg.icp_symmetric
    if sym == "auto":
        sym = system._sym_auto_gate(st, cfg.icp_sym_min_deg,
                                    cfg.icp_sym_max_deg)
    out = {}
    cuda = slam.device.type == "cuda"

    def part(name, fn):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
        slam.synchronize()
        t0 = time.perf_counter()
        if cuda:
            start.record()
        r = fn()
        if cuda:
            end.record()
        slam.synchronize()
        out[name] = (1e3 * (time.perf_counter() - t0),
                     start.elapsed_time(end) if cuda else None)
        return r

    _, vertices, normals = part("pyramid", lambda: preprocessing.build_pyramid(
        st.scaled_depth, kd, len(cfg.pyramid), neg_y=neg_y))
    view = part("view", lambda: camera.camera_matrix(kd) @ inv(
        st.raycast_pose))
    carry, result, _ = part("loops", lambda: tracking.track_levels(
        st.pose, vertices, normals, st.ref_vertex, st.ref_normal, view,
        cfg.pyramid, cfg.icp_threshold,
        finest_decimate=cfg.icp_finest_decimate, symmetric=sym,
        robust=cfg.icp_robust, robust_delta=cfg.icp_robust_delta,
        assoc=cfg.icp_assoc))

    def read():
        rmse = torch.sqrt(carry.error2 / torch.clamp(carry.count, min=1.0))
        return bool((rmse <= 2e-2)
                    & (carry.count / result.numel() >= TRACK_THRESHOLD))

    part("read", read)
    return out


def part_medians(rows):
    """{part: {"host": ms, "device": ms}}: the medians of
    :func:`track_parts`' rows."""
    return {p: {clock: None if rows[0][p][i] is None else
                statistics.median(r[p][i] for r in rows)
                for i, clock in enumerate(("host", "device"))}
            for p in PARTS}


def staged_run(slam, depths, k):
    """Every frame through ``step_staged``, each frame after the first
    SKIP first cut in its tracking parts: (the stages' medians, the parts'
    medians or None)."""
    rows, parts = [], []
    for f in range(len(depths)):
        if f >= SKIP:
            cut = track_parts(slam, depths[f], k, f)
            if cut is not None:
                parts.append(cut)
        _, stage_s = slam.step_staged(depths[f], k, f)
        if f >= SKIP:
            rows.append(stage_s)
    return _medians(rows), part_medians(parts) if parts else None


def format_parts(parts) -> str:
    """The parts' medians as ``part host / device`` ms."""
    ms = lambda v: "not measured" if v is None else f"{v:.3f}"
    return ", ".join(f"{p} {ms(t['host'])} / {ms(t['device'])}"
                     for p, t in parts.items())


def _medians(rows):
    out = {k: 1e3 * statistics.median(r[k] for r in rows) for k in rows[0]}
    out["total"] = 1e3 * statistics.median(sum(r.values()) for r in rows)
    return out


def preset_stages(smoke, name: str, dev) -> dict:
    """A preset's stage medians (ms) over its sequence."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    sequence = smoke.RUNS[name][0]
    depths, poses = smoke.load_sequence(sequence)
    slam = DenseSLAMSystem((240, 320), smoke.preset_config(name), dev)
    slam.setPose(poses[0])
    stages, parts = staged_run(slam, depths, smoke.K)
    return dict(stages, parts=parts)


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
            if k != "parts"), flush=True)
        if res["ms"][name].get("parts"):
            print(f"# {args.root} {name} tracking parts (host / device ms): "
                  + format_parts(res["ms"][name]["parts"]), flush=True)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
