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

A preset's run also cuts the tracking stage of each of those frames in
the four parts of :data:`PARTS` (:func:`track_parts`), each timed alone
from the state the stage starts from, on the host clock and by CUDA
events; their medians are the run's ``parts``.  Of the other checkout
these also take ``preprocessing.build_pyramid``, ``camera.camera_matrix``,
``core.numerics.inv`` and ``tracking.track_levels`` (given the raycast
pose and the intrinsics where it takes them, the view otherwise).

It also cuts the integration stage of each of those frames in the parts
of :data:`INT_PARTS` (:func:`integration_parts`), each timed alone the
same way on clones of the map's tables; a run's ``int_parts`` are their
medians over the frames that run each part.  Of the other checkout these
take ``system.tracking_stage``, ``system._alloc_fires``, ``integration``'s
``allocate_sdf`` / ``allocate_ofusion``, ``fusion_operands`` (which
returns ``T_cw`` too: a checkout from before the inverse went into the
selection's launch is cut by its own probe), ``fuse``
(which returns the map with its new node tables: a checkout from before
the node update went into the fusion's launch is cut by its own probe),
``raycast.view_alloc_fill`` / ``pack_view`` and ``gradmap.build_table``.

After each of those frames it cuts the reference raycast of the frame's
final state in the parts of :data:`RAY_PARTS` (:func:`raycast_parts`),
each timed alone the same way; a run's ``ray_parts`` are their medians.
Of the other checkout these take ``raycast``'s phases (on the card its
raycast kernels; the ``scan`` part holds the second window and the
midsolve, which run in the scan's launch).
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
#: (``camera_matrix(k) @ inv(raycast_pose)``: ``pose_inv`` and a matrix
#: product, for a checkout whose level loops take the view; since the view
#: is formed inside ``icp_track_levels``' launch, part of the loops), the
#: level loops (``track_levels``) and the divergence test with its
#: ``bool(ok)`` read
PARTS = ("pyramid", "view", "loops", "read")


def track_parts(slam, depth_mm, k, frame: int):
    """The tracking stage of ``frame`` in its four parts (:data:`PARTS`),
    from the state the stage would start from (this frame's preprocessing
    on ``slam.state``), each part with the device synchronised before and
    after it: {part: (host ms, device ms by CUDA events)}; on the CPU the
    device ms are None.  The state is left as it was.  None where the
    frame runs no ICP."""
    import inspect
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
    part = _timer(slam, out)

    _, vertices, normals = part("pyramid", lambda: preprocessing.build_pyramid(
        st.scaled_depth, kd, len(cfg.pyramid), neg_y=neg_y))
    if "raycast_pose" in inspect.signature(tracking.track_levels).parameters:
        # the view is formed inside the level loops' launch: no view part
        camera_args = (st.raycast_pose, kd)
    else:
        camera_args = (part("view", lambda: camera.camera_matrix(kd) @ inv(
            st.raycast_pose)),)
    carry, result, _ = part("loops", lambda: tracking.track_levels(
        st.pose, vertices, normals, st.ref_vertex, st.ref_normal,
        *camera_args, cfg.pyramid, cfg.icp_threshold,
        finest_decimate=cfg.icp_finest_decimate, symmetric=sym,
        robust=cfg.icp_robust, robust_delta=cfg.icp_robust_delta,
        assoc=cfg.icp_assoc))

    def read():
        rmse = torch.sqrt(carry.error2 / torch.clamp(carry.count, min=1.0))
        return bool((rmse <= 2e-2)
                    & (carry.count / result.numel() >= TRACK_THRESHOLD))

    part("read", read)
    return out


#: the integration stage's parts: the allocation march with its slot
#: assignment (allocating frames), the held view's fill (an SDF view's
#: ``view_alloc_fill``, a multiscale view's rebuild), the fusion's
#: operands (``fusion_operands``: on the budget branch the frustum
#: selection with ``inv(pose)`` inside its launch, else ``inv(pose)``
#: alone), the fusion launch (with the node pyramid's update inside it)
#: and the stored gradient table's rebuild (``raycast_normals="stored"``)
INT_PARTS = ("alloc", "fill", "select", "fuse", "grad")


def _timer(slam, out):
    """``part(name, fn)``: ``fn()`` with the device synchronised before
    and after it, its (host ms, device ms by CUDA events or None on the
    CPU) stored in ``out[name]``."""
    import time
    import torch
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
    return part


def integration_parts(slam, depth_mm, k, frame: int):
    """The integration stage of ``frame`` in the parts of
    :data:`INT_PARTS` that it runs, from the state the stage would start
    from (this frame's preprocessing and tracking on ``slam.state``), each
    part with the device synchronised before and after it, on clones of
    the map's tables and of a held view: {part: (host ms, device ms)}.
    The state is left as it was.  None where the frame does not fuse."""
    import numpy as np
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.pipeline import (camera, gradmap, integration,
                                               raycast, system)
    cfg, field = slam.config, slam.field
    kd, neg_y = slam._k(k)
    st = system.preprocessing_stage(slam.state, slam._depth(depth_mm), cfg)
    st = system.tracking_stage(st, kd, frame, cfg, neg_y)
    boot = frame <= cfg.bootstrap_frames
    if not (((st.tracked and st.model_ref) or boot)
            and (frame % cfg.integration_rate == 0 or boot)):
        return None
    out = {}
    part = _timer(slam, out)
    K = camera.camera_matrix(kd)
    depth = st.scaled_depth if cfg.fuse_filtered else st.float_depth
    pose = st.pose
    timestamp = float(np.float32(1.0 / 30.0) * np.float32(frame))
    m = st.map.replace(voxels={n: v.clone() for n, v in st.map.voxels.items()},
                       active=st.map.active.clone())
    view = None if st.view is None else st.view.clone()
    live_before = octree.slot_mask(m)
    if system._alloc_fires(st, depth, K, frame, cfg):
        if field.multiscale_alloc:
            m = part("alloc", lambda: integration.allocate_ofusion(
                m, depth, pose, K, field.alloc_band(), phase=st.alloc_count))
        else:
            m = part("alloc", lambda: integration.allocate_sdf(
                m, depth, pose, K, field.alloc_band(),
                stride=cfg.alloc_stride))
    sdf_view = view is not None and not field.multiscale_alloc
    if sdf_view:
        part("fill", lambda: raycast.view_alloc_fill(view, m, live_before,
                                                     field))
    K, depth = K.contiguous(), depth.contiguous()
    slots, _, T_cw = part("select", lambda: integration.fusion_operands(
        m, pose, K, depth.shape, cfg.integrate_budget))
    m = part("fuse", lambda: integration.fuse(
        field, m, slots, depth, T_cw, K, timestamp, cfg.integrate_patch,
        view if sdf_view else None))
    if view is not None and not sdf_view:
        part("fill", lambda: raycast.pack_view(m, field)["F"])
    if st.grad is not None:
        part("grad", lambda: gradmap.build_table(m, field))
    return out


#: the reference raycast's parts: the read view's pack (``pack_view``,
#: where no view is held), the splat bounds (with the slots' inside-voxel
#: flags), the scan (with the rays' directions and start depths, the
#: second window and the midsolve), the full-resolution re-solve (with the
#: volume and hybrid normals) and the stored and exact normals
RAY_PARTS = ("pack", "splat", "scan", "refine", "normals")


def raycast_parts(slam, k):
    """The reference raycast of ``slam.state`` (the map, pose, held view
    and gradient table that the frame's raycasting stage reads) in the
    parts of :data:`RAY_PARTS` it runs, each timed alone with the device
    synchronised before and after it: {part: (host ms, device ms)}.
    The state is left as it was.  The phases run as ``raycast.raycast``
    runs them (on the card the kernels R1-R4)."""
    from supereight_tpu_torch.pipeline import camera, raycast
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    st, cfg, field, m = slam.state, slam.config, slam.field, slam.state.map
    kd, _ = slam._k(k)
    view = st.pose @ camera.inverse_camera_matrix(kd)
    H, W = st.float_depth.shape
    near, far = NEAR_PLANE, FAR_PLANE
    out = {}
    part = _timer(slam, out)
    plan = raycast.scan_plan(m, field, H, W, near, far,
                             cfg.raycast_span_factor,
                             cfg.raycast_scan_stride,
                             cfg.raycast_full_res_scan)
    dense = {"F": st.view} if st.view is not None else \
        part("pack", lambda: raycast.pack_view(m, field))
    tmin, tmax, g = part("splat", lambda: raycast._splat_bounds(
        m, field, view, H, W, near, far,
        near_rescue=cfg.raycast_near_rescue))
    scan = part("scan", lambda: raycast.ray_scan(
        m, dense, field, view, plan, tmin, tmax, g,
        cfg.raycast_second_window, cfg.raycast_w2_budget,
        cfg.raycast_midsolve))
    fin = part("refine", lambda: raycast.ray_finish(
        m, dense, field, view, plan, scan, normals=cfg.raycast_normals,
        refine=cfg.raycast_refine, grad_decim=cfg.raycast_grad_decim,
        grad_table=st.grad))
    if fin.normal is None:
        part("normals", lambda: raycast.gradient_normals(
            m, field, fin, cfg.raycast_normals, st.grad))
    return out


def part_medians(rows, names=PARTS):
    """{part: {"host": ms, "device": ms, "frames": n}}: the medians of
    :func:`track_parts`' (or :func:`integration_parts`') rows over the
    frames that ran each part."""
    out = {}
    for p in names:
        have = [r[p] for r in rows if p in r]
        if have:
            out[p] = {clock: None if have[0][i] is None else
                      statistics.median(h[i] for h in have)
                      for i, clock in enumerate(("host", "device"))}
            out[p]["frames"] = len(have)
    return out


def staged_run(slam, depths, k):
    """Every frame through ``step_staged``, each frame after the first
    SKIP first cut in its tracking and its integration parts, and after
    its step its reference raycast cut in its parts: (the stages'
    medians, the tracking parts' medians or None, the integration parts'
    medians or None, the raycast parts' medians)."""
    rows, parts, int_parts, ray_parts = [], [], [], []
    for f in range(len(depths)):
        if f >= SKIP:
            cut = track_parts(slam, depths[f], k, f)
            if cut is not None:
                parts.append(cut)
            cut = integration_parts(slam, depths[f], k, f)
            if cut is not None:
                int_parts.append(cut)
        _, stage_s = slam.step_staged(depths[f], k, f)
        if f >= SKIP:
            rows.append(stage_s)
            ray_parts.append(raycast_parts(slam, k))
    return (_medians(rows), part_medians(parts) if parts else None,
            part_medians(int_parts, INT_PARTS) if int_parts else None,
            part_medians(ray_parts, RAY_PARTS))


def format_parts(parts) -> str:
    """The parts' medians as ``part host / device`` ms."""
    ms = lambda v: "not measured" if v is None else f"{v:.3f}"
    return ", ".join(f"{p} {ms(t['host'])} / {ms(t['device'])}"
                     + (f" ({t['frames']} frames)" if "frames" in t else "")
                     for p, t in parts.items())


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
    stages, parts, int_parts, ray_parts = staged_run(runs[0], depths,
                                                     smoke.K)
    del runs[0]
    return dict(stages, parts=parts, int_parts=int_parts,
                ray_parts=ray_parts,
                run=step_run(runs[0], depths, poses, smoke.K,
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
            if k not in ("parts", "int_parts", "ray_parts", "run")),
            flush=True)
        if "run" in res["ms"][name]:
            print(f"# {args.root} {name} step run: " + ", ".join(
                f"{k} {v:.2f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in res["ms"][name]["run"].items()), flush=True)
        for key, what in (("parts", "tracking"), ("int_parts", "integration"),
                          ("ray_parts", "raycast")):
            if res["ms"][name].get(key):
                print(f"# {args.root} {name} {what} parts (host / device "
                      "ms): " + format_parts(res["ms"][name][key]),
                      flush=True)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
