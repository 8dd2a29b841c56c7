"""Device times of the gather-probe kernels K2 and K3 at the probe's shapes
and at their second shapes, and of the frame's pyramid, inverse, raycast
kernels and fusion at the headline's shapes, for the package at a given
checkout root.

Run on a CUDA device from the root of this checkout, once for each checkout
to compare, in turns within one machine (for example the parent, this one,
this one, the parent):

    python -m supereight_tpu_torch.probes.kernel_times --root DIR

``DIR`` is the root of a checkout whose ``supereight_tpu_torch`` is timed
(built from its own sources).  The inputs are always this checkout's
(`gather_probe.kernel_inputs`, the data ``chip_smoke.py`` holds the kernels
on), made before the other checkout's package is imported in place of this
one; of that package only the wrappers' call signatures are assumed, as
this checkout has them.  It prints one JSON object:
the card's name and power limit, and the median device time (ms, CUDA
events, 25 runs) of ``lane_shuffle_sum`` at 256 and 65536 rows (krep 64)
and ``slab_row_sum`` at 2048 and 8192 slabs.  Then, with the other
checkout's ``preprocessing.build_pyramid``, ``numerics.inv`` and
``raycast_kernel``'s ``splat_bounds`` and scan (and ``chip_smoke.warm_map``
run on its package): the headline pyramid (frame 40 of the cached
sequence, 320x240, 3 levels), the inverse of a pose (frame 30's), R1 (the
view's inverse inside it), the headline's scan (one ``ray_scan``
launch: the first window, the second window cut at its budget, the
midsolve off) and R4 on its rays (the secant re-solve, hybrid normals at
the headline's grad_decim; and the other re-solve and normals modes,
``ray_refine_normals_<resolve>_<normals>``) on the headline map after 12
frames from the last pose, the fusion with the node update
(:func:`fusion_calls`; a package from before the update went into the
fusion's launch times its fusion alone there), the budget branch's
operands with the selection at three capacities (:func:`operands_calls`;
one launch with the inverse inside, or the inverse then the selection)
and ``icp_track_levels`` and a trip of the sharded frame on a rank's
strip of each level (:func:`icp_calls`; one launch with the previous
trip's update inside, or kernel B then kernel A),
each's median device time (``ms``), host time with the device
synchronised before and after (``host_ms``) and enqueue time, the call's
own time from an idle device (``enqueue_ms``), over 25 runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PKG = "supereight_tpu_torch"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    from supereight_tpu_torch.probes import gather_probe as probe
    from supereight_tpu_torch.probes.timing import device_times_ms

    dev = torch.device("cuda", 0)
    k2, table, k3 = probe.kernel_inputs(dev)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    # the package under ``--root`` in place of this one
    for name in [m for m in sys.modules if m.split(".")[0] == PKG]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.root))
    from supereight_tpu_torch.ops import gather_probe as gp

    med = lambda fn: statistics.median(device_times_ms(fn, 25))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(root=args.root, card=smi, ms={})
    for src, idx in k2:
        res["ms"][f"lane_shuffle_sum_{src.shape[0]}x128x{probe.KREP}"] = med(
            lambda: gp.lane_shuffle_sum(src, idx, probe.KREP))
    for rows in k3:
        res["ms"][f"slab_row_sum_{rows.numel()}"] = med(
            lambda: gp.slab_row_sum(rows, table))
    res["host_ms"], res["enqueue_ms"] = {}, {}
    for name, call in glue_calls(smoke, dev).items():
        fn, setup = call if isinstance(call, tuple) else (call, None)
        res["ms"][name] = statistics.median(device_times_ms(fn, 25, setup))
        res["host_ms"][name] = statistics.median(
            host_times_ms(fn, True, setup=setup))
        res["enqueue_ms"][name] = statistics.median(
            host_times_ms(fn, False, setup=setup))
    print(json.dumps(res))
    return res


def host_times_ms(fn, synchronised: bool, runs: int = 25, setup=None):
    """The host clock's ms of ``fn`` from an idle device, to its return
    (the enqueue) or, ``synchronised``, to the device's end; ``setup``, if
    given, runs before each run, outside the clock."""
    import torch
    fn()
    out = []
    for _ in range(runs):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if synchronised:
            torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return out


def glue_calls(smoke, dev) -> dict:
    """The calls timed beside K2 and K3, by name, on the package in place
    (imported here, after the swap)."""
    import numpy as np
    import torch
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import camera, preprocessing, raycast
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    depths, poses = smoke.load_sequence("synthetic_256_frames")
    k = torch.from_numpy(smoke.K).to(dev)
    d = preprocessing.mm_to_meters(
        torch.from_numpy(depths[40].astype(np.int32)).to(dev), (240, 320))
    pose = torch.from_numpy(poses[30]).to(dev)
    slam = smoke.warm_map(smoke.preset_config("headline"), depths, poses,
                          dev, 12)
    view = slam.state.pose @ camera.inverse_camera_matrix(k)
    m, field = slam.state.map, slam.field
    cfg = slam.config
    dense = {"F": slam.state.view} if slam.state.view is not None else \
        raycast.pack_view(m, field)
    plan = raycast.scan_plan(m, field, 240, 320, NEAR_PLANE, FAR_PLANE,
                             cfg.raycast_span_factor,
                             cfg.raycast_scan_stride, False)
    grids = rk.splat_bounds(m, field, view, 240, 320, NEAR_PLANE, FAR_PLANE)

    scan = rk.ray_scan(m, dense, field, view, plan, *grids, True,
                       cfg.raycast_w2_budget, False)
    calls = {
        "build_pyramid_320x240x3": lambda: preprocessing.build_pyramid(
            d, k, 3, False),
        "pose_inv_4x4": lambda: numerics.inv(pose),
        "splat_bounds_headline": lambda: rk.splat_bounds(
            m, field, view, 240, 320, NEAR_PLANE, FAR_PLANE),
        "ray_scan_headline": lambda: rk.ray_scan(
            m, dense, field, view, plan, *grids, True, cfg.raycast_w2_budget,
            False),
        "ray_refine_normals_headline": lambda: rk.ray_refine_normals(
            m, dense, field, view, plan, scan.z, scan.hit, "secant",
            "hybrid", cfg.raycast_grad_decim)}
    for resolve, normals in (("interp", "hybrid"), ("secant", "volume"),
                             ("interp", "volume"), ("secant", "none"),
                             ("interp", "none")):
        calls[f"ray_refine_normals_{resolve}_{normals}"] = (
            lambda r=resolve, n=normals: rk.ray_refine_normals(
                m, dense, field, view, plan, scan.z, scan.hit, r, n,
                cfg.raycast_grad_decim))
    calls.update(fusion_calls(smoke, dev, slam, depths[12]))
    calls.update(operands_calls(smoke, dev, slam, depths, poses))
    calls.update(icp_calls(smoke, dev, depths, poses))
    return calls


def operands_calls(smoke, dev, slam, depths, poses) -> dict:
    """The budget branch's fusion operands (``integration.fusion_operands``
    from the pose: the selection with the inverse inside its one launch; a
    package from before that takes ``numerics.inv(pose)`` first, as its
    ``integrate`` did) on the headline map after 12 frames at its budget,
    3072 of 6144 slots, and on maps of frame 30's blocks at
    demo512-ofusion's and 1024-quality's capacities and budgets
    (``chip_smoke.SELECT_CAPACITIES``)."""
    import numpy as np
    import torch
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import (camera, integration,
                                               preprocessing)
    k = camera.camera_matrix(torch.from_numpy(smoke.K).to(dev)).contiguous()
    out = {"operands_6144_3072": operands(
        integration, numerics, slam.state.map, slam.state.pose, k, 3072)}
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[30].astype(np.int32)).to(dev), (240, 320))
    pose = torch.from_numpy(poses[30]).to(dev)
    for size, cap, budget in smoke.SELECT_CAPACITIES:
        m = smoke.select_map(torch, size, cap, dev, depth, pose, k)
        out[f"operands_{cap}_{budget}"] = operands(integration, numerics, m,
                                                   pose, k, budget)
    return out


def operands(integration, numerics, m, pose, k, budget):
    """A call of the package's ``integration.fusion_operands`` from the
    pose at ``budget``: since the selection inverts the pose in its own
    launch it takes the pose; before, the caller inverted it first, as
    ``integrate`` did."""
    import inspect
    if list(inspect.signature(
            integration.fusion_operands).parameters)[1] == "pose":
        return lambda: integration.fusion_operands(m, pose, k, (240, 320),
                                                   budget)
    return lambda: integration.fusion_operands(m, numerics.inv(pose), k,
                                               (240, 320), budget)


#: a rank's strip of each level of the headline's pyramid (level, stride,
#: ranks): the sharded frame's trips on rank 1 of 2
TRIP_STRIPS = {"160x120 decimated, rank 1 of 2": (0, 2, 2),
               "160x120, rank 1 of 2": (1, 1, 2),
               "80x60, rank 1 of 2": (2, 1, 2)}


def icp_calls(smoke, dev, depths, poses) -> dict:
    """``icp_track_levels`` on the headline frame ``chip_smoke.ICP_FRAME``
    at its pyramid, and a trip of the sharded frame on each strip of
    TRIP_STRIPS from that frame's start pose, the previous trip's sums
    pending: one launch with the update inside it, or, for a package from
    before it, kernel A then kernel B (the carry restored before each
    run, outside the time)."""
    import inspect
    import torch
    from supereight_tpu_torch.ops import icp_kernel as icp
    ops = smoke.icp_operands(torch, depths, poses, dev)
    cfg = ops["cfg"]
    refs = (ops["ref_v"], ops["ref_n"], ops["view"])
    levels = smoke.icp_level_set(ops, cfg.icp_finest_decimate)
    out = {f"icp_track_levels_{cfg.pyramid}": lambda: icp.icp_track_levels(
        ops["start"], levels, *refs, cfg.pyramid, cfg.icp_threshold)}
    merged = "pending" in inspect.signature(icp.icp_track_reduce).parameters
    for name, (level, d, n) in TRIP_STRIPS.items():
        iv, inm = (a[::d, ::d] for a in (ops["vertices"][level],
                                         ops["normals"][level]))
        rows = iv.shape[0] // n
        iv, inm = (a[rows:2 * rows] for a in (iv, inm))
        res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=dev)
        sums = torch.zeros(icp.N_SUMS, device=dev)
        start = smoke.icp_carry(torch, ops["start"])
        carry = smoke.icp_carry(torch, ops["start"])
        scratch = icp.make_scratch(res.numel(), dev)
        icp.icp_track_reduce(iv, inm, *refs, carry, 4, res, sums,
                             scratch=scratch)
        pending, out_sums = sums.clone(), torch.zeros_like(sums)
        if merged:
            fn = (lambda iv=iv, inm=inm, res=res, carry=carry,
                  pending=pending, out_sums=out_sums, scratch=scratch:
                  icp.icp_track_reduce(iv, inm, *refs, carry, 4, res,
                                       out_sums, scratch=scratch,
                                       pending=pending, icp_threshold=0.0))
        else:
            def fn(iv=iv, inm=inm, res=res, carry=carry, pending=pending,
                   out_sums=out_sums, scratch=scratch):
                icp.icp_update(pending, carry, 4, 0.0)
                icp.icp_track_reduce(iv, inm, *refs, carry, 4, res, out_sums,
                                     scratch=scratch)
        out[f"icp_trip_{name}"] = (fn, lambda carry=carry, start=start: [
            a.copy_(b) for a, b in zip(carry, start)])
    return out


def fusion_calls(smoke, dev, slam, depth_mm) -> dict:
    """The fusion with the node pyramid's update, as ``integration.fuse``
    runs it: on clones of the headline
    map after 12 frames at the budget's 3072 slots, and on a 1024^3 map of
    the frame's blocks with random node tables (``chip_smoke.fusion_map``)
    at the same budget; the frame is the sequence's next (``depth_mm``).
    Also ``fuse_sdf`` and ``fuse_ofusion`` without the nodes on 3072
    distinct slots repeating the headline map's and the ofusion map's (after
    8 frames) blocks (``chip_smoke.synthetic_table``)."""
    import numpy as np
    import torch
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.fields import SDFField
    from supereight_tpu_torch.ops import integrate_kernel
    from supereight_tpu_torch.pipeline import (camera, integration,
                                               preprocessing)
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depth_mm.astype(np.int32)).to(dev), (240, 320))
    k = camera.camera_matrix(torch.from_numpy(smoke.K).to(dev)).contiguous()
    now = float(np.float32(1.0 / 30.0) * np.float32(12))
    pose = slam.state.pose
    T_cw = numerics.inv(pose)
    big = SDFField(mu=0.1)
    maps = {"headline": (smoke.clone_tables(slam.state.map), slam.field),
            "1024_sdf": (smoke.fusion_map(torch, 1024, big, dev, 1024, depth,
                                          pose, k), big)}
    # the rows alone (no node update) at the budget's shape: 3072 distinct
    # slots repeating the headline and ofusion maps' live blocks
    table, rows = smoke.synthetic_table(torch, slam.state.map, 3072)
    out = {"fuse_sdf_rows_3072": lambda: integrate_kernel.fuse_sdf(
        table, depth, T_cw, k, slam.field.mu, slam.field.max_weight, rows)}
    of = smoke.warm_map(smoke.preset_config("ofusion"), *smoke.load_sequence(
        "synthetic_256_frames"), dev, 8)
    of_table, of_rows = smoke.synthetic_table(torch, of.state.map, 3072)
    of_T = numerics.inv(of.state.pose)
    out["fuse_ofusion_rows_3072"] = lambda: integrate_kernel.fuse_ofusion(
        of_table, depth, of_T, k, of.field.mu, of.field.sigma_lo, now,
        of_rows)
    for name, (m, field) in maps.items():
        slots = operands(integration, numerics, m, pose, k, 3072)()[0]
        out[f"fuse_with_nodes_{name}_3072"] = (
            lambda m=m, field=field, slots=slots: integration.fuse(
                field, m, slots, depth, T_cw, k, now))
    return out


if __name__ == "__main__":
    main()
