"""Device times of the gather-probe kernels K2 and K3 at the probe's shapes
and at their second shapes, and of the frame's pyramid, inverse and
raycast splat bounds at the headline's shapes, for the package at a given
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
view's inverse inside it) and the headline's scan (one ``ray_scan``
launch: the first window, the second window cut at its budget, the
midsolve off) on the headline map after 12 frames from the last pose,
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
    for name, fn in glue_calls(smoke, dev).items():
        res["ms"][name] = med(fn)
        res["host_ms"][name] = statistics.median(host_times_ms(fn, True))
        res["enqueue_ms"][name] = statistics.median(host_times_ms(fn, False))
    print(json.dumps(res))
    return res


def host_times_ms(fn, synchronised: bool, runs: int = 25):
    """The host clock's ms of ``fn`` from an idle device, to its return
    (the enqueue) or, ``synchronised``, to the device's end."""
    import torch
    fn()
    out = []
    for _ in range(runs):
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

    return {
        "build_pyramid_320x240x3": lambda: preprocessing.build_pyramid(
            d, k, 3, False),
        "pose_inv_4x4": lambda: numerics.inv(pose),
        "splat_bounds_headline": lambda: rk.splat_bounds(
            m, field, view, 240, 320, NEAR_PLANE, FAR_PLANE),
        "ray_scan_headline": lambda: rk.ray_scan(
            m, dense, field, view, plan, *grids, True, cfg.raycast_w2_budget,
            False)}


if __name__ == "__main__":
    main()
