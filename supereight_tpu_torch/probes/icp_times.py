"""Device time of ``icp_track_levels`` by trips and level size, for the
package at a given checkout root: what a trip costs and what a launch
costs.

Run on a CUDA device from the root of this checkout, once for each checkout
to compare, in turns within one machine (for example the parent, this one,
this one, the parent):

    python -m supereight_tpu_torch.probes.icp_times --root DIR

``DIR`` is the root of a checkout whose ``supereight_tpu_torch`` has
``ops.icp_kernel.icp_track_levels`` (built from its own sources).  The
operands are always this checkout's: the headline frame ``chip_smoke``
holds the ICP kernels on (``chip_smoke.icp_operands``), made before the
other checkout's package is imported in place of this one.  With the
threshold at 0 no level exits early, so a level given n iterations runs n
trips.  It prints one JSON object: the card's name and power limit, and
the median device time (ms, CUDA events, 25 runs) of n trips at the finest
level (the headline's 160x120 decimated level, 19200 pixels) and at the
coarsest (80x60, 4800 pixels) for each n of ``TRIPS``, the cost of a trip
at each (the least-squares slope over n) and the headline's pyramid at its
threshold.

``--trip-parts`` (this checkout's package, ``--root .``) adds a trip's
parts: a build of `csrc/icp.cu` with ``ICP_TRIP_CLOCKS`` defined, into its
own subdirectory of the build directory (the main path never loads it),
in which CTA 0 stamps ``clock64`` at the end of each part of each trip:
the pixel pass (to a barrier after it, which only this build has), the
warp and CTA reduction, the exchange and the solve.  It prints the median
cycles of each part over every trip of 25 launches of ``TRIP_PART_N``
trips at the finest and the coarsest level, and the same in us at the
clock the launches ran at (their clock64 cycles over their globaltimer
nanoseconds).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys

PKG = "supereight_tpu_torch"
#: the trip counts timed at each level
TRIPS = (1, 2, 4, 8, 16)
#: trips a launch of the trip-parts build runs
TRIP_PART_N = 8
#: the parts of a trip, in order (stamps 1-4 after stamp 0)
TRIP_PARTS = ("pass", "reduce", "exchange", "solve")


def camera_args(icp, ops) -> tuple:
    """What ``icp.icp_track_levels`` (a checkout's) takes after the
    reference maps: the raycast pose and the intrinsics where it forms the
    view inside its launch, else the view."""
    if "raycast_pose" in inspect.signature(
            icp.icp_track_levels).parameters:
        return ops["rpose"], ops["k"]
    return (ops["view"],)


def trip_parts(icp, ops, levels, dev) -> dict:
    """The median cycles and us of each part of :data:`TRIP_PARTS` at the
    finest and the coarsest level, from the ``ICP_TRIP_CLOCKS`` build of
    ``icp`` (this checkout's ``ops.icp_kernel``)."""
    import ctypes
    import torch
    from supereight_tpu_torch.ops import _build
    lib = _build.load("icp", defines=("ICP_TRIP_CLOCKS",))
    k = _build.constants("icp")
    n_trips, n_stamps = k["kClockTrips"], k["kClockStamps"]
    buf = torch.zeros(n_trips * n_stamps + 4, dtype=torch.int64,
                      device=dev)
    point = lib.icp_set_trip_clocks
    point.argtypes, point.restype = [ctypes.c_void_p], ctypes.c_int
    plain = icp._lib
    icp._lib = lambda: lib
    out = {}
    try:
        if point(buf.data_ptr()) != 0:
            raise RuntimeError("icp_set_trip_clocks failed")
        for label, level in (("finest", 0), ("coarsest", len(levels) - 1)):
            iv = levels[level][0]
            iters = [0] * len(levels)
            iters[level] = TRIP_PART_N
            parts = {p: [] for p in TRIP_PARTS}
            ghz = []
            for _ in range(25):
                buf.zero_()
                icp.icp_track_levels(ops["start"], levels, ops["ref_v"],
                                     ops["ref_n"], *camera_args(icp, ops),
                                     iters, 0.0)
                c = buf.cpu().tolist()
                launch = c[n_trips * n_stamps:]
                ghz.append((launch[2] - launch[0]) / (launch[3] - launch[1]))
                for t in range(TRIP_PART_N):
                    s = c[t * n_stamps:(t + 1) * n_stamps]
                    for i, p in enumerate(TRIP_PARTS):
                        parts[p].append(s[i + 1] - s[i])
            clock = statistics.median(ghz)
            out[f"{label} {iv.shape[0]}x{iv.shape[1]}"] = dict(
                clock_ghz=clock,
                cycles={p: statistics.median(v) for p, v in parts.items()},
                us={p: statistics.median(v) / clock / 1e3
                    for p, v in parts.items()})
    finally:
        point(None)
        icp._lib = plain
    return out


def slope(xs, ys) -> float:
    """The least-squares slope of ys over xs."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--trip-parts", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("icp_times: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from supereight_tpu_torch.probes.timing import device_times_ms

    dev = torch.device("cuda", 0)
    depths, poses = smoke.load_sequence("synthetic_256_frames")
    ops = smoke.icp_operands(torch, depths, poses, dev)
    cfg = ops["cfg"]
    levels = smoke.icp_level_set(ops, cfg.icp_finest_decimate)
    # the package under ``--root`` in place of this one
    for name in [m for m in sys.modules if m.split(".")[0] == PKG]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.root))
    from supereight_tpu_torch.ops import icp_kernel as icp

    med = lambda fn: statistics.median(device_times_ms(fn, 25))
    refs = (ops["ref_v"], ops["ref_n"], *camera_args(icp, ops))
    run = lambda iters, thr: icp.icp_track_levels(ops["start"], levels,
                                                  *refs, iters, thr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    res = dict(root=args.root, card=smi, ms={}, trip_ms={})
    for label, level in (("finest", 0), ("coarsest", len(levels) - 1)):
        iv = levels[level][0]
        name = f"{label} {iv.shape[0]}x{iv.shape[1]}"
        times = []
        for n in TRIPS:
            iters = [0] * len(levels)
            iters[level] = n
            times.append(med(lambda: run(iters, 0.0)))
            res["ms"][f"{name}, {n} trips"] = times[-1]
        res["trip_ms"][name] = slope(TRIPS, times)
    res["ms"][f"pyramid {cfg.pyramid}"] = med(
        lambda: run(cfg.pyramid, cfg.icp_threshold))
    if args.trip_parts:
        res["trip_parts"] = trip_parts(icp, ops, levels, dev)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
