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
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

PKG = "supereight_tpu_torch"
#: the trip counts timed at each level
TRIPS = (1, 2, 4, 8, 16)


def slope(xs, ys) -> float:
    """The least-squares slope of ys over xs."""
    mx, my = statistics.fmean(xs), statistics.fmean(ys)
    return (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
            / sum((x - mx) ** 2 for x in xs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default=None)
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
    refs = (ops["ref_v"], ops["ref_n"], ops["view"])
    # the package under ``--root`` in place of this one
    for name in [m for m in sys.modules if m.split(".")[0] == PKG]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(args.root))
    from supereight_tpu_torch.ops import icp_kernel as icp

    med = lambda fn: statistics.median(device_times_ms(fn, 25))
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
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
