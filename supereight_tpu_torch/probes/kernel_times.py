"""Device times of the gather-probe kernels K2 and K3 at the probe's shapes
and at their second shapes, for the package at a given checkout root.

Run on a CUDA device from the root of this checkout, once for each checkout
to compare, in turns within one machine (for example the parent, this one,
this one, the parent):

    python -m supereight_tpu_torch.probes.kernel_times --root DIR

``DIR`` is the root of a checkout whose ``supereight_tpu_torch`` is timed
(built from its own sources).  The inputs are always this checkout's
(`gather_probe.kernel_inputs`, the data ``chip_smoke.py`` holds the kernels
on), made before the other checkout's package is imported in place of this
one; of that package only the wrappers' call signature is assumed, which
has not changed since the kernels were ported.  It prints one JSON object:
the card's name and power limit, and the median device time (ms, CUDA
events, 25 runs) of ``lane_shuffle_sum`` at 256 and 65536 rows (krep 64)
and ``slab_row_sum`` at 2048 and 8192 slabs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

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
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
