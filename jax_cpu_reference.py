#!/usr/bin/env python3
"""The JAX package's figures on the CPU that ``chip_smoke.py`` holds the
PyTorch port to (its ``JAX_CPU`` and ``JAX_CPU_APP`` tables).

The JAX records in ``bench_data/`` were taken on a TPU, whose rounding the
CPU does not share; this script runs the same configurations through the
JAX package on the CPU and prints one JSON object:

- ``presets``: each preset of ``chip_smoke.RUNS`` through the JAX
  ``DenseSLAMSystem.step`` over its cached sequence from
  ``setPose(poses[0])``: tracked frames, ATE (cm), blocks, overflow;
- ``app``: ``supereight_tpu.apps.benchmark`` on the cached base sequence
  (written as .raw + TUM trajectory) with ``chip_smoke.APP_ARGS``, in
  ground-truth mode (``-g``) and in ICP mode (``-p 0.5,0.5,0.23``);
- ``facade_gt``: ``step(gt_pose=)`` at the configuration of
  ``bench_data/ate_icp_256_gt.json`` (SDF, volume normals, every frame,
  no budget, capacity 6144);
- ``runner``: ``supereight_tpu.apps.runner.run("synthetic-room",
  resolution=256)``.

Run from the repository root (JAX on the CPU; 1024-quality takes minutes):
    JAX_PLATFORMS=cpu python3 jax_cpu_reference.py [--parts app,runner]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("presets", "app", "facade_gt", "runner")


def _ate_cm(est, gt) -> float:
    from supereight_tpu.apps import evaluate
    return 100 * evaluate.ate(list(est), list(gt))["rmse"]


def presets():
    import chip_smoke
    from supereight_tpu.config import Configuration, apply_preset
    from supereight_tpu.pipeline import DenseSLAMSystem
    out = {}
    for name, (sequence, _, _) in chip_smoke.RUNS.items():
        depths, poses = chip_smoke.load_sequence(sequence)
        cfg = apply_preset(name, Configuration(**chip_smoke.BASE))
        slam = DenseSLAMSystem((240, 320), cfg)
        slam.setPose(poses[0])
        est, tracked = [], 0
        for f in range(len(depths)):
            st = slam.step(depths[f], chip_smoke.K, f)
            est.append(np.asarray(st.pose))
            tracked += bool(st.tracked)
        out[name] = dict(tracked=tracked, ate_cm=_ate_cm(est, poses),
                         blocks=int(st.map.n_blocks),
                         overflow=int(st.map.overflow))
        print(f"# {name}: {out[name]}", file=sys.stderr, flush=True)
    return out


def app():
    import chip_smoke
    from supereight_tpu.apps import benchmark
    from supereight_tpu.io import groundtruth, raw
    from supereight_tpu.pipeline import system
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rawp, gtp = os.path.join(tmp, "seq.raw"), os.path.join(tmp, "seq.gt")
        w = raw.RawWriter(rawp, 320, 240)
        for d in depths:
            w.write(d)
        w.close()
        groundtruth.write_poses(gtp, poses)
        made = []
        cls = system.DenseSLAMSystem

        class Kept(cls):              # keeps the app's system for its map
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        benchmark.DenseSLAMSystem = Kept
        try:
            for mode, extra in (("gt", ["-c", "0", "-g", gtp]),
                                ("icp", chip_smoke.APP_ICP_START)):
                log = os.path.join(tmp, mode + ".tsv")
                est = benchmark.main(["-i", rawp] + chip_smoke.APP_ARGS
                                     + extra + ["-q", "-o", log])
                rows = np.loadtxt(log, skiprows=1, ndmin=2)
                m = made[-1].state.map
                out[mode] = dict(rows=len(rows),
                                 tracked=int(rows[:, 12].sum()),
                                 integrated=int(rows[:, 13].sum()),
                                 ate_cm=_ate_cm(est, poses[:len(est)]),
                                 blocks=int(m.n_blocks),
                                 overflow=int(m.overflow))
                print(f"# app {mode}: {out[mode]}", file=sys.stderr,
                      flush=True)
        finally:
            benchmark.DenseSLAMSystem = cls
    return out


def facade_gt():
    import chip_smoke
    from supereight_tpu.config import Configuration
    from supereight_tpu.pipeline import DenseSLAMSystem
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    slam = DenseSLAMSystem((240, 320), Configuration(
        **chip_smoke.BASE, integration_rate=1))
    slam.setPose(poses[0])
    for f in range(len(depths)):
        st = slam.step(depths[f], chip_smoke.K, f, gt_pose=poses[f])
    return dict(blocks=int(st.map.n_blocks), overflow=int(st.map.overflow))


def runner():
    from supereight_tpu.apps import runner as jr
    with tempfile.TemporaryDirectory() as tmp:
        res = jr.run("synthetic-room", resolution=256, out=tmp)
    return {k: res[k] for k in ("frames", "ate_rmse_m", "tracked_ratio",
                                "rpe_trans_rmse_m", "rpe_rot_rmse_deg")} \
        | {"auto_regime": res.get("auto_regime")}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ",".join(PARTS))
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    out = {}
    for part in args.parts.split(","):
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}")
        out[part] = globals()[part]()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
