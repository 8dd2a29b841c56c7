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
  resolution=256)``;
- ``mesh``: the app in ground-truth mode with ``--dump-mesh`` (phase E of
  the smoke): the triangles of the final map's mesh;
- ``phase_f``: each run of ``chip_smoke.F_RUNS`` (the ``headline`` preset
  with one knob group over it) as ``presets`` runs a preset;
- ``sharded``: each run of ``chip_smoke.G_RUNS`` through the JAX
  package's sharded frame (``parallel.frame_dist``) over a 2-device CPU
  mesh: tracked frames, ATE (cm), blocks, overflow, ``part_counts``.

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
PARTS = ("presets", "app", "facade_gt", "runner", "mesh", "phase_f",
         "sharded")


def _ate_cm(est, gt) -> float:
    from supereight_tpu.apps import evaluate
    return 100 * evaluate.ate(list(est), list(gt))["rmse"]


def _run(cfg, sequence):
    """The JAX system over a cached sequence from ``setPose(poses[0])``:
    tracked frames, ATE (cm), blocks, overflow."""
    import chip_smoke
    from supereight_tpu.pipeline import DenseSLAMSystem
    depths, poses = chip_smoke.load_sequence(sequence)
    slam = DenseSLAMSystem((240, 320), cfg)
    slam.setPose(poses[0])
    est, tracked = [], 0
    for f in range(len(depths)):
        st = slam.step(depths[f], chip_smoke.K, f)
        est.append(np.asarray(st.pose))
        tracked += bool(st.tracked)
    return dict(tracked=tracked, ate_cm=_ate_cm(est, poses),
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow))


def presets():
    import chip_smoke
    from supereight_tpu.config import Configuration, apply_preset
    out = {}
    for name, (sequence, _, _) in chip_smoke.RUNS.items():
        cfg = apply_preset(name, Configuration(**chip_smoke.BASE))
        out[name] = _run(cfg, sequence)
        print(f"# {name}: {out[name]}", file=sys.stderr, flush=True)
    return out


def phase_f():
    import dataclasses
    import chip_smoke
    from supereight_tpu.config import Configuration, apply_preset
    out = {}
    for name, (knobs, _) in chip_smoke.F_RUNS.items():
        cfg = dataclasses.replace(apply_preset(
            "headline", Configuration(**chip_smoke.BASE)), **knobs)
        out[name] = _run(cfg, "synthetic_256_frames")
        print(f"# {name}: {out[name]}", file=sys.stderr, flush=True)
    return out


def sharded():
    """Phase G's full-size runs through ``make_process_frame_sharded`` on
    a mesh of 2 CPU devices (``XLA_FLAGS`` set in :func:`main`)."""
    import functools
    import chip_smoke
    import jax
    import jax.numpy as jnp
    from supereight_tpu.config import Configuration, apply_preset
    from supereight_tpu.parallel import frame_dist, make_mesh
    from supereight_tpu.pipeline import DenseSLAMSystem
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.parallel.frame_dist import frame_knobs
    out = {}
    for name, (preset, ranks, max_visible, frames) in \
            chip_smoke.G_RUNS.items():
        if name == "G3":
            continue
        mesh = make_mesh(ranks)
        cfg = apply_preset(preset, Configuration(
            **chip_smoke.BASE, map_partitions=ranks))
        depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
        slam = DenseSLAMSystem((240, 320), cfg)
        slam.setPose(poses[0])
        st = frame_dist.frame_sharding(mesh)(slam.state)
        step = jax.jit(functools.partial(
            frame_dist.make_process_frame_sharded(
                mesh, slam.field, 240, 320,
                max_visible_per_device=max_visible,
                **frame_knobs(SlamConfig.of(cfg))),
            use_gt=False, neg_y=False))
        est, tracked = [], 0
        k = jnp.asarray(chip_smoke.K)
        eye = jnp.eye(4, dtype=jnp.float32)
        for f in range(frames):
            st = step(st, jnp.asarray(depths[f]), k,
                      jnp.asarray(f, jnp.int32), eye)
            est.append(np.asarray(st.pose))
            tracked += bool(st.tracked)
        out[name] = dict(tracked=tracked, ate_cm=_ate_cm(est, poses[:frames]),
                         blocks=int(st.map.n_blocks),
                         overflow=int(st.map.overflow),
                         part_counts=np.asarray(st.map.part_counts).tolist())
        print(f"# {name}: {out[name]}", file=sys.stderr, flush=True)
    return out


def _write_sequence(tmp):
    """The cached base sequence as ``seq.raw`` and ``seq.gt`` in ``tmp``,
    written with the JAX package's io; returns (paths, poses)."""
    import chip_smoke
    from supereight_tpu.io import groundtruth, raw
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    rawp, gtp = os.path.join(tmp, "seq.raw"), os.path.join(tmp, "seq.gt")
    w = raw.RawWriter(rawp, 320, 240)
    for d in depths:
        w.write(d)
    w.close()
    groundtruth.write_poses(gtp, poses)
    return (rawp, gtp), poses


def app():
    import chip_smoke
    from supereight_tpu.apps import benchmark
    from supereight_tpu.pipeline import system
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        (rawp, gtp), poses = _write_sequence(tmp)
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


def mesh():
    import chip_smoke
    from supereight_tpu.apps import benchmark
    with tempfile.TemporaryDirectory() as tmp:
        (rawp, gtp), _ = _write_sequence(tmp)
        path = os.path.join(tmp, "E.vtk")
        benchmark.main(["-i", rawp] + chip_smoke.APP_ARGS
                       + ["-c", "0", "-g", gtp, "-q", "--dump-mesh", path])
        with open(path) as f:
            polygons = next(ln for ln in f if ln.startswith("POLYGONS"))
    return dict(gt_triangles=int(polygons.split()[1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parts", default=",".join(PARTS),
                   help="comma-separated subset of " + ",".join(PARTS))
    args = p.parse_args(argv)
    if "sharded" in args.parts.split(","):
        # the sharded part's 2-device mesh: before JAX is imported
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=2")
    sys.path.insert(0, HERE)
    out = {}
    for part in args.parts.split(","):
        if part not in PARTS:
            raise SystemExit(f"unknown part {part!r}")
        out[part] = globals()[part]()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
