"""Evaluation harness: run pipelines over datasets, report ATE/RPE + timing
(counterpart of `supereight_tpu/apps/runner.py`, on the card unless
``--device`` names another device).

Reference: `se_apps/scripts/run_kf.py` + `_run.py` (SLAMAlgorithm /
KinectFusion: generate run command, parse the TSV log, Horn-align and report
ATE) and `datasets.py` (dataset registry).

Datasets resolve in order: an on-disk path (ICL-NUIM/TUM converted with
tools/scene2raw), else the synthetic analytic room (zero-egress fallback).

Usage:
    python -m supereight_tpu_torch.apps.runner --dataset synthetic-room \
        --field sdf -v 256 --frames 120
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from supereight_tpu_torch.apps import benchmark, evaluate
from supereight_tpu_torch.io import groundtruth, synthetic

#: dataset registry (reference `se_apps/scripts/datasets.py`).  Paths are
#: relative to $SE_DATASETS (default ./datasets).  ``scene_dir`` (ICL-NUIM
#: text depth) and ``tum_dir`` (TUM rgbd directory) sources are converted
#: on demand with tools/scene2raw / tools/tum2raw when the .raw is absent.
DATASETS = {
    "synthetic-room": {
        "synthetic": True, "n_frames": 120, "hw": (240, 320),
        "volume": 4.8, "init_pose": "0.5,0.5,0.23",
    },
    # real-sensor-noise ATE as a tracked number (TUM/Kinect noise model +
    # the bilateral filter path, reference -F flag)
    "synthetic-room-noise": {
        "synthetic": True, "noise": True, "n_frames": 120, "hw": (240, 320),
        "volume": 4.8, "init_pose": "0.5,0.5,0.23",
        "extra_args": ("-F",),
    },
    "icl-lr-traj0": {
        "raw": "living_room_traj0_loop.raw",
        "gt": "livingRoom0.gt.freiburg",
        "scene_dir": "living_room_traj0_loop",
        "camera": "481.2,-480,320,240", "volume": 4.8,
        "init_pose": "0.34,0.5,0.24",
    },
    "icl-lr-traj2": {
        "raw": "living_room_traj2_loop.raw",
        "gt": "livingRoom2.gt.freiburg",
        "scene_dir": "living_room_traj2_loop",
        "camera": "481.2,-480,320,240", "volume": 4.8,
        "init_pose": "0.34,0.5,0.24",
    },
    "tum-fr1-desk": {
        "raw": "rgbd_dataset_freiburg1_desk.raw",
        "gt": "rgbd_dataset_freiburg1_desk.gt",
        "tum_dir": "rgbd_dataset_freiburg1_desk",
        "camera": "517.3,516.5,318.6,255.3", "volume": 4.8,
        "init_pose": "0.5,0.5,0.5",
    },
    "tum-fr2-xyz": {
        "raw": "rgbd_dataset_freiburg2_xyz.raw",
        "gt": "rgbd_dataset_freiburg2_xyz.gt",
        "tum_dir": "rgbd_dataset_freiburg2_xyz",
        "camera": "520.9,521.0,325.1,249.7", "volume": 4.8,
        "init_pose": "0.5,0.5,0.5",
    },
}


def datasets_root() -> str:
    return os.environ.get("SE_DATASETS", "datasets")


def prepare_dataset(name: str, spec: dict, frames: int, workdir: str,
                    device="cuda"):
    """Returns (raw_path, gt_path, camera_str).  Converts on-disk ICL/TUM
    source directories to .raw on first use (`se_apps/scripts/_run.py`
    drives pre-converted files; here conversion is part of preparation).
    A synthetic sequence is rendered on ``device``."""
    if spec.get("synthetic"):
        H, W = spec["hw"]
        prefix = os.path.join(workdir, name)
        n = frames or spec["n_frames"]
        rawp, gtp, k = synthetic.write_dataset(
            prefix, n, H=H, W=W, room_dim=spec["volume"],
            noise=spec.get("noise", False), device=device)
        return rawp, gtp, ",".join(str(float(v)) for v in k)

    root = datasets_root()
    rawp = os.path.join(root, spec["raw"])
    gtp = os.path.join(root, spec["gt"])
    if not os.path.exists(rawp):
        scene_dir = spec.get("scene_dir") and os.path.join(
            root, spec["scene_dir"])
        tum_dir = spec.get("tum_dir") and os.path.join(root, spec["tum_dir"])
        if scene_dir and os.path.isdir(scene_dir):
            from supereight_tpu_torch.tools import scene2raw
            n = scene2raw.convert(scene_dir, rawp)
            print(f"# scene2raw: converted {n} frames -> {rawp}",
                  file=sys.stderr)
        elif tum_dir and os.path.isdir(tum_dir):
            from supereight_tpu_torch.tools import tum2raw
            prefix = rawp[:-4]
            n = tum2raw.convert(tum_dir, prefix)
            gtp = prefix + ".gt"
            print(f"# tum2raw: converted {n} frames -> {rawp}",
                  file=sys.stderr)
        else:
            raise FileNotFoundError(
                f"{rawp} not found and no source directory "
                f"({spec.get('scene_dir') or spec.get('tum_dir')}) under "
                f"$SE_DATASETS={root} — place the dataset there or use "
                f"--dataset synthetic-room")
    return rawp, gtp, spec["camera"]


def classify_motion(poses):
    """Per-frame motion statistics of a trajectory: (median rotation
    deg/frame, median translation m/frame).  The regime signal for the
    dispatcher — rotation-rich orbits and pure dollies separate cleanly
    (bench orbit ~3.7 deg, translation dolly ~0 deg)."""
    rots, trs = [], []
    for a, b in zip(poses[:-1], poses[1:]):
        d = np.linalg.inv(np.asarray(a)) @ np.asarray(b)
        c = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rots.append(np.degrees(np.arccos(c)))
        trs.append(np.linalg.norm(d[:3, 3]))
    if not rots:
        return 0.0, 0.0
    return float(np.median(rots)), float(np.median(trs))


#: auto_regime thresholds: translation-dominant = almost no rotation but
#: real translation (the 25 mm/frame dolly measures ~0 deg / 25 mm; the
#: bench orbit ~3.7 deg — an order of magnitude apart)
TRANS_ROT_MAX_DEG = 0.5
TRANS_MIN_M = 0.005
MISTRACK_RATIO = 0.8


def run(dataset: str, field: str = "sdf", resolution: int = 256,
        frames: int = 0, staged: bool = False, out: str = "",
        extra_args=(), scale_search: bool = False,
        auto_regime: bool = True, _rerun_preset: str = "",
        device="cuda"):
    """Runs the dataset's stream through the benchmark app on ``device``
    and reports ATE, RPE and timing.  ``auto_regime`` (motion-class
    dispatcher, no reference analog — its one config simply fails these
    regimes): after an SDF run, classify the ESTIMATED trajectory;
    translation-dominant motion or a low tracked ratio reruns the stream
    once on the occupancy quality stack the JAX package validated for the
    dolly (config.PRESETS["trans"]).  Sensor noise is dispatched up-front
    by the -F bilateral signal (apply_noise_regime)."""
    spec = DATASETS[dataset]
    workdir = out or tempfile.mkdtemp(prefix="se_run_")
    os.makedirs(workdir, exist_ok=True)
    rawp, gtp, camera = prepare_dataset(dataset, spec, frames, workdir,
                                        device)
    log_path = os.path.join(workdir, "benchmark.log")

    argv = ["-i", rawp, "-s", str(spec["volume"]), "-v", str(resolution),
            "-k", camera, "-o", log_path, "-q",
            "-p", spec.get("init_pose", "0.5,0.5,0"), "--device",
            str(device)]
    # explicit --field/-z would PIN those fields against preset or
    # noise-regime overrides, so: presets carry their own stack; noisy
    # streams (-F in the spec or caller args) must leave the -F
    # auto-regime free to select the noise stack unless the caller
    # explicitly chose a non-default field
    noisy = "-F" in spec.get("extra_args", ()) or "-F" in extra_args
    if _rerun_preset:
        argv += ["--preset", _rerun_preset]
    elif noisy and field == "sdf":
        pass                      # default field on a noisy stream:
                                  # let apply_noise_regime dispatch
    else:
        argv += ["--field", field, "-z", "1"]
    if frames:
        argv += ["--max-frames", str(frames)]
    if staged:
        argv += ["--staged"]
    argv += list(spec.get("extra_args", ()))
    argv += list(extra_args)

    t0 = time.perf_counter()
    est_poses = benchmark.main(argv)
    wall = time.perf_counter() - t0

    gt_poses = groundtruth.read_poses(gtp)
    n = min(len(est_poses), len(gt_poses))
    # optional golden-section trajectory-scale search before alignment
    # (the reference harness's `_run.py:366-380` path, for
    # scale-ambiguous trajectories; metric SLAM optima sit at ~1.0)
    if scale_search:
        ate = evaluate.ate_scale_search(est_poses[:n], gt_poses[:n])
    else:
        ate = evaluate.ate(est_poses[:n], gt_poses[:n])
    rpe = evaluate.rpe(est_poses[:n], gt_poses[:n])

    # timing means from the TSV log (`_run.py:179`)
    cols = {}
    with open(log_path) as f:
        header = f.readline().strip().split("\t")
        data = np.loadtxt(f, delimiter="\t")
    if data.ndim == 1:
        data = data[None]
    for i, name in enumerate(header):
        cols[name] = data[:, i]

    results = {
        "dataset": dataset, "field": field, "resolution": resolution,
        "frames": int(n), "wall_s": round(wall, 2),
        "fps": round(n / max(cols["computation"].sum(), 1e-9), 2),
        "ate_rmse_m": round(ate["rmse"], 5),
        "ate_mean_m": round(ate["mean"], 5),
        "rpe_trans_rmse_m": round(rpe["trans_rmse"], 5),
        "rpe_rot_rmse_deg": round(rpe["rot_rmse_deg"], 4),
        # skip warmup rows when the run is long enough to have them
        "mean_computation_s": round(float(
            cols["computation"][4 if len(cols["computation"]) > 4 else 0:]
            .mean()), 5),
        "tracked_ratio": round(float(cols["tracked"].mean()), 3),
    }
    if scale_search:
        results["ate_scale"] = round(ate["scale"], 4)

    # ---- motion-class dispatcher (auto_regime) ----
    rot_med, tr_med = classify_motion(est_poses[:n])
    results["median_rot_deg"] = round(rot_med, 3)
    results["median_trans_m"] = round(tr_med, 4)
    if auto_regime and not _rerun_preset and field == "sdf" and not noisy:
        trans_dom = rot_med < TRANS_ROT_MAX_DEG and tr_med > TRANS_MIN_M
        mistrack = results["tracked_ratio"] < MISTRACK_RATIO
        if trans_dom or mistrack:
            why = "translation-dominant" if trans_dom else "mistracking"
            print(f"# auto_regime: {why} (rot {rot_med:.2f} deg/frame, "
                  f"trans {tr_med*1000:.1f} mm/frame, tracked "
                  f"{results['tracked_ratio']:.2f}) -> rerun on the "
                  f"occupancy quality stack (preset 'trans')",
                  file=sys.stderr)
            rerun = run(dataset, field, resolution, frames, staged,
                        os.path.join(workdir, "regime_rerun"),
                        extra_args, scale_search,
                        auto_regime=False, _rerun_preset="trans",
                        device=device)
            rerun["auto_regime"] = why
            rerun["first_pass_ate_rmse_m"] = results["ate_rmse_m"]
            with open(os.path.join(workdir, "results.json"), "w") as f:
                json.dump(rerun, f, indent=2)
            return rerun

    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="synthetic-room",
                   choices=sorted(DATASETS))
    p.add_argument("--field", default="sdf", choices=("sdf", "ofusion"))
    p.add_argument("-v", "--resolution", type=int, default=256)
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--staged", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--ate-scale-search", action="store_true",
                   help="golden-section trajectory-scale search before "
                        "the Horn alignment (reference _run.py:366-380)")
    p.add_argument("--no-auto-regime", action="store_true",
                   help="disable the motion-class dispatcher (keep the "
                        "requested stack even on translation-dominant or "
                        "mistracking streams)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the renderer and the pipeline "
                        "(default: the card)")
    args = p.parse_args(argv)
    results = run(args.dataset, args.field, args.resolution, args.frames,
                  args.staged, args.out, scale_search=args.ate_scale_search,
                  auto_regime=not args.no_auto_regime, device=args.device)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
