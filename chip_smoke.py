#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supereight_tpu_torch``) on one NVIDIA
GPU.

1. Requires a CUDA device and prints its name and power limit.
2. Builds the SDF fusion kernel from ``supereight_tpu_torch/csrc`` and
   holds it against its plain PyTorch twin at main-path shapes (3072 rows
   of a real map, a 320x240 depth), with the median device time of each.
3. Runs the headline SLAM configuration (SDF, 256^3 over 4.8 m, 320x240,
   ICP pyramid (10,5,4), capacity 6144, fusion budget 3072) on the 96
   cached frames of ``bench_data/synthetic_256_frames.npz`` and checks
   tracked frames, ATE, blocks and overflow against the JAX package's
   record, and that the frame went through the kernel.

Run from the repository root:  python3 chip_smoke.py
It exits non-zero, printing no result line, if there is no CUDA device or
any check fails.  The last line of its output is one JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES = os.path.join(HERE, "bench_data", "synthetic_256_frames.npz")
K = np.array([240.6, 240.0, 160.0, 120.0], np.float32)   # 320x240 frames

# the JAX package's record of this run
# (bench_data/ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_gd2.json)
JAX_RECORD = dict(tracked=92, ate_cm=1.85, blocks=3049, overflow=0)
MIN_TRACKED = 88
MAX_ATE_M = 0.030
KERNEL_ATOL = 1e-5       # tsdf/weight; visible must match exactly
TIMED_RUNS = 25


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the estimated positions after the least-squares rigid
    alignment to the ground truth (Horn), as
    supereight_tpu.apps.evaluate.ate computes it."""
    est = est.astype(np.float64).T
    gt = gt.astype(np.float64).T
    mc = est - est.mean(1, keepdims=True)
    dc = gt - gt.mean(1, keepdims=True)
    U, _, Vt = np.linalg.svd(mc @ dc.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    t = gt.mean(1, keepdims=True) - R @ est.mean(1, keepdims=True)
    err = np.linalg.norm(R @ est + t - gt, axis=0)
    return float(np.sqrt(np.mean(err ** 2)))


def headline_config():
    from supereight_tpu_torch.pipeline import SlamConfig
    return SlamConfig(volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
                      block_capacity=6144, integration_rate=1,
                      raycast_normals="hybrid", integrate_budget=3072,
                      icp_finest_decimate=2, raycast_scan_stride=1.0,
                      alloc_rate=3, raycast_adaptive_deg=3.8,
                      raycast_adaptive_dist=0.07, raycast_grad_decim=2)


def device_times_ms(torch, fn, runs: int):
    """Per-run device time of ``fn`` by CUDA events.  All runs are queued
    behind a sleeping kernel first, so host launch overhead does not show
    up as device idle time between the events."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def check_kernel(torch, depths, poses, dev):
    """Kernel vs twin on 3072 rows of the map after the first frames."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.ops import _build, integrate_kernel as ik
    from supereight_tpu_torch.pipeline import (DenseSLAMSystem, camera,
                                               preprocessing)

    t0 = time.perf_counter()
    lib_path = _build.library_path("integrate_sdf")
    _build.load("integrate_sdf")
    print(f"# kernel built in {time.perf_counter() - t0:.1f} s: "
          f"{os.path.relpath(lib_path, HERE)}")
    log = lib_path.with_name(lib_path.name + ".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   ptxas: {line.strip()}")

    slam = DenseSLAMSystem((240, 320), headline_config(), dev)
    slam.setPose(poses[0])
    for f in range(6):
        slam.step(depths[f], K, f)
    m = slam.state.map
    n = int(m.n_blocks)
    idx = torch.arange(3072, device=dev) % n
    bc = octree.block_coords_table(m)[idx].contiguous()
    live = m.active[idx].contiguous()
    tsdf = m.voxels["tsdf"][idx].contiguous()
    weight = m.voxels["weight"][idx].contiguous()
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[6].astype(np.int32)).to(dev), (240, 320))
    T_cw = torch.linalg.inv(slam.state.pose).contiguous()
    Km = camera.camera_matrix(torch.from_numpy(K).to(dev)).contiguous()
    field = slam.field
    args = (bc, live, tsdf, weight, depth, T_cw, Km, field.mu,
            field.max_weight, m.voxel_size, ik.PATCH)

    out = ik.fuse_sdf(*args)
    ref = ik.fuse_sdf_reference(*args)
    torch.cuda.synchronize()
    vis_mismatch = int((out[2] != ref[2]).sum())
    t_mismatch = int((out[0] != ref[0]).sum())
    w_mismatch = int((out[1] != ref[1]).sum())
    max_err = max(float((out[0] - ref[0]).abs().max()),
                  float((out[1] - ref[1]).abs().max()))
    fused = int((out[1] != weight).sum())
    print(f"# kernel vs twin, {bc.shape[0]} rows of a {n}-block map, "
          f"320x240 depth: {fused} voxels fused, {int(out[2].sum())} rows "
          f"visible; mismatches visible {vis_mismatch}, tsdf {t_mismatch}, "
          f"weight {w_mismatch}; max abs err {max_err:.3g}")
    if fused == 0:
        fail("the kernel comparison fused no voxel")
    if vis_mismatch or max_err > KERNEL_ATOL:
        fail(f"kernel and twin disagree (visible {vis_mismatch}, max abs "
             f"err {max_err} > {KERNEL_ATOL})")

    k_ms = device_times_ms(torch, lambda: ik.fuse_sdf(*args), TIMED_RUNS)
    p_ms = device_times_ms(torch, lambda: ik.fuse_sdf_reference(*args),
                           TIMED_RUNS)
    kernel = dict(name="fuse_sdf", route="cuda",
                  source="supereight_tpu_torch/csrc/integrate_sdf.cu",
                  replaces="supereight_tpu/ops/integrate_kernel.py:38",
                  max_abs_err=max_err, ms=statistics.median(k_ms),
                  plain_ms=statistics.median(p_ms))
    print(f"# fuse_sdf median device time over {TIMED_RUNS} runs: kernel "
          f"{kernel['ms']:.4f} ms, plain twin {kernel['plain_ms']:.4f} ms")
    return kernel


def run_headline(torch, depths, poses, dev):
    """The main path: every cached frame through DenseSLAMSystem.step."""
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    slam = DenseSLAMSystem((240, 320), headline_config(), dev)
    slam.setPose(poses[0])
    n = len(depths)
    est, tracked, integrated, ms = [], [], [], []
    ik.LAUNCHES = 0
    for f in range(n):
        t0 = time.perf_counter()
        st = slam.step(depths[f], K, f)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        est.append(st.pose.cpu().numpy())
        tracked.append(st.tracked)
        integrated.append(st.integrated)
    launches = ik.LAUNCHES
    st = slam.state
    return dict(est=np.stack(est), tracked=sum(tracked),
                integrated=sum(integrated), ms=ms, launches=launches,
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
                ref_vertex=st.ref_vertex, ref_normal=st.ref_normal)


def stage_times(torch, depths, poses, dev):
    """Median host time per stage (device synchronised after each) over
    the frames after the first 16, from a second run with step_staged."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), headline_config(), dev)
    slam.setPose(poses[0])
    rows = []
    for f in range(len(depths)):
        _, times = slam.step_staged(depths[f], K, f)
        if f >= 16:
            rows.append(times)
    return {k: 1e3 * statistics.median(r[k] for r in rows) for k in rows[0]}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    for need in (FRAMES, os.path.join(HERE, "supereight_tpu_torch")):
        if not os.path.exists(need):
            fail(f"{need} is missing: run from the root of a checkout")
    z = np.load(FRAMES)
    depths, poses = z["depths"], z["poses"]

    kernel = check_kernel(torch, depths, poses, dev)

    t0 = time.perf_counter()
    r = run_headline(torch, depths, poses, dev)
    wall = time.perf_counter() - t0
    n = len(depths)
    ate = ate_rmse(r["est"][:, :3, 3], poses[:n, :3, 3])
    steady = statistics.median(r["ms"][16:])
    kernel["launches"] = r["launches"]
    print(f"# headline, {n} frames in {wall:.1f} s: tracked "
          f"{r['tracked']}/{n} (JAX {JAX_RECORD['tracked']}/96), ATE "
          f"{100 * ate:.2f} cm (JAX {JAX_RECORD['ate_cm']} cm), blocks "
          f"{r['blocks']} (JAX {JAX_RECORD['blocks']}), overflow "
          f"{r['overflow']} (JAX {JAX_RECORD['overflow']})")
    print(f"# fuse_sdf LAUNCHES {r['launches']} over {r['integrated']} "
          f"integrated frames")
    print(f"# median ms/frame after the first 16 frames: {steady:.2f} "
          f"(first frame {r['ms'][0]:.1f} ms)")

    hit = r["ref_vertex"].abs().sum(-1) > 0
    if r["ref_vertex"].shape != (240, 320, 3) or \
            not bool(torch.isfinite(r["ref_vertex"]).all()) or \
            not bool(torch.isfinite(r["ref_normal"]).all()):
        fail("reference maps are not finite [240, 320, 3] maps")
    if float(hit.float().mean()) < 0.5:
        fail(f"the last raycast hit only {float(hit.float().mean()):.2f} "
             "of the pixels")
    if not np.isfinite(r["est"]).all():
        fail("non-finite pose")
    if r["launches"] < r["integrated"]:
        fail(f"LAUNCHES {r['launches']} < {r['integrated']} integrated "
             "frames: the main path did not go through the kernel")
    if r["tracked"] < MIN_TRACKED:
        fail(f"tracked {r['tracked']} < {MIN_TRACKED}")
    if r["overflow"] != 0:
        fail(f"overflow {r['overflow']} != 0")
    if ate > MAX_ATE_M:
        fail(f"ATE {100 * ate:.2f} cm > {100 * MAX_ATE_M:.1f} cm")

    stages = stage_times(torch, depths, poses, dev)
    print("# median ms per stage after the first 16 frames (step_staged): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
