#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supereight_tpu_torch``) on one NVIDIA
GPU.

1. Requires a CUDA device and prints its name and power limit, then builds
   every kernel from ``supereight_tpu_torch/csrc`` (one nvcc per source,
   all started together).
2. Holds the SDF fusion kernel against its plain PyTorch twin at main-path
   shapes (3072 rows of a real map, a 320x240 depth), with the median
   device time of each.
3. Holds the gather-probe kernels (K2 ``lane_shuffle_sum``, K3
   ``slab_row_sum``) against their twins at the probe's shapes, bit for
   bit, then runs the probe (``probes/gather_probe.py``), the kernels' own
   path, and prints its four measurements.
4. Runs the headline SLAM configuration (SDF, 256^3 over 4.8 m, 320x240,
   ICP pyramid (10,5,4), capacity 6144, fusion budget 3072) on the 96
   cached frames of ``bench_data/synthetic_256_frames.npz`` and checks
   tracked frames, ATE, blocks and overflow against the JAX package's
   record, and that the frame went through the kernel.
5. Holds the OFusion fusion kernel against its twin on 3072 rows of a real
   OFusion map.
6. Runs the ``ofusion`` preset (OFusion, mu 0.05, integration every 4th
   frame, held read view; 256^3, capacity 6144) on the same frames with the
   same kinds of checks against its JAX record.

Run from the repository root:  python3 chip_smoke.py
It exits non-zero, printing no result line, if there is no CUDA device or
any check fails.  The last line of its output is one JSON object; the line
before it lists every kernel with its launches on its main path, its
largest difference from its twin and the median device times of both.
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

# the JAX package's records of the two runs
# (bench_data/ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_gd2.json,
#  bench_data/ate_icp_ofusion_256_hybrid_id2_ib3072_ss1_iv_nr_z4.json)
JAX_RECORD = dict(tracked=92, ate_cm=1.85, blocks=3049, overflow=0)
OF_RECORD = dict(tracked=92, ate_cm=2.21, blocks=3852, overflow=0)
MIN_TRACKED = 88
MAX_ATE_M = 0.030        # headline: its record + ~1.1 cm of knob chaos
OF_MAX_ATE_M = 0.033     # ofusion: the same margin over its record
KERNEL_ATOL = 1e-5       # tsdf/weight; visible must match exactly
OF_RTOL, OF_ATOL = 1e-5, 1e-6   # occupancy: the last bits of logf
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


def ofusion_config():
    """The ``ofusion`` preset (`supereight_tpu/config.py:307-313`) at the
    size of its record."""
    from supereight_tpu_torch.pipeline import SlamConfig
    return SlamConfig(volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
                      block_capacity=6144, field_type="ofusion", mu=0.05,
                      raycast_normals="hybrid", icp_finest_decimate=2,
                      integrate_budget=3072, raycast_scan_stride=1.0,
                      incremental_view=True, raycast_near_rescue=False,
                      integration_rate=4)


def times(fn, plain):
    """Median device times (ms) of a kernel call and of its twin."""
    from supereight_tpu_torch.probes.timing import device_times_ms
    return (statistics.median(device_times_ms(fn, TIMED_RUNS)),
            statistics.median(device_times_ms(plain, TIMED_RUNS)))


def build_kernels():
    """Every kernel source, one nvcc each, started together."""
    from supereight_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"# kernels built in {time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        lib_path = _build.library_path(name)
        print(f"#   {os.path.relpath(lib_path, HERE)}")
        log = lib_path.with_name(lib_path.name + ".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"#   ptxas: {line.strip()}")


def fusion_rows(torch, slam, depths, dev, frame):
    """3072 rows of the map of ``slam`` (its live blocks, repeated), frame
    ``frame``'s depth, T_cw and K, all on the card."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.pipeline import camera, preprocessing
    m = slam.state.map
    n = int(m.n_blocks)
    idx = torch.arange(3072, device=dev) % n
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[frame].astype(np.int32)).to(dev), (240, 320))
    return dict(n=n, bc=octree.block_coords_table(m)[idx].contiguous(),
                live=m.active[idx].contiguous(),
                rows={k: v[idx].contiguous() for k, v in m.voxels.items()},
                depth=depth,
                T_cw=torch.linalg.inv(slam.state.pose).contiguous(),
                K=camera.camera_matrix(torch.from_numpy(K).to(dev))
                .contiguous(), voxel_size=m.voxel_size)


def warm_map(cfg, depths, poses, dev, frames: int):
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    for f in range(frames):
        slam.step(depths[f], K, f)
    return slam


def check_fuse_sdf(torch, depths, poses, dev):
    """SDF kernel vs twin on 3072 rows of the map after the first frames."""
    from supereight_tpu_torch.ops import integrate_kernel as ik

    slam = warm_map(headline_config(), depths, poses, dev, 6)
    r = fusion_rows(torch, slam, depths, dev, 6)
    field = slam.field
    args = (r["bc"], r["live"], r["rows"]["tsdf"], r["rows"]["weight"],
            r["depth"], r["T_cw"], r["K"], field.mu, field.max_weight,
            r["voxel_size"], ik.PATCH)

    out = ik.fuse_sdf(*args)
    ref = ik.fuse_sdf_reference(*args)
    torch.cuda.synchronize()
    vis_mismatch = int((out[2] != ref[2]).sum())
    t_mismatch = int((out[0] != ref[0]).sum())
    w_mismatch = int((out[1] != ref[1]).sum())
    max_err = max(float((out[0] - ref[0]).abs().max()),
                  float((out[1] - ref[1]).abs().max()))
    fused = int((out[1] != args[3]).sum())
    print(f"# fuse_sdf vs twin, 3072 rows of a {r['n']}-block map, "
          f"320x240 depth: {fused} voxels fused, {int(out[2].sum())} rows "
          f"visible; mismatches visible {vis_mismatch}, tsdf {t_mismatch}, "
          f"weight {w_mismatch}; max abs err {max_err:.3g}")
    if fused == 0:
        fail("the fuse_sdf comparison fused no voxel")
    if vis_mismatch or max_err > KERNEL_ATOL:
        fail(f"fuse_sdf and twin disagree (visible {vis_mismatch}, max abs "
             f"err {max_err} > {KERNEL_ATOL})")
    ms, plain_ms = times(lambda: ik.fuse_sdf(*args),
                         lambda: ik.fuse_sdf_reference(*args))
    print(f"# fuse_sdf median device time over {TIMED_RUNS} runs: kernel "
          f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return dict(name="fuse_sdf", route="cuda",
                source="supereight_tpu_torch/csrc/integrate.cu",
                replaces="supereight_tpu/ops/integrate_kernel.py:38",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def check_fuse_ofusion(torch, depths, poses, dev):
    """OFusion kernel vs twin on 3072 rows of the ofusion map after its
    first 8 frames, fused with frame 8: visible and timestamp exact,
    occupancy within OF_RTOL relative (OF_ATOL absolute)."""
    from supereight_tpu_torch.ops import integrate_kernel as ik

    slam = warm_map(ofusion_config(), depths, poses, dev, 8)
    r = fusion_rows(torch, slam, depths, dev, 8)
    field = slam.field
    now = float(np.float32(1.0 / 30.0) * np.float32(8))
    args = (r["bc"], r["live"], r["rows"]["occupancy"],
            r["rows"]["timestamp"], r["depth"], r["T_cw"], r["K"], field.mu,
            field.sigma_lo, now, r["voxel_size"], ik.PATCH)

    out = ik.fuse_ofusion(*args)
    ref = ik.fuse_ofusion_reference(*args)
    torch.cuda.synchronize()
    vis_mismatch = int((out[2] != ref[2]).sum())
    ts_mismatch = int((out[1] != ref[1]).sum())
    occ_mismatch = int((out[0] != ref[0]).sum())
    err = (out[0] - ref[0]).abs()
    max_err = float(err.max())
    beyond = int((err > OF_ATOL + OF_RTOL * ref[0].abs()).sum())
    fused = int((out[1] == now).sum())
    print(f"# fuse_ofusion vs twin, 3072 rows of a {r['n']}-block map, "
          f"320x240 depth: {fused} voxels fused, {int(out[2].sum())} rows "
          f"visible; mismatches visible {vis_mismatch}, timestamp "
          f"{ts_mismatch}, occupancy {occ_mismatch} ({beyond} beyond the "
          f"tolerance); max abs err {max_err:.3g}")
    if fused == 0:
        fail("the fuse_ofusion comparison fused no voxel")
    if vis_mismatch or ts_mismatch or beyond:
        fail(f"fuse_ofusion and twin disagree (visible {vis_mismatch}, "
             f"timestamp {ts_mismatch}, occupancy beyond the tolerance "
             f"{beyond})")
    ms, plain_ms = times(lambda: ik.fuse_ofusion(*args),
                         lambda: ik.fuse_ofusion_reference(*args))
    print(f"# fuse_ofusion median device time over {TIMED_RUNS} runs: "
          f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms")
    return dict(name="fuse_ofusion", route="cuda",
                source="supereight_tpu_torch/csrc/integrate.cu",
                replaces="supereight_tpu/pipeline/integration.py:396",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def check_probe_kernels(torch, dev):
    """K2 and K3 vs their twins at the probe's shapes (bit for bit), then
    the probe itself, the kernels' main path, with their counts set to 0
    just before it."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.probes import gather_probe as probe

    d = probe.make_data()
    src = torch.from_numpy(d["src"]).to(dev)
    idx = probe.shuffle_inputs(d, 1, dev)[0]
    table = probe.table16(d, dev)
    rows = probe.rows_inputs(d, 1, dev)[0]
    cases = (
        ("lane_shuffle_sum", "scripts/pallas_gather_probe.py:105",
         lambda: gp.lane_shuffle_sum(src, idx, probe.KREP),
         lambda: gp.lane_shuffle_sum_reference(src, idx, probe.KREP)),
        ("slab_row_sum", "scripts/pallas_gather_probe.py:146",
         lambda: gp.slab_row_sum(rows, table),
         lambda: gp.slab_row_sum_reference(rows, table)),
    )
    kernels = {}
    for name, replaces, fn, plain in cases:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        mismatch = int((out != ref).sum())
        max_err = float((out - ref).abs().max())
        print(f"# {name} vs twin at {tuple(out.shape)}: {mismatch} of "
              f"{out.numel()} differ, max abs err {max_err:.3g}")
        if mismatch:
            fail(f"{name} and its twin are not bit-identical")
        ms, plain_ms = times(fn, plain)
        print(f"# {name} median device time over {TIMED_RUNS} runs: kernel "
              f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms")
        kernels[name] = dict(
            name=name, route="cuda",
            source="supereight_tpu_torch/csrc/gather_probe.cu",
            replaces=replaces, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)

    for k in gp.LAUNCHES:
        gp.LAUNCHES[k] = 0
    res = probe.measure(dev)
    for name, kernel in kernels.items():
        kernel["launches"] = gp.LAUNCHES[name]
        if kernel["launches"] == 0:
            fail(f"the probe did not launch {name}")
    for name, m in res.items():
        print(f"# probe {name}: {m['ms']:.4f} ms, {m['ns_per_elem']:.4f} "
              "ns/elem")
    return kernels


def run_slam(torch, cfg, depths, poses, dev, counter: str):
    """A main path: every cached frame through DenseSLAMSystem.step, with
    the fusion kernels' counts set to 0 just before; returns the run, with
    ``counter``'s count read just after."""
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    est, tracked, integrated, ms = [], [], [], []
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    for f in range(len(depths)):
        t1 = time.perf_counter()
        st = slam.step(depths[f], K, f)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        est.append(st.pose.cpu().numpy())
        tracked.append(st.tracked)
        integrated.append(st.integrated)
    launches = ik.LAUNCHES[counter]
    st = slam.state
    return dict(est=np.stack(est), tracked=sum(tracked),
                integrated=sum(integrated), ms=ms, launches=launches,
                wall=time.perf_counter() - t0,
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
                ref_vertex=st.ref_vertex, ref_normal=st.ref_normal)


def check_run(torch, name, r, poses, record, max_ate, counter):
    """Print a run beside its JAX record and apply the gates."""
    n = len(r["est"])
    ate = ate_rmse(r["est"][:, :3, 3], poses[:n, :3, 3])
    print(f"# {name}, {n} frames in {r['wall']:.1f} s: tracked "
          f"{r['tracked']}/{n} (JAX {record['tracked']}/96), ATE "
          f"{100 * ate:.2f} cm (JAX {record['ate_cm']} cm), blocks "
          f"{r['blocks']} (JAX {record['blocks']}), overflow "
          f"{r['overflow']} (JAX {record['overflow']})")
    print(f"# {name}: {counter} LAUNCHES {r['launches']} over "
          f"{r['integrated']} integrated frames")
    print(f"# {name}: median ms/frame after the first 16 frames: "
          f"{statistics.median(r['ms'][16:]):.2f} (first frame "
          f"{r['ms'][0]:.1f} ms)")

    hit = r["ref_vertex"].abs().sum(-1) > 0
    if r["ref_vertex"].shape != (240, 320, 3) or \
            not bool(torch.isfinite(r["ref_vertex"]).all()) or \
            not bool(torch.isfinite(r["ref_normal"]).all()):
        fail(f"{name}: reference maps are not finite [240, 320, 3] maps")
    if float(hit.float().mean()) < 0.5:
        fail(f"{name}: the last raycast hit only "
             f"{float(hit.float().mean()):.2f} of the pixels")
    if not np.isfinite(r["est"]).all():
        fail(f"{name}: non-finite pose")
    if r["integrated"] == 0 or r["launches"] < r["integrated"]:
        fail(f"{name}: {counter} LAUNCHES {r['launches']} < "
             f"{r['integrated']} integrated frames: the main path did not "
             "go through the kernel")
    if r["tracked"] < MIN_TRACKED:
        fail(f"{name}: tracked {r['tracked']} < {MIN_TRACKED}")
    if r["overflow"] != 0:
        fail(f"{name}: overflow {r['overflow']} != 0")
    if ate > max_ate:
        fail(f"{name}: ATE {100 * ate:.2f} cm > {100 * max_ate:.1f} cm")


def print_stage_times(name, cfg, depths, poses, dev):
    """Median host time per stage (device synchronised after each) over
    the frames after the first 16, from a second run with step_staged."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    rows = []
    for f in range(len(depths)):
        _, stage_s = slam.step_staged(depths[f], K, f)
        if f >= 16:
            rows.append(stage_s)
    print(f"# {name}: median ms per stage after the first 16 frames "
          "(step_staged): " + ", ".join(
              f"{k} {1e3 * statistics.median(r[k] for r in rows):.2f}"
              for k in rows[0]))


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

    build_kernels()
    kernels = {"fuse_sdf": check_fuse_sdf(torch, depths, poses, dev)}
    kernels.update(check_probe_kernels(torch, dev))

    r = run_slam(torch, headline_config(), depths, poses, dev, "fuse_sdf")
    kernels["fuse_sdf"]["launches"] = r["launches"]
    check_run(torch, "headline", r, poses, JAX_RECORD, MAX_ATE_M, "fuse_sdf")
    print_stage_times("headline", headline_config(), depths, poses, dev)

    kernels["fuse_ofusion"] = check_fuse_ofusion(torch, depths, poses, dev)
    r = run_slam(torch, ofusion_config(), depths, poses, dev, "fuse_ofusion")
    kernels["fuse_ofusion"]["launches"] = r["launches"]
    check_run(torch, "ofusion", r, poses, OF_RECORD, OF_MAX_ATE_M,
              "fuse_ofusion")
    print_stage_times("ofusion", ofusion_config(), depths, poses, dev)

    order = ("fuse_sdf", "fuse_ofusion", "lane_shuffle_sum", "slab_row_sum")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
