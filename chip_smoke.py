#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supereight_tpu_torch``) on one NVIDIA
GPU.

1. Requires a CUDA device and prints its name and power limit, then builds
   every kernel from ``supereight_tpu_torch/csrc`` (one nvcc per source,
   all started together).
2. Holds the SDF and the OFusion fusion kernel against their plain
   PyTorch twins at main-path shapes (3072 rows of a real map, a 320x240
   depth), with the median device time of each.
3. Holds the gather-probe kernels (K2 ``lane_shuffle_sum``, K3
   ``slab_row_sum``) against their twins at the probe's shapes, bit for
   bit, then runs the probe (``probes/gather_probe.py``), the kernels' own
   path, and prints its four measurements.
4. Runs the nine presets of ``supereight_tpu_torch/config.py``
   (``headline``: SDF, 256^3 over 4.8 m, 320x240, capacity 6144, fusion
   budget 3072; ``ofusion``; then the seven others), each at the size of
   its JAX record over the 96 frames of its cached sequence in
   ``bench_data/``, and checks tracked frames, ATE, blocks and overflow
   against the record (the ATE gate is the record + ~1.1 cm, ~2 cm for
   ``noise``; overflow is gated only where the record's is 0), that the
   frames went through the kernel, and that ``headline`` and ``ofusion``
   repeat the earlier runs' counts.  After each run the fusion kernel is
   held against its twin on the operands the run's fusion takes (the whole
   table with its dead rows, or the budget's rows), the held SDF view of
   ``demo512-sdf`` against a full rebuild; each run prints its peak device
   memory.

Every preset is built with ``config.apply_preset``.  Each run prints its
wall time, the median ms per frame and the median of each stage (from a
second run through ``step_staged``).

Run from the repository root:  python3 chip_smoke.py
It exits non-zero, printing no result line, if there is no CUDA device or
any check fails.  The last line of its output is one JSON object; the line
before it lists every kernel with its launches summed over the runs that
took it, its largest difference from its twin and the median device times
of both at the 3072-row shapes.
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
BENCH_DATA = os.path.join(HERE, "bench_data")
FRAMES = os.path.join(BENCH_DATA, "synthetic_256_frames.npz")
K = np.array([240.6, 240.0, 160.0, 120.0], np.float32)   # 320x240 frames
#: the size every preset runs on unless it sets its own (its JAX record's)
BASE = dict(volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
            block_capacity=6144)

#: preset: (cached sequence, the JAX package's record in bench_data/, ATE
#: gate in m: the record + ~1.1 cm of knob chaos, ~2 cm for noise)
RUNS = {
    "headline": ("synthetic_256_frames",
                 "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_gd2.json",
                 0.030),
    "ofusion": ("synthetic_256_frames",
                "ate_icp_ofusion_256_hybrid_id2_ib3072_ss1_iv_nr_z4.json",
                0.033),
    "quality": ("synthetic_256_frames", "ate_icp_256_sy_nr.json", 0.026),
    "trans": ("synthetic_256_frames_trans",
              "ate_icp_ofusion_256_trans_nr_z4.json", 0.069),
    "noise": ("synthetic_256_frames_noisy",
              "ate_icp_ofusion_256_bf_noisy_nr_z4.json", 0.120),
    "demo512-sdf": ("synthetic_256_frames",
                    "ate_icp_512_hybrid_id2_ib24576_ss1_sy_gd2_iv_fr.json",
                    0.024),
    "demo512-ofusion": (
        "synthetic_256_frames",
        "ate_icp_ofusion_512_hybrid_id2_ib6144_ss1_aod0.01_iv_nr_z4.json",
        0.034),
    "ofusion-fidelity": ("synthetic_256_frames",
                         "ate_icp_ofusion_256_exact_pl_nr_z4_mu0.008.json",
                         0.026),
    "1024-quality": (
        "synthetic_256_frames",
        "ate_icp_ofusion_1024_id2_ib98304_ss1_aad16x0.3_iv_nr_z4.json",
        0.041),
}
#: the counts the earlier slice's runs gave on the card; the path is
#: deterministic, so they repeat exactly
REPEAT = {"headline": dict(tracked=92, ate_cm=0.97, blocks=2768, overflow=0),
          "ofusion": dict(tracked=92, ate_cm=0.99, blocks=3674, overflow=0)}
MIN_TRACKED = 88
#: least share of the last raycast's pixels that hit the map; ``noise``
#: fills its table (its record overflows by 1891 blocks), so surface past
#: the capacity is never allocated and cannot be hit
MIN_HIT = dict(noise=0.4)
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


def preset_config(name: str):
    """The named preset of the port's config on BASE."""
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    return apply_preset(name, SlamConfig(**BASE))


def load_sequence(name: str):
    z = np.load(os.path.join(BENCH_DATA, name + ".npz"))
    return z["depths"], z["poses"]


def load_record(file: str) -> dict:
    with open(os.path.join(BENCH_DATA, file)) as f:
        r = json.load(f)
    return dict(tracked=r["tracked_frames"], ate_cm=100 * r["ate_rmse_m"],
                blocks=r["blocks"], overflow=r["overflow"])


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

    slam = warm_map(preset_config("headline"), depths, poses, dev, 6)
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
                launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def check_fuse_ofusion(torch, depths, poses, dev):
    """OFusion kernel vs twin on 3072 rows of the ofusion map after its
    first 8 frames, fused with frame 8: visible and timestamp exact,
    occupancy within OF_RTOL relative (OF_ATOL absolute)."""
    from supereight_tpu_torch.ops import integrate_kernel as ik

    slam = warm_map(preset_config("ofusion"), depths, poses, dev, 8)
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
                launches=0, max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


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


def run_slam(torch, cfg, depths, poses, dev):
    """A main path: every cached frame through DenseSLAMSystem.step, with
    the fusion kernels' counts set to 0 just before and read just after."""
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
    launches = dict(ik.LAUNCHES)
    st = slam.state
    return dict(slam=slam, est=np.stack(est), tracked=sum(tracked),
                integrated=sum(integrated), ms=ms, launches=launches,
                wall=time.perf_counter() - t0,
                blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
                ref_vertex=st.ref_vertex, ref_normal=st.ref_normal)


def check_run(torch, name, r, poses, record, max_ate, counter):
    """Print a run beside its JAX record and apply the gates."""
    n = len(r["est"])
    ate = ate_rmse(r["est"][:, :3, 3], poses[:n, :3, 3])
    launches = r["launches"][counter]
    print(f"# {name}, {n} frames in {r['wall']:.1f} s: tracked "
          f"{r['tracked']}/{n} (JAX {record['tracked']}/96), ATE "
          f"{100 * ate:.2f} cm (JAX {record['ate_cm']:.2f} cm, gate "
          f"{100 * max_ate:.1f}), blocks {r['blocks']} (JAX "
          f"{record['blocks']}), overflow {r['overflow']} (JAX "
          f"{record['overflow']})")
    print(f"# {name}: {counter} LAUNCHES {launches} over "
          f"{r['integrated']} integrated frames")
    print(f"# {name}: median ms/frame after the first 16 frames: "
          f"{statistics.median(r['ms'][16:]):.2f} (first frame "
          f"{r['ms'][0]:.1f} ms)")

    hit = r["ref_vertex"].abs().sum(-1) > 0
    if r["ref_vertex"].shape != (240, 320, 3) or \
            not bool(torch.isfinite(r["ref_vertex"]).all()) or \
            not bool(torch.isfinite(r["ref_normal"]).all()):
        fail(f"{name}: reference maps are not finite [240, 320, 3] maps")
    hit_share = float(hit.float().mean())
    print(f"# {name}: the last raycast hit {hit_share:.3f} of the pixels")
    if hit_share < MIN_HIT.get(name, 0.5):
        fail(f"{name}: the last raycast hit only {hit_share:.3f} of the "
             "pixels")
    if not np.isfinite(r["est"]).all():
        fail(f"{name}: non-finite pose")
    if r["integrated"] == 0 or launches < r["integrated"]:
        fail(f"{name}: {counter} LAUNCHES {launches} < "
             f"{r['integrated']} integrated frames: the main path did not "
             "go through the kernel")
    if r["tracked"] < MIN_TRACKED:
        fail(f"{name}: tracked {r['tracked']} < {MIN_TRACKED}")
    if record["overflow"] == 0 and r["overflow"] != 0:
        fail(f"{name}: overflow {r['overflow']} != 0")
    if ate > max_ate:
        fail(f"{name}: ATE {100 * ate:.2f} cm > {100 * max_ate:.1f} cm")
    want = REPEAT.get(name)
    if want is not None:
        got = dict(tracked=r["tracked"], ate_cm=round(100 * ate, 2),
                   blocks=r["blocks"], overflow=r["overflow"])
        if got != want:
            fail(f"{name}: {got} does not repeat the earlier runs' {want}")
        print(f"# {name}: repeats the earlier runs' counts {want}")


def check_path_kernel(torch, name, slam, cfg):
    """The run's fusion kernel against its twin on the operands its fusion
    takes at the last frame (`integration.fusion_operands`): the whole
    table with its dead rows when the budget is 0 or the capacity, else the
    budget's rows (the frustum candidates, repeated up to the budget).
    Dead rows must come back unchanged.  Returns (kernel, max abs err)."""
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.pipeline import camera, integration

    st, field = slam.state, slam.field
    m = st.map
    depth = st.scaled_depth if cfg.fuse_filtered else st.float_depth
    T_cw = torch.linalg.inv(st.pose).contiguous()
    Km = camera.camera_matrix(torch.from_numpy(K).to(depth.device))
    sel, bc, live, rows, _ = integration.fusion_operands(
        m, T_cw, Km, depth.shape, cfg.integrate_budget)
    if sel is not None:
        idx = sel[torch.arange(cfg.integrate_budget, device=sel.device)
                  % sel.numel()]
        bc = octree.block_coords_table(m)[idx].contiguous()
        live = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
        rows = {k: v[idx].contiguous() for k, v in m.voxels.items()}
    now = float(np.float32(1.0 / 30.0) * np.float32(95))
    if field.name == "ofusion":
        kernel, names = "fuse_ofusion", ("occupancy", "timestamp")
        params = (field.mu, field.sigma_lo, now)
    else:
        kernel, names = "fuse_sdf", ("tsdf", "weight")
        params = (field.mu, field.max_weight)
    args = (bc, live, rows[names[0]], rows[names[1]], depth, T_cw, Km,
            *params, m.voxel_size, ik.PATCH)
    fn = getattr(ik, kernel)
    plain = getattr(ik, kernel + "_reference")
    out, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    dead = ~live
    n_dead = int(dead.sum())
    dead_changed = sum(int((o[dead] != a[dead]).sum())
                       for o, a in zip(out[:2], args[2:4]))
    vis_mismatch = int((out[2] != ref[2]).sum())
    err = [(o - r).abs() for o, r in zip(out[:2], ref[:2])]
    max_err = max(float(e.max()) for e in err)
    if kernel == "fuse_ofusion":
        # occupancy within tolerance, timestamp exact
        beyond = int((err[0] > OF_ATOL + OF_RTOL * ref[0].abs()).sum()) \
            + int((err[1] != 0).sum())
        fused = int((out[1] == now).sum())
    else:
        beyond = sum(int((e > KERNEL_ATOL).sum()) for e in err)
        fused = int((out[1] != args[3]).sum())
    branch = "all rows" if sel is None else \
        f"budget rows ({sel.numel()} candidates)"
    print(f"# {name}: {kernel} vs twin on {bc.shape[0]} rows, {branch}, "
          f"{n_dead} dead: {fused} voxels fused, {int(out[2].sum())} rows "
          f"visible; mismatches visible {vis_mismatch}, {names[0]} "
          f"{int((out[0] != ref[0]).sum())}, {names[1]} "
          f"{int((out[1] != ref[1]).sum())} ({beyond} beyond the "
          f"tolerance); dead rows changed {dead_changed}; max abs err "
          f"{max_err:.3g}")
    if fused == 0:
        fail(f"{name}: the {kernel} comparison fused no voxel")
    if vis_mismatch or beyond or dead_changed:
        fail(f"{name}: {kernel} and twin disagree")
    ms, plain_ms = times(lambda: fn(*args), lambda: plain(*args))
    print(f"# {name}: {kernel} median device time at {bc.shape[0]} rows "
          f"over {TIMED_RUNS} runs: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms")
    return kernel, max_err


def check_held_view(torch, name, slam):
    """The held SDF view against a full ``pack_view`` of the same map, bit
    for bit."""
    from supereight_tpu_torch.pipeline import raycast
    view = slam.state.view
    rebuilt = raycast.pack_view(slam.state.map, slam.field)["F"]
    same = torch.equal(torch.isnan(view), torch.isnan(rebuilt)) and \
        torch.equal(torch.nan_to_num(view), torch.nan_to_num(rebuilt))
    print(f"# {name}: held view {tuple(view.shape)} {view.dtype} equals a "
          f"full pack_view rebuild bit for bit: {same}")
    if not same:
        fail(f"{name}: the held view differs from pack_view of its map")


def print_stage_times(name, cfg, depths, poses, dev):
    """Median host time per stage (device synchronised after each) over
    the frames after the first 16, from a second run with step_staged."""
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    rows = []
    t0 = time.perf_counter()
    for f in range(len(depths)):
        _, stage_s = slam.step_staged(depths[f], K, f)
        if f >= 16:
            rows.append(stage_s)
    print(f"# {name}: median ms per stage after the first 16 frames "
          f"(step_staged, {time.perf_counter() - t0:.1f} s): " + ", ".join(
              f"{k} {1e3 * statistics.median(r[k] for r in rows):.2f}"
              for k in rows[0]) + ", total " +
          f"{1e3 * statistics.median(sum(r.values()) for r in rows):.2f}")


def run_preset(torch, name, dev, kernels):
    """One preset over its sequence: the run and its gates, the kernel of
    its fusion path against the twin, and its stage medians."""
    sequence, record_file, max_ate = RUNS[name]
    cfg = preset_config(name)
    depths, poses = load_sequence(sequence)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r = run_slam(torch, cfg, depths, poses, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    counter = "fuse_ofusion" if cfg.field_type == "ofusion" else "fuse_sdf"
    for k, n in r["launches"].items():
        kernels[k]["launches"] += n
    print(f"# {name}: {cfg.volume_resolution[0]}^3, capacity "
          f"{cfg.block_capacity}, budget {cfg.integrate_budget}, sequence "
          f"{sequence}; peak device memory {peak / 2 ** 30:.2f} GiB")
    check_run(torch, name, r, poses, load_record(record_file), max_ate,
              counter)
    if cfg.incremental_view and cfg.field_type == "sdf":
        check_held_view(torch, name, r["slam"])
    kernel, err = check_path_kernel(torch, name, r["slam"], cfg)
    kernels[kernel]["max_abs_err"] = max(kernels[kernel]["max_abs_err"], err)
    del r
    torch.cuda.empty_cache()
    print_stage_times(name, cfg, depths, poses, dev)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
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
    depths, poses = load_sequence("synthetic_256_frames")

    build_kernels()
    kernels = {"fuse_sdf": check_fuse_sdf(torch, depths, poses, dev),
               "fuse_ofusion": check_fuse_ofusion(torch, depths, poses, dev)}
    kernels.update(check_probe_kernels(torch, dev))
    for name in RUNS:
        run_preset(torch, name, dev, kernels)
    print(f"# all runs done in {time.perf_counter() - t_start:.1f} s")

    order = ("fuse_sdf", "fuse_ofusion", "lane_shuffle_sum", "slab_row_sum")
    print(json.dumps({"kernels": [kernels[k] for k in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
