#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``supereight_tpu_torch``) on one NVIDIA
GPU.

1. Requires a CUDA device and prints its name and power limit, then builds
   every kernel from ``supereight_tpu_torch/csrc`` (one nvcc per source,
   all started together).
2. Holds the SDF and the OFusion fusion kernel, each updating a map's
   block table in place, against their plain PyTorch twins on clones of
   the same table at main-path shapes (3072 distinct slots of a real map,
   a 320x240 depth): whole tables and ``active`` compared, with the
   median device time of each and the kernel's bound.
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
   held against its twin on clones of the run's map with the slots its
   fusion takes (every live slot, or the budget's frustum candidates):
   whole tables, ``active`` and the held SDF view compared, the slots not
   fused unchanged; the device time of that in-place launch is the fusion
   step's.  Where the candidates are fewer than the budget, it is held
   again at the budget's shape: a table of that many distinct slots
   repeating the candidates' blocks.  The held SDF view of
   ``demo512-sdf`` is held against a full rebuild; each run prints its
   peak device memory.

Every preset is built with ``config.apply_preset``.  Each run prints its
wall time, the median ms per frame and the median of each stage (from a
second run through ``step_staged``).

Run from the repository root:  python3 chip_smoke.py
It exits non-zero, printing no result line, if there is no CUDA device or
any check fails.  The last line of its output is one JSON object; the line
before it lists every kernel with its launches summed over the runs that
took it, its largest difference from its twin, the median device times of
both at the 3072-row shapes (the probe's for K2 and K3), the least time
the card could take for that work (``bound_ms``: the bytes the call must
move at 3.35 TB/s or its float32 operations at 67 TFLOP/s, the larger;
for a fusion kernel, the bytes of the voxels this data updates) and,
where one PyTorch call computes the same function, that call's time.
Each fusion hold also prints the least time its warps take to issue
their instructions, from the compiled code (`probes/sass_count.py`).
"""

from __future__ import annotations

import functools
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
OF_RTOL, OF_ATOL = 1e-5, 1e-6   # occupancy: the last bits of logf; the
#                                 SDF, visible and timestamp bit for bit
TIMED_RUNS = 25
#: the H100 SXM's device memory rate and float32 rate outside the tensor
#: cores (NVIDIA's data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
#: float operations (an fma counts two) of a voxel's projection and patch
#: test, and of a fused voxel's update, counted in csrc/integrate.cu
PROJECT_FLOPS = 34
UPDATE_FLOPS = {"fuse_sdf": 19, "fuse_ofusion": 50}


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


def median_ms(fn, setup=None) -> float:
    """Median device time (ms) of ``fn`` over TIMED_RUNS runs, each after
    an untimed ``setup``."""
    from supereight_tpu_torch.probes.timing import device_times_ms
    return statistics.median(device_times_ms(fn, TIMED_RUNS, setup))


def times(fn, plain):
    """Median device times (ms) of a kernel call and of its twin."""
    return median_ms(fn), median_ms(plain)


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
            if "entry function" in line:
                print(f"#   ptxas: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                print(f"#   ptxas: {line.strip()}")


def bound(nbytes: float, flops: float):
    """(bound ms, what binds): the larger of the bytes at the memory rate
    and the float32 operations at the float32 rate."""
    b_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    o_ms = 1e3 * flops / FP32_FLOPS_PER_S
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


@functools.lru_cache(maxsize=None)
def issue_model():
    """The fusion kernels' compiled main bodies (``cuobjdump -sass``) and
    the card's warp-instruction issue rate, for the issue lower bound."""
    from supereight_tpu_torch.probes import sass_count
    return sass_count.kernel_bodies(), sass_count.card_issue_rate()[4]


def clone_tables(m):
    """``m`` with its own copy of the tables a fusion updates."""
    return m.replace(voxels={k: v.clone() for k, v in m.voxels.items()},
                     active=m.active.clone())


def hold_kernel(torch, label, kernel, m, field, frame, now, slots=None,
                view=None):
    """The in-place fusion kernel and its twin on clones of ``m``'s
    tables (and of ``view``) with ``slots`` (None: every live slot).
    Whole tables and ``active`` must agree (the SDF and its view, visible
    and timestamp bit for bit, occupancy within OF_RTOL / OF_ATOL), the
    slots not fused must keep their rows and flags, and some voxel must
    fuse.  Then both are timed, launching again on their clones.  Returns
    dict(rows, max_abs_err, ms, plain_ms, bound_ms, bound_by, issue_ms)."""
    from supereight_tpu_torch.core import morton, octree
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.probes import sass_count

    if kernel == "fuse_ofusion":
        names, params = ik.OFUSION_CHANNELS, (field.mu, field.sigma_lo, now)
    else:
        names, params = ik.SDF_CHANNELS, (field.mu, field.max_weight)
    fn, plain = getattr(ik, kernel), getattr(ik, kernel + "_twin")
    km, tm = clone_tables(m), clone_tables(m)
    kw = [{}, {}] if view is None else [dict(view=view.clone()),
                                         dict(view=view.clone())]
    run = lambda: fn(km, *frame, *params, slots=slots, **kw[0])
    run_plain = lambda: plain(tm, *frame, *params, slots=slots, **kw[1])
    run()
    run_plain()
    torch.cuda.synchronize()

    rows = (torch.nonzero(octree.slot_mask(m) & m.active)[:, 0]
            if slots is None else slots.long())
    kept = torch.ones(m.capacity, dtype=torch.bool, device=m.device)
    kept[rows] = False
    err = [(km.voxels[k] - tm.voxels[k]).abs() for k in names]
    max_err = max(float(e.max()) for e in err)
    if kernel == "fuse_ofusion":
        beyond = int((err[0] > OF_ATOL + OF_RTOL
                      * tm.voxels[names[0]].abs()).sum()) \
            + int((err[1] != 0).sum())
    else:
        beyond = sum(int((e != 0).sum()) for e in err)
    vis_mismatch = int((km.active != tm.active).sum())
    changed_kept = sum(int((km.voxels[k][kept] != m.voxels[k][kept]).sum())
                       for k in names) \
        + int((km.active[kept] != m.active[kept]).sum())
    changed = [tm.voxels[k] != m.voxels[k] for k in names]
    updated = changed[0] | changed[1]
    fused = int(updated.sum())
    view_mismatch, view_note, view_sectors = 0, "", 0
    if view is not None:
        kv, tv = kw[0]["view"], kw[1]["view"]
        view_mismatch = int((torch.isnan(kv) != torch.isnan(tv)).sum()) \
            + int((torch.nan_to_num(kv) != torch.nan_to_num(tv)).sum())
        view_note = f", held view {view_mismatch}"
        same = (tv == view) | (torch.isnan(tv) & torch.isnan(view))
        view_sectors = int((~same).view(-1, 16).any(-1).sum())
    print(f"# {label}: {kernel} vs twin in place on {rows.numel()} of "
          f"{m.capacity} slots ({'live' if slots is None else 'listed'}): "
          f"{fused} voxels updated, {int(tm.active[rows].sum())} rows "
          f"visible; mismatches active {vis_mismatch}, {beyond} voxels "
          f"beyond the tolerance{view_note}; slots not fused changed "
          f"{changed_kept}; max abs err {max_err:.3g}")
    if fused == 0:
        fail(f"{label}: the {kernel} comparison fused no voxel")
    if vis_mismatch or beyond or view_mismatch or changed_kept:
        fail(f"{label}: {kernel} and twin disagree")

    # every timed launch fuses the same rows: on the whole-table branch the
    # live set depends on `active`, which each launch rewrites
    ms = median_ms(run, lambda: km.active.copy_(m.active))
    plain_ms = median_ms(run_plain, lambda: tm.active.copy_(m.active))

    # What the function needs to move: whether a voxel updates depends on
    # the pose, the depth and the field, never on the stored values, so
    # only the 32-byte sectors (8 voxels) holding updated voxels are read
    # (both channels) and written (where a channel changed), and the
    # view's changed sectors (16 voxels) written; besides, each row's key
    # and `active`, the slots (or every slot's `active` and n_blocks), the
    # depth image, T_cw and K.
    depth, T_cw, Km = frame
    n = rows.numel()
    sectors = lambda x: int(x.view(-1, 8).any(-1).sum())
    nbytes = 32 * (2 * sectors(updated) + sum(sectors(c) for c in changed)
                   + view_sectors) \
        + n * (8 + 1) + (m.capacity + 4 if slots is None else 4 * n) \
        + depth.numel() * 4 + 2 * 64
    b_ms, b_by = bound(nbytes, n * 512 * PROJECT_FLOPS
                       + fused * UPDATE_FLOPS[kernel])
    # the fewest instructions the launch's warps can issue, from the
    # compiled code and which voxels of each warp this data updates
    bc = torch.stack(morton.block_key_decode(m.keys[rows]), -1)
    _, ds, _, _ = ik._sample_rows(bc, torch.ones_like(rows, dtype=torch.bool),
                                  depth, T_cw, Km, m.voxel_size, ik.PATCH)
    bodies, issue_per_s = issue_model()
    dead_warps = sass_count.WARPS * (m.capacity - n) if slots is None else 0
    issue_ms = sass_count.issue_lower_bound_ms(
        bodies[kernel][0], sass_count.warp_classes(ds > 0, updated[rows]),
        dead_warps, issue_per_s)
    del ds
    print(f"# {label}: {kernel} median device time over {TIMED_RUNS} runs "
          f"at {n} rows: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.2f} MB of "
          f"{fused} updated voxels), {100 * b_ms / ms:.0f} % of it; "
          f"issue lower bound {issue_ms:.4f} ms, "
          f"{100 * issue_ms / ms:.0f} % of it")
    return dict(rows=n, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, issue_ms=issue_ms)


def synthetic_table(torch, m, n_rows: int, rows=None):
    """A table of ``n_rows`` distinct slots holding the blocks of ``m``'s
    slots ``rows`` (default: its live slots), repeated with their voxels to
    fill it, all live, and the slots int32[n_rows] that list them."""
    if rows is None:
        rows = torch.nonzero(m.active[:int(m.n_blocks)])[:, 0]
    rows = rows.long()
    idx = rows[torch.arange(n_rows, device=rows.device) % rows.numel()]
    table = m.replace(
        capacity=n_rows, keys=m.keys[idx].contiguous(),
        active=torch.ones(n_rows, dtype=torch.bool, device=idx.device),
        n_blocks=torch.tensor(n_rows, dtype=torch.int32, device=idx.device),
        voxels={k: v[idx].contiguous() for k, v in m.voxels.items()})
    return table, torch.arange(n_rows, dtype=torch.int32, device=idx.device)


def warm_map(cfg, depths, poses, dev, frames: int):
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    for f in range(frames):
        slam.step(depths[f], K, f)
    return slam


def check_fusion_kernel(torch, kernel, preset, frames, depths, poses, dev):
    """A fusion kernel against its twin on 3072 distinct slots holding the
    live blocks of ``preset``'s map after its first ``frames`` frames,
    fused with the next frame (the budget branch at the headline's
    budget)."""
    from supereight_tpu_torch.pipeline import camera, preprocessing
    slam = warm_map(preset_config(preset), depths, poses, dev, frames)
    m, slots = synthetic_table(torch, slam.state.map, 3072)
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[frames].astype(np.int32)).to(dev), (240, 320))
    frame = (depth, torch.linalg.inv(slam.state.pose).contiguous(),
             camera.camera_matrix(torch.from_numpy(K).to(dev)).contiguous())
    now = float(np.float32(1.0 / 30.0) * np.float32(frames))
    label = f"3072 slots of the {preset} map after {frames} frames " \
        f"({int(slam.state.map.n_blocks)} blocks)"
    r = hold_kernel(torch, label, kernel, m, slam.field, frame, now, slots)
    replaces = ("supereight_tpu/ops/integrate_kernel.py:38"
                if kernel == "fuse_sdf"
                else "supereight_tpu/pipeline/integration.py:396")
    return dict(name=kernel, route="cuda",
                source="supereight_tpu_torch/csrc/integrate.cu",
                replaces=replaces, launches=0, max_abs_err=r["max_abs_err"],
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None)


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
    slabs = table.view(-1, gp.SLAB_ROWS * table.shape[1])
    bags = (rows // gp.SLAB_ROWS).long()[None]
    n_slabs = int(torch.unique(rows).numel())
    # bytes each input read once and the output written once; K3 reads the
    # distinct slabs its rows name, not the whole table
    k2_bytes = src.nbytes + idx.nbytes + src.nbytes
    k3_bytes = rows.nbytes + n_slabs * slabs.shape[1] * 2 \
        + gp.SLAB_ROWS * table.shape[1] * 4
    cases = (
        ("lane_shuffle_sum", "scripts/pallas_gather_probe.py:105",
         lambda: gp.lane_shuffle_sum(src, idx, probe.KREP),
         lambda: gp.lane_shuffle_sum_reference(src, idx, probe.KREP),
         bound(k2_bytes, src.numel() * probe.KREP), None),
        # one call that gathers and sums the same slabs: embedding_bag
        # (it sums in its own order and returns bf16)
        ("slab_row_sum", "scripts/pallas_gather_probe.py:146",
         lambda: gp.slab_row_sum(rows, table),
         lambda: gp.slab_row_sum_reference(rows, table),
         bound(k3_bytes, rows.numel() * slabs.shape[1]),
         lambda: torch.nn.functional.embedding_bag(bags, slabs,
                                                   mode="sum")),
    )
    kernels = {}
    for name, replaces, fn, plain, (b_ms, b_by), library in cases:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        mismatch = int((out != ref).sum())
        max_err = float((out - ref).abs().max())
        print(f"# {name} vs twin at {tuple(out.shape)}: {mismatch} of "
              f"{out.numel()} differ, max abs err {max_err:.3g}")
        if mismatch:
            fail(f"{name} and its twin are not bit-identical")
        ms, plain_ms = times(fn, plain)
        library_ms = None if library is None else median_ms(library)
        print(f"# {name} median device time over {TIMED_RUNS} runs: kernel "
              f"{ms:.4f} ms, plain twin {plain_ms:.4f} ms, one PyTorch call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}; "
              f"bound {b_ms:.5f} ms ({b_by}), {100 * b_ms / ms:.1f} % of it")
        kernels[name] = dict(
            name=name, route="cuda",
            source="supereight_tpu_torch/csrc/gather_probe.cu",
            replaces=replaces, max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)

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
    """The run's fusion kernel against its twin on clones of the run's map
    (and held SDF view), with the slots its fusion takes at the last frame
    (`integration.fusion_operands`): every live slot when the budget is 0
    or the capacity, else the budget's frustum candidates.  The device
    time of that launch is the fusion step's.  When the candidates are
    fewer than the budget, the kernel is held again at the budget's shape:
    a table of ``budget`` distinct slots repeating the candidates' blocks
    (`synthetic_table`).  Returns (kernel, max abs err)."""
    from supereight_tpu_torch.pipeline import camera, integration

    st, field = slam.state, slam.field
    m = st.map
    depth = (st.scaled_depth if cfg.fuse_filtered else st.float_depth) \
        .contiguous()
    T_cw = torch.linalg.inv(st.pose).contiguous()
    Km = camera.camera_matrix(torch.from_numpy(K).to(depth.device)) \
        .contiguous()
    slots, _ = integration.fusion_operands(m, T_cw, Km, depth.shape,
                                           cfg.integrate_budget)
    now = float(np.float32(1.0 / 30.0) * np.float32(95))
    kernel = "fuse_ofusion" if field.name == "ofusion" else "fuse_sdf"
    view = st.view if kernel == "fuse_sdf" else None
    frame = (depth, T_cw, Km)
    r = hold_kernel(torch, name, kernel, m, field, frame, now, slots, view)
    print(f"# {name}: fusion step (in-place {kernel} on the run's "
          f"{r['rows']} {'live' if slots is None else 'listed'} slots"
          f"{', held view' if view is not None else ''}) device time "
          f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    max_err = r["max_abs_err"]
    if slots is not None and slots.numel() < cfg.integrate_budget:
        table, budget_slots = synthetic_table(torch, m, cfg.integrate_budget,
                                              slots)
        r = hold_kernel(torch, f"{name} (budget shape: {cfg.integrate_budget}"
                        f" slots repeating the {slots.numel()} candidates)",
                        kernel, table, field, frame, now, budget_slots, view)
        max_err = max(max_err, r["max_abs_err"])
        del table
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
    kernels = {
        "fuse_sdf": check_fusion_kernel(torch, "fuse_sdf", "headline", 6,
                                        depths, poses, dev),
        "fuse_ofusion": check_fusion_kernel(torch, "fuse_ofusion", "ofusion",
                                            8, depths, poses, dev)}
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
