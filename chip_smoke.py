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
   ``slab_row_sum``) against their twins at the probe's shapes and at a
   second shape each (K2 at 65536 rows, K3 at 8192 slabs), bit for bit,
   timed beside the launch floor (an empty kernel) and their bounds, then
   runs the probe (``probes/gather_probe.py``), the kernels' own path, and
   prints its four measurements.
4. Runs the slice's entry points as users run them, each with the fusion
   kernels' counts set to 0 just before and read just after (every
   integrated frame must launch one):
   A. ``apps.benchmark`` in ground-truth mode (``-g``) at the headline
      preset on the cached base sequence, written as a .raw stream and a
      TUM trajectory with the port's ``io``: 96/96 frames, ATE < 1e-4 m,
      overflow 0, blocks within 0.5 % of the JAX package's on the CPU;
   B. the same in ICP mode (``-p 0.5,0.5,0.23``) with the renderers every
      4th frame: >= 88 tracked, ATE <= the JAX CPU run's + 1 cm, 96 TSV
      rows, the last ``renderVolume`` shading half the pixels;
   C. ``DenseSLAMSystem.step(gt_pose=)`` at the configuration of the TPU
      record ``bench_data/ate_icp_256_gt.json``: blocks within 0.5 % of
      the JAX CPU run's;
   D. ``apps.runner.run("synthetic-room", resolution=256)``, its 120 frames
      sphere-traced on the card (the trace timed alone first): tracked
      share >= 0.92, ATE <= the JAX CPU run's + 1.5 cm.
5. Runs the nine presets of ``supereight_tpu_torch/config.py``
   (``headline``: SDF, 256^3 over 4.8 m, 320x240, capacity 6144, fusion
   budget 3072; ``ofusion``; then the seven others), each at the size of
   its JAX record over the 96 frames of its cached sequence in
   ``bench_data/``, and checks tracked frames, ATE, blocks and overflow
   (the ATE gate is the JAX package's own CPU run + 0.5 cm, 1 cm for
   ``trans`` and 2.5 cm for ``noise``, `jax_cpu_reference.py`; overflow is
   gated only where the TPU record's is 0), that the frames went through
   the kernel, and that ``headline`` and ``ofusion`` repeat the earlier
   runs' counts.  After each run the fusion kernel is held against its
   twin on clones of the run's map with the slots its fusion takes (every
   live slot, or the budget's frustum candidates): whole tables,
   ``active`` and the held SDF view compared, the slots not fused
   unchanged; the device time of that in-place launch is the fusion
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
took it (the app phases and the presets), its largest difference from its
twin, the median device times of both at the 3072-row shapes (the
probe's for K2 and K3), the least time the card could take for that work (``bound_ms``: the bytes the call must
move at 3.35 TB/s or its float32 operations at 67 TFLOP/s, the larger;
for a fusion kernel, the bytes of the voxels this data updates) and,
where one PyTorch call computes the same function, that call's time.
Each fusion hold, and each K2 / K3 hold, also prints the least time its
warps take to issue their instructions, from the compiled code
(`probes/sass_count.py`); K2's and K3's entries carry it (``issue_ms``),
K2's its shared-memory bound (``smem_ms``), K3's the time its distinct
slabs take at the rate one PyTorch reduction reads its L2-resident table
(``resident_ms``, beside that rate), both the launch floor and their times
at the second shape (``at_scale``).
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

#: the JAX package's own run of each preset on the CPU at its record's size
#: over the same 96 frames (ATE cm, blocks; `jax_cpu_reference.py`): the
#: JAX records in bench_data/ were taken on a TPU, whose rounding the CPU
#: does not share
JAX_CPU = {"headline": (0.97, 2767), "ofusion": (0.92, 3674),
           "quality": (1.07, 2951), "trans": (3.13, 3141),
           "noise": (5.66, 6144), "demo512-sdf": (1.36, 17961),
           "demo512-ofusion": (1.74, 22116),
           "ofusion-fidelity": (0.92, 2050), "1024-quality": (0.99, 128318)}
#: the ATE gate over JAX_CPU, in cm: the port parts from the JAX package by
#: rounding, which ICP amplifies (up to 0.44 cm on trans in the port's CPU
#: run); noise is chaotic in the JAX package itself (a one-ulp nudge of the
#: depth moves its pose by 6 mm, and rounding-only changes of the port moved
#: its ATE on the card between 6.1 and 7.6 cm)
ATE_MARGIN_CM = {"trans": 1.0, "noise": 2.5}
ATE_MARGIN_DEFAULT_CM = 0.5


def ate_gate(name: str) -> float:
    """A preset's ATE gate in metres."""
    return 0.01 * (JAX_CPU[name][0]
                   + ATE_MARGIN_CM.get(name, ATE_MARGIN_DEFAULT_CM))


#: preset: (cached sequence, the JAX package's record in bench_data/, ATE
#: gate in m)
RUNS = {name: (sequence, record, ate_gate(name))
        for name, sequence, record in (
    ("headline", "synthetic_256_frames",
     "ate_icp_256_hybrid_ad3.8x0.07_id2_ib3072_ss1_ar3_gd2.json"),
    ("ofusion", "synthetic_256_frames",
     "ate_icp_ofusion_256_hybrid_id2_ib3072_ss1_iv_nr_z4.json"),
    ("quality", "synthetic_256_frames", "ate_icp_256_sy_nr.json"),
    ("trans", "synthetic_256_frames_trans",
     "ate_icp_ofusion_256_trans_nr_z4.json"),
    ("noise", "synthetic_256_frames_noisy",
     "ate_icp_ofusion_256_bf_noisy_nr_z4.json"),
    ("demo512-sdf", "synthetic_256_frames",
     "ate_icp_512_hybrid_id2_ib24576_ss1_sy_gd2_iv_fr.json"),
    ("demo512-ofusion", "synthetic_256_frames",
     "ate_icp_ofusion_512_hybrid_id2_ib6144_ss1_aod0.01_iv_nr_z4.json"),
    ("ofusion-fidelity", "synthetic_256_frames",
     "ate_icp_ofusion_256_exact_pl_nr_z4_mu0.008.json"),
    ("1024-quality", "synthetic_256_frames",
     "ate_icp_ofusion_1024_id2_ib98304_ss1_aad16x0.3_iv_nr_z4.json"))}
#: the app phases: the README's command line on the cached base sequence
#: (the headline preset; -g gives ground-truth poses, -p the ICP start)
APP_ARGS = ["-s", "4.8", "-v", "256", "-k", "240.6,240,160,120",
            "--preset", "headline"]
APP_ICP_START = ["-p", "0.5,0.5,0.23"]
#: the JAX package's results on the CPU for the app phases
#: (`jax_cpu_reference.py`): blocks of the app in ground-truth mode, ATE
#: (cm) and blocks of the app in ICP mode, blocks of the facade in
#: ground-truth mode at the configuration of bench_data/ate_icp_256_gt.json
#: (whose TPU run allocated 2686), and the runner's ATE (cm) and tracked
#: share on its synthetic room
JAX_CPU_APP = dict(gt_blocks=2607, icp_ate_cm=4.03, icp_blocks=2914,
                   facade_gt_blocks=2658, runner_ate_cm=2.98,
                   runner_tracked=0.967)
TPU_GT_BLOCKS = 2686
BLOCKS_RTOL = 0.005          # blocks within 0.5 % of the JAX run's
GT_MAX_ATE_M = 1e-4          # ground-truth poses come back unchanged
APP_ICP_ATE_MARGIN_CM = 1.0
RUNNER_MIN_TRACKED = 0.92
RUNNER_ATE_MARGIN_CM = 1.5
#: least share of the last volume rendering's pixels that are shaded
MIN_SHADED = 0.5
#: runs of the sphere trace timed by CUDA events
TRACE_RUNS = 5

#: the counts the earlier runs of this code gave on the card; the path is
#: deterministic, so they repeat exactly
REPEAT = {"headline": dict(tracked=92, ate_cm=0.97, blocks=2767, overflow=0),
          "ofusion": dict(tracked=92, ate_cm=0.91, blocks=3674, overflow=0)}
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


def ate_rmse(est, gt) -> float:
    """RMSE of the estimated positions of the poses ``est`` [n,4,4] after
    the least-squares rigid alignment to the ground truth ``gt`` (Horn):
    the port's ``apps.evaluate.ate``."""
    from supereight_tpu_torch.apps import evaluate
    return evaluate.ate(list(est), list(gt))["rmse"]


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
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing
    slam = warm_map(preset_config(preset), depths, poses, dev, frames)
    m, slots = synthetic_table(torch, slam.state.map, 3072)
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[frames].astype(np.int32)).to(dev), (240, 320))
    frame = (depth, numerics.inv(slam.state.pose),
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


def smem_bound_ms(gathers: int, sms: int, mhz: float) -> float:
    """Least time ``gathers`` 4-byte shared-memory loads take at 32 banks x
    4 bytes a clock on each of ``sms`` SMs at ``mhz``."""
    return 1e3 * 4 * gathers / (sms * 32 * 4 * mhz * 1e6)


#: passes over the resident table of the reduction that times its read rate
RESIDENT_PASSES = 64


def resident_read_rate(torch, table) -> float:
    """Bytes a second at which one PyTorch reduction reads ``table`` while
    it sits in the L2 (K3's 6 MB table; the card's L2 holds 50 MB): an
    int64 max over RESIDENT_PASSES passes of it, in one launch.  A rate
    some code reaches, so a time at it is not a lower bound, only a
    tighter reference than the memory's rate for data that never leaves
    the L2."""
    passes = table.view(torch.int64).view(1, -1) \
        .expand(RESIDENT_PASSES, -1)
    ms = median_ms(lambda: passes.amax())
    return RESIDENT_PASSES * table.nbytes / (1e-3 * ms)


def probe_cases(torch, dev):
    """K2 and K3 at the probe's shapes and at their second shapes: {name:
    (replaces, [(shape label, kernel call, twin call, (byte bound ms, what
    binds), warp-trips of the main loop, shared-memory gathers or None,
    bytes read from the resident table or None), ...], the one PyTorch
    call at the probe's shape or None, the table or None)}."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.probes import gather_probe as probe

    k2, table, k3 = probe.kernel_inputs(dev)
    slabs = table.view(-1, gp.SLAB_ROWS * table.shape[1])

    def k2_case(src, idx):
        # bytes each input read once and the output written once
        nbytes = src.nbytes + idx.nbytes + src.nbytes
        S = src.shape[0]
        return (f"{S}x{gp.LANES}x{probe.KREP}",
                lambda: gp.lane_shuffle_sum(src, idx, probe.KREP),
                lambda: gp.lane_shuffle_sum_reference(src, idx, probe.KREP),
                bound(nbytes, src.numel() * probe.KREP),
                gp.shuffle_warp_trips(S), src.numel() * probe.KREP, None)

    def k3_case(rows):
        # K3 reads the distinct slabs its rows name, not the whole table
        n_slabs = int(torch.unique(rows).numel())
        resident = n_slabs * slabs.shape[1] * 2
        nbytes = rows.nbytes + resident + gp.SLAB_ROWS * table.shape[1] * 4
        return (f"{rows.numel()} slabs ({n_slabs} distinct)",
                lambda: gp.slab_row_sum(rows, table),
                lambda: gp.slab_row_sum_reference(rows, table),
                bound(nbytes, rows.numel() * slabs.shape[1]),
                gp.slab_warp_trips(rows.numel(), table.shape[1]), None,
                resident)

    bags = (k3[0] // gp.SLAB_ROWS).long()[None]
    return {
        "lane_shuffle_sum": ("scripts/pallas_gather_probe.py:105",
                             [k2_case(*x) for x in k2], None, None),
        # one call that gathers and sums the same slabs: embedding_bag (it
        # sums in its own order and returns bf16)
        "slab_row_sum": ("scripts/pallas_gather_probe.py:146",
                         [k3_case(x) for x in k3],
                         lambda: torch.nn.functional.embedding_bag(
                             bags, slabs, mode="sum"), table),
    }


def check_probe_kernels(torch, dev):
    """K2 and K3 vs their twins at the probe's shapes and at their second
    shapes (bit for bit), timed beside the launch floor (an empty kernel),
    the byte bound, the issue lower bound of the main loop (compiled code,
    `probes/sass_count.py`) and, for K2, the shared-memory bound; then the
    probe itself, the kernels' main path, with their counts set to 0 just
    before it."""
    from supereight_tpu_torch.ops import gather_probe as gp
    from supereight_tpu_torch.probes import gather_probe as probe
    from supereight_tpu_torch.probes import sass_count

    _, _, mhz, sms, issue_per_s = sass_count.card_issue_rate()
    trips = sass_count.gather_trips()
    floor = median_ms(lambda: gp.empty_launch(dev))
    print(f"# launch floor (an empty kernel, timed as the kernels are): "
          f"{floor:.4f} ms; loop trips (SASS instructions): {trips}")
    kernels = {}
    for name, (replaces, shapes, library, table) in \
            probe_cases(torch, dev).items():
        rate = None if table is None else resident_read_rate(torch, table)
        if rate is not None:
            print(f"# {name}: one reduction reads its resident table at "
                  f"{rate / 1e12:.3f} TB/s ({RESIDENT_PASSES} passes of "
                  f"{table.nbytes / 1e6:.2f} MB in one launch)")
        held = []
        for label, fn, plain, (b_ms, b_by), warp_trips, gathers, resident \
                in shapes:
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            mismatch = int((out != ref).sum())
            max_err = float((out - ref).abs().max())
            print(f"# {name} vs twin at {label}: {mismatch} of {out.numel()} "
                  f"differ, max abs err {max_err:.3g}")
            if mismatch:
                fail(f"{name} and its twin are not bit-identical at {label}")
            trip = trips[name + "<64>" if name == "lane_shuffle_sum" else name]
            issue_ms = sass_count.loop_issue_lower_bound_ms(
                trip, warp_trips, issue_per_s)
            smem_ms = None if gathers is None \
                else smem_bound_ms(gathers, sms, mhz)
            resident_ms = None if resident is None \
                else 1e3 * resident / rate
            ms = median_ms(fn)
            print(f"# {name} at {label}: median device time over "
                  f"{TIMED_RUNS} runs {ms:.4f} ms (launch floor {floor:.4f});"
                  f" byte bound {b_ms:.5f} ms ({b_by}), "
                  f"{100 * b_ms / ms:.1f} % of it; issue lower bound "
                  f"{issue_ms:.5f} ms ({trip} instructions x {warp_trips} "
                  f"warp-trips), {100 * issue_ms / ms:.1f} % of it"
                  + ("" if smem_ms is None else
                     f"; shared-memory bound {smem_ms:.5f} ms, "
                     f"{100 * smem_ms / ms:.1f} % of it")
                  + ("" if resident_ms is None else
                     f"; its distinct slabs at the resident read rate "
                     f"{resident_ms:.5f} ms, {100 * resident_ms / ms:.1f} % "
                     f"of it"))
            held.append(dict(shape=label, max_abs_err=max_err, ms=ms,
                             bound_ms=b_ms, bound_by=b_by, issue_ms=issue_ms,
                             smem_ms=smem_ms, resident_ms=resident_ms))
        # the twin and the one PyTorch call at the probe's shape
        probe_shape, scale = held
        if name == "slab_row_sum":
            # one column tile of the probe's rows (a cluster for each slab
            # row): whether the card or each CTA sets the time
            d = probe.make_data()
            rows = probe.rows_inputs(d, 1, dev)[0]
            tile = probe.table16(d, dev)[:, :gp.TILE_COLS].contiguous()
            scale["one_tile_ms"] = median_ms(
                lambda: gp.slab_row_sum(rows, tile))
            print(f"# slab_row_sum at {probe_shape['shape']} on one "
                  f"{gp.TILE_COLS}-column tile ({gp.slab_grid(gp.TILE_COLS)}"
                  f" CTAs): {scale['one_tile_ms']:.4f} ms")
        plain_ms = median_ms(shapes[0][2])
        library_ms = None if library is None else median_ms(library)
        print(f"# {name} at {probe_shape['shape']}: plain twin "
              f"{plain_ms:.4f} ms, one PyTorch call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}")
        kernels[name] = dict(
            name=name, route="cuda",
            source="supereight_tpu_torch/csrc/gather_probe.cu",
            replaces=replaces,
            max_abs_err=max(h["max_abs_err"] for h in held),
            ms=probe_shape["ms"], plain_ms=plain_ms,
            bound_ms=probe_shape["bound_ms"],
            bound_by=probe_shape["bound_by"], library_ms=library_ms,
            issue_ms=probe_shape["issue_ms"], smem_ms=probe_shape["smem_ms"],
            resident_ms=probe_shape["resident_ms"],
            resident_read_tb_s=None if rate is None else rate / 1e12,
            launch_floor_ms=floor, at_scale=scale)

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
    ate = ate_rmse(r["est"], poses[:n])
    launches = r["launches"][counter]
    cpu_ate, cpu_blocks = JAX_CPU[name]
    print(f"# {name}, {n} frames in {r['wall']:.1f} s: tracked "
          f"{r['tracked']}/{n} (TPU record {record['tracked']}/96), ATE "
          f"{100 * ate:.2f} cm (JAX on the CPU {cpu_ate:.2f}, TPU record "
          f"{record['ate_cm']:.2f}, gate {100 * max_ate:.2f}), blocks "
          f"{r['blocks']} (JAX on the CPU {cpu_blocks}, TPU record "
          f"{record['blocks']}), overflow {r['overflow']} (TPU record "
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
        fail(f"{name}: ATE {100 * ate:.2f} cm > {100 * max_ate:.2f} cm")
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
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, integration

    st, field = slam.state, slam.field
    m = st.map
    depth = (st.scaled_depth if cfg.fuse_filtered else st.float_depth) \
        .contiguous()
    T_cw = numerics.inv(st.pose)
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


def reset_launches():
    from supereight_tpu_torch.ops import integrate_kernel as ik
    for k in ik.LAUNCHES:
        ik.LAUNCHES[k] = 0


def launches():
    from supereight_tpu_torch.ops import integrate_kernel as ik
    return dict(ik.LAUNCHES)


def check_blocks(label, blocks, want):
    """Blocks within BLOCKS_RTOL of the JAX run's ``want``."""
    if abs(blocks - want) > BLOCKS_RTOL * want:
        fail(f"{label}: {blocks} blocks, not within "
             f"{100 * BLOCKS_RTOL:.1f} % of the JAX run's {want}")


def check_launched(label, counts, integrated):
    """The fusion kernels launched at least once per integrated frame."""
    n = sum(counts.values())
    print(f"# {label}: fusion LAUNCHES {counts} over {integrated} "
          "integrated frames")
    if integrated == 0 or n < integrated:
        fail(f"{label}: {n} fusion launches < {integrated} integrated "
             "frames: the path did not go through the kernel")


def write_sequence(tmp, depths, poses):
    """The cached frames as ``seq.raw`` and ``seq.gt`` in ``tmp``, written
    with the port's io."""
    from supereight_tpu_torch.io import groundtruth, raw
    w = raw.RawWriter(os.path.join(tmp, "seq.raw"), depths.shape[2],
                      depths.shape[1])
    for d in depths:
        w.write(d)
    w.close()
    groundtruth.write_poses(os.path.join(tmp, "seq.gt"), poses)
    return os.path.join(tmp, "seq.raw"), os.path.join(tmp, "seq.gt")


def app_phase(torch, label, argv, poses, tmp):
    """``apps.benchmark`` over the sequence with ``argv``, its fusion
    counts set to 0 just before: returns the run's figures from its TSV
    log, its state and its last images."""
    from supereight_tpu_torch.apps import benchmark
    log = os.path.join(tmp, label + ".tsv")
    reset_launches()
    t0 = time.perf_counter()
    r = benchmark.run(argv + ["-q", "-o", log, "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = launches()
    rows = np.loadtxt(log, delimiter="\t", skiprows=1, ndmin=2)
    st = r.system.state
    out = dict(rows=len(rows), tracked=int(rows[:, 12].sum()),
               integrated=int(rows[:, 13].sum()),
               ate=ate_rmse(np.stack(r.est_poses), poses[:len(r.est_poses)]),
               blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
               ms=statistics.median(1e3 * rows[16:, 7]), wall=wall,
               images=r.images)
    print(f"# {label}: {out['rows']} TSV rows in {wall:.1f} s, tracked "
          f"{out['tracked']}, integrated {out['integrated']}, ATE "
          f"{100 * out['ate']:.4f} cm, blocks {out['blocks']}, overflow "
          f"{out['overflow']}; median computation {out['ms']:.2f} ms/frame "
          "after the first 16 frames")
    check_launched(label, counts, out["integrated"])
    if out["rows"] != len(poses):
        fail(f"{label}: {out['rows']} TSV rows for {len(poses)} frames")
    if out["overflow"]:
        fail(f"{label}: overflow {out['overflow']}")
    return out


def check_apps(torch, depths, poses, dev):
    """Phases A-C, the ground-truth mode and the app: the benchmark app in
    ground-truth mode (A) and ICP mode with the renderers every 4th frame
    (B) on the cached base sequence, written as a .raw stream and a TUM
    trajectory; then the facade in ground-truth mode at the configuration
    of the TPU record bench_data/ate_icp_256_gt.json (C).  Returns the
    fusion launches and the phases' figures."""
    import tempfile
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    total = {"fuse_sdf": 0, "fuse_ofusion": 0}
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        rawp, gtp = write_sequence(tmp, depths, poses)
        a = app_phase(torch, "A app ground truth",
                      ["-i", rawp] + APP_ARGS + ["-c", "0", "-g", gtp],
                      poses, tmp)
        total = {k: total[k] + n for k, n in launches().items()}
        print(f"# A: blocks {a['blocks']} (JAX on the CPU "
              f"{JAX_CPU_APP['gt_blocks']})")
        if a["tracked"] != len(poses):
            fail(f"A: tracked {a['tracked']} of {len(poses)} frames")
        if a["ate"] >= GT_MAX_ATE_M:
            fail(f"A: ATE {a['ate']:.3g} m >= {GT_MAX_ATE_M} m")
        check_blocks("A", a["blocks"], JAX_CPU_APP["gt_blocks"])

        b = app_phase(torch, "B app ICP",
                      ["-i", rawp] + APP_ARGS + APP_ICP_START, poses, tmp)
        total = {k: total[k] + n for k, n in launches().items()}
        gate = JAX_CPU_APP["icp_ate_cm"] + APP_ICP_ATE_MARGIN_CM
        print(f"# B: ATE {100 * b['ate']:.2f} cm (JAX on the CPU "
              f"{JAX_CPU_APP['icp_ate_cm']}, gate {gate:.2f}), blocks "
              f"{b['blocks']} (JAX on the CPU {JAX_CPU_APP['icp_blocks']})")
        if b["tracked"] < MIN_TRACKED:
            fail(f"B: tracked {b['tracked']} < {MIN_TRACKED}")
        if 100 * b["ate"] > gate:
            fail(f"B: ATE {100 * b['ate']:.2f} cm > {gate:.2f} cm")
        if b["images"] is None:
            fail("B: the renderers did not run")
        depth_img, track_img, volume = b["images"]
        for name, img in zip(("depth", "track", "volume"), b["images"]):
            if img.dtype != torch.uint8 or tuple(img.shape) != (240, 320, 4):
                fail(f"B: render{name} gave {img.dtype} "
                     f"{tuple(img.shape)}, not uint8 (240, 320, 4)")
        shaded = float((volume[..., :3].amax(-1) > 0).float().mean())
        print(f"# B: the last renderVolume shades {shaded:.3f} of the "
              "pixels")
        if shaded < MIN_SHADED:
            fail(f"B: renderVolume shades only {shaded:.3f} of the pixels")

    cfg = SlamConfig(**BASE, integration_rate=1)
    slam = DenseSLAMSystem((240, 320), cfg, dev)
    slam.setPose(poses[0])
    reset_launches()
    t0 = time.perf_counter()
    est, integrated = [], 0
    for f in range(len(depths)):
        st = slam.step(depths[f], K, f, gt_pose=poses[f])
        integrated += st.integrated
        est.append(st.pose.cpu().numpy())
    wall = time.perf_counter() - t0
    counts = launches()
    total = {k: total[k] + n for k, n in counts.items()}
    c = dict(blocks=int(st.map.n_blocks), overflow=int(st.map.overflow),
             ate=ate_rmse(np.stack(est), poses))
    print(f"# C facade ground truth (SDF, volume normals, every frame "
          f"fused and raycast, no budget, capacity 6144), "
          f"{len(depths)} frames in {wall:.1f} s: blocks {c['blocks']} "
          f"(JAX on the CPU {JAX_CPU_APP['facade_gt_blocks']}, TPU record "
          f"{TPU_GT_BLOCKS}), overflow {c['overflow']}, ATE "
          f"{c['ate']:.3g} m")
    check_launched("C", counts, integrated)
    check_blocks("C", c["blocks"], JAX_CPU_APP["facade_gt_blocks"])
    if c["overflow"] or c["ate"] >= GT_MAX_ATE_M:
        fail(f"C: overflow {c['overflow']}, ATE {c['ate']:.3g} m")
    for name, r in (("A", a), ("B", b), ("C", c)):
        figures[name] = {k: v for k, v in r.items() if k != "images"}
    return total, figures


def check_runner(torch, dev):
    """Phase D: ``apps.runner.run`` on the synthetic room at 256^3, its 120
    frames rendered by the port's sphere trace on the card; the trace is
    timed on its own first."""
    import tempfile
    from supereight_tpu_torch.apps import runner
    from supereight_tpu_torch.io import synthetic
    from supereight_tpu_torch.probes.timing import device_times_ms

    spec = runner.DATASETS["synthetic-room"]
    H, W = spec["hw"]
    pose = torch.from_numpy(synthetic.orbit_poses(spec["n_frames"],
                                                  spec["volume"])[60]).to(dev)
    k = torch.tensor([synthetic.DEFAULT_K[0] * W / 320.0,
                      synthetic.DEFAULT_K[1] * H / 240.0, W / 2.0, H / 2.0],
                     device=dev)
    trace = lambda: synthetic.render_depth(pose, k, spec["volume"], H, W)
    dev_ms = statistics.median(device_times_ms(trace, TRACE_RUNS))
    t0 = time.perf_counter()
    for _ in range(TRACE_RUNS):
        trace()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / TRACE_RUNS
    print(f"# D: sphere trace ({H}x{W}, 160 steps) {dev_ms:.2f} ms a frame "
          f"of device time (CUDA events, median of {TRACE_RUNS}), "
          f"{host_ms:.2f} ms a frame on the host clock")
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = runner.run("synthetic-room", resolution=256, out=tmp,
                         device=dev)
        wall = time.perf_counter() - t0
        log = os.path.join(tmp, "regime_rerun" if "auto_regime" in res
                           else "", "benchmark.log")
        integrated = int(np.loadtxt(log, delimiter="\t", skiprows=1,
                                    ndmin=2)[:, 13].sum())
    gate = JAX_CPU_APP["runner_ate_cm"] + RUNNER_ATE_MARGIN_CM
    print(f"# D runner synthetic-room 256^3, {res['frames']} frames in "
          f"{wall:.1f} s: tracked {res['tracked_ratio']} (JAX on the CPU "
          f"{JAX_CPU_APP['runner_tracked']}), ATE "
          f"{100 * res['ate_rmse_m']:.2f} cm (JAX on the CPU "
          f"{JAX_CPU_APP['runner_ate_cm']}, gate {gate:.2f}), RPE "
          f"{1e3 * res['rpe_trans_rmse_m']:.2f} mm / "
          f"{res['rpe_rot_rmse_deg']:.3f} deg, rerun "
          f"{res.get('auto_regime', 'none')}")
    check_launched("D", launches(), integrated)
    if res["tracked_ratio"] < RUNNER_MIN_TRACKED:
        fail(f"D: tracked ratio {res['tracked_ratio']} < "
             f"{RUNNER_MIN_TRACKED}")
    if 100 * res["ate_rmse_m"] > gate:
        fail(f"D: ATE {100 * res['ate_rmse_m']:.2f} cm > {gate:.2f} cm")
    return launches(), dict(trace_ms=dev_ms, trace_host_ms=host_ms,
                            wall=wall, **res)


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
    app_launches, _ = check_apps(torch, depths, poses, dev)
    runner_launches, _ = check_runner(torch, dev)
    for counts in (app_launches, runner_launches):
        for k, n in counts.items():
            kernels[k]["launches"] += n
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
