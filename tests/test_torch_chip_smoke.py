"""``chip_smoke.py``'s own checks, runnable without a card: its ATE agrees
with ``supereight_tpu.apps.evaluate.ate`` (to 1e-9 m), its runs (the
presets and phase F) are the configurations of the JAX records they are
held against, its gates are the JAX package's CPU figures plus the stated
margins, its ICP hold covers the headline's level shapes and every knob
group (its CPU half run here on the twins), its raycast hold covers every
normals and refine mode of the presets and of phase F (its plumbing run
here with the twins standing in for the kernels), its JSON line lists the
fifteen kernels, and without CUDA it exits non-zero and prints no
result."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from supereight_tpu.apps import evaluate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ate_matches_evaluate():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (40, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.02, (40, 3)), axis=0)
    est = gt.copy()
    c, s = np.cos(0.1), np.sin(0.1)
    est[:, :3, 3] = gt[:, :3, 3] @ np.array([[c, -s, 0], [s, c, 0],
                                             [0, 0, 1]]).T + 0.3
    est[:, :3, 3] += rng.normal(0, 0.01, (40, 3))
    want = evaluate.ate(list(est), list(gt))["rmse"]
    got = chip_smoke.ate_rmse(est, gt)
    assert want > 0.005
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


#: the smoke run's knobs beside the JAX record's keys for them
RECORD_KEYS = dict(
    field_type="field", mu="mu", block_capacity="capacity",
    integrate_budget="integrate_budget", integration_rate="integration_rate",
    raycast_normals="normals", raycast_refine="refine",
    raycast_full_res_scan="full_res_scan",
    incremental_view="incremental_view", icp_symmetric="icp_symmetric",
    raycast_near_rescue="near_rescue", bilateral_filter="bilateral",
    icp_finest_decimate="icp_finest_decimate",
    raycast_scan_stride="scan_stride", raycast_grad_decim="grad_decim",
    alloc_rate="alloc_rate", raycast_adaptive_deg="adaptive_deg",
    alloc_on_demand="alloc_on_demand",
    alloc_adaptive_deg="alloc_adaptive_deg",
    alloc_adaptive_dist="alloc_adaptive_dist")


@pytest.mark.parametrize("name", sorted(chip_smoke.RUNS))
def test_runs_are_the_records(name):
    """Each preset the smoke runs is the configuration of the JAX record it
    is held against, on the record's sequence at its size; the ATE gate is
    the JAX package's CPU figure plus a margin of at most 2.5 cm, and no
    looser than the record + ~2 cm the gates allowed before."""
    from supereight_tpu.config import PRESETS
    assert set(chip_smoke.RUNS) == set(PRESETS)
    sequence, record_file, max_ate = chip_smoke.RUNS[name]
    with open(os.path.join(REPO, "bench_data", record_file)) as f:
        rec = json.load(f)
    cfg = chip_smoke.preset_config(name)
    assert (rec["sequence"], rec["frames"], rec["size"]) == \
        (sequence, 96, cfg.volume_resolution[0])
    for knob, key in RECORD_KEYS.items():
        assert getattr(cfg, knob) == rec[key], knob
    margin = chip_smoke.ATE_MARGIN_CM.get(name,
                                          chip_smoke.ATE_MARGIN_DEFAULT_CM)
    assert 0 < margin <= 2.5
    assert max_ate == pytest.approx(0.01 * (chip_smoke.JAX_CPU[name][0]
                                            + margin), abs=1e-12)
    assert max_ate <= rec["ate_rmse_m"] + 0.0215
    record = chip_smoke.load_record(record_file)
    assert record["tracked"] == rec["tracked_frames"] >= chip_smoke.MIN_TRACKED


#: the phase-F knobs under their record's keys
F_RECORD_KEYS = dict(
    raycast_normals="normals", raycast_refine="refine",
    raycast_midsolve="midsolve", icp_robust="icp_robust",
    icp_robust_delta="icp_robust_delta", icp_assoc="icp_assoc",
    icp_symmetric="icp_symmetric", bootstrap_f2f="bootstrap_f2f")


@pytest.mark.parametrize("name", sorted(chip_smoke.F_RUNS))
def test_phase_f_runs_are_the_records(name):
    """Each phase-F run is the JAX package's ``headline`` configuration
    with its knob group, knob for knob; its record (a TPU run, printed
    beside the run) names the same knobs, and where the record was taken on
    the headline base, the base's knobs too; its ATE gate is the JAX
    package's CPU figure + 0.5 cm."""
    import dataclasses
    from supereight_tpu.config import Configuration, apply_preset
    from supereight_tpu_torch.config import SlamConfig
    knobs, record_file = chip_smoke.F_RUNS[name]
    cfg = chip_smoke.f_config(name)
    jcfg = dataclasses.replace(apply_preset(
        "headline", Configuration(**chip_smoke.BASE)), **knobs)
    assert SlamConfig.of(jcfg) == cfg
    for knob, value in knobs.items():
        assert getattr(cfg, knob) == value
    assert any(getattr(SlamConfig(), knob) != v for knob, v in knobs.items())
    with open(os.path.join(REPO, "bench_data", record_file)) as f:
        rec = json.load(f)
    assert (rec["frames"], rec["size"], rec["field"]) == (96, 256, "sdf")
    keys = dict(F_RECORD_KEYS, **RECORD_KEYS) if "sequence" in rec \
        else F_RECORD_KEYS
    for knob, key in keys.items():
        if key in rec:
            assert getattr(cfg, knob) == rec[key], knob
    assert sum(key in rec for key in F_RECORD_KEYS.values()
               if key != "icp_robust_delta") >= 1
    assert chip_smoke.ate_gate(name) == pytest.approx(
        0.01 * (chip_smoke.JAX_CPU_F[name][0] + 0.5), abs=1e-12)
    record = chip_smoke.load_record(record_file)
    assert record["overflow"] == 0
    want = dict(F4=(3.46, 3147, 92), F5=(1.85, 3049, 92),
                F6=(2.95, 3068, 95)).get(name)
    if want is not None:
        assert (round(record["ate_cm"], 2), record["blocks"],
                record["tracked"]) == want


def test_fails_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smem_bound():
    """K2 at 65536 rows: 537M 4-byte gathers at 32 banks x 4 B a clock on
    132 SMs at 1980 MHz take 0.064 ms."""
    got = chip_smoke.smem_bound_ms(65536 * 128 * 64, 132, 1980.0)
    assert got == pytest.approx(1e3 * 4 * 65536 * 128 * 64
                                / (132 * 128 * 1980e6))
    assert 0.0641 < got < 0.0642


def test_probe_cases_bounds():
    """The byte bounds and warp-trips the smoke prints for K2 and K3, at the
    probe's shapes and the second ones (computed on the CPU; the kernels
    run only on the card)."""
    import torch
    cases = chip_smoke.probe_cases(torch, "cpu")
    (_, k2, k2_library, k2_table), (_, k3, k3_library, k3_table) = (
        cases["lane_shuffle_sum"], cases["slab_row_sum"])
    assert k2_library is None and len(k3_library) == len(k3) == 2
    assert k2_table is None and tuple(k3_table.shape) == (6144, 512)
    (label, _, _, (b_ms, by), trips, gathers, resident) = k2[1]
    assert label == "65536x128x64" and by == "bytes"
    assert b_ms == pytest.approx(1e3 * 3 * 65536 * 128 * 4 / 3.35e12)
    assert trips == 4 * 65536 and gathers == 65536 * 128 * 64
    assert resident is None
    assert k2[0][3][0] == pytest.approx(1e3 * 3 * 256 * 512 / 3.35e12)
    # K3: the distinct slabs of the rows (8 KB each), the rows, the output
    for (label, _, _, (b_ms, by), trips, gathers, resident), n in zip(
            k3, (2048, 8192)):
        assert label.startswith(f"{n} slabs") and by == "bytes"
        assert gathers is None and trips == 2 * 256 * (n // 128)
        distinct = int(label.split("(")[1].split()[0])
        assert 500 < distinct <= 768
        assert resident == distinct * 8192
        assert b_ms == pytest.approx(1e3 * (4 * n + distinct * 8192
                                            + 8 * 512 * 4) / 3.35e12)


def test_jax_cpu_figures():
    """The JAX package's CPU figures the gates hold to (printed by
    `jax_cpu_reference.py`): every preset, the app phases and the
    runner."""
    assert set(chip_smoke.JAX_CPU) == set(chip_smoke.RUNS)
    for name, (ate_cm, blocks) in chip_smoke.JAX_CPU.items():
        assert 0.5 < ate_cm < 6.0 and blocks > 2000, name
    assert set(chip_smoke.JAX_CPU_F) == set(chip_smoke.F_RUNS)
    for name, (ate_cm, blocks) in chip_smoke.JAX_CPU_F.items():
        assert 0.5 < ate_cm < 6.0 and blocks > 2000, name
    assert chip_smoke.JAX_CPU_APP == dict(
        gt_blocks=2607, icp_ate_cm=4.03, icp_blocks=2914,
        facade_gt_blocks=2658, runner_ate_cm=2.98, runner_tracked=0.967,
        gt_triangles=606182)
    assert chip_smoke.TPU_GT_BLOCKS == 2686


def test_app_phase_gates():
    """Phases A-D: blocks within 0.5 %, ground-truth ATE below 1e-4 m, the
    ICP app's ATE gate 5.03 cm, the runner's 4.48 cm and 92 % tracked, half
    the last volume rendering shaded, the app's own flags."""
    assert chip_smoke.BLOCKS_RTOL == 0.005
    assert chip_smoke.GT_MAX_ATE_M == 1e-4
    assert chip_smoke.JAX_CPU_APP["icp_ate_cm"] \
        + chip_smoke.APP_ICP_ATE_MARGIN_CM == pytest.approx(5.03)
    assert chip_smoke.JAX_CPU_APP["runner_ate_cm"] \
        + chip_smoke.RUNNER_ATE_MARGIN_CM == pytest.approx(4.48)
    assert chip_smoke.RUNNER_MIN_TRACKED == 0.92
    assert chip_smoke.MIN_SHADED == 0.5
    assert chip_smoke.MIN_TRACKED == 88
    from supereight_tpu_torch.apps import benchmark
    args = benchmark.parse_args(["-i", "x.raw"] + chip_smoke.APP_ARGS
                                + chip_smoke.APP_ICP_START)
    assert (args.volume_size, args.volume_resolution, args.camera,
            args.preset, args.init_pose, args.rendering_rate) == (
        "4.8", "256", "240.6,240,160,120", "headline", "0.5,0.5,0.23", 4)


def test_check_blocks():
    chip_smoke.check_blocks("x", 2607 + 13, 2607)
    chip_smoke.check_blocks("x", 2607 - 13, 2607)
    with pytest.raises(SystemExit, match="0.5 %"):
        chip_smoke.check_blocks("x", 2607 + 14, 2607)


def test_check_launched():
    chip_smoke.check_launched("x", {"fuse_sdf": 96, "fuse_ofusion": 0}, 96)
    for counts, integrated in (({"fuse_sdf": 95}, 96), ({"fuse_sdf": 0}, 0),
                               ({"fuse_sdf": 95, "icp_track_reduce": 1824,
                                 "icp_update": 1824}, 96)):
        with pytest.raises(SystemExit, match="kernel"):
            chip_smoke.check_launched("x", counts, integrated)


def test_write_sequence(tmp_path):
    """The app phases' stream and trajectory, read back with the JAX
    package's readers."""
    from supereight_tpu.io import groundtruth, raw
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    rawp, gtp = chip_smoke.write_sequence(str(tmp_path), depths[:3],
                                          poses[:3])
    r = raw.RawReader(rawp)
    assert (r.width, r.height, len(r)) == (320, 240, 3)
    np.testing.assert_array_equal(r.read(2)[0], depths[2])
    got = groundtruth.read_poses(gtp)
    np.testing.assert_allclose(np.stack(got), poses[:3], rtol=0, atol=1e-6)


def test_map_output_phase_constants():
    """Phase E: the app's ground-truth command line with both map flags,
    the mesh held to the JAX CPU run's triangles within BLOCKS_RTOL (0.5 %:
    3030 of 606182), 2048 blocks meshed on the card and the CPU, and the
    largest preset's whole map meshed after its run."""
    from supereight_tpu_torch.apps import benchmark
    assert chip_smoke.MESH_HOLD_BLOCKS == 2048
    assert chip_smoke.MESH_AT_SCALE == "1024-quality"
    assert chip_smoke.MESH_AT_SCALE in chip_smoke.RUNS
    assert int(chip_smoke.BLOCKS_RTOL
               * chip_smoke.JAX_CPU_APP["gt_triangles"]) == 3030
    args = benchmark.parse_args(["-i", "x.raw"] + chip_smoke.APP_ARGS
                                + ["-c", "0", "-g", "x.gt", "-d", "E.npz",
                                   "--dump-mesh", "E.vtk"])
    assert (args.dump_volume, args.dump_mesh, args.ground_truth,
            args.rendering_rate) == ("E.npz", "E.vtk", "x.gt", 0)


def test_same_tables():
    """The smoke's table comparison: the whole map, or the first n slots
    without the ``active`` flags (what a reference binary keeps)."""
    import torch
    from supereight_tpu_torch.core import octree
    from supereight_tpu_torch.fields import SDFField
    m = octree.init(64, 4.8, SDFField().channels, "cpu", capacity=64)
    m = octree.allocate_blocks(m, torch.tensor([[1, 2, 3], [4, 0, 0]]),
                               torch.ones(2, dtype=torch.bool))
    assert chip_smoke.same_tables(torch, m, m)
    flags = m.replace(active=~m.active)
    assert not chip_smoke.same_tables(torch, flags, m)
    assert chip_smoke.same_tables(torch, flags, m, 2)
    vox = dict(m.voxels, tsdf=m.voxels["tsdf"].clone())
    vox["tsdf"][1, 7] = 0.5
    assert not chip_smoke.same_tables(torch, m.replace(voxels=vox), m, 2)
    vox["tsdf"][1, 7] = 1.0
    vox["tsdf"][5, 7] = 0.5             # past the blocks: not compared
    assert chip_smoke.same_tables(torch, m.replace(voxels=vox), m, 2)


@pytest.mark.parametrize("name", sorted(chip_smoke.G_RUNS))
def test_phase_g_runs(name):
    """Phase G's runs are JAX presets at the full size the presets run
    (``BASE``: 256^3 over 4.8 m, capacity 6144) over the base sequence,
    partitioned into their 2 ranks, each rank a slot range of 3072; the
    G1/G2 gate figures are a JAX sharded run's, its part counts summing to
    its blocks."""
    from supereight_tpu.config import PRESETS, Configuration, apply_preset
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.parallel import multihost
    preset, ranks, max_visible, frames = chip_smoke.G_RUNS[name]
    assert preset in PRESETS and ranks == 2
    assert chip_smoke.BASE["block_capacity"] // ranks == max_visible
    job = multihost.job_config(dict(preset=preset, config=chip_smoke.BASE),
                               ranks)
    want = apply_preset(preset, Configuration(**chip_smoke.BASE,
                                              map_partitions=ranks))
    assert job == SlamConfig.of(want)
    if name == "G3":
        assert frames == 4
        return
    assert frames == 96
    tracked, ate_cm, blocks, overflow, parts = chip_smoke.JAX_CPU_G[name]
    assert sum(parts) == blocks and len(parts) == ranks
    assert tracked >= chip_smoke.MIN_TRACKED


def test_kernel_line_order():
    """The JSON line lists the fifteen kernels in a fixed order: the fusion
    kernels, the gather-probe kernels, the ICP pair, the one-launch ICP,
    the frame's glue (the pyramid, the inverse, the frustum selection, the
    node update), then the raycast (R1-R4); every counter of the SLAM
    paths is one of them."""
    assert chip_smoke.KERNEL_ORDER == (
        "fuse_sdf", "fuse_ofusion", "lane_shuffle_sum", "slab_row_sum",
        "icp_track_reduce", "icp_update", "icp_track_levels",
        "build_pyramid", "pose_inv", "frustum_select", "update_nodes",
        "splat_bounds", "ray_scan", "ray_scan_second", "ray_refine_normals")
    from supereight_tpu_torch.ops import (icp_kernel, integrate_kernel,
                                          numerics_kernel, pyramid_kernel,
                                          raycast_kernel)
    assert set(chip_smoke.FUSION) | {"frustum_select", "update_nodes"} == \
        set(integrate_kernel.LAUNCHES)
    assert set(chip_smoke.ICP) == set(icp_kernel.LAUNCHES)
    assert set(chip_smoke.GLUE) == {"frustum_select", "update_nodes"} | \
        set(pyramid_kernel.LAUNCHES) | set(numerics_kernel.LAUNCHES)
    assert chip_smoke.RAYCAST == tuple(raycast_kernel.LAUNCHES) == \
        chip_smoke.KERNEL_ORDER[-4:]
    assert set(chip_smoke.RAYCAST_REPLACES) == set(chip_smoke.RAYCAST)
    assert set(chip_smoke.launches()) == set(chip_smoke.FUSION) | \
        set(chip_smoke.ICP) | set(chip_smoke.GLUE) | set(chip_smoke.RAYCAST)


def test_kernels_line_marks_merged_launches():
    """The kernels line's ``launches_counted_in``: R2's entry under the
    merged scan, the node update's under both fusion kernels (it runs in
    their launches), each naming entries of the line; a fusion map's node
    update (``fusion_map`` at 64^3 on the CPU: live blocks, random node
    tables) equals ``update_nodes_twin`` through the fusion's ``nodes``."""
    import torch
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.fields import OFusionField, SDFField
    from supereight_tpu_torch.ops import integrate_kernel as ik
    from supereight_tpu_torch.pipeline import camera, preprocessing
    assert chip_smoke.LAUNCHES_COUNTED_IN == {
        "ray_scan": "ray_scan_second",
        "update_nodes": ["fuse_sdf", "fuse_ofusion"]}
    for name, inside in chip_smoke.LAUNCHES_COUNTED_IN.items():
        inside = [inside] if isinstance(inside, str) else inside
        assert name in chip_smoke.KERNEL_ORDER
        assert set(inside) <= set(chip_smoke.KERNEL_ORDER) - {name}
    assert chip_smoke.LAUNCHES_COUNTED_IN["update_nodes"] == \
        list(chip_smoke.FUSION)
    torch.set_num_threads(1)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    k = chip_smoke.K / 2
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(depths[30][::2, ::2].astype(np.int32)), (120, 160))
    pose = torch.from_numpy(poses[30])
    Km = camera.camera_matrix(torch.from_numpy(k)).contiguous()
    T_cw = numerics.inv(pose)
    for field in (SDFField(mu=0.1), OFusionField(mu=0.008, voxel_size=0.075)):
        m = chip_smoke.fusion_map(torch, 64, field, "cpu", 2, depth, pose, Km)
        assert int(m.n_blocks) > 10 and m.block_level == 3
        kept = chip_smoke.clone_tables(m)
        params = (field.mu, field.max_weight) if field.name == "sdf" else \
            (field.mu, field.sigma_lo, 0.5)
        fn = ik.fuse_sdf if field.name == "sdf" else ik.fuse_ofusion
        got = fn(m, depth, T_cw, Km, *params, nodes=True)
        want = ik.update_nodes_twin(kept, field, depth, T_cw, Km,
                                    params[-1] if field.name != "sdf"
                                    else 0.0)
        changed = 0
        for level in range(1, m.block_level + 1):
            for n in want[level]:
                assert torch.equal(got[level][n], want[level][n])
                changed += int((want[level][n]
                                != kept.node_values[level][n]).sum())
        assert changed > 0


def test_glue_holds_on_the_cpu():
    """The glue holds' CPU half (the kernels run only on the card): the
    frustum selection of a warmed 64^3 map at a budget its candidates
    overflow and at one they do not, the node update on random node tables
    of both fields, the helpers' bit comparison, and the launch gates."""
    import torch
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.fields import OFusionField, SDFField
    from supereight_tpu_torch.pipeline import DenseSLAMSystem, camera
    torch.set_num_threads(1)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    cfg = SlamConfig(volume_size=(4.8,) * 3, volume_resolution=(64,) * 3,
                     compute_size_ratio=2, block_capacity=1024)
    slam = DenseSLAMSystem((240, 320), cfg, "cpu")
    slam.setPose(poses[0])
    k = chip_smoke.K / 2
    for f in range(4):
        slam.step(depths[f], k, f)
    m = slam.state.map
    T_cw = numerics.inv(slam.state.pose)
    Km = camera.camera_matrix(torch.from_numpy(k)).contiguous()
    pose = slam.state.pose
    cand, timed = chip_smoke.hold_select(torch, "x", m, pose, Km, (120, 160),
                                         1000)
    assert cand > 10 and timed is None
    assert chip_smoke.hold_select(torch, "x", m, pose, Km, (120, 160),
                                  cand // 2)[0] == cand
    depth = slam.state.float_depth
    for field in (SDFField(mu=0.1), OFusionField(mu=0.008, voxel_size=0.075)):
        nm = chip_smoke.node_map(torch, 64, field, "cpu", 1)
        err, timed = chip_smoke.hold_nodes(torch, "x", nm, field,
                                           (depth, T_cw, Km), 0.1)
        assert err == 0.0 and timed is None
    a = torch.tensor([1.0, float("nan"), -0.0])
    assert chip_smoke.bits_err(torch, a, a.clone()) == (0.0, True)
    assert chip_smoke.bits_err(torch, a, torch.tensor(
        [1.5, float("nan"), 0.0])) == (0.5, False)
    # the budget branch's inverse is inside the selection's launch and the
    # tracking view's inside icp_track_levels': the inverse counts the
    # whole-table fusions
    counts = dict(build_pyramid=10, pose_inv=0, update_nodes=9,
                  frustum_select=9, fuse_sdf=9)
    qcfg = chip_smoke.preset_config("quality")
    chip_smoke.check_glue_launched(
        "x", {**counts, "pose_inv": 9, "frustum_select": 0}, qcfg, 10, 9)
    with pytest.raises(SystemExit, match="launched"):
        chip_smoke.check_glue_launched(
            "x", {**counts, "pose_inv": 8, "frustum_select": 0}, qcfg, 10,
            9)
    hcfg = chip_smoke.preset_config("headline")
    chip_smoke.check_glue_launched("x", counts, hcfg, 10, 9)
    chip_smoke.check_glue_launched("x", {**counts, "build_pyramid": 12,
                                         "pose_inv": 3}, hcfg, 10, 9)
    for bad in (dict(build_pyramid=9), dict(update_nodes=10, fuse_sdf=10),
                dict(frustum_select=8), dict(frustum_select=10)):
        with pytest.raises(SystemExit, match="launched"):
            chip_smoke.check_glue_launched("x", {**counts, **bad}, hcfg, 10, 9)
    # the node update counts once inside each fusion launch
    for bad in (dict(fuse_sdf=8), dict(fuse_ofusion=1)):
        with pytest.raises(SystemExit, match="inside"):
            chip_smoke.check_glue_launched("x", {**counts, **bad}, hcfg, 10, 9)


def test_icp_hold_covers_the_headline():
    """The ICP hold: the headline's three level shapes (its finest level
    strided by its icp_finest_decimate) and a rank's strip of 2, every knob
    group once, ``icp_track_levels``' two level sets (the headline's and
    the whole 320x240 finest level), the stated tolerances, and the
    launches a run must show: one ``icp_track_levels`` launch a frame with
    ICP and no pair on one device; the pair every trip of every level and
    no ``icp_track_levels`` on a rank."""
    import dataclasses
    cfg = chip_smoke.preset_config("headline")
    assert cfg.pyramid == (10, 5, 4) and cfg.icp_finest_decimate == 2
    levels = {(lv, d) for lv, d, _ in chip_smoke.ICP_SHAPES.values()}
    assert levels == {(2, 1), (1, 1), (0, cfg.icp_finest_decimate)}
    assert [s for _, _, s in chip_smoke.ICP_SHAPES.values()].count(
        (1, 2)) == 1
    assert chip_smoke.ICP_MAIN in chip_smoke.ICP_SHAPES
    groups = {(k["assoc"], k["symmetric"], k["robust"])
              for k in chip_smoke.ICP_KNOBS}
    assert len(groups) == len(chip_smoke.ICP_KNOBS) == 18
    assert chip_smoke.ICP_KNOBS[0] == dict(assoc="nearest", symmetric="off",
                                           robust="none", robust_delta=0.01)
    assert (chip_smoke.ICP_SUM_RTOL, chip_smoke.ICP_SUM_MAG,
            chip_smoke.ICP_UPDATE_ATOL, chip_smoke.ICP_TRACK_ATOL,
            chip_smoke.ICP_TRACK_FLIPS) == (1e-5, 1e-6, 1e-6, 1e-4, 1e-3)
    assert chip_smoke.FP32_EPS == np.finfo(np.float32).eps
    assert chip_smoke.ICP_LEVEL_SETS == {
        "headline": cfg.icp_finest_decimate, "320x240": 1}
    assert chip_smoke.icp_expected(cfg, 96) == (96 * 19, 96 * 3)
    assert chip_smoke.icp_expected(
        dataclasses.replace(cfg, tracking_rate=2), 96) == (48 * 19, 48 * 3)
    assert chip_smoke.icp_expected(
        dataclasses.replace(cfg, pyramid=(10, 5, 0)), 96) == (96 * 15,
                                                              96 * 2)
    assert chip_smoke.icp_frames(cfg, 96) == 96
    assert chip_smoke.icp_frames(
        dataclasses.replace(cfg, tracking_rate=3), 96) == 32
    counts = lambda a, b, n: {"icp_track_reduce": a, "icp_update": b,
                              "icp_track_levels": n}
    chip_smoke.check_icp_launched("x", counts(0, 0, 96), 96)
    chip_smoke.check_icp_launched("x", counts(0, 0, 5))
    for a, b, n, want in ((0, 0, 95, 96), (1, 1, 96, 96), (0, 0, 0, None),
                          (1824, 1824, 0, 96)):
        with pytest.raises(SystemExit, match="icp_track_levels once"):
            chip_smoke.check_icp_launched("x", counts(a, b, n), want)
    chip_smoke.check_icp_pair_launched("x", counts(1824, 288, 0),
                                       (1824, 288))
    for a, b, n in ((1824, 1824, 0), (1824, 287, 0), (1805, 288, 0),
                    (1824, 288, 1)):
        with pytest.raises(SystemExit, match="ICP kernels every trip"):
            chip_smoke.check_icp_pair_launched("x", counts(a, b, n),
                                               (1824, 288))


def test_icp_hold_on_the_cpu(monkeypatch):
    """The hold's CPU half on the twins (the kernels run only on the card):
    the operands of a warmed headline frame, every shape held in two knob
    groups, and the byte count of kernel A's bound: the level's maps, the
    status image and the sums, plus the distinct reference rows reached (at
    most one a pixel nearest, four bilinear)."""
    import torch
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "ICP_FRAME", 6)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    ops = chip_smoke.icp_operands(torch, depths, poses, "cpu")
    for shape in chip_smoke.ICP_SHAPES:
        iv, inm = chip_smoke.icp_level(ops, shape)
        n = iv.shape[0] * iv.shape[1]
        fixed = n * 28 + 29 * 4 + 2 * 64 + 5
        for knobs, most in ((chip_smoke.ICP_KNOBS[0], 1),
                            (chip_smoke.ICP_KNOBS[-1], 4)):
            sum_err, upd_err, n_ok, to_exact = chip_smoke.hold_icp(
                torch, ops, shape, knobs)
            assert (sum_err, upd_err) == (0.0, 0.0) and n_ok > 0.1 * n
            assert to_exact[0] == to_exact[1] < 1e-4
            extra = chip_smoke.icp_bytes(torch, ops, iv, inm, knobs) - fixed
            assert 24 * n_ok // 4 <= extra <= 24 * most * n


def test_icp_levels_hold_on_the_cpu(monkeypatch):
    """``icp_track_levels``' hold, its CPU half on the twin (the kernel runs
    only on the card): both level sets in two knob groups, the trips each
    level runs, and its bound's byte count: every level's maps, the
    finest status image and the carry, plus the distinct reference rows
    reached (at least those of the finest level)."""
    import torch
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "ICP_FRAME", 6)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    ops = chip_smoke.icp_operands(torch, depths, poses, "cpu")
    cfg = ops["cfg"]
    for level_set, d in chip_smoke.ICP_LEVEL_SETS.items():
        levels = chip_smoke.icp_level_set(ops, d)
        assert levels[0][0].shape[:2] == (240 // d, 320 // d)
        for knobs in (chip_smoke.ICP_KNOBS[0], chip_smoke.ICP_KNOBS[-1]):
            sum_err, pose_err, flips, n_ok, (k_it, t_it) = \
                chip_smoke.hold_icp_levels(torch, ops, level_set, knobs)
            assert (sum_err, pose_err, flips) == (0.0, 0.0, 0)
            assert n_ok > 0.1 * levels[0][0].numel() // 3
            assert k_it == t_it and 1 <= k_it <= cfg.pyramid[0]
        trips = chip_smoke.level_trips(torch, ops, levels, cfg.pyramid,
                                       cfg.icp_threshold)
        assert all(1 <= t <= n for t, n in zip(trips, cfg.pyramid))
        n_px = [iv.shape[0] * iv.shape[1] for iv, _ in levels]
        fixed = 24 * sum(n_px) + 4 * n_px[0] + 80 + 144
        extra = chip_smoke.icp_levels_bytes(
            torch, ops, levels, chip_smoke.ICP_KNOBS[0]) - fixed
        finest = chip_smoke.icp_bytes(torch, ops, *levels[0],
                                      chip_smoke.ICP_KNOBS[0]) \
            - 28 * n_px[0] - 29 * 4 - 2 * 64 - 5
        assert finest <= extra <= 24 * sum(n_px)


def test_solve_tolerance():
    """Kernel B's twist tolerance: ICP_UPDATE_ATOL plus 2 eps cond(JTJ)
    |x| of the sums' system, with its float64 solve."""
    import torch
    from supereight_tpu_torch.ops import icp_kernel
    A = np.diag([1.0, 2.0, 4.0, 8.0, 16.0, 100.0]).astype(np.float32)
    b = np.array([1, 2, 4, 8, 16, 50], np.float32)
    sums = icp_kernel.pack_sums(torch.tensor(3.0), torch.from_numpy(b),
                                torch.from_numpy(A), torch.tensor(9.0))
    tol, x = chip_smoke.solve_tolerance(torch, sums)
    np.testing.assert_allclose(x.numpy(), [1, 1, 1, 1, 1, 0.5])
    assert tol == pytest.approx(1e-6 + 2 * 2.0 ** -23 * 100.0 * 1.0)


def test_stage_times_print_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.print_stage_times`` on the CPU at a small size: the
    stages' medians, then each span's median host and self ms, every
    stage's span once a frame."""
    import torch
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.probes import stage_times
    torch.set_num_threads(1)
    monkeypatch.setattr(stage_times, "SKIP", 2)
    monkeypatch.setattr(chip_smoke, "K", chip_smoke.K / 2)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    cfg = SlamConfig(volume_size=(4.8,) * 3, volume_resolution=(64,) * 3,
                     compute_size_ratio=2, block_capacity=1024)
    chip_smoke.print_stage_times("small", cfg, depths[:5], poses, "cpu")
    stages, spans = capsys.readouterr().out.strip().splitlines()
    assert stages.startswith("# small: median ms per stage")
    for n in ("preprocessing", "tracking", "integration", "raycasting",
              "total"):
        assert f" {n} " in stages
    assert spans.startswith("# small: spans of a step run")
    for n in ("preprocessing", "tracking", "integration", "raycasting"):
        assert f"se.{n}.stage " in spans
        assert spans.split(f"se.{n}.stage ")[1].split(")")[0] \
            .endswith("(5")


def test_step_run_on_the_cpu(monkeypatch):
    """``probes/stage_times.step_run`` on the CPU at a small size: the
    ``step`` median after SKIP frames and the run's outcome, the counts
    those of the system's own state."""
    import torch
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    from supereight_tpu_torch.probes import stage_times
    torch.set_num_threads(1)
    monkeypatch.setattr(stage_times, "SKIP", 2)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    cfg = SlamConfig(volume_size=(4.8,) * 3, volume_resolution=(64,) * 3,
                     compute_size_ratio=2, block_capacity=1024)
    slam = DenseSLAMSystem((240, 320), cfg, "cpu")
    slam.setPose(poses[0])
    r = stage_times.step_run(slam, depths[:5], poses, chip_smoke.K / 2,
                             chip_smoke.ate_rmse)
    assert r["step"] > 0 and 1 <= r["tracked"] <= 5
    assert r["blocks"] == int(slam.state.map.n_blocks) > 0
    assert r["overflow"] == 0 and 0 <= r["ate_cm"] < 5


def _twins_for_kernels(monkeypatch):
    """The raycast kernels' wrappers replaced by their twins (the merged
    scan's by ``ray_scan_windows_twin``), each counting its launches as
    the kernels do: the hold's plumbing runs on the CPU."""
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import raycast as rc

    def counted(name, fn):
        def run(*args, **kwargs):
            rk.LAUNCHES[name] += 1
            return fn(*args, **kwargs)
        return run

    def scan(*args):
        rk.LAUNCHES["ray_scan"] += 1
        if len(args) > 8 and (args[8] or args[10]):
            rk.LAUNCHES["ray_scan_second"] += 1
        return rc.ray_scan_windows_twin(*args)._replace(need2=None,
                                                        z_start=None)

    stand_in = dict(splat_bounds=counted("splat_bounds",
                                         rc._splat_bounds_twin),
                    ray_scan=scan,
                    ray_refine_normals=counted("ray_refine_normals",
                                               rc.ray_refine_normals_twin))
    for name, fn in stand_in.items():
        monkeypatch.setattr(rk, name, fn)
    monkeypatch.setattr(rc, "_PHASES", dict(
        splat=stand_in["splat_bounds"], scan=stand_in["ray_scan"],
        finish=stand_in["ray_refine_normals"]))


@pytest.mark.parametrize("preset", ["headline", "ofusion"])
def test_raycast_hold_on_the_cpu(monkeypatch, preset):
    """The raycast phase's CPU form: ``hold_raycast`` in every knob group
    of RAYCAST_MODES / RAYCAST_OF_MODES on a warmed 64^3 map at 320x240,
    with the twins standing in for the kernels (the kernels run only on
    the card): the phases compose, each launch is counted once a raycast
    (R3's count only with the second window or the midsolve), the budget
    group cuts the second window, the strip is rank 1's of 2, and the
    run's own raycast holds as ``check_path_raycast`` holds it."""
    import dataclasses
    import torch
    from supereight_tpu_torch.pipeline import camera, raycast
    torch.set_num_threads(1)
    _twins_for_kernels(monkeypatch)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    cfg = chip_smoke.preset_config(preset)
    cfg = dataclasses.replace(cfg, volume_resolution=(64,) * 3,
                              block_capacity=1024,
                              integrate_budget=min(cfg.integrate_budget,
                                                   1024))
    slam = chip_smoke.warm_map(cfg, depths, poses, "cpu", 6)
    st = slam.state
    view = st.pose @ camera.inverse_camera_matrix(
        torch.from_numpy(chip_smoke.K))
    dense = {"F": st.view} if st.view is not None else \
        raycast.pack_view(st.map, slam.field)
    modes = chip_smoke.RAYCAST_MODES if preset == "headline" else \
        chip_smoke.RAYCAST_OF_MODES
    normals = set()
    for mode, knobs in modes.items():
        r, need2 = chip_smoke.hold_raycast(torch, mode, st.map, slam.field,
                                           view, dense, knobs)
        assert set(r) == set(chip_smoke.RAYCAST)
        assert all(t["max_abs_err"] == 0.0 for t in r.values())
        normals.add((knobs["normals"], knobs.get("refine", "secant")))
        if knobs.get("w2_budget") == chip_smoke.RAYCAST_BUDGET:
            assert need2 > chip_smoke.RAYCAST_BUDGET
        if "row_range" in knobs:
            assert knobs["row_range"] == (120, 120) and knobs["inside"]
    kernels = {n: dict(max_abs_err=0.0) for n in chip_smoke.RAYCAST}
    chip_smoke.check_path_raycast(torch, preset, slam, cfg, kernels)
    if preset == "headline":
        # every normals and refine mode of the presets and of phase F
        runs = [chip_smoke.preset_config(p) for p in chip_smoke.RUNS] + \
            [chip_smoke.f_config(f) for f in chip_smoke.F_RUNS]
        sdf = {(c.raycast_normals, c.raycast_refine) for c in runs
               if c.field_type == "sdf"}
        assert sdf <= normals


def test_raycast_work_counts_this_data():
    """``raycast_work`` at the timed knob group (hybrid normals at
    ``grad_decim`` 2) on a warmed 64^3 map: R2's samples are each ray's
    count up to its first valid outside -> inside crossing (the window on
    a miss, none when inactive), counted here ray by ray; the merged
    launch's (R2 with R3) those and the second windows of the rays the
    budget ranks; R4's taps are the secant pair of each pixel whose parent
    hit and the 6 gradient taps of each decimated parent that hit."""
    import dataclasses
    import torch
    from supereight_tpu_torch.pipeline import camera, raycast as rc
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    torch.set_num_threads(1)
    depths, poses = chip_smoke.load_sequence("synthetic_256_frames")
    cfg = dataclasses.replace(chip_smoke.preset_config("headline"),
                              volume_resolution=(64,) * 3,
                              block_capacity=1024, integrate_budget=1024)
    slam = chip_smoke.warm_map(cfg, depths, poses, "cpu", 6)
    m, field = slam.state.map, slam.field
    view = slam.state.pose @ camera.inverse_camera_matrix(
        torch.from_numpy(chip_smoke.K))
    dense = rc.pack_view(m, field)
    k = chip_smoke._full_knobs(chip_smoke.RAYCAST_MODES[
        "hybrid gd2 near_rescue (headline)"])
    plan = rc.scan_plan(m, field, 240, 320, NEAR_PLANE, FAR_PLANE,
                        k["span_factor"], k["scan_stride"], False)
    tmin, tmax, g = rc._splat_bounds_twin(m, field, view, 240, 320,
                                          NEAR_PLANE, FAR_PLANE)
    s1 = rc.ray_scan_twin(m, dense, field, view, plan, tmin, tmax, g)
    s2 = rc.ray_scan_second_twin(m, dense, field, view, plan, s1, True,
                                 k["w2_budget"], False)
    fin = rc.ray_refine_normals_twin(m, dense, field, view, plan, s2.z,
                                     s2.hit, "secant", "hybrid", 2)
    work = chip_smoke.raycast_work(torch, m, dense, field, view, plan, k,
                                   s1, s2, tmin, g, fin, 0)

    origin, _, fd = rc._scan_dirs(view, plan)
    nF = plan.n_fine + 1
    rays = s1.hit.numel()

    def by_ray(z0, dirs):
        z = z0[None] + (plan.fine_span / plan.n_fine) * torch.arange(
            nF, dtype=torch.float32).reshape((nF,) + (1,) * z0.ndim)
        f, _ = rc._sample_volume(dense["F"], (origin + dirs[None]
                                              * z[..., None])
                                 * m.inverse_voxel_size, m.size,
                                 float("nan"))
        f = f.reshape(nF, -1).numpy()
        total = 0
        for r in range(f.shape[1]):
            last, n = None, nF
            for j in range(nF):
                if np.isnan(f[j, r]):
                    continue
                inside = bool(field.is_inside(torch.tensor(f[j, r])))
                if inside and last is False:
                    n = j + 1
                    break
                last = inside
            total += n
        return total

    active = torch.isfinite(tmin.repeat_interleave(g // 2, 0)
                            .repeat_interleave(g // 2, 1))
    a = active.reshape(-1)
    n1 = by_ray(s1.z_start.reshape(-1)[a], fd.reshape(-1, 3)[a])
    assert work["ray_scan"][1] == chip_smoke.RAY_FLOPS[True] * rays \
        + chip_smoke.SAMPLE_FLOPS * n1
    idx = torch.nonzero(s1.need2.reshape(-1))[:, 0][:k["w2_budget"]]
    assert idx.numel() > 0
    n2 = by_ray((s1.z_start + plan.fine_span).reshape(-1)[idx],
                fd.reshape(-1, 3)[idx])
    assert work["ray_scan_second"][1] == chip_smoke.RAY_FLOPS[True] * rays \
        + chip_smoke.SAMPLE_FLOPS * (n1 + n2)
    taps = 2 * 4 * int(s2.hit.sum()) + 6 * int(s2.hit[::2, ::2].sum())
    assert work["ray_refine_normals"][1] == \
        chip_smoke.PIXEL_FLOPS * fin.hit.numel() + chip_smoke.TAP_FLOPS * taps
    assert work["ray_refine_normals"][0] == 2 * taps + 76800 * 29 + rays * 5


def test_raycast_launch_gates():
    """``check_raycast_launched``: R1, R2 and R4 once a raycast, R3 once a
    raycast with the second window or the midsolve, and some raycast."""
    ok = dict(splat_bounds=5, ray_scan=5, ray_scan_second=5,
              ray_refine_normals=5)
    chip_smoke.check_raycast_launched("ok", ok, 5)
    chip_smoke.check_raycast_launched("ok", dict(ok, ray_scan_second=0), 5,
                                      second=False)
    for bad, n in ((dict(ok, ray_scan=4), 5), (ok, 6), (ok, 0),
                   (dict(ok, ray_scan_second=0), 5)):
        with pytest.raises(SystemExit):
            chip_smoke.check_raycast_launched("bad", bad, n)


def test_counting_raycasts():
    """``counting_raycasts`` counts the calls of ``raycast.raycast`` made
    through the module (the stage's and the renderers') and restores it."""
    from supereight_tpu_torch.pipeline import raycast
    inner = raycast.raycast
    with chip_smoke.counting_raycasts() as calls:
        with pytest.raises(ValueError):
            raycast.raycast(None, None, None, 1, 1, 0.1, 1.0,
                            normals="none of them")
    assert calls == [1] and raycast.raycast is inner
