"""``chip_smoke.py``'s own checks, runnable without a card: its ATE agrees
with ``supereight_tpu.apps.evaluate.ate`` (to 1e-9 m), its runs are the
configurations of the JAX records they are held against, its gates are the
JAX package's CPU figures plus the stated margins, and without CUDA it exits
non-zero and prints no result."""

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
    assert k2_library is None and k3_library is not None
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
    assert chip_smoke.JAX_CPU_APP == dict(
        gt_blocks=2607, icp_ate_cm=4.03, icp_blocks=2914,
        facade_gt_blocks=2658, runner_ate_cm=2.98, runner_tracked=0.967)
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
    for counts, integrated in (({"fuse_sdf": 95}, 96), ({"fuse_sdf": 0}, 0)):
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
