"""``chip_smoke.py``'s own checks, runnable without a card: its ATE agrees
with ``supereight_tpu.apps.evaluate.ate`` (to 1e-9 m), its runs are the
configurations of the JAX records they are held against, and without CUDA
it exits non-zero and prints no result."""

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
    got = chip_smoke.ate_rmse(est[:, :3, 3], gt[:, :3, 3])
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
    is held against, on the record's sequence at its size, and the ATE gate
    lies at most ~2 cm above the record."""
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
    assert rec["ate_rmse_m"] < max_ate <= rec["ate_rmse_m"] + 0.0215
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
