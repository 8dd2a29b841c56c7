"""``chip_smoke.py``'s own checks, runnable without a card: its ATE agrees
with ``supereight_tpu.apps.evaluate.ate`` (to 1e-9 m), and without CUDA it
exits non-zero and prints no result."""

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


def test_fails_without_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
