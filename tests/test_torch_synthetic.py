"""The port's synthetic sequence generator against the JAX package's: the
pose and sensor-noise functions bit for bit; the analytic scene and its
sphere trace (PyTorch here, jitted XLA there) at 60x80 on 4 orbit poses
and both scene variants.

Measured at this commit: every millimetre pixel equal, and the metric
depths equal but for 1-3 ulp away from silhouettes (largest difference
2.4e-7 m) and up to 1e-4 m at silhouette pixels, where the 160-step trace
ends in a different step.  The tolerances below are those, with room."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.io import synthetic as jsyn
from supereight_tpu_torch.io import synthetic

torch.set_num_threads(1)

H, W = 60, 80
K = np.asarray([120.0 * W / 320, 120.0 * H / 240, W / 2, H / 2], np.float32)
MM_EQUAL = 0.999          # share of equal millimetre pixels
MAX_OFF_SILHOUETTE = 1e-6  # m, away from depth jumps
MAX_DIFF = 1e-3            # m, anywhere
JUMP = 0.1                 # m between neighbours: a silhouette pixel


def test_pose_functions_bit_exact():
    for n in (1, 12, 96):
        np.testing.assert_array_equal(synthetic.orbit_poses(n, 4.8),
                                      jsyn.orbit_poses(n, 4.8))
        np.testing.assert_array_equal(synthetic.translation_poses(n, 4.8),
                                      jsyn.translation_poses(n, 4.8))
    np.testing.assert_array_equal(
        synthetic.orbit_poses(20, 5.0, radius=0.8, sweep=2.0),
        jsyn.orbit_poses(20, 5.0, radius=0.8, sweep=2.0))
    base = jsyn.orbit_poses(10, 4.8)
    np.testing.assert_array_equal(synthetic.jitter_poses(base, seed=3),
                                  jsyn.jitter_poses(base, seed=3))
    assert synthetic.DEFAULT_K == jsyn.DEFAULT_K
    assert synthetic.MARGIN == jsyn.MARGIN


def test_sensor_noise_bit_exact():
    rng = np.random.default_rng(0)
    d = rng.integers(300, 6000, (H, W)).astype(np.uint16)
    d[rng.random((H, W)) < 0.1] = 0
    for seed in (0, 5):
        got = synthetic.apply_sensor_noise(d, seed)
        np.testing.assert_array_equal(got, jsyn.apply_sensor_noise(d, seed))
        assert got.dtype == np.uint16 and (got != d).mean() > 0.5


@pytest.mark.parametrize("variant", [0, 1])
def test_scene_sdf_matches(variant):
    p = np.random.default_rng(variant).uniform(0, 4.8, (20000, 3)) \
        .astype(np.float32)
    want = np.asarray(jsyn.scene_sdf(jnp.asarray(p), 4.8, variant))
    got = synthetic.scene_sdf(torch.from_numpy(p), 4.8, variant).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want < 0).any() and (want > 0).any()


def _silhouette(depth):
    pad = np.pad(depth, 1, mode="edge")
    jumps = [np.abs(pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W] - depth)
             for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1))]
    return np.max(jumps, axis=0) > JUMP


@pytest.mark.parametrize("variant", [0, 1])
def test_render_depth_matches(variant):
    mm_equal = []
    for pose in jsyn.orbit_poses(4, 4.8):
        want = np.asarray(jsyn.render_depth(jnp.asarray(pose),
                                            jnp.asarray(K), 4.8, H, W,
                                            variant=variant))
        got = synthetic.render_depth(torch.from_numpy(pose),
                                     torch.from_numpy(K), 4.8, H, W,
                                     variant=variant).numpy()
        assert got.dtype == np.float32 and got.shape == (H, W)
        np.testing.assert_array_equal(got > 0, want > 0)
        assert (want > 0).mean() > 0.9
        diff = np.abs(got - want)
        sil = _silhouette(want)
        assert sil.any() and not sil.all()
        assert diff[~sil].max() <= MAX_OFF_SILHOUETTE
        assert diff.max() <= MAX_DIFF
        to_mm = lambda d: np.clip(d * 1000.0, 0, 65535).astype(np.uint16)
        mm_equal.append((to_mm(got) == to_mm(want)).mean())
    assert min(mm_equal) >= MM_EQUAL


def test_write_dataset_matches(tmp_path):
    """The files of a 3-frame noisy sequence, byte for byte."""
    jsyn.write_dataset(str(tmp_path / "j"), 3, H=H, W=W, noise=True)
    rawp, gtp, k = synthetic.write_dataset(str(tmp_path / "t"), 3, H=H, W=W,
                                           noise=True, device="cpu")
    assert (rawp, gtp) == (str(tmp_path / "t.raw"), str(tmp_path / "t.gt"))
    assert (tmp_path / "t.gt").read_text() == (tmp_path / "j.gt").read_text()
    assert (tmp_path / "t.raw").read_bytes() == \
        (tmp_path / "j.raw").read_bytes()
    np.testing.assert_array_equal(k, np.asarray(K))
