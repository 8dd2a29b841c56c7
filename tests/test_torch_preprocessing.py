"""Preprocessing, camera and SDF-update parity of the PyTorch port against
the JAX package, on the cached bench frames.  Masks (INVALID normals,
depth-valid pixels) must match bit for bit; floats within 1e-6, except
the metric depth, the pyramid's depths, vertices and normals and the SDF
update, which equal the jitted JAX functions bit for bit, as the JAX system
runs them (the port rounds as XLA's CPU code does: multiply-adds where XLA
contracts, products with a constant divisor's reciprocal, correctly
rounded roots)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu.pipeline.constants import INVALID
from supereight_tpu_torch.fields import SDFField
from supereight_tpu_torch.pipeline import camera, preprocessing

from torch_port_util import K_FULL, load_frames

torch.set_num_threads(1)
ATOL = 1e-6


@pytest.fixture(scope="module")
def frames():
    return load_frames()


@pytest.mark.parametrize("ratio", [1, 2])
def test_mm_to_meters_matches_jax(frames, ratio):
    """Against the jitted JAX function, as the JAX system runs it (XLA
    multiplies by float32(1/1000) there)."""
    d = frames[0][5]
    hw = (240 // ratio, 320 // ratio)
    want = np.asarray(jax.jit(jpre.mm_to_meters, static_argnums=1)(
        jnp.asarray(d), hw))
    got = preprocessing.mm_to_meters(torch.from_numpy(d.astype(np.int32)),
                                     hw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sequence,frame,ratio,neg_y", [
    ("synthetic_256_frames", 0, 2, False),
    ("synthetic_256_frames", 40, 2, True),
    ("synthetic_256_frames", 90, 1, False),
    ("synthetic_256_frames_noisy", 10, 1, False)])
def test_build_pyramid_matches_jax(sequence, frame, ratio, neg_y):
    """Against the jitted JAX pyramid, bit for bit at every level."""
    H, W = 240 // ratio, 320 // ratio
    depth = np.asarray(jpre.mm_to_meters(
        jnp.asarray(load_frames(sequence)[0][frame]), (H, W)))
    depth = depth.copy()
    depth[H // 3:H // 2, W // 4:W // 3] = 0.0      # a hole: invalid pixels
    k = K_FULL / ratio
    jd, jv, jn = jpre.build_pyramid(jnp.asarray(depth), jnp.asarray(k), 3,
                                    neg_y=neg_y)
    td, tv, tn = preprocessing.build_pyramid(
        torch.from_numpy(depth), torch.from_numpy(k), 3, neg_y=neg_y)
    for level in range(3):
        want_d, got_d = np.asarray(jd[level]), td[level].numpy()
        assert (want_d > 0).any() and not (want_d > 0).all()
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(tv[level].numpy(),
                                      np.asarray(jv[level]))
        want_n, got_n = np.asarray(jn[level]), tn[level].numpy()
        invalid = want_n[..., 0] == INVALID
        assert invalid.any() and not invalid.all()
        np.testing.assert_array_equal(got_n, want_n)


@pytest.mark.parametrize("sequence,frame,ratio", [
    ("synthetic_256_frames_noisy", 10, 2),
    ("synthetic_256_frames_noisy", 60, 1),
    ("synthetic_256_frames", 40, 2)])
def test_bilateral_filter_matches_jax(sequence, frame, ratio):
    """Within 1e-6 relative; zero depth stays exactly 0 (a hole and the
    sequence's own dropouts)."""
    H, W = 240 // ratio, 320 // ratio
    depth = np.asarray(jpre.mm_to_meters(
        jnp.asarray(load_frames(sequence)[0][frame]), (H, W))).copy()
    depth[H // 3:H // 2, W // 4:W // 3] = 0.0
    want = np.asarray(jpre.bilateral_filter(jnp.asarray(depth)))
    got = preprocessing.bilateral_filter(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_array_equal(got == 0, depth == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.abs(want - depth).max() > 1e-3          # it does filter
    np.testing.assert_array_equal(
        preprocessing.gaussian_weights().numpy(),
        np.asarray(jpre.gaussian_weights()))


def test_se3_exp_matches_jax():
    rng = np.random.default_rng(0)
    twists = [rng.normal(0, s, 6).astype(np.float32)
              for s in (1e-9, 1e-7, 1e-3, 0.1, 1.0)]
    twists.append(np.zeros(6, np.float32))
    for x in twists:
        want = np.asarray(jcam.se3_exp(jnp.asarray(x)))
        got = camera.se3_exp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_camera_matrices_match_jax():
    k = K_FULL / 2
    np.testing.assert_array_equal(
        camera.camera_matrix(torch.from_numpy(k)).numpy(),
        np.asarray(jcam.camera_matrix(jnp.asarray(k))))
    np.testing.assert_allclose(
        camera.inverse_camera_matrix(torch.from_numpy(k)).numpy(),
        np.asarray(jcam.inverse_camera_matrix(jnp.asarray(k))),
        rtol=0, atol=ATOL)


def test_sdf_update_matches_jax():
    rng = np.random.default_rng(1)
    n = 4096
    pos = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(-0.5, 4, n)], -1).astype(np.float32)
    pos[:16, 2] = 0.0                                  # z == 0 guard
    ds = (pos[:, 2] + rng.uniform(-0.3, 0.3, n)).astype(np.float32)
    ds[rng.random(n) < 0.1] = 0.0
    valid = rng.random(n) < 0.9
    data = {"tsdf": rng.uniform(-1, 1, n).astype(np.float32),
            "weight": rng.integers(0, 101, n).astype(np.float32)}
    # the jitted update, as the JAX system runs it: the port rounds as XLA
    # does (multiply-adds, a product with 1/mu)
    update = jax.jit(lambda d, p, s, v: JaxSDF(mu=0.1).update(d, p, s, v,
                                                              0.0))
    want = update({k: jnp.asarray(v) for k, v in data.items()},
                  jnp.asarray(pos), jnp.asarray(ds), jnp.asarray(valid))
    got = SDFField(mu=0.1).update({k: torch.from_numpy(v)
                                   for k, v in data.items()},
                                  torch.from_numpy(pos), torch.from_numpy(ds),
                                  torch.from_numpy(valid))
    for name in ("tsdf", "weight"):
        w, g = np.asarray(want[name]), got[name].numpy()
        np.testing.assert_array_equal(g != data[name], w != data[name])
        np.testing.assert_array_equal(g, w)
    assert (got["weight"].numpy() == 100.0).any()      # the weight cap
