"""The measured-negative variants of the PyTorch port
(``pipeline/experimental.py``) against the JAX package's, on maps from the
cached frames (160x120):

- ``warp_maps``: a frame's world-space vertex and normal maps warped into a
  view 2 frames on; the pixels that receive a point and every row equal
  bit for bit;
- ``image_normals``: the same frame's vertex map; the bad mask equal, the
  normals within 1e-6;
- ``grad3``: a JAX map after the 3 bootstrap frames (128^3), carried over
  by ``convert.map_from_numpy``, at random points near its surface, bit
  for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import experimental as jex
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu.pipeline import raycast as jrc
from supereight_tpu_torch import convert
from supereight_tpu_torch.fields import SDFField
from supereight_tpu_torch.pipeline import experimental, raycast

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

H, W = 120, 160
K = K_FULL / 2
FRAME = 20


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def maps():
    depths, poses = load_frames()
    d = jpre.mm_to_meters(jnp.asarray(depths[FRAME]), (H, W))
    _, v, n = jpre.build_pyramid(d, jnp.asarray(K), 1, neg_y=False)
    p = jnp.asarray(poses[FRAME])
    invalid = n[0][..., :1] == -2.0
    wn = jnp.where(invalid, n[0], jcam.rotate_vectors(p, n[0]))
    wv = jnp.where(invalid, 0.0, jcam.transform_points(p, v[0]))
    view = jcam.camera_matrix(jnp.asarray(K)) \
        @ jnp.linalg.inv(jnp.asarray(poses[FRAME + 2]))
    dirs = jrc.ray_directions(p @ jcam.inverse_camera_matrix(
        jnp.asarray(K)), H, W)[1]
    a = np.asarray
    return dict(v=a(wv), n=a(wn), view=a(view), dirs=a(dirs),
                hit=~a(invalid[..., 0]))


def test_warp_maps_match_jax(maps):
    jv, jn = jax.jit(jex.warp_maps, static_argnums=(3, 4))(
        maps["v"], maps["n"], maps["view"], H, W)
    tv, tn = experimental.warp_maps(_t(maps["v"]), _t(maps["n"]),
                                    _t(maps["view"]), H, W)
    jv, jn = np.asarray(jv), np.asarray(jn)
    landed = jn[..., 0] != -2.0
    assert 0.5 < landed.mean() < 1.0          # disocclusion holes stay
    np.testing.assert_array_equal(tn.numpy(), jn)
    np.testing.assert_array_equal(tv.numpy(), jv)


def test_image_normals_match_jax(maps):
    jn, jbad = jax.jit(jex.image_normals)(maps["v"], maps["hit"],
                                          maps["dirs"])
    tn, tbad = experimental.image_normals(_t(maps["v"]), _t(maps["hit"]),
                                          _t(maps["dirs"]))
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    ok = ~np.asarray(jbad)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(tn.numpy()[ok], np.asarray(jn)[ok], rtol=0,
                               atol=1e-6)


def test_grad3_matches_jax():
    depths, poses = load_frames()
    cfg = apply_preset("headline", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(3):
        slam.step(depths[f], K, f)
    jm = slam.state.map
    tm = convert.map_from_numpy(map_to_numpy(jm), "cpu")
    rng = np.random.default_rng(5)
    # points around the first frame's surface: its depth along the rays
    d = np.asarray(depths[0][::2, ::2], np.float32) / 1000.0
    ys, xs = rng.integers(0, H, 2048), rng.integers(0, W, 2048)
    z = d[ys, xs] + rng.normal(0, 0.05, 2048).astype(np.float32)
    cam = np.stack([(xs - K[2]) / K[0] * z, (ys - K[3]) / K[1] * z, z], -1)
    pos = (cam @ poses[0][:3, :3].T + poses[0][:3, 3]).astype(np.float32)
    want = jex.grad3(jm, jrc.pack_view(jm, JaxSDF(mu=0.1)), JaxSDF(mu=0.1),
                     jnp.asarray(pos))
    got = experimental.grad3(tm, raycast.pack_view(tm, SDFField(mu=0.1)),
                             SDFField(mu=0.1), torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(np.asarray(want)) < 0.99).any()
