"""Raycasting of the PyTorch port against the JAX package on a JAX map
carried over by ``convert.map_from_numpy`` (headline knobs, 160x120,
128^3, and an OFusion map of the ``ofusion-fidelity`` preset).

The bf16 read view must match bit for bit; hit masks agree on >= 99.9 % of
the pixels (the full-res scan, exact normals and interp refine, stored
normals, the plane refine and the midsolve: all of them), and where both
hit, vertices within 1e-4 m and normals within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import raycast as jrc
from supereight_tpu.pipeline.constants import FAR_PLANE, NEAR_PLANE
from supereight_tpu_torch import convert
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.pipeline import raycast

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

FRAME = 8
H, W = 120, 160
K = K_FULL / 2
KNOBS = dict(second_window=True, span_factor=1.6, w2_budget=8192,
             scan_stride=1.0, near_rescue=True, grad_decim=2)


@pytest.fixture(scope="module")
def scene():
    depths, poses = load_frames()
    cfg = apply_preset("headline", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(FRAME):
        slam.step(depths[f], K, f)
    jm = slam.state.map
    view = np.asarray(jnp.asarray(poses[FRAME])
                      @ jcam.inverse_camera_matrix(jnp.asarray(K)))
    return dict(jmap=jm, tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"),
                view=view)


@pytest.fixture(scope="module")
def of_scene():
    """The JAX ``ofusion-fidelity`` map (mu 0.008) after its 5 bootstrap
    and tracked frames."""
    depths, poses = load_frames()
    cfg = apply_preset("ofusion-fidelity", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(5):
        slam.step(depths[f], K, f)
    jm = slam.state.map
    view = np.asarray(jnp.asarray(poses[5])
                      @ jcam.inverse_camera_matrix(jnp.asarray(K)))
    return dict(jmap=jm, tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"),
                view=view)


@pytest.fixture(scope="module")
def jax_raycasts(scene):
    """One JAX raycast per normals mode, shared by the tests."""
    return {n: jrc.raycast(scene["jmap"], JaxSDF(mu=0.1),
                           jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                           FAR_PLANE, normals=n, refine="secant", **KNOBS)
            for n in ("hybrid", "volume")}


def test_pack_view_matches_jax(scene):
    want = np.asarray(jrc.pack_view(scene["jmap"], JaxSDF(mu=0.1))["F"]
                      .astype(jnp.float32))
    got = raycast.pack_view(scene["tmap"], SDFField(mu=0.1))["F"]
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert np.isnan(want).any() and (want[ok] < 0).any()


def test_splat_bounds_match_jax(scene):
    jt = jrc._splat_bounds(scene["jmap"], JaxSDF(mu=0.1),
                           jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                           FAR_PLANE)
    tt = raycast._splat_bounds(scene["tmap"], SDFField(mu=0.1),
                               torch.from_numpy(scene["view"]), H, W,
                               NEAR_PLANE, FAR_PLANE)
    assert jt[2] == tt[2]
    for j, t in zip(jt[:2], tt[:2]):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        fin = np.isfinite(j)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("normals", ["hybrid", "volume"])
def test_raycast_matches_jax(scene, jax_raycasts, normals):
    want = jax_raycasts[normals]
    got = raycast.raycast(scene["tmap"], SDFField(mu=0.1),
                          torch.from_numpy(scene["view"]), H, W, NEAR_PLANE,
                          FAR_PLANE, normals=normals, **KNOBS)
    jv, tv = np.asarray(want.vertex), got.vertex.numpy()
    jn, tn = np.asarray(want.normal), got.normal.numpy()
    jhit, thit = jv.any(-1), tv.any(-1)
    assert jhit.mean() > 0.5
    assert (jhit == thit).mean() >= 0.999
    both = jhit & thit
    np.testing.assert_allclose(tv[both], jv[both], rtol=0, atol=1e-4)
    jok, tok = jn[..., 0] != -2.0, tn[..., 0] != -2.0
    assert (jok == tok).mean() >= 0.999
    ok = jok & tok
    np.testing.assert_allclose(tn[ok], jn[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t_hit.numpy()[both],
                               np.asarray(want.t_hit)[both], rtol=0,
                               atol=1e-4)


FIELDS = {"sdf": (JaxSDF(mu=0.1), SDFField(mu=0.1)),
          "ofusion": (JaxOFusion(mu=0.008, voxel_size=4.8 / 128),
                      OFusionField(mu=0.008, voxel_size=4.8 / 128))}


@pytest.mark.parametrize("field,knobs", [
    ("sdf", dict(full_res_scan=True, normals="hybrid")),
    ("sdf", dict(normals="exact")),
    ("sdf", dict(refine="interp")),
    ("ofusion", dict(normals="exact", refine="interp")),
    ("ofusion", dict(full_res_scan=True, normals="volume"))])
def test_raycast_modes_match_jax(scene, of_scene, field, knobs):
    """The full-res scan (hybrid normals fall back to volume there), exact
    normals and the trilinear re-solve: every hit mask exactly."""
    sc = scene if field == "sdf" else of_scene
    jfield, tfield = FIELDS[field]
    base = dict(KNOBS, near_rescue=field == "sdf")
    want = jrc.raycast(sc["jmap"], jfield, jnp.asarray(sc["view"]), H, W,
                       NEAR_PLANE, FAR_PLANE, **base,
                       **dict(dict(normals="volume", refine="secant"),
                              **knobs))
    got = raycast.raycast(sc["tmap"], tfield, torch.from_numpy(sc["view"]),
                          H, W, NEAR_PLANE, FAR_PLANE, **base, **knobs)
    jv, tv = np.asarray(want.vertex), got.vertex.numpy()
    jn, tn = np.asarray(want.normal), got.normal.numpy()
    jhit, thit = jv.any(-1), tv.any(-1)
    assert jhit.mean() > 0.4
    np.testing.assert_array_equal(thit, jhit)
    np.testing.assert_allclose(tv[jhit], jv[jhit], rtol=0, atol=1e-4)
    jok, tok = jn[..., 0] != -2.0, tn[..., 0] != -2.0
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tn[jok], jn[jok], rtol=0, atol=1e-3)


@pytest.mark.parametrize("field,knobs", [
    ("sdf", dict(normals="stored")),
    ("sdf", dict(normals="stored", refine="plane")),
    ("sdf", dict(normals="hybrid", midsolve=True)),
    ("ofusion", dict(normals="stored", refine="plane"))],
    ids=["stored", "stored-plane", "midsolve", "ofusion-stored-plane"])
def test_raycast_knobs_match_jax(scene, of_scene, field, knobs):
    """Stored normals (each package's table from the same map), the plane
    refine on them and the half-res midsolve: every hit mask exactly."""
    test_raycast_modes_match_jax(scene, of_scene, field, knobs)
