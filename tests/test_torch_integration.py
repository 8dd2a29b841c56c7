"""Allocation and fusion of the PyTorch port against the JAX package, from a
JAX map carried over mid-sequence (the headline's SDF map and the
``ofusion`` preset's map, 160x120, 128^3).

The band-march mask, the allocation, the budget's block selection,
``active`` and ``overflow`` must match bit for bit; fused SDF rows within
1e-5; fused OFusion rows with timestamps bit for bit and occupancy within
1e-5 relative (1e-6 absolute where log-odds cancel toward 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.core import octree as joct
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import integration as jint
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.pipeline import integration

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

FRAME = 6
K = K_FULL / 2


def _scene(preset):
    """The JAX map of ``preset`` after frames 0..FRAME-1, and frame FRAME's
    depth and true pose."""
    depths, poses = load_frames()
    cfg = apply_preset(preset, Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(FRAME):
        slam.step(depths[f], K, f)
    depth = jpre.mm_to_meters(jnp.asarray(depths[FRAME]), (120, 160))
    return dict(map=slam.state.map, depth=np.asarray(depth),
                pose=poses[FRAME].astype(np.float32),
                K=np.asarray(jcam.camera_matrix(jnp.asarray(K))))


@pytest.fixture(scope="module")
def scene():
    return _scene("headline")


@pytest.fixture(scope="module")
def of_scene():
    return _scene("ofusion")


def _port_map(s):
    return convert.map_from_numpy(map_to_numpy(s["map"]), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_maps_equal(tm, jm):
    np.testing.assert_array_equal(tm.block_index.numpy(),
                                  np.asarray(jm.block_index))
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    assert int(tm.n_blocks) == int(jm.n_blocks)
    assert int(tm.overflow) == int(jm.overflow)


@pytest.mark.parametrize("decim", [1, 2])
def test_sdf_wanted_mask_matches_jax(scene, decim):
    args = dict(size=128, dim=4.8, band=0.2, decim=decim)
    want = np.asarray(jint.sdf_wanted_mask(
        jnp.asarray(scene["depth"]), jnp.asarray(scene["pose"]),
        jnp.asarray(scene["K"]), **args))
    got = integration.sdf_wanted_mask(_t(scene["depth"]), _t(scene["pose"]),
                                      _t(scene["K"]), **args).numpy()
    assert want.sum() > 100
    np.testing.assert_array_equal(got, want)


def test_allocate_sdf_matches_jax(scene):
    jm = scene["map"]
    # move the camera so that the march requests new blocks too
    pose = scene["pose"].copy()
    pose[:3, 3] += (0.3, 0.0, 0.4)
    jm2 = jint.allocate_sdf(jm, jnp.asarray(scene["depth"]),
                            jnp.asarray(pose), jnp.asarray(scene["K"]), 0.2)
    tm2 = integration.allocate_sdf(_port_map(scene), _t(scene["depth"]),
                                   _t(pose), _t(scene["K"]), 0.2)
    assert int(jm2.n_blocks) > int(jm.n_blocks)
    _assert_maps_equal(tm2, jm2)


@pytest.mark.parametrize("budget", [64, 1024])
def test_integrate_matches_jax(scene, budget):
    """Budget 64 is below the frustum-candidate count (the rest is
    dropped and counted into overflow); 1024 holds them all."""
    jm = scene["map"]
    args = (scene["depth"], scene["pose"], scene["K"])
    jm2 = jint.integrate(jm, JaxSDF(mu=0.1), *(jnp.asarray(a) for a in args),
                         budget=budget)
    tm2 = integration.integrate(_port_map(scene), SDFField(mu=0.1),
                                *(_t(a) for a in args), budget=budget)
    dropped = int(jm2.overflow) - int(jm.overflow)
    assert (dropped > 0) == (budget == 64)
    _assert_maps_equal(tm2, jm2)
    for name in ("tsdf", "weight"):
        before = np.asarray(jm.voxels[name])
        want, got = np.asarray(jm2.voxels[name]), tm2.voxels[name].numpy()
        # the same rows were fused
        np.testing.assert_array_equal((got != before).any(1),
                                      (want != before).any(1))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (np.asarray(jm2.voxels["weight"])
            != np.asarray(jm.voxels["weight"])).any(1).sum() > 0


def test_slot_mask_and_coords_of_carried_map(scene):
    tm = _port_map(scene)
    jm = scene["map"]
    np.testing.assert_array_equal(octree.slot_mask(tm).numpy(),
                                  np.asarray(joct.slot_mask(jm)))
    np.testing.assert_array_equal(octree.block_coords_table(tm).numpy(),
                                  np.asarray(joct.block_coords_table(jm)))


@pytest.mark.parametrize("budget", [64, 1024])
def test_integrate_ofusion_matches_jax(of_scene, budget):
    """OFusion fusion at frame FRAME's timestamp; budget 64 drops frustum
    candidates into overflow, 1024 holds them all.  The node pyramid's
    values are updated as well."""
    jm = of_scene["map"]
    now = float(np.float32(1 / 30) * np.float32(FRAME))
    args = (of_scene["depth"], of_scene["pose"], of_scene["K"])
    jm2 = jint.integrate(jm, JaxOFusion(mu=0.05, voxel_size=4.8 / 128),
                         *(jnp.asarray(a) for a in args),
                         timestamp=jnp.float32(now), budget=budget)
    tm2 = integration.integrate(
        convert.map_from_numpy(map_to_numpy(jm), "cpu"),
        OFusionField(mu=0.05, voxel_size=4.8 / 128), *(_t(a) for a in args),
        timestamp=now, budget=budget)
    dropped = int(jm2.overflow) - int(jm.overflow)
    assert (dropped > 0) == (budget == 64)
    _assert_maps_equal(tm2, jm2)
    got, want = tm2.voxels["timestamp"].numpy(), \
        np.asarray(jm2.voxels["timestamp"])
    np.testing.assert_array_equal(got, want)
    assert (want == np.float32(now)).any(1).sum() > 10
    np.testing.assert_allclose(tm2.voxels["occupancy"].numpy(),
                               np.asarray(jm2.voxels["occupancy"]),
                               rtol=1e-5, atol=1e-6)
    for level in range(1, tm2.block_level + 1):
        for name in ("occupancy", "timestamp"):
            np.testing.assert_allclose(
                tm2.node_values[level][name].numpy(),
                np.asarray(jm2.node_values[level][name]), rtol=1e-5,
                atol=1e-6, err_msg=f"level {level} {name}")
