"""The mesher of the PyTorch port against the JAX package
(`tests/test_meshing.py`'s cases): the analytic-sphere map, built with
each package's ``allocate_blocks`` / ``set_voxels`` (tables equal bit for
bit), and maps fused by the JAX system over a few ground-truth frames of
both fields.  The triangles must be equal in count and order and bit for
bit (the crossing is one multiply-add, as XLA computes it), whatever the
chunk of blocks the port meshes at once."""

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration
from supereight_tpu.core import meshing as jmesh
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import meshing, octree
from supereight_tpu_torch.core.octree import ChannelSpec
from supereight_tpu_torch.fields import make_field

from test_meshing import sphere_map as jax_sphere_map
from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

CHANS = (ChannelSpec("v", torch.float32, 1.0, 1.0),
         ChannelSpec("w", torch.float32, 0.0, -1.0))


def sphere_map(size=64, dim=4.8, radius=1.0):
    """`test_meshing.sphere_map` with the port's octree."""
    m = octree.init(size, dim, CHANS, "cpu", capacity=(size // 8) ** 3)
    r = torch.arange(size // 8)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) \
        .reshape(-1, 3).int()
    m = octree.allocate_blocks(m, coords, torch.ones(len(coords),
                                                     dtype=torch.bool))
    vs = m.voxel_size
    g = np.arange(size)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    c = dim / 2
    sdf = np.sqrt((gx * vs - c) ** 2 + (gy * vs - c) ** 2
                  + (gz * vs - c) ** 2) - radius
    t = [torch.from_numpy(a.ravel()) for a in (gx, gy, gz)]
    m = octree.set_voxels(m, "v", *t, torch.from_numpy(
        sdf.ravel().astype(np.float32)))
    return octree.set_voxels(m, "w", *t, torch.ones(size ** 3))


def _same(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32 and got.shape[1:] == (3, 3)
    assert got.shape[0] == want.shape[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_sphere_map_tables_match_jax():
    jm, tm = jax_sphere_map(), sphere_map()
    for name in ("block_index", "keys", "n_blocks", "active"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    for name in ("v", "w"):
        np.testing.assert_array_equal(tm.voxels[name].numpy(),
                                      np.asarray(jm.voxels[name]))


@pytest.mark.parametrize("chunk", [7, 64, 512])
def test_sphere_mesh_matches_jax(chunk):
    want = np.asarray(jmesh.marching_cubes(jax_sphere_map(), "v"))
    got = meshing.marching_cubes(sphere_map(), "v", chunk=chunk)
    assert want.shape[0] > 1000
    _same(got, want)
    d = np.linalg.norm(got.numpy().reshape(-1, 3) - 2.4, axis=-1)
    assert np.abs(d - 1.0).max() < 0.02


def test_unobserved_and_empty_maps_give_nothing():
    m = sphere_map(size=32)
    m = m.replace(voxels={**m.voxels, "w": torch.zeros_like(m.voxels["w"])})
    assert meshing.marching_cubes(m, "v").shape == (0, 3, 3)
    empty = octree.init(32, 4.8, CHANS, "cpu", capacity=64)
    assert meshing.marching_cubes(empty, "v").shape == (0, 3, 3)


def _fused(field_type, frames=3):
    """A 64^3 map of the JAX system after ``frames`` ground-truth frames of
    the cached sequence at 160x120."""
    cfg = Configuration(volume_resolution=(64,) * 3, volume_size=(4.8,) * 3,
                        compute_size_ratio=2, integration_rate=1,
                        field_type=field_type, block_capacity=512)
    depths, poses = load_frames()
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(frames):
        slam.step(depths[f], K_FULL / 2, f, gt_pose=poses[f])
    return slam.state.map, slam.field


@pytest.mark.parametrize("field_type", ["sdf", "ofusion"])
def test_fused_map_mesh_matches_jax(field_type):
    jm, jfield = _fused(field_type)
    want = np.asarray(jmesh.marching_cubes(jm, jfield.select_channel,
                                           inside=jfield.is_inside))
    tm = convert.map_from_numpy(map_to_numpy(jm), "cpu")
    field = make_field(field_type)
    assert want.shape[0] > 500
    for chunk in (13, 256):
        _same(meshing.marching_cubes(tm, field.select_channel,
                                     inside=field.is_inside, chunk=chunk),
              want)
