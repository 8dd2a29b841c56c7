"""VTK / PLY writers of the PyTorch port against the JAX package
(`tests/test_io.py`'s export cases): for the same inputs (the sphere mesh,
slices of its map, a map's block list) every file is byte for byte the
JAX writer's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import meshing as jmesh
from supereight_tpu.core import octree as jo
from supereight_tpu.core.octree import ChannelSpec as JaxSpec
from supereight_tpu.io import vtk as jvtk
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.octree import ChannelSpec
from supereight_tpu_torch.io import vtk

from test_meshing import sphere_map
from torch_port_util import map_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sphere():
    jm = sphere_map(size=32, radius=0.8)
    tris = np.asarray(jmesh.marching_cubes(jm, "v"))
    return jm, convert.map_from_numpy(map_to_numpy(jm), "cpu"), tris


def _both(tmp_path, name, port_fn, jax_fn):
    a, b = tmp_path / f"port-{name}", tmp_path / f"jax-{name}"
    port_fn(str(a))
    jax_fn(str(b))
    assert a.read_bytes() == b.read_bytes()
    return a.read_text()


def test_meshes_match_jax(sphere, tmp_path):
    _, _, tris = sphere
    assert len(tris) > 500
    for name, tw, jw in (("m.vtk", vtk.write_vtk_mesh, jvtk.write_vtk_mesh),
                         ("m.ply", vtk.write_ply_mesh, jvtk.write_ply_mesh)):
        text = _both(tmp_path, name, lambda p: tw(p, torch.from_numpy(tris)),
                     lambda p: jw(p, tris))
        assert (f"POLYGONS {len(tris)}" in text) or \
            (f"element face {len(tris)}" in text)
    small = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                      [[1, 1, 1], [2.4, 1e-5, 1], [1, 2, -0.3]]], np.float32)
    _both(tmp_path, "s.vtk", lambda p: vtk.write_vtk_mesh(p, small),
          lambda p: jvtk.write_vtk_mesh(p, small))
    _both(tmp_path, "e.ply", lambda p: vtk.write_ply_mesh(
        p, np.zeros((0, 3, 3), np.float32)),
        lambda p: jvtk.write_ply_mesh(p, np.zeros((0, 3, 3), np.float32)))


@pytest.mark.parametrize("lower, upper", [((0, 0, 0), (4, 4, 2)),
                                          ((10, 12, 14), (22, 19, 17)),
                                          ((-2, 28, 5), (3, 34, 6))])
def test_slices_match_jax(sphere, tmp_path, lower, upper):
    jm, tm, _ = sphere
    text = _both(tmp_path, "slice.vtk",
                 lambda p: vtk.save_3d_slice(p, tm, "v", lower, upper),
                 lambda p: jvtk.save_3d_slice(p, jm, "v", lower, upper))
    dims = [u - l for l, u in zip(lower, upper)]
    assert f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}" in text


def test_block_lists_match_jax(tmp_path):
    coords = np.array([[0, 0, 0], [2, 3, 1], [1, 1, 1], [3, 0, 2]], np.int32)
    jm = jo.init(32, 2.0, (JaxSpec("v", jnp.float32, 0.0, -1.0),),
                 capacity=128)
    jm = jo.allocate_blocks(jm, jnp.asarray(coords),
                            jnp.ones((len(coords),), bool))
    tm = octree.init(32, 2.0, (ChannelSpec("v", torch.float32, 0.0, -1.0),),
                     "cpu", capacity=128)
    tm = octree.allocate_blocks(tm, torch.from_numpy(coords),
                                torch.ones(len(coords), dtype=torch.bool))
    text = _both(tmp_path, "blocks.txt",
                 lambda p: vtk.save_block_list(p, tm),
                 lambda p: jvtk.save_block_list(p, jm))
    rows = sorted(tuple(map(int, ln.split())) for ln in text.splitlines())
    assert rows == sorted(map(tuple, coords.tolist()))
