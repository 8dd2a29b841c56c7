"""Voxel reads of the PyTorch port against the JAX package: ``get``,
``get_multiscale``, ``interp``, ``interp_multiscale`` and ``grad`` of
`core/octree.py`, on a random 64^3 OFusion map (blocks, node-pyramid cells
and unallocated space) at coordinates inside, at the edges of and outside
the volume.  Integer reads bit for bit, interpolated ones within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import octree as joct
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import octree

from torch_port_util import map_to_numpy

torch.set_num_threads(1)

SIZE = 64


@pytest.fixture(scope="module")
def maps():
    """Random requests at every level (some blocks past the capacity stay
    unallocated), random voxel and node values."""
    rng = np.random.default_rng(7)
    jm = joct.init(SIZE, 2.4, JaxOFusion().channels, capacity=160)
    masks = [rng.random((1 << l,) * 3) < 0.4 for l in range(4)]
    jm = joct.allocate_octant_masks(jm, [jnp.asarray(m) for m in masks])
    vox = {c.name: jnp.asarray(rng.uniform(-5, 5, (160, 512))
                               .astype(np.float32)) for c in jm.channels}
    nodes = [{c.name: jnp.asarray(rng.uniform(-5, 5, (1 << l,) * 3)
                                  .astype(np.float32))
              for c in jm.channels} for l in range(4)]
    jm = jm.replace(voxels=vox, node_values=nodes)
    assert int(jm.overflow) > 0
    return jm, convert.map_from_numpy(map_to_numpy(jm), "cpu")


def _positions(seed, n=6000):
    """Fractional voxel coordinates [n, 3]: random over [-3, SIZE + 3),
    whole numbers, and the edges of the volume."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-3, SIZE + 3, (n, 3))
    pos[:500] = np.floor(pos[:500])
    pos[500:600, 0] = SIZE - 1 + rng.uniform(0, 1, 100)
    pos[600:700, 1] = rng.uniform(-1, 0, 100)
    return pos.astype(np.float32)


@pytest.mark.parametrize("channel", ["occupancy", "timestamp"])
@pytest.mark.parametrize("fn", ["get", "get_multiscale"])
def test_integer_reads_match_jax(maps, channel, fn):
    jm, tm = maps
    v = np.floor(_positions(1)).astype(np.int32)
    want = np.asarray(getattr(joct, fn)(jm, channel, *(jnp.asarray(v[:, a])
                                                       for a in range(3))))
    got = getattr(octree, fn)(tm, channel, *(torch.from_numpy(v[:, a])
                                             for a in range(3))).numpy()
    np.testing.assert_array_equal(got, want)
    # allocated voxels, unallocated space and (multiscale) node values
    slots = np.asarray(joct.fetch(jm, *(jnp.asarray(v[:, a])
                                        for a in range(3))))
    assert (slots >= 0).sum() > 100 and (slots < 0).sum() > 100
    np.testing.assert_array_equal(
        octree.fetch(tm, *(torch.from_numpy(v[:, a])
                           for a in range(3))).numpy(), slots)


@pytest.mark.parametrize("channel", ["occupancy", "timestamp"])
@pytest.mark.parametrize("fn", ["interp", "interp_multiscale", "grad"])
def test_interpolated_reads_match_jax(maps, channel, fn):
    jm, tm = maps
    pos = _positions(2)
    want = np.asarray(getattr(joct, fn)(jm, channel, jnp.asarray(pos)))
    got = getattr(octree, fn)(tm, channel, torch.from_numpy(pos)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # grad scales by 0.5 * dim / size = 0.019
    assert np.abs(want).max() > (0.05 if fn == "grad" else 1.0)
