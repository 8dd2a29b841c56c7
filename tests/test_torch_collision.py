"""Collision queries of the PyTorch port against the JAX package
(`tests/test_collision.py`'s maps and boxes, and random boxes): the AABB
tests and every box's ``CollisionStatus`` equal, on maps built with both
packages' ``allocate_blocks`` / ``allocate_octants`` and
``axis_aligned_map`` (whose tables are compared first, bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import collision as jc
from supereight_tpu.core import octree as jo
from supereight_tpu.core.octree import ChannelSpec as JaxSpec
from supereight_tpu_torch.core import collision as tc
from supereight_tpu_torch.core import octree as to
from supereight_tpu_torch.core.collision import CollisionStatus
from supereight_tpu_torch.core.octree import ChannelSpec

torch.set_num_threads(1)

SDF = (("tsdf", 1.0, 1.0), ("weight", 0.0, -1.0))
OFUSION = (("occupancy", 0.0, 0.0), ("timestamp", 0.0, 0.0))


def _maps(chans, coords, fill, octants=None):
    """The same map in both packages: blocks at ``coords``, octant requests
    ``octants`` = (voxel coords, levels), voxels from ``fill(where, x)``
    (``where`` jnp.where or torch.where), and random node-pyramid values
    so that unallocated space reads them where it is marked."""
    jm = jo.init(64, 4.8, tuple(JaxSpec(n, jnp.float32, i, e)
                               for n, i, e in chans), capacity=512)
    tm = to.init(64, 4.8, tuple(ChannelSpec(n, torch.float32, i, e)
                               for n, i, e in chans), "cpu", capacity=512)
    coords = np.asarray(coords, np.int32)
    jm = jo.allocate_blocks(jm, jnp.asarray(coords),
                            jnp.ones((len(coords),), bool))
    tm = to.allocate_blocks(tm, torch.from_numpy(coords),
                            torch.ones(len(coords), dtype=torch.bool))
    if octants is not None:
        oc, lv = octants
        jm = jo.allocate_octants(jm, jnp.asarray(oc), jnp.asarray(lv),
                                 jnp.ones((len(oc),), bool))
        tm = to.allocate_octants(tm, torch.from_numpy(oc),
                                 torch.from_numpy(lv),
                                 torch.ones(len(oc), dtype=torch.bool))
        rng = np.random.default_rng(3)
        vals = [{n: rng.uniform(-3, 3, a.shape).astype(np.float32)
                 for n, _, _ in chans} for a in jm.node_alloc]
        jm = jm.replace(node_values=[{n: jnp.asarray(v) for n, v in lv.items()}
                                     for lv in vals])
        tm = tm.replace(node_values=[{n: torch.from_numpy(v)
                                      for n, v in lv.items()} for lv in vals])
    jm = jo.axis_aligned_map(jm, lambda v, c: fill(jnp.where, c[..., 0]))
    tm = to.axis_aligned_map(tm, lambda v, c: fill(torch.where, c[..., 0]))
    for name in ("block_index", "n_blocks", "active"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    for n, _, _ in chans:
        np.testing.assert_array_equal(tm.voxels[n].numpy(),
                                      np.asarray(jm.voxels[n]))
    for a, b in zip(tm.node_alloc, jm.node_alloc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return jm, tm


def _wall(where, x):
    """A seen wall at x in [16, 20), seen free space in [8, 16), allocated
    but never fused voxels in [20, 24)."""
    return {"tsdf": where((x >= 16) & (x < 20), -0.5, 1.0),
            "weight": where((x >= 8) & (x < 20), 10.0, 0.0)}


def _occupancy(where, x):
    return {"occupancy": where((x >= 16) & (x < 20), 5.0, -5.0),
            "timestamp": where((x >= 8) & (x < 20), 3.0, 0.0)}


def _wall_blocks():
    r = np.arange(1, 3)
    bx, by, bz = np.meshgrid(r, np.arange(8), np.arange(8), indexing="ij")
    return np.stack([bx, by, bz], -1).reshape(-1, 3)


#: the JAX tests' boxes and their statuses
BOXES = [((17, 2, 2), (2, 2, 2), CollisionStatus.occupied),
         ((9, 2, 2), (4, 4, 4), CollisionStatus.empty),
         ((40, 40, 40), (4, 4, 4), CollisionStatus.unseen),
         ((12, 2, 2), (8, 4, 4), CollisionStatus.occupied),
         ((21, 2, 2), (2, 2, 2), CollisionStatus.unseen)]


#: box sizes of the random boxes (few, since each size compiles anew in JAX)
SIDES = ((2, 2, 2), (4, 4, 4), (8, 3, 5))


def _random_boxes(seed, n=9):
    rng = np.random.default_rng(seed)
    return [(tuple(int(v) for v in rng.integers(-6, 60, 3)),
             SIDES[i % len(SIDES)]) for i in range(n)]


@pytest.mark.parametrize("field", ["sdf", "ofusion"])
def test_statuses_match_jax(field):
    if field == "sdf":
        jm, tm = _maps(SDF, _wall_blocks(), _wall)
        jt, tt = jc.sdf_collision_test, tc.sdf_collision_test
        for bbox, side, want in BOXES:
            assert int(tc.collides_with(tm, bbox, side, tt)) == int(want)
    else:
        # two blocks, and coarse octants at levels 1-2 around them whose
        # node values show through unallocated space
        oc = np.array([[40, 8, 8], [8, 40, 40], [50, 50, 10], [20, 0, 0]],
                      np.int32)
        jm, tm = _maps(OFUSION, [[1, 0, 0], [2, 0, 0]], _occupancy,
                       (oc, np.array([1, 2, 2, 1], np.int32)))
        jt, tt = jc.ofusion_collision_test, tc.ofusion_collision_test
        for bbox, want in (((17, 2, 2), CollisionStatus.occupied),
                           ((9, 2, 2), CollisionStatus.empty),
                           ((21, 2, 2), CollisionStatus.unseen)):
            assert int(tc.collides_with(tm, bbox, (2, 2, 2), tt)) == \
                int(want)
    seen = set()
    for bbox, side in _random_boxes(len(field)) + [(b, s) for b, s, _ in
                                                   BOXES]:
        want = int(jc.collides_with(jm, bbox, side, jt))
        got = tc.collides_with(tm, bbox, side, tt)
        assert got.dtype == torch.int32 and int(got) == want, (bbox, side)
        seen.add(want)
    assert seen == {0, 1, 2}


def test_aabb_tests_match_jax():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 12, (2, 200, 3))
    ae, be = rng.integers(4, 16, (200, 3)), rng.integers(1, 4, (200, 3))
    for jf, tf in ((jc.aabb_aabb_collision, tc.aabb_aabb_collision),
                   (jc.aabb_aabb_inclusion, tc.aabb_aabb_inclusion)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(ae), jnp.asarray(b),
                             jnp.asarray(be)))
        got = tf(*(torch.from_numpy(x) for x in (a, ae, b, be)))
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < len(want)
    assert bool(tc.aabb_aabb_collision([0, 0, 0], [4, 4, 4], [3, 3, 3],
                                       [2, 2, 2]))
    assert not bool(tc.aabb_aabb_collision([0, 0, 0], [4, 4, 4], [5, 0, 0],
                                           [2, 2, 2]))
    assert bool(tc.aabb_aabb_inclusion([0, 0, 0], [10, 10, 10], [2, 2, 2],
                                       [3, 3, 3]))
    assert not bool(tc.aabb_aabb_inclusion([0, 0, 0], [10, 10, 10],
                                           [8, 8, 8], [3, 3, 3]))
