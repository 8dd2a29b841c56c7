"""Key-list algorithms and the active-list filter of the PyTorch port
against the JAX package (`tests/test_algorithms.py`'s cases and random
key sets): sorted keys, the ``unique`` / ``filter_ancestors`` /
``unique_multiscale`` masks, ``in_frustum``, ``filter_blocks`` and
``block_list`` equal bit for bit, uint32 and uint64 JAX keys alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import algorithms as ja
from supereight_tpu.core import morton as jm
from supereight_tpu.core import octree as jo
from supereight_tpu.core.octree import ChannelSpec as JaxSpec
from supereight_tpu_torch.core import algorithms as ta
from supereight_tpu_torch.core import morton as tm
from supereight_tpu_torch.core import octree as to
from supereight_tpu_torch.core.octree import ChannelSpec

torch.set_num_threads(1)


def _eq(got, want):
    want = np.asarray(want)
    if want.dtype.kind == "u":
        want = want.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def _keys(max_depth, seed, n=300):
    """Keys at random levels, with duplicates, ancestors and several levels
    of one morton code: (JAX keys, port keys)."""
    rng = np.random.default_rng(seed)
    xyz = rng.integers(0, 1 << max_depth, size=(n, 3)).astype(np.uint32)
    lv = rng.integers(1, max_depth + 1, n)
    jk = np.concatenate([np.asarray(jm.key_encode(
        xyz[i:i + 1, 0], xyz[i:i + 1, 1], xyz[i:i + 1, 2], int(lv[i]),
        max_depth)) for i in range(n)])
    jk = np.concatenate([jk, jk[:40],                     # duplicates
                         np.asarray(jm.key_parent(jk[:60], max_depth))])
    return jk, torch.from_numpy(jk.astype(np.int64))


@pytest.mark.parametrize("max_depth", [6, 9, 11])
def test_key_lists_match_jax(max_depth):
    jk, tk = _keys(max_depth, max_depth)
    with jax.enable_x64(True):          # keeps uint64 keys uint64
        js = ja.sort_keys(jnp.asarray(jk))
    ts = ta.sort_keys(tk)
    _eq(ts, js)
    jmask, jcount = ja.unique(js)
    tmask, tcount = ta.unique(ts)
    _eq(tmask, jmask)
    assert int(tcount) == int(jcount) == len(np.unique(jk))
    _eq(ta.filter_ancestors(ts, max_depth),
        ja.filter_ancestors(js, max_depth))
    _eq(ta.unique_multiscale(ts, max_depth),
        ja.unique_multiscale(js, max_depth))
    n = len(jk) - 17
    _eq(ta.unique(ts, n_valid=n)[0], ja.unique(js, n_valid=n)[0])
    _eq(ta.filter_ancestors(ts, max_depth, n_valid=n),
        ja.filter_ancestors(js, max_depth, n_valid=n))
    _eq(ta.unique_multiscale(ts, max_depth, n_valid=n),
        ja.unique_multiscale(js, max_depth, n_valid=n))


def test_unique_counts():
    mask, count = ta.unique(torch.tensor([1, 1, 2, 5, 5, 5, 9]))
    assert int(count) == 4
    assert mask.tolist() == [True, False, True, True, False, False, True]


@pytest.mark.parametrize("max_depth, parent, child", [
    (6, (8, 0, 0, 2), (10, 2, 1, 4)),
    (11, (1536, 0, 0, 2), (1600, 64, 32, 6))])
def test_parent_dropped(max_depth, parent, child):
    k = torch.cat([tm.key_encode(torch.tensor([c[0]]), torch.tensor([c[1]]),
                                 torch.tensor([c[2]]), c[3], max_depth)
                   for c in (parent, child)])
    keep = ta.filter_ancestors(ta.sort_keys(k), max_depth)
    assert int(keep.sum()) == 1


@pytest.mark.parametrize("max_depth, x", [(6, 16), (11, 1024)])
def test_deepest_level_wins(max_depth, x):
    x = torch.tensor([x])
    keys = ta.sort_keys(torch.cat([tm.key_encode(x, x, x, lv, max_depth)
                                   for lv in (2, 3)]))
    keep = ta.unique_multiscale(keys, max_depth)
    assert tm.key_level(keys[keep]).tolist() == [3]


def _maps():
    """The JAX test's two-block map (one block in front of the camera, one
    behind) and 30 random blocks, in both packages."""
    rng = np.random.default_rng(7)
    coords = np.concatenate([[[4, 4, 6], [4, 4, 0]],
                             rng.integers(0, 8, (30, 3))]).astype(np.int32)
    jmap = jo.init(64, 4.8, (JaxSpec("v", jnp.float32, 0.0, 0.0),),
                   capacity=64)
    jmap = jo.allocate_blocks(jmap, jnp.asarray(coords),
                              jnp.ones((len(coords),), bool))
    tmap = to.init(64, 4.8, (ChannelSpec("v", torch.float32, 0.0, 0.0),),
                   "cpu", capacity=64)
    tmap = to.allocate_blocks(tmap, torch.from_numpy(coords),
                              torch.ones(len(coords), dtype=torch.bool))
    return jmap, tmap


def _camera(rot=0.0):
    c, s = np.cos(rot), np.sin(rot)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = (2.4, 2.4, 2.4)
    K = np.array([[60.0, 0, 40, 0], [0, 60.0, 30, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    return pose, K


@pytest.mark.parametrize("rot", [0.0, 0.4, -1.1])
def test_active_list_filter_matches_jax(rot):
    jmap, tmap = _maps()
    pose, K = _camera(rot)
    jf = ja.in_frustum(jmap, jnp.asarray(pose), jnp.asarray(K), (60, 80))
    tf = ta.in_frustum(tmap, pose, K, (60, 80))
    _eq(tf, jf)
    assert 0 < int(tf[:int(tmap.n_blocks)].sum()) < int(tmap.n_blocks)
    _eq(ta.filter_blocks(tmap, tf, lambda m: m.active),
        ja.filter_blocks(jmap, jf, lambda m: m.active))
    none = ta.filter_blocks(tmap, tf, torch.zeros(tmap.capacity,
                                                  dtype=torch.bool))
    assert int(none.sum()) == 0
    for active_only in (False, True):
        jc, jmask = ja.block_list(jmap, active_only)
        tc, tmask = ta.block_list(tmap, active_only)
        _eq(tc, jc)
        _eq(tmask, jmask)
    _, mask = ta.block_list(tmap.replace(active=torch.zeros_like(
        tmap.active)), active_only=True)
    assert int(mask.sum()) == 0
