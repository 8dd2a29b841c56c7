"""Morton codes and octant keys of the PyTorch port against the JAX
package (`tests/test_morton.py`'s cases): the same random coordinates
through both, every key, level, coordinate, child id, sibling group,
descendant test, far corner and face neighbour equal bit for bit.  The
port's keys are int64 where JAX's are uint32 (up to 512^3) or uint64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import morton as jm
from supereight_tpu_torch.core import morton as tm

torch.set_num_threads(1)


def _eq(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
        return
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype.kind == "u":
        want = want.astype(np.int64)
        assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_expand_compact_match_jax():
    v = np.arange(1024, dtype=np.uint32)
    _eq(tm.expand_bits(torch.from_numpy(v.astype(np.int64))),
        jm.expand_bits(jnp.asarray(v)))
    _eq(tm.compact_bits(tm.expand_bits(torch.from_numpy(v.astype(np.int64)))),
        v)
    rng = np.random.default_rng(0)
    w = rng.integers(0, 1 << 21, 4096)
    _eq(tm.expand_bits_64(torch.from_numpy(w)), jm.expand_bits_64(w))
    _eq(tm.compact_bits_64(tm.expand_bits_64(torch.from_numpy(w))), w)


def test_morton_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1024, size=(1000, 3)).astype(np.uint32)
    code = jm.encode_morton(xyz[:, 0], xyz[:, 1], xyz[:, 2])
    t = [torch.from_numpy(xyz[:, a].astype(np.int64)) for a in range(3)]
    got = tm.encode_morton(*t)
    _eq(got, code)
    _eq(tm.decode_morton(got), jm.decode_morton(code))
    assert [int(tm.encode_morton(*c)) for c in
            ((1, 0, 0), (0, 1, 0), (0, 0, 1))] == [1, 2, 4]


def _coords(rng, max_depth, n=500):
    return rng.integers(0, 1 << max_depth, size=(n, 3)).astype(np.uint32)


@pytest.mark.parametrize("max_depth", [6, 8, 9, 10, 11])
def test_key_algebra_matches_jax(max_depth):
    """uint32 keys (max_depth <= 9) and uint64 keys (10, 11) alike."""
    rng = np.random.default_rng(max_depth)
    xyz = _coords(rng, max_depth)
    t = [torch.from_numpy(xyz[:, a].astype(np.int64)) for a in range(3)]
    for level in sorted({1, 2, max_depth // 2, max_depth - 1, max_depth}):
        jk = jm.key_encode(xyz[:, 0], xyz[:, 1], xyz[:, 2], level,
                           max_depth)
        tk = tm.key_encode(*t, level, max_depth)
        _eq(tk, jk)
        assert (tk >= 0).all()
        _eq(tm.key_morton(tk), jm.key_morton(jk))
        _eq(tm.key_level(tk), jm.key_level(jk))
        _eq(tm.key_decode(tk), jm.key_decode(jk))
        _eq(tm.key_parent(tk, max_depth), jm.key_parent(jk, max_depth))
        _eq(tm.key_child_id(tk, max_depth), jm.key_child_id(jk, max_depth))
        _eq(tm.key_siblings(tk, max_depth), jm.key_siblings(jk, max_depth))
        _eq(tm.key_far_corner(tk, max_depth),
            jm.key_far_corner(jk, max_depth))
        for face in range(6):
            _eq(tm.key_face_neighbour(tk, face, max_depth),
                jm.key_face_neighbour(jk, face, max_depth))
        # descendants of each key's parent, and of a shuffled ancestor set
        jp, tp = jm.key_parent(jk, max_depth), tm.key_parent(tk, max_depth)
        _eq(tm.key_is_descendant(tk, tp, max_depth),
            jm.key_is_descendant(jk, jp, max_depth))
        perm = rng.permutation(len(xyz))
        _eq(tm.key_is_descendant(tk, tp[perm], max_depth),
            jm.key_is_descendant(jk, jp[perm], max_depth))
        # int64 keys sort as the unsigned keys do
        np.testing.assert_array_equal(
            torch.sort(tk).values.numpy(),
            np.sort(np.asarray(jk)).astype(np.int64))


def test_key_dtype_and_capacity_guard():
    assert tm.key_dtype(9) == tm.key_dtype(19) == torch.int64
    x = torch.tensor([5])
    for bad, err in ((20, ValueError), (np.float32(8), TypeError)):
        with pytest.raises(err):
            tm.key_encode(x, x, x, 3, bad)
        with pytest.raises(err):
            jm.key_encode(jnp.asarray([5]), jnp.asarray([5]),
                          jnp.asarray([5]), 3, bad)
    # the largest key the JAX package makes still fits below the sign bit
    top = (1 << 19) - 1
    k = tm.key_encode(torch.tensor([top]), torch.tensor([top]),
                      torch.tensor([top]), 19, 19)
    assert int(k) == (1 << 62) - 1 - (31 - 19)
    _eq(tm.key_decode(k), (np.array([top]),) * 3)


def test_block_key_is_encode_morton():
    rng = np.random.default_rng(2)
    c = torch.from_numpy(rng.integers(0, 1024, (3, 64)))
    assert torch.equal(tm.block_key(*c), tm.encode_morton(*c))
    for a, b in zip(tm.block_key_decode(tm.block_key(*c)), c):
        assert torch.equal(a.long(), b)
