"""Morton (Z-order) codes and octant-key algebra (counterpart of
`supereight_tpu/core/morton.py`).

Keys are held as int64.  The JAX package packs octant keys as
``(morton(x, y, z) << 5) | level`` in uint32 up to 512^3 and in uint64
above, with at most 19 bits per axis: 57 morton bits and 5 level bits, 62
bits in all.  So every JAX key fits an int64 without reaching the sign bit,
an int64 key is >= 0 and sorts as its unsigned counterpart does, and one
64-bit path serves both widths.  Block keys (:func:`block_key`, no level
bits) carry 10 bits per axis, 30 bits.

Bit order: x is bit 0 of each triplet, y bit 1, z bit 2, so a child id's
bit 0 selects x, bit 1 y, bit 2 z.  ``level`` counts from the root (0) to
``max_depth`` = log2(size), a single voxel.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_COORD_BITS = 10            # bits per axis in a 30-bit block-key code
MAX_COORD_BITS_32 = 9          # bits per axis of the JAX package's uint32 keys
MAX_COORD_BITS_64 = 19         # bits per axis an octant key can hold
LEVEL_BITS = 5
LEVEL_MASK = (1 << LEVEL_BITS) - 1


def _i64(v) -> torch.Tensor:
    return torch.as_tensor(v).to(torch.int64)


def expand_bits(v) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so each lands 3 positions apart."""
    v = _i64(v) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def compact_bits(v) -> torch.Tensor:
    """Inverse of :func:`expand_bits`: collect every 3rd bit into the low 10."""
    v = _i64(v) & 0x09249249
    v = (v ^ (v >> 2)) & 0x030C30C3
    v = (v ^ (v >> 4)) & 0x0300F00F
    v = (v ^ (v >> 8)) & 0x030000FF
    v = (v ^ (v >> 16)) & 0x000003FF
    return v


def expand_bits_64(v) -> torch.Tensor:
    """Spread the low 21 bits of ``v`` 3 positions apart (63-bit morton)."""
    v = _i64(v) & 0x1FFFFF
    v = (v | (v << 32)) & 0x001F00000000FFFF
    v = (v | (v << 16)) & 0x001F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def compact_bits_64(v) -> torch.Tensor:
    """Inverse of :func:`expand_bits_64`."""
    v = _i64(v) & 0x1249249249249249
    v = (v ^ (v >> 2)) & 0x10C30C30C30C30C3
    v = (v ^ (v >> 4)) & 0x100F00F00F00F00F
    v = (v ^ (v >> 8)) & 0x001F0000FF0000FF
    v = (v ^ (v >> 16)) & 0x001F00000000FFFF
    v = (v ^ (v >> 32)) & 0x1FFFFF
    return v


def encode_morton(x, y, z) -> torch.Tensor:
    """Interleave three coordinate tensors into 30-bit morton codes."""
    return expand_bits(x) | (expand_bits(y) << 1) | (expand_bits(z) << 2)


def decode_morton(code):
    """Inverse of :func:`encode_morton`: (x, y, z) int32 tensors."""
    code = _i64(code)
    return (compact_bits(code).to(torch.int32),
            compact_bits(code >> 1).to(torch.int32),
            compact_bits(code >> 2).to(torch.int32))


def block_key(bx, by, bz) -> torch.Tensor:
    """Morton key (int64) for a voxel-block coordinate (no level bits)."""
    return encode_morton(bx, by, bz)


def block_key_decode(key: torch.Tensor):
    """Inverse of :func:`block_key`: (x, y, z) int32 tensors."""
    return decode_morton(key)


# ---------------------------------------------------------------------------
# Octant keys: (morton << 5) | level
# ---------------------------------------------------------------------------

def check_key_capacity(max_depth) -> None:
    """Octant keys carry at most 19 bits per axis; a deeper tree would
    truncate them silently, so it raises.  ``max_depth`` must be a Python
    int (it is static, derived from the map size)."""
    if not isinstance(max_depth, (int, np.integer)):
        raise TypeError(
            f"max_depth must be a static python int, got "
            f"{type(max_depth).__name__}")
    if max_depth > MAX_COORD_BITS_64:
        raise ValueError(
            f"octant morton keys support max_depth <= {MAX_COORD_BITS_64} "
            f"(524288^3 voxels); got max_depth={max_depth}.")


def key_dtype(max_depth) -> torch.dtype:
    """Key dtype for a tree of ``max_depth`` levels: int64 at every depth
    the keys hold (the JAX package's uint32 below 1024^3 and uint64 above
    give the same values)."""
    check_key_capacity(max_depth)
    return torch.int64


def key_encode(x, y, z, level, max_depth) -> torch.Tensor:
    """Octant keys of voxel coordinates at ``level``: the coordinates are
    truncated to that level's octant grid."""
    key_dtype(max_depth)
    level = _i64(level)
    shift = max_depth - level
    x, y, z = ((_i64(v) >> shift) << shift for v in (x, y, z))
    morton = (expand_bits_64(x) | (expand_bits_64(y) << 1)
              | (expand_bits_64(z) << 2))
    return (morton << LEVEL_BITS) | level


def key_morton(key) -> torch.Tensor:
    """The morton code of a key (level stripped)."""
    return _i64(key) >> LEVEL_BITS


def key_level(key) -> torch.Tensor:
    """The level stored in a key's low bits (int32)."""
    return (_i64(key) & LEVEL_MASK).to(torch.int32)


def key_decode(key):
    """Voxel coordinates of a key's octant origin: (x, y, z) int32."""
    m = key_morton(key)
    return tuple(compact_bits_64(m >> a).to(torch.int32) for a in range(3))


def _shift(key, max_depth: int) -> torch.Tensor:
    """3 * (max_depth - level): the morton bits below the key's octant."""
    return 3 * (max_depth - key_level(key).to(torch.int64))


def key_parent(key, max_depth) -> torch.Tensor:
    """Key of the parent octant (one level up)."""
    parent_level = key_level(key).to(torch.int64) - 1
    shift = 3 * (max_depth - parent_level)
    morton = (key_morton(key) >> shift) << shift
    return (morton << LEVEL_BITS) | parent_level


def key_child_id(key, max_depth) -> torch.Tensor:
    """Index of the octant within its sibling group (0..7, int32)."""
    return ((key_morton(key) >> _shift(key, max_depth)) & 7) \
        .to(torch.int32)


def key_siblings(key, max_depth) -> torch.Tensor:
    """All 8 keys of the sibling group holding ``key`` (a new last axis)."""
    shift = _shift(key, max_depth)
    base = (key_morton(key) >> (shift + 3)) << (shift + 3)
    ids = torch.arange(8, dtype=torch.int64, device=base.device)
    morton = base[..., None] | (ids << shift[..., None])
    return (morton << LEVEL_BITS) | key_level(key).to(torch.int64)[..., None]


def key_is_descendant(key, ancestor, max_depth) -> torch.Tensor:
    """True where ``key``'s octant lies inside ``ancestor``'s."""
    shift = _shift(ancestor, max_depth)
    pref_k = (key_morton(key) >> shift) << shift
    deeper = key_level(key) >= key_level(ancestor)
    return (pref_k == key_morton(ancestor)) & deeper


def _side(key, max_depth) -> torch.Tensor:
    return torch.ones((), dtype=torch.int32) << (max_depth - key_level(key))


def key_far_corner(key, max_depth):
    """The corner of the octant not shared with any sibling."""
    x, y, z = key_decode(key)
    side = _side(key, max_depth)
    cid = key_child_id(key, max_depth)
    return (x + (cid & 1) * side, y + ((cid >> 1) & 1) * side,
            z + ((cid >> 2) & 1) * side)


def key_face_neighbour(key, face, max_depth):
    """Origin coordinates of the face-adjacent octant (may be out of
    bounds); ``face`` 0:-x 1:+x 2:-y 3:+y 4:-z 5:+z."""
    x, y, z = key_decode(key)
    side = _side(key, max_depth)
    face = torch.as_tensor(face, dtype=torch.int32)
    zero = torch.zeros_like(side)
    d = [torch.where(face == 2 * a, -side,
                     torch.where(face == 2 * a + 1, side, zero))
         for a in range(3)]
    return x + d[0], y + d[1], z + d[2]
