"""Block-granularity Morton keys (counterpart of
`supereight_tpu/core/morton.py`: ``block_key`` / ``block_key_decode``).

Keys are held as int64: the JAX package stores them as uint32, which torch
supports poorly.  A block key carries 10 bits per axis, so it fits 30 bits
and the two dtypes hold the same values.
"""

from __future__ import annotations

import torch


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` so each lands 3 positions apart."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def compact_bits(v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`expand_bits`: collect every 3rd bit into the low 10."""
    v = v.to(torch.int64) & 0x09249249
    v = (v ^ (v >> 2)) & 0x030C30C3
    v = (v ^ (v >> 4)) & 0x0300F00F
    v = (v ^ (v >> 8)) & 0x030000FF
    v = (v ^ (v >> 16)) & 0x000003FF
    return v


def block_key(bx, by, bz) -> torch.Tensor:
    """Morton key (int64) for a voxel-block coordinate; x is bit 0 of each
    triplet, y bit 1, z bit 2."""
    return expand_bits(bx) | (expand_bits(by) << 1) | (expand_bits(bz) << 2)


def block_key_decode(key: torch.Tensor):
    """Inverse of :func:`block_key`: (x, y, z) int32 tensors."""
    return (compact_bits(key).to(torch.int32),
            compact_bits(key >> 1).to(torch.int32),
            compact_bits(key >> 2).to(torch.int32))
