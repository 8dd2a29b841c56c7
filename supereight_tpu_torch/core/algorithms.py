"""Key-list algorithms: sort, unique, ancestor filtering, multiscale
dedup, and the active-list filter (counterpart of
`supereight_tpu/core/algorithms.py`).

Keys are int64 (`morton.py`): the JAX package's uint32 and uint64 keys
hold the same values and sort in the same order.  Each function works in
one vectorised pass over a sorted key tensor.
"""

from __future__ import annotations

import torch

from . import morton, numerics, octree


def _as_keys(keys) -> torch.Tensor:
    return torch.as_tensor(keys).to(torch.int64)


def _valid(mask: torch.Tensor, n_valid) -> torch.Tensor:
    if n_valid is None:
        return mask
    return mask & (torch.arange(mask.shape[0], device=mask.device) < n_valid)


def sort_keys(keys) -> torch.Tensor:
    """The keys in ascending order."""
    return torch.sort(_as_keys(keys)).values


def unique(keys_sorted, n_valid=None):
    """(mask of the first occurrence of each key in a sorted tensor, their
    count); the first key's predecessor is its complement, which differs
    from it."""
    k = _as_keys(keys_sorted)
    prev = torch.cat([~k[:1], k[:-1]])
    mask = _valid(k != prev, n_valid)
    return mask, mask.sum(dtype=torch.int32)


def filter_ancestors(keys_sorted, max_depth, n_valid=None) -> torch.Tensor:
    """Keep-mask dropping each key that is an ancestor of its successor in
    a sorted tensor (the deeper key implies the branch); the last is
    kept."""
    k = _as_keys(keys_sorted)
    nxt = torch.cat([k[1:], k[-1:]])
    keep = ~(morton.key_is_descendant(nxt, k, max_depth) & (nxt != k))
    keep[-1:] = True
    return _valid(keep, n_valid)


def unique_multiscale(keys_sorted, max_depth, n_valid=None) -> torch.Tensor:
    """Keep-mask of the deepest key of each morton code in a tensor sorted
    by (code, level): the last of each run of equal codes; the last key's
    successor code is its own with the low bit flipped, which differs."""
    k = _as_keys(keys_sorted)
    code = morton.key_morton(k)
    level = morton.key_level(k)
    nxt_code = torch.cat([code[1:], code[-1:] ^ 1])
    nxt_level = torch.cat([level[1:], level[-1:]])
    keep = (code != nxt_code) | (level > nxt_level)
    keep[-1:] = True
    return _valid(keep, n_valid)


# ----------------------------------------------------------------------
# Active-list filtering
# ----------------------------------------------------------------------

def in_frustum(m: octree.VoxelMap, pose, K, frame_hw) -> torch.Tensor:
    """bool[capacity]: the block's centre projects into the camera frustum
    of ``pose`` (camera to world) and ``K`` [4, 4] on a ``frame_hw``
    image.  The pose is inverted as XLA inverts it (`numerics.inv`) and
    the products are its dots (`numerics.matvec`)."""
    H, W = frame_hw
    dev = m.device
    pose = torch.as_tensor(pose, dtype=torch.float32).to(dev)
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    bc = octree.block_coords_table(m).to(torch.float32)
    centers = (bc + 0.5) * (octree.BLOCK_SIDE * m.voxel_size)
    T_cw = numerics.inv(pose)
    cam = numerics.matvec(T_cw[:3, :3], centers) + T_cw[:3, 3]
    hom = numerics.matvec(K[:3, :3], cam)
    z = torch.where(hom[:, 2] == 0, 1.0, hom[:, 2])
    px = hom[:, 0] / z
    py = hom[:, 1] / z
    return (cam[:, 2] > 0) & (px >= 0) & (px < W) & (py >= 0) & (py < H)


def filter_blocks(m: octree.VoxelMap, *predicates) -> torch.Tensor:
    """bool[capacity]: the live slots that satisfy every predicate, each a
    bool[capacity] tensor or a callable of the map."""
    mask = octree.slot_mask(m)
    for p in predicates:
        mask = mask & (p(m) if callable(p) else p)
    return mask


def block_list(m: octree.VoxelMap, active_only: bool = False):
    """(block coordinates int32[capacity, 3], bool[capacity] mask of the
    live slots, intersected with ``active`` if ``active_only``)."""
    mask = octree.slot_mask(m)
    if active_only:
        mask = mask & m.active
    return octree.block_coords_table(m), mask
