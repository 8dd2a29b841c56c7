"""Collision queries: axis-aligned boxes against the voxel map
(counterpart of `supereight_tpu/core/collision.py`).

Every voxel of the box is classified in one vectorised pass, and the box's
status is the maximum over the ordered codes (occupied wins over unseen
over empty).  Allocated voxels read their block; unallocated ones the
deepest allocated node of the pyramid; space no octant covers is unseen.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable

import torch

from . import octree
from .octree import VoxelMap


class CollisionStatus(IntEnum):
    """Priority-ordered status: a box takes the highest of its voxels'."""
    empty = 0
    unseen = 1
    occupied = 2


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v)


def axis_overlap(a, a_edge, b, b_edge) -> torch.Tensor:
    """Whether the intervals [a, a + a_edge) and [b, b + b_edge) overlap
    (centre distance against the half edges)."""
    a, a_edge, b, b_edge = (_t(v) for v in (a, a_edge, b, b_edge))
    return torch.abs((b + b_edge / 2) - (a + a_edge / 2)) \
        <= (a_edge + b_edge) / 2


def aabb_aabb_collision(a, a_edge, b, b_edge) -> torch.Tensor:
    """Overlap of the boxes (origin, edge) ``a`` and ``b``, [..., 3]."""
    a, a_edge, b, b_edge = (_t(v) for v in (a, a_edge, b, b_edge))
    hit = axis_overlap(a[..., 0], a_edge[..., 0], b[..., 0], b_edge[..., 0])
    for i in (1, 2):
        hit = hit & axis_overlap(a[..., i], a_edge[..., i], b[..., i],
                                 b_edge[..., i])
    return hit


def aabb_aabb_inclusion(a, a_edge, b, b_edge) -> torch.Tensor:
    """Whether box ``a`` strictly contains box ``b``."""
    a, a_edge, b, b_edge = (_t(v) for v in (a, a_edge, b, b_edge))
    ok = (a < b) & ((a + a_edge) > (b + b_edge))
    return ok[..., 0] & ok[..., 1] & ok[..., 2]


def collides_with(m: VoxelMap, bbox, side,
                  test: Callable[[dict], torch.Tensor]) -> torch.Tensor:
    """Collision status (an int32 scalar ``CollisionStatus`` code) of the
    box [bbox, bbox + side) in voxels.  ``test`` maps a dict of channel
    values to status codes (:func:`sdf_collision_test`,
    :func:`ofusion_collision_test`).  The box's extent is clamped to the
    map's size; voxels outside the map are unseen."""
    dev = m.device
    nx, ny, nz = (min(int(v), m.size) for v in side)
    axes = [int(bbox[a]) + torch.arange(n, dtype=torch.int32, device=dev)
            for a, n in enumerate((nx, ny, nz))]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")

    slot = octree.fetch(m, gx, gy, gz)
    leaf = {c.name: octree.get(m, c.name, gx, gy, gz) for c in m.channels}
    node = {c.name: octree.get_multiscale(m, c.name, gx, gy, gz)
            for c in m.channels}
    covered = slot >= 0
    for level in range(1, m.block_level + 1):
        shift = m.max_depth - level
        s = 1 << level
        o = [(v >> shift).clamp(0, s - 1).long() for v in (gx, gy, gz)]
        covered = covered | m.node_alloc[level][o[0], o[1], o[2]]

    unseen = int(CollisionStatus.unseen)
    status = torch.where(slot >= 0, test(leaf).to(torch.int32),
                         test(node).to(torch.int32))
    status = torch.where(covered, status, unseen)
    inb = (gx >= 0) & (gx < m.size) & (gy >= 0) & (gy < m.size) \
        & (gz >= 0) & (gz < m.size)
    return torch.where(inb, status, unseen).max()


def _status(seen, inside) -> torch.Tensor:
    return torch.where(~seen, int(CollisionStatus.unseen),
                       torch.where(inside, int(CollisionStatus.occupied),
                                   int(CollisionStatus.empty))) \
        .to(torch.int32)


def sdf_collision_test(vals) -> torch.Tensor:
    """SDF: unseen where weight <= 0, else occupied inside (tsdf < 0) and
    empty outside."""
    return _status(vals["weight"] > 0, vals["tsdf"] < 0)


def ofusion_collision_test(vals) -> torch.Tensor:
    """OFusion: unseen where never fused (timestamp 0), else occupied where
    the log-odds are positive and empty elsewhere."""
    return _status(vals["timestamp"] > 0, vals["occupancy"] > 0)
