"""Sparse voxel map: flat block table + dense block index (counterpart of
`supereight_tpu/core/octree.py`, single-partition subset).

Same layout as the JAX map: ``block_index`` int32[B,B,B] maps a block
coordinate to its slot (or -1); the block table holds Morton ``keys``,
per-channel voxel bricks ``{name: [capacity, 512]}`` (linear voxel index
x + 8y + 64z), an ``active`` flag per slot and a bump counter ``n_blocks``.
The coarse node pyramid (``node_values`` / ``node_alloc``) takes the
fusion's node update; OFusion's multiscale allocation marks its cells and
its values show through unallocated space (``node_fill``).  Functions
return a new map and never write into the tensors of the map they were
given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from . import morton

BLOCK_SIDE = 8
BLOCK_VOXELS = BLOCK_SIDE ** 3
BLOCK_BITS = 3


def _log2i(v: int) -> int:
    l = v.bit_length() - 1
    if (1 << l) != v:
        raise ValueError(f"size must be a power of two, got {v}")
    return l


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Per-channel voxel field description: ``empty`` is what unallocated
    space reads, ``init`` what freshly allocated voxels start with."""
    name: str
    dtype: torch.dtype
    init: float
    empty: float


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    """Flat-array sparse voxel map over a ``size^3`` cube of extent ``dim`` m."""
    size: int
    dim: float
    capacity: int
    channels: Tuple[ChannelSpec, ...]

    block_index: torch.Tensor            # int32[B,B,B], slot or -1
    keys: torch.Tensor                   # int64[capacity] block Morton keys
    n_blocks: torch.Tensor               # int32[]
    active: torch.Tensor                 # bool[capacity]
    overflow: torch.Tensor               # int32[] dropped allocations/fusions
    voxels: Dict[str, torch.Tensor]      # {name: [capacity, 512]}
    node_values: List[Dict[str, torch.Tensor]]   # per level 0..block_level
    node_alloc: List[torch.Tensor]       # per level bool[2^l]^3

    def replace(self, **kw) -> "VoxelMap":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.block_index.device

    @property
    def blocks_per_edge(self) -> int:
        return self.size // BLOCK_SIDE

    @property
    def max_depth(self) -> int:
        return _log2i(self.size)

    @property
    def block_level(self) -> int:
        return self.max_depth - BLOCK_BITS

    @property
    def voxel_size(self) -> float:
        return self.dim / self.size

    @property
    def inverse_voxel_size(self) -> float:
        return self.size / self.dim


def init(size: int, dim: float, channels: Tuple[ChannelSpec, ...],
         device: torch.device, capacity: Optional[int] = None) -> VoxelMap:
    """An empty map (`octree.py:init` with one partition)."""
    B = size // BLOCK_SIDE
    if capacity is None:
        capacity = min(B * B * B, max(4096, (B * B * B) // 4))
    block_level = _log2i(size) - BLOCK_BITS
    node_values, node_alloc = [], []
    for level in range(block_level + 1):
        s = 1 << level
        node_values.append({c.name: torch.full((s, s, s), c.init,
                                               dtype=c.dtype, device=device)
                            for c in channels})
        node_alloc.append(torch.zeros((s, s, s), dtype=torch.bool,
                                      device=device))
    i32 = dict(dtype=torch.int32, device=device)
    return VoxelMap(
        size=size, dim=float(dim), capacity=capacity,
        channels=tuple(channels),
        block_index=torch.full((B, B, B), -1, **i32),
        keys=torch.zeros((capacity,), dtype=torch.int64, device=device),
        n_blocks=torch.zeros((), **i32),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
        overflow=torch.zeros((), **i32),
        voxels={c.name: torch.full((capacity, BLOCK_VOXELS), c.init,
                                   dtype=c.dtype, device=device)
                for c in channels},
        node_values=node_values, node_alloc=node_alloc)


def block_coords_table(m: VoxelMap) -> torch.Tensor:
    """All block keys decoded into int32[capacity, 3] block coordinates."""
    return torch.stack(morton.block_key_decode(m.keys), dim=-1)


def slot_mask(m: VoxelMap) -> torch.Tensor:
    """bool[capacity]: the live slots, a prefix of the table."""
    return torch.arange(m.capacity, dtype=torch.int32,
                        device=m.device) < m.n_blocks


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """``dst`` with ``dst[idx] = src`` where ``idx`` < len(dst), dropping
    the rest (JAX's ``.at[idx].set(src, mode="drop")`` for the sentinel
    index ``len(dst)``): the sentinel lands in a scratch row that is cut
    off, so no index leaves the tensor and the host never syncs."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    ext[idx.clamp(0, n).long()] = src
    return ext[:n]


def allocate_block_mask(m: VoxelMap, wanted: torch.Tensor) -> VoxelMap:
    """Allocate every block where ``wanted`` bool[B,B,B] is set and mark
    every touched block active (`octree.py:allocate_block_mask`): a prefix
    sum over the unallocated wanted cells assigns slots in flat order; cells
    past the capacity stay unallocated and count into ``overflow``."""
    B = m.blocks_per_edge
    cap = m.capacity
    dev = m.device
    new = (wanted & (m.block_index < 0)).reshape(-1)
    order = torch.cumsum(new, 0, dtype=torch.int32) - 1
    slots = m.n_blocks + order
    total_new = order[-1] + 1
    fits = new & (slots < cap)
    flat_new = torch.where(fits, slots, m.block_index.reshape(-1))

    lin = torch.arange(B * B * B, dtype=torch.int64, device=dev)
    new_keys = morton.block_key(lin // (B * B), (lin // B) % B, lin % B)
    keys = scatter_drop(m.keys, torch.where(fits, slots, cap), new_keys)
    touched = wanted.reshape(-1) & (flat_new >= 0)
    active = scatter_drop(m.active, torch.where(touched, flat_new, cap),
                          True)

    n_new = m.n_blocks + total_new
    return m.replace(block_index=flat_new.reshape(B, B, B), keys=keys,
                     n_blocks=torch.clamp(n_new, max=cap),
                     active=active,
                     overflow=m.overflow + torch.clamp(n_new - cap, min=0))


def allocate_octant_masks(m: VoxelMap, masks: List[torch.Tensor]) -> VoxelMap:
    """Allocate octants from per-level request masks
    (`octree.py:allocate_octant_masks`): ``masks[l]`` bool[2^l]^3 requests
    a node at level l < block_level, whose 2x2x2 child cells join
    ``node_alloc[l + 1]``, or a block at l == block_level."""
    m = allocate_block_mask(m, masks[m.block_level])
    node_alloc = list(m.node_alloc)
    for level in range(m.block_level):
        node_alloc[level + 1] = node_alloc[level + 1] | _upsample(
            masks[level], 2)
    return m.replace(node_alloc=node_alloc)


def _upsample(a: torch.Tensor, f: int) -> torch.Tensor:
    """Repeat each cell of a 3-D tensor ``f`` times along every axis."""
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1) \
        .repeat_interleave(f, 2)


def node_fill(m: VoxelMap, channel: str) -> torch.Tensor:
    """``[B^3]``: over each block-grid cell, the value of the deepest
    allocated node-pyramid level (a deeper level overwrites), ``empty``
    where no ancestor octant is allocated (`octree.py:node_fill`)."""
    spec = next(c for c in m.channels if c.name == channel)
    B = m.blocks_per_edge
    fill = torch.full((B, B, B), spec.empty, dtype=spec.dtype,
                      device=m.device)
    for level in range(1, m.block_level + 1):
        rep = B >> level
        fill = torch.where(_upsample(m.node_alloc[level], rep),
                           _upsample(m.node_values[level][channel], rep),
                           fill)
    return fill.reshape(B * B * B)


def pack_tiled_multiscale(m: VoxelMap, channel: str) -> torch.Tensor:
    """Brick-tiled rows ``[B^3, 512]`` of one channel: allocated blocks
    carry their voxels, every other row its cell's :func:`node_fill` value
    (`octree.py:pack_tiled_multiscale`)."""
    spec = next(c for c in m.channels if c.name == channel)
    B = m.blocks_per_edge
    bc = block_coords_table(m)
    lin = (bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]
    flat = torch.full((B * B * B, BLOCK_VOXELS), spec.empty,
                      dtype=spec.dtype, device=m.device)
    flat = scatter_drop(flat, torch.where(slot_mask(m), lin, B * B * B),
                        m.voxels[channel])
    has_leaf = (m.block_index >= 0).reshape(-1)
    return torch.where(has_leaf[:, None], flat, node_fill(m, channel)[:, None])
