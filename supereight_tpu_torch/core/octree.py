"""Sparse voxel map: flat block table + dense block index (counterpart of
`supereight_tpu/core/octree.py`).

Same layout as the JAX map: ``block_index`` int32[B,B,B] maps a block
coordinate to its slot (or -1); the block table holds Morton ``keys``,
per-channel voxel bricks ``{name: [capacity, 512]}`` (linear voxel index
x + 8y + 64z), an ``active`` flag per slot and a bump counter ``n_blocks``.
With ``partitions`` D > 1 the slot space splits into D equal ranges, one
per x-slab of the block grid, each with its own bump counter
(``part_counts``): the owner-partitioned layout of the multi-device map
(`parallel/`), which also runs on one device.
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
from .numerics import trunc_i32

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


def channel_specs(specs) -> Tuple[ChannelSpec, ...]:
    """ChannelSpecs from ``(name, dtype name, init, empty)`` tuples, the
    form the JAX package's checkpoints store (``np.dtype(...).name``)."""
    return tuple(ChannelSpec(n, getattr(torch, str(d)), float(i), float(e))
                 for n, d, i, e in specs)


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
    #: owner partitions: slot range d holds the blocks of x-slab d
    partitions: int = 1
    #: int32[partitions] per-partition bump counters (sum == n_blocks)
    part_counts: Optional[torch.Tensor] = None

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
         device: torch.device, capacity: Optional[int] = None,
         partitions: int = 1) -> VoxelMap:
    """An empty map (`octree.py:init`, `supereight_tpu/core/octree.py:
    130-166`); ``partitions`` > 1 must divide the block grid edge and the
    capacity."""
    B = size // BLOCK_SIDE
    if capacity is None:
        capacity = min(B * B * B, max(4096, (B * B * B) // 4))
    if partitions > 1 and (B % partitions or capacity % partitions):
        raise ValueError(
            f"partitions={partitions} must divide the block grid edge "
            f"({B}) and the capacity ({capacity})")
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
        node_values=node_values, node_alloc=node_alloc,
        partitions=partitions,
        part_counts=torch.zeros((partitions,), **i32))


def partition_counts(m: VoxelMap) -> torch.Tensor:
    """int32[partitions]: each partition's live slots (``[n_blocks]`` for
    one partition)."""
    if m.partitions == 1 or m.part_counts is None:
        return m.n_blocks.reshape(1)
    return m.part_counts


def block_coords_table(m: VoxelMap) -> torch.Tensor:
    """All block keys decoded into int32[capacity, 3] block coordinates."""
    return torch.stack(morton.block_key_decode(m.keys), dim=-1)


def slot_mask(m: VoxelMap) -> torch.Tensor:
    """bool[capacity]: the live slots, a prefix of each partition's slot
    range (`octree.py:slot_mask`, `:484-491`)."""
    idx = torch.arange(m.capacity, dtype=torch.int32, device=m.device)
    if m.partitions == 1:
        return idx < m.n_blocks
    per_cap = m.capacity // m.partitions
    return (idx % per_cap) < m.part_counts[(idx // per_cap).long()]


def live_slots(m: VoxelMap) -> torch.Tensor:
    """int64[n_blocks]: the live slots in ascending order."""
    if m.partitions == 1:
        return torch.arange(int(m.n_blocks), device=m.device)
    return torch.nonzero(slot_mask(m))[:, 0]


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
    every touched block active (`octree.py:allocate_block_mask`,
    `:283-338`): within each owner partition (x-slab; the whole grid for
    one partition) a prefix sum over the unallocated wanted cells assigns
    the partition's next slots in flat order; cells past the partition's
    slot range stay unallocated and count into ``overflow``."""
    B = m.blocks_per_edge
    D = m.partitions
    cap = m.capacity
    per_cap = cap // D
    dev = m.device
    i32 = dict(dtype=torch.int32, device=dev)
    new = (wanted & (m.block_index < 0)).reshape(D, -1)
    order = torch.cumsum(new, 1, dtype=torch.int32) - 1
    counts = partition_counts(m)
    slots = counts[:, None] + order
    total_new = order[:, -1] + 1
    fits = new & (slots < per_cap)
    slots = slots + per_cap * torch.arange(D, **i32)[:, None]
    flat_new = torch.where(fits, slots, m.block_index.reshape(D, -1))

    lin = torch.arange(B * B * B, dtype=torch.int64, device=dev)
    new_keys = morton.block_key(lin // (B * B), (lin // B) % B, lin % B)
    keys = scatter_drop(m.keys, torch.where(fits, slots, cap).reshape(-1),
                        new_keys)
    touched = wanted.reshape(D, -1) & (flat_new >= 0)
    active = scatter_drop(m.active, torch.where(touched, flat_new, cap)
                          .reshape(-1), True)

    n_new = counts + total_new
    new_counts = torch.clamp(n_new, max=per_cap)
    return m.replace(block_index=flat_new.reshape(B, B, B), keys=keys,
                     n_blocks=new_counts.sum(dtype=torch.int32),
                     part_counts=new_counts, active=active,
                     overflow=m.overflow + torch.clamp(
                         n_new - per_cap, min=0).sum(dtype=torch.int32))


def _mark(mask: torch.Tensor, idx, sel: torch.Tensor) -> torch.Tensor:
    """``mask`` (bool) with ``True`` added at the cells ``idx`` (a tuple of
    index tensors) where ``sel``, dropping cells outside the mask as JAX's
    scatter drops them: an int32 max-scatter, so that duplicate cells keep
    any ``True`` and the host never syncs."""
    lin = torch.zeros_like(idx[0], dtype=torch.int64)
    for i, n in zip(idx, mask.shape):
        sel = sel & (i >= 0) & (i < n)
        lin = lin * n + i.long().clamp(0, n - 1)
    hit = torch.zeros(mask.numel(), dtype=torch.int32, device=mask.device)
    hit.scatter_reduce_(0, lin.reshape(-1), sel.reshape(-1).to(torch.int32),
                        "amax")
    return mask | (hit > 0).reshape(mask.shape)


def allocate_blocks(m: VoxelMap, block_coords: torch.Tensor,
                    valid: torch.Tensor) -> VoxelMap:
    """Allocate the blocks ``block_coords`` int[N, 3] where ``valid`` and
    in bounds (`octree.py:allocate_blocks`): their dense ``wanted`` mask
    through :func:`allocate_block_mask`."""
    B = m.blocks_per_edge
    wanted = _mark(torch.zeros((B, B, B), dtype=torch.bool, device=m.device),
                   block_coords.unbind(1), valid)
    return allocate_block_mask(m, wanted)


def allocate_octants(m: VoxelMap, coords: torch.Tensor, levels: torch.Tensor,
                     valid: torch.Tensor) -> VoxelMap:
    """Allocate octants at tree ``levels`` of voxel ``coords`` int[N, 3]
    (`octree.py:allocate_octants`): a request at or below the block level
    allocates a block; one at level l < block_level marks the 2x2x2 child
    group of ``node_alloc[l + 1]`` holding its coordinates."""
    m = allocate_blocks(m, coords >> BLOCK_BITS,
                        valid & (levels >= m.block_level))
    node_alloc = list(m.node_alloc)
    for level in range(m.block_level):
        store = level + 1
        s = 1 << store
        shift = m.max_depth - store
        sel = valid & (levels == level)
        o = [((coords[:, a] >> shift) & ~1).clamp(0, s - 1) for a in range(3)]
        for cid in range(8):
            node_alloc[store] = _mark(
                node_alloc[store], (o[0] + (cid & 1), o[1] + ((cid >> 1) & 1),
                                    o[2] + ((cid >> 2) & 1)), sel)
    return m.replace(node_alloc=node_alloc)


def set_voxels(m: VoxelMap, channel: str, vx, vy, vz, values) -> VoxelMap:
    """Write ``values`` into voxels (`octree.py:set_voxels`): no
    allocation, writes to unallocated or out-of-bounds voxels are
    dropped."""
    slot = fetch(m, vx, vy, vz)
    flat = m.voxels[channel].reshape(-1)
    idx = torch.where(slot >= 0, slot.clamp(min=0).long() * BLOCK_VOXELS
                      + _voxel_linear(vx, vy, vz).long(), flat.shape[0])
    values = torch.as_tensor(values, dtype=flat.dtype, device=flat.device)
    vox = dict(m.voxels)
    vox[channel] = scatter_drop(flat, idx.reshape(-1),
                                values.expand(idx.shape).reshape(-1)) \
        .reshape(m.voxels[channel].shape)
    return m.replace(voxels=vox)


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


def block_rows(m: VoxelMap) -> torch.Tensor:
    """int64[capacity]: each slot's row in a brick-tiled ``[B^3, 512]``
    view, ``(bx * B + by) * B + bz``."""
    B = m.blocks_per_edge
    bc = block_coords_table(m)
    return ((bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]).long()


def tile_rows(fill: torch.Tensor, m: VoxelMap,
              rows: torch.Tensor) -> torch.Tensor:
    """Brick-tiled ``[B^3, 512]``: the live slots' ``rows`` ([capacity,
    512]) at their blocks' rows, every other row its cell's ``fill``
    ([B^3], cast to the rows' dtype).  One write of the view and one row
    scatter of every slot, the dead ones into a scratch row ``B^3`` that is
    cut off (JAX's ``mode="drop"``), so the host reads nothing."""
    n = fill.shape[0]
    out = torch.cat([fill, fill[:1]]).to(rows.dtype)[:, None] \
        .expand(-1, BLOCK_VOXELS).contiguous()
    tgt = torch.where(slot_mask(m), block_rows(m), n)
    return out.index_copy_(0, tgt, rows)[:n]


def pack_tiled_multiscale(m: VoxelMap, channel: str) -> torch.Tensor:
    """Brick-tiled rows ``[B^3, 512]`` of one channel: allocated blocks
    carry their voxels, every other row its cell's :func:`node_fill` value
    (`octree.py:pack_tiled_multiscale`)."""
    return tile_rows(node_fill(m, channel), m, m.voxels[channel])


def leaves_count(m: VoxelMap) -> torch.Tensor:
    """Allocated blocks (`octree.py:leaves_count`)."""
    return m.n_blocks


def nodes_count(m: VoxelMap) -> torch.Tensor:
    """Allocated nodes plus blocks (`octree.py:nodes_count`): each marked
    2x2x2 child group of level l is one node of level l - 1."""
    n = m.n_blocks
    for level in range(1, m.block_level + 1):
        n = n + m.node_alloc[level].sum(dtype=torch.int32) // 8
    return n


def axis_aligned_map(m: VoxelMap, fn) -> VoxelMap:
    """Apply ``fn(values_dict, coords) -> values_dict`` to every voxel of
    every live block (`octree.py:axis_aligned_map`); ``coords`` is
    int32[capacity, 512, 3]."""
    i = torch.arange(BLOCK_VOXELS, dtype=torch.int32, device=m.device)
    offs = torch.stack([i % BLOCK_SIDE, (i // BLOCK_SIDE) % BLOCK_SIDE,
                        i // (BLOCK_SIDE * BLOCK_SIDE)], dim=-1)
    coords = (block_coords_table(m) * BLOCK_SIDE)[:, None, :] + offs
    new_vals = fn(dict(m.voxels), coords)
    live = slot_mask(m)[:, None]
    return m.replace(voxels={
        name: torch.where(live, torch.as_tensor(new_vals[name]).to(v.dtype),
                          v)
        for name, v in m.voxels.items()})


def pack_tiled(m: VoxelMap, channel: str) -> torch.Tensor:
    """Brick-tiled rows ``[B^3, 512]`` of one channel with ``empty`` in the
    unallocated rows (`octree.py:pack_tiled`)."""
    B = m.blocks_per_edge
    fill = torch.full((B * B * B,), _channel(m, channel).empty,
                      dtype=m.voxels[channel].dtype, device=m.device)
    return tile_rows(fill, m, m.voxels[channel])


def _untile(m: VoxelMap, tiled: torch.Tensor) -> torch.Tensor:
    """``[B^3, 512]`` brick rows -> the dense ``[S, S, S]`` volume (a
    brick's linear index is x + 8y + 64z, so its 512 unpack as (z, y, x))."""
    B = m.blocks_per_edge
    return tiled.reshape(B, B, B, BLOCK_SIDE, BLOCK_SIDE, BLOCK_SIDE) \
        .permute(0, 5, 1, 4, 2, 3).reshape(m.size, m.size, m.size)


def pack_dense(m: VoxelMap, channel: str) -> torch.Tensor:
    """One channel as a dense ``[S, S, S]`` volume with ``empty`` in
    unallocated space (`octree.py:pack_dense`)."""
    return _untile(m, pack_tiled(m, channel))


def pack_dense_multiscale(m: VoxelMap, channel: str) -> torch.Tensor:
    """Like :func:`pack_dense`, but unallocated space reads the deepest
    allocated node-pyramid value (`octree.py:pack_dense_multiscale`);
    coarse octants are block-sized or larger, so the block-cell fill of
    :func:`pack_tiled_multiscale` is exact."""
    return _untile(m, pack_tiled_multiscale(m, channel))


def unpack_dense(m: VoxelMap, channel: str, dense: torch.Tensor) -> VoxelMap:
    """Write a dense ``[S, S, S]`` volume back into the live blocks
    (`octree.py:unpack_dense`, the inverse of :func:`pack_dense`)."""
    B = m.blocks_per_edge
    flat = dense.reshape(B, BLOCK_SIDE, B, BLOCK_SIDE, B, BLOCK_SIDE) \
        .permute(0, 2, 4, 5, 3, 1).reshape(B * B * B, BLOCK_VOXELS)
    bricks = flat[block_rows(m).clamp(0, B * B * B - 1)]
    vox = dict(m.voxels)
    vox[channel] = torch.where(slot_mask(m)[:, None],
                               bricks.to(vox[channel].dtype), vox[channel])
    return m.replace(voxels=vox)


# ----------------------------------------------------------------------
# Voxel reads at integer and fractional coordinates
# ----------------------------------------------------------------------

def _channel(m: VoxelMap, name: str) -> ChannelSpec:
    return next(c for c in m.channels if c.name == name)


def fetch(m: VoxelMap, vx, vy, vz) -> torch.Tensor:
    """Slot of the block holding int32 voxel (vx, vy, vz); -1 where it is
    unallocated or out of bounds.  The block index is read at the clamped
    block coordinates."""
    B = m.blocks_per_edge
    inb = ((vx >= 0) & (vx < m.size) & (vy >= 0) & (vy < m.size)
           & (vz >= 0) & (vz < m.size))
    b = [(v >> BLOCK_BITS).clamp(0, B - 1).long() for v in (vx, vy, vz)]
    return torch.where(inb, m.block_index[b[0], b[1], b[2]], -1)


def _voxel_linear(vx, vy, vz) -> torch.Tensor:
    """Linear index inside a brick, x + 8y + 64z."""
    m7 = BLOCK_SIDE - 1
    return (vx & m7) + (vy & m7) * BLOCK_SIDE \
        + (vz & m7) * (BLOCK_SIDE * BLOCK_SIDE)


def get(m: VoxelMap, channel: str, vx, vy, vz) -> torch.Tensor:
    """Voxel value at int32 coordinates; the channel's ``empty`` outside
    the allocated blocks (a clamped slot, then a select)."""
    slot = fetch(m, vx, vy, vz)
    val = m.voxels[channel][slot.clamp(min=0).long(),
                            _voxel_linear(vx, vy, vz).long()]
    return torch.where(slot >= 0, val, _channel(m, channel).empty)


def get_multiscale(m: VoxelMap, channel: str, vx, vy, vz) -> torch.Tensor:
    """Value of the deepest allocated octant holding the voxel: the block's
    voxel where allocated, else the deepest allocated node-pyramid cell,
    else ``empty``."""
    spec = _channel(m, channel)
    val = torch.full(vx.shape, spec.empty, dtype=spec.dtype, device=vx.device)
    for level in range(1, m.block_level + 1):
        shift = m.max_depth - level
        s = 1 << level
        o = [(v >> shift).clamp(0, s - 1).long() for v in (vx, vy, vz)]
        val = torch.where(m.node_alloc[level][o[0], o[1], o[2]],
                          m.node_values[level][channel][o[0], o[1], o[2]],
                          val)
    slot = fetch(m, vx, vy, vz)
    leaf = m.voxels[channel][slot.clamp(min=0).long(),
                             _voxel_linear(vx, vy, vz).long()]
    return torch.where(slot >= 0, leaf, val)


def _corner_offsets(device) -> torch.Tensor:
    """int32[8, 3]: corner i has x-bit i&1, y-bit (i>>1)&1, z-bit
    (i>>2)&1."""
    o = torch.arange(8, dtype=torch.int32, device=device)
    return torch.stack([o & 1, (o >> 1) & 1, (o >> 2) & 1], dim=-1)


def _trilinear(vals: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Blend corner values [..., 8] by the fractional position [..., 3]:
    weight (wx * wy) * wz per corner, summed corner by corner."""
    w = [torch.stack([1 - factor[..., a], factor[..., a]], dim=-1)
         for a in range(3)]
    acc = None
    for i in range(8):
        term = vals[..., i] * (w[0][..., i & 1] * w[1][..., (i >> 1) & 1]
                               * w[2][..., (i >> 2) & 1])
        acc = term if acc is None else acc + term
    return acc


def _corners(pos: torch.Tensor):
    """(int32 corners [..., 8, 3] from floor(pos) clamped at 0, the
    fractional position [..., 3])."""
    base = trunc_i32(torch.floor(pos))
    lower = base.clamp(min=0)
    return lower[..., None, :] + _corner_offsets(pos.device), pos - base


def interp(m: VoxelMap, channel: str, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of the leaf data at fractional voxel
    coordinates ``pos`` [..., 3] (``empty`` outside allocated blocks)."""
    corner, factor = _corners(pos)
    vals = get(m, channel, corner[..., 0], corner[..., 1], corner[..., 2])
    return _trilinear(vals.to(torch.float32), factor)


def interp_multiscale(m: VoxelMap, channel: str,
                      pos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation whose corners fall back to the deepest
    allocated node value where leaf blocks are missing."""
    corner, factor = _corners(pos)
    vals = get_multiscale(m, channel, corner[..., 0], corner[..., 1],
                          corner[..., 2])
    return _trilinear(vals.to(torch.float32), factor)


def grad(m: VoxelMap, channel: str, pos: torch.Tensor) -> torch.Tensor:
    """Trilinearly blended central-difference gradient [..., 3]: per
    corner, the difference of the border-clamped neighbours along each
    axis, blended by the interpolation weights and scaled by
    ``0.5 * dim / size``."""
    corner, factor = _corners(pos)
    grads = []
    for axis in range(3):
        step = torch.zeros(3, dtype=torch.int32, device=pos.device)
        step[axis] = 1
        hi = (corner + step).clamp(0, m.size - 1)
        lo = (corner - step).clamp(0, m.size - 1)
        v_hi = get(m, channel, hi[..., 0], hi[..., 1], hi[..., 2])
        v_lo = get(m, channel, lo[..., 0], lo[..., 1], lo[..., 2])
        grads.append(_trilinear(v_hi.to(torch.float32)
                                - v_lo.to(torch.float32), factor))
    return torch.stack(grads, dim=-1) * (0.5 * m.dim / m.size)
