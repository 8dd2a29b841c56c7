"""Stored per-voxel field gradients, the raycaster's normal source with
``raycast_normals="stored"`` (counterpart of
`supereight_tpu/pipeline/gradmap.py`).

The field changes only on integration frames, so the gradient is built then
over the whole block table and stored; the raycast reads the gradient of
its hit voxel with one block lookup and one 4-wide row per pixel instead of
6 volume taps.

Inside a brick (``l = x + 8y + 64z``) the three axis shifts are rotations
of the ``[capacity, 512]`` row by 1, 8 and 64 lanes; the face voxels come
from the 6 face-neighbour bricks (one ``block_index`` lookup and one row
gather per direction and block).  As `raycast._grad6` over the NaN-encoded
view: invalid (weight 0, unobserved) and unallocated in-volume taps read
the channel's ``init``, out-of-volume taps its ``empty``.
"""

from __future__ import annotations

import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.numerics import trunc_i32
from supereight_tpu_torch.core.octree import (BLOCK_SIDE, BLOCK_VOXELS,
                                              VoxelMap)
from supereight_tpu_torch.utils.perfstats import Stats

#: table layout: [capacity, 512, 4] bf16 rows (gx, gy, gz, F): g* the
#: per-voxel-step central difference 0.5 * (f[v+e] - f[v-e]), F the
#: NaN-encoded field value (NaN = invalid or unobserved, as in pack_view)
GRAD_COMPONENTS = 4
#: (axis, lane stride) of the brick layout l = x + 8y + 64z
_AXIS_STRIDES = ((0, 1), (1, BLOCK_SIDE), (2, BLOCK_SIDE * BLOCK_SIDE))


def empty_table(capacity: int, device) -> torch.Tensor:
    """The all-unobserved table (gradient 0, value NaN) a state carries
    before its first integration."""
    t = torch.zeros((capacity, BLOCK_VOXELS, GRAD_COMPONENTS),
                    dtype=torch.bfloat16, device=device)
    t[..., 3] = float("nan")
    return t


def _neighbour_rows(m: VoxelMap, R, bc, live, axis: int, step: int,
                    init: float, empty: float) -> torch.Tensor:
    """The rows of ``R`` of each block's face neighbour along ``axis`` in
    direction ``step`` (+1 / -1): ``init`` where the neighbour is in the
    volume and not allocated (or the block is dead), ``empty`` outside the
    volume."""
    B = m.blocks_per_edge
    n = bc[:, axis] + step
    oob = (n < 0) | (n >= B)
    nb = [bc[:, 0], bc[:, 1], bc[:, 2]]
    nb[axis] = n.clamp(0, B - 1)
    nslot = m.block_index[nb[0].long(), nb[1].long(), nb[2].long()]
    nslot = torch.where(oob | ~live, -1, nslot)
    rows = R[nslot.clamp(min=0).long()]
    bf = lambda v: torch.full((), v, dtype=torch.bfloat16, device=R.device)
    fill = torch.where(oob, bf(empty), bf(init))[:, None]
    return torch.where((nslot >= 0)[:, None], rows, fill)


def build_table(m: VoxelMap, field) -> torch.Tensor:
    """bf16 [capacity, 512, 4] (gx, gy, gz, F) of every live brick; dead
    rows read unobserved.  ``g`` is the unscaled central difference of the
    resolved field (the value where it is a valid sample, else ``init``),
    rounded to bf16 first as the raycaster's view is; metric gradients are
    ``g * inverse_voxel_size``."""
    spec = next(c for c in m.channels if c.name == field.select_channel)
    data = {c.name: m.voxels[c.name].to(torch.float32) for c in m.channels}
    live = octree.slot_mask(m)
    obs = field.sample_valid(data) & live[:, None]
    f = data[field.select_channel]
    R = torch.where(obs, f, spec.init).to(torch.bfloat16)
    F = torch.where(obs, f, float("nan")).to(torch.bfloat16)
    bc = octree.block_coords_table(m)
    lidx = torch.arange(BLOCK_VOXELS, device=f.device)
    comps = []
    for axis, st in _AXIS_STRIDES:
        la = (lidx // st) % BLOCK_SIDE
        # v + e: the row rotated by one step, the last layer from the
        # neighbour's first; v - e alike
        up = _neighbour_rows(m, R, bc, live, axis, +1, spec.init, spec.empty)
        plus = torch.where((la == BLOCK_SIDE - 1)[None],
                           torch.roll(up, (BLOCK_SIDE - 1) * st, dims=1),
                           torch.roll(R, -st, dims=1))
        down = _neighbour_rows(m, R, bc, live, axis, -1, spec.init,
                               spec.empty)
        minus = torch.where((la == 0)[None],
                            torch.roll(down, -(BLOCK_SIDE - 1) * st, dims=1),
                            torch.roll(R, st, dims=1))
        comps.append(0.5 * (plus.to(torch.float32) - minus.to(torch.float32)))
    comps.append(F.to(torch.float32))
    table = torch.stack(comps, dim=-1).to(torch.bfloat16)
    with Stats.host_read("grad_dead"):
        dead = torch.tensor([0.0, 0.0, 0.0, float("nan")],
                            device=f.device).to(torch.bfloat16)
    return torch.where(live[:, None, None], table, dead)


def sample(m: VoxelMap, table: torch.Tensor, pos_vox: torch.Tensor):
    """(g [..., 3], F, valid) at the voxel holding fractional voxel
    coordinates ``pos_vox`` [..., 3]; unallocated or out-of-volume queries
    give g = 0, F = NaN, valid False."""
    v = trunc_i32(torch.floor(pos_vox))
    inb = ((v >= 0) & (v < m.size)).all(-1)
    vc = v.clamp(0, m.size - 1)
    b = (vc >> 3).long()
    l = (vc & 7).long()
    slot = m.block_index[b[..., 0], b[..., 1], b[..., 2]]
    ok = inb & (slot >= 0)
    col = l[..., 0] + l[..., 1] * BLOCK_SIDE \
        + l[..., 2] * (BLOCK_SIDE * BLOCK_SIDE)
    flat = table.reshape(-1, GRAD_COMPONENTS)
    row = flat[slot.clamp(min=0).long() * BLOCK_VOXELS + col] \
        .to(torch.float32)
    g = torch.where(ok[..., None], row[..., :3], 0.0)
    return g, torch.where(ok, row[..., 3], float("nan")), ok
