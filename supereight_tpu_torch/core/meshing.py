"""Surface mesh extraction from the sparse voxel map: marching tetrahedra
(counterpart of `supereight_tpu/core/meshing.py`).

Each cell of each live block is cut into 6 tetrahedra around its 0-6
diagonal, and each tetrahedron gives up to 2 triangles from a 16-case
table derived below.  A cell with any unobserved corner, or at the map's
top border, gives none.  Vertices are the linear zero crossings along the
tetrahedra's edges, in metres.  The triangles come out in the JAX
function's order: block by live slot, then cell with x slowest, then
tetrahedron, then triangle.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import octree
from .numerics import fma
from .octree import BLOCK_SIDE, VoxelMap

# Cube corner offsets in the reference's order:
# 0:(0,0,0) 1:(1,0,0) 2:(1,0,1) 3:(0,0,1) 4:(0,1,0) 5:(1,1,0) 6:(1,1,1) 7:(0,1,1)
CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1],
    [0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1],
], np.int32)

# 6 tetrahedra around the 0-6 main diagonal
TETS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6],
], np.int32)


def _build_tet_table() -> np.ndarray:
    """The marching-tetrahedra case table int32[16, 2, 3, 2]: for each of
    the 16 inside-masks of a tetrahedron (a, b, c, d), up to 2 triangles,
    each vertex an edge (inside corner, outside corner); -1 pads."""
    table = np.full((16, 2, 3, 2), -1, np.int32)
    for mask in range(16):
        inside = [i for i in range(4) if (mask >> i) & 1]
        outside = [i for i in range(4) if not ((mask >> i) & 1)]
        if len(inside) == 1:
            i = inside[0]
            table[mask, 0] = [[i, outside[0]], [i, outside[1]],
                              [i, outside[2]]]
        elif len(inside) == 3:
            o = outside[0]
            table[mask, 0] = [[inside[0], o], [inside[2], o], [inside[1], o]]
        elif len(inside) == 2:
            i0, i1 = inside
            o0, o1 = outside
            # quad (i0-o0, i0-o1, i1-o1, i1-o0) -> two triangles
            table[mask, 0] = [[i0, o0], [i0, o1], [i1, o1]]
            table[mask, 1] = [[i0, o0], [i1, o1], [i1, o0]]
    return table


TET_TABLE = _build_tet_table()
MAX_TRIS_PER_CELL = 2 * len(TETS)   # 12


def _cell_triangles(corner_pos, corner_val, inside_mask, observed_all):
    """Candidate triangles of a batch of cells: corner_pos f32[..., 8, 3]
    (metres), corner_val f32[..., 8], inside_mask bool[..., 8],
    observed_all bool[...].  Returns (tris f32[..., 12, 3, 3], valid
    bool[..., 12]), triangle tet * 2 + k.

    The endpoints are gathered by index where JAX contracts one-hot
    weights: with 0/1 weights and finite values both are exact.  The
    crossing ``pa + frac * (pb - pa)`` is one multiply-add, as XLA's CPU
    code computes it."""
    dev = corner_val.device
    table = torch.from_numpy(TET_TABLE).to(dev)
    lead = corner_val.shape[:-1]
    tris, valids = [], []
    for t in range(len(TETS)):
        cidx = torch.from_numpy(TETS[t]).long().to(dev)
        tv = corner_val[..., cidx]                            # [..., 4]
        tp = corner_pos[..., cidx, :]                         # [..., 4, 3]
        tin = inside_mask[..., cidx].to(torch.int64)
        mask = tin[..., 0] + 2 * tin[..., 1] + 4 * tin[..., 2] \
            + 8 * tin[..., 3]
        entries = table[mask]                                 # [..., 2, 3, 2]
        ends = []
        for e in range(2):
            i = entries[..., e].clamp(min=0).reshape(*lead, 6).long()
            ends.append((torch.gather(tv, -1, i).reshape(*lead, 2, 3),
                         torch.gather(tp, -2, i[..., None].expand(
                             *lead, 6, 3)).reshape(*lead, 2, 3, 3)))
        (va, pa), (vb, pb) = ends
        denom = vb - va
        denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)
        frac = ((0.0 - va) / denom)[..., None]
        tris.append(fma(frac, pb - pa, pa))
        valids.append((entries[..., 0, 0] >= 0) & observed_all[..., None])
    return torch.cat(tris, dim=-3), torch.cat(valids, dim=-1)


def _block_chunk_triangles(m: VoxelMap, channel: str, inside_fn, observed_fn,
                           slots: torch.Tensor):
    """Candidate triangles of every cell of the blocks in ``slots``:
    (tris f32[n, 512, 12, 3, 3], valid bool[n, 512, 12])."""
    dev = m.device
    base = octree.block_coords_table(m)[slots.long()] * BLOCK_SIDE  # [n, 3]
    r = torch.arange(BLOCK_SIDE, dtype=torch.int32, device=dev)
    cell = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) \
        .reshape(-1, 3)                                           # [512, 3]
    cell = base[:, None, :] + cell[None]                          # [n, 512, 3]
    corners = cell[:, :, None, :] + torch.from_numpy(CORNERS).to(dev)
    vx, vy, vz = corners[..., 0], corners[..., 1], corners[..., 2]
    vals = {c.name: octree.get(m, c.name, vx, vy, vz) for c in m.channels}
    fval = vals[channel].to(torch.float32)
    # cells whose +1 corner would leave the volume are skipped
    in_bounds = (cell < m.size - 1).all(-1)
    obs_all = observed_fn(vals).all(-1) & in_bounds
    pos = corners.to(torch.float32) * np.float32(m.voxel_size)
    return _cell_triangles(pos, fval, inside_fn(fval), obs_all)


def marching_cubes(m: VoxelMap, channel: str,
                   inside: Callable = lambda f: f < 0.0,
                   observed: Optional[Callable] = None,
                   chunk: int = 256) -> torch.Tensor:
    """The surface mesh, float32 [n_tris, 3, 3] in metres on the map's
    device, ``chunk`` live blocks at a time (the result does not depend on
    it).  ``observed`` defaults to the reference's rule: the map's other
    channel (the weight) is non-zero at every corner."""
    if observed is None:
        other = [c.name for c in m.channels if c.name != channel]
        w = other[0] if other else channel
        observed = lambda vals: vals[w] != 0.0
    live = torch.nonzero(octree.slot_mask(m))[:, 0]
    out = [torch.zeros((0, 3, 3), dtype=torch.float32, device=m.device)]
    for s0 in range(0, live.numel(), chunk):
        tris, valid = _block_chunk_triangles(m, channel, inside, observed,
                                             live[s0:s0 + chunk])
        out.append(tris.reshape(-1, 3, 3)[valid.reshape(-1)])
    return torch.cat(out)
