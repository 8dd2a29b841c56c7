"""SDF block allocation and projective fusion (counterpart of the SDF half
of `supereight_tpu/pipeline/integration.py`).

Allocation is the per-pixel band march of ``buildAllocationList`` over a
(decimated) pixel grid, deduplicated by one dense block mask.  Fusion
compacts the frustum candidates into at most ``budget`` rows and fuses them
through the SDF kernel (`ops/integrate_kernel.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.numerics import matvec, trunc_i32
from supereight_tpu_torch.core.octree import BLOCK_SIDE, VoxelMap
from supereight_tpu_torch.ops import integrate_kernel
from .constants import FAR_PLANE
from .preprocessing import norm

PATCH = integrate_kernel.PATCH


def _pixel_valid(px, py, pos_cam, frame_hw):
    H, W = frame_hw
    return ((pos_cam[..., 2] >= 1e-4) & (px >= 0.5) & (px <= W - 1.5)
            & (py >= 0.5) & (py <= H - 1.5))


def _sample_depth(depth, px, py, valid):
    """Nearest depth sample at int(pixel), 0 where not ``valid``."""
    H, W = depth.shape
    ix = trunc_i32(px).clamp(0, W - 1).long()
    iy = trunc_i32(py).clamp(0, H - 1).long()
    return torch.where(valid, depth[iy, ix], 0.0)


def _alloc_decimation(m: VoxelMap, depth_shape) -> int:
    """Pixel stride of the allocation march: 2 while a block's footprint at
    the far plane stays >= 4 px (fx bounded below by W/3)."""
    foot_far = BLOCK_SIDE * m.voxel_size * (depth_shape[1] / 3.0) / FAR_PLANE
    return 2 if foot_far >= 4.0 else 1


def _pixel_rays(depth, pose, K, decim: int):
    """Per-(decimated-)pixel world vertex at the measured depth + unit
    direction toward the camera.  The strided set always includes the last
    row and column."""
    H, W = depth.shape
    dev = depth.device
    extra = 1 if decim > 1 else 0
    iy = torch.clamp(torch.arange((H + decim - 1) // decim + extra,
                                  device=dev) * decim, max=H - 1)
    ix = torch.clamp(torch.arange((W + decim - 1) // decim + extra,
                                  device=dev) * decim, max=W - 1)
    d = depth[iy][:, ix]
    x = (ix.to(torch.float32) + 0.5)[None, :]
    y = (iy.to(torch.float32) + 0.5)[:, None]
    kpose = pose @ torch.linalg.inv(K)
    hom = torch.stack([x * d, y * d, d, torch.ones_like(d)], dim=-1)
    vertex = matvec(kpose[:3], hom)
    camera = pose[:3, 3]
    to_cam = camera - vertex
    dist = norm(to_cam, keepdim=True)
    direction = to_cam / torch.clamp(dist, min=1e-12)
    return d, vertex, direction, dist[..., 0], camera


def sdf_wanted_mask(depth, pose, K, *, size: int, dim: float, band: float,
                    decim: int = 1, stride: float = 1.0) -> torch.Tensor:
    """Dense bool[B,B,B] block-request mask of the band march: every pixel
    with depth > 0 samples a ``band``-long segment centred on its surface
    point at voxel spacing (times ``stride``)."""
    inv_vs = size / dim
    d, vertex, direction, _, _ = _pixel_rays(depth, pose, K, decim)
    n_steps = max(int(np.ceil(band * inv_vs / stride)), 1)
    t = -0.5 * band + (band / n_steps) * torch.arange(
        n_steps, dtype=torch.float32, device=depth.device)
    pts = vertex[..., None, :] + direction[..., None, :] * t[:, None]
    bc = trunc_i32(torch.floor(pts.reshape(-1, 3) * inv_vs)) \
        >> octree.BLOCK_BITS
    B = size // BLOCK_SIDE
    ok = ((d > 0)[..., None].expand(d.shape + (n_steps,)).reshape(-1)
          & (bc >= 0).all(1) & (bc < B).all(1))
    lin = (bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]
    wanted = torch.zeros((B * B * B,), dtype=torch.bool, device=depth.device)
    # scatter True at the ok entries only (duplicates all write True)
    return octree.scatter_drop(wanted, torch.where(ok, lin, B * B * B),
                               True).reshape(B, B, B)


def allocate_sdf(m: VoxelMap, depth, pose, K, band: float,
                 stride: float = 1.0) -> VoxelMap:
    """SDF block allocation: band-march mask, then slot assignment."""
    wanted = sdf_wanted_mask(depth, pose, K, size=m.size, dim=m.dim,
                             band=band, decim=_alloc_decimation(m, depth.shape),
                             stride=stride)
    return octree.allocate_block_mask(m, wanted)


def frustum_candidates(m: VoxelMap, T_cw, K, frame_hw):
    """bool[capacity]: live active blocks whose centre projects into the
    frame dilated by the block's footprint and that are not fully behind
    the camera (a superset of the blocks with a voxel in frame)."""
    H, W = frame_hw
    vs = m.voxel_size
    bc = octree.block_coords_table(m)
    centers = ((bc * BLOCK_SIDE).to(torch.float32) + 0.5 * BLOCK_SIDE) * vs
    ccam, cpx, cpy = integrate_kernel.project(T_cw, K, centers)
    diag = 1.7320508 * BLOCK_SIDE * vs
    foot = torch.abs(K[0, 0]) * diag / torch.clamp(ccam[..., 2], min=1e-3)
    return (octree.slot_mask(m) & m.active & (ccam[..., 2] > -0.5 * diag)
            & (cpx >= -foot) & (cpx <= W - 1 + foot)
            & (cpy >= -foot) & (cpy <= H - 1 + foot))


def integrate(m: VoxelMap, field, depth, pose, K, budget: int = 0,
              patch: int = PATCH) -> VoxelMap:
    """Fuse one depth frame.  With ``0 < budget < capacity`` only the first
    ``budget`` frustum candidates (in slot order) fuse; the rest keep their
    voxels and active flag and count into ``overflow``.  Fused rows refresh
    ``active`` from visibility."""
    T_cw = torch.linalg.inv(pose).contiguous()
    K = K.contiguous()
    depth = depth.contiguous()
    vs = m.voxel_size
    bc_full = octree.block_coords_table(m)
    live_full = octree.slot_mask(m) & m.active

    if budget and budget < m.capacity:
        cand = frustum_candidates(m, T_cw, K, depth.shape)
        idx = torch.nonzero(cand)[:, 0]           # ascending slot order
        sel = idx[:budget]
        m = m.replace(overflow=m.overflow + max(idx.numel() - budget, 0))
        bc = bc_full[sel]
        live = torch.ones(sel.shape, dtype=torch.bool, device=sel.device)
        rows = {name: v[sel] for name, v in m.voxels.items()}
    else:
        sel = None
        bc, live, rows = bc_full, live_full, m.voxels

    tsdf, weight, visible = integrate_kernel.fuse_sdf(
        bc, live, rows["tsdf"], rows["weight"], depth, T_cw, K, field.mu,
        field.max_weight, vs, patch)

    if sel is not None:
        voxels = {"tsdf": m.voxels["tsdf"].index_copy(0, sel, tsdf),
                  "weight": m.voxels["weight"].index_copy(0, sel, weight)}
        active = m.active.index_copy(0, sel, visible)
    else:
        voxels = {"tsdf": tsdf, "weight": weight}
        active = torch.where(live_full, visible, m.active)
    m = m.replace(voxels=voxels, active=active)
    return _update_nodes(m, field, depth, T_cw, K)


def _update_nodes(m: VoxelMap, field, depth, T_cw, K) -> VoxelMap:
    """Coarse node-pyramid updates: project every allocated pyramid cell's
    corner and fuse its depth sample."""
    node_values = list(m.node_values)
    for level in range(1, m.block_level + 1):
        s = 1 << level
        g = torch.arange(s, dtype=torch.float32, device=m.device)
        grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1)
        corners = grid * ((m.size // s) * m.voxel_size)
        pos_cam, px, py = integrate_kernel.project(T_cw, K, corners)
        alloc = m.node_alloc[level]
        ok = _pixel_valid(px, py, pos_cam, depth.shape) & alloc
        vals = m.node_values[level]
        new = field.update(vals, pos_cam, _sample_depth(depth, px, py, ok),
                           ok)
        node_values[level] = {name: torch.where(alloc, new[name], vals[name])
                              for name in vals}
    return m.replace(node_values=node_values)
