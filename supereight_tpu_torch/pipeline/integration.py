"""Block allocation and projective fusion (counterpart of
`supereight_tpu/pipeline/integration.py`, single partition).

SDF allocation is the per-pixel band march of ``buildAllocationList`` over a
(decimated) pixel grid, deduplicated by one dense block mask; OFusion's is
the distance-adaptive octant march of ``buildOctantList``, one dense request
mask per octree level.  Fusion picks at most ``budget`` frustum candidates
(``frustum_select``, which on the card also inverts the pose in its one
launch) or every live slot and fuses them in place on the
map's block table through the field's kernel (`ops/integrate_kernel.py`:
``fuse_sdf`` or ``fuse_ofusion``, which also writes a held SDF read view's
fused rows and updates the coarse node pyramid, ``update_nodes``' values,
in the same launch on the card); on the card a frame without allocation
reads nothing back.
``unallocated_fraction`` is the on-demand allocation gate's signal.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.numerics import inv, matvec, trunc_i32
from supereight_tpu_torch.core.octree import BLOCK_SIDE, VoxelMap
from supereight_tpu_torch.fields.ofusion import (compute_stepsize,
                                                 step_to_depth)
from supereight_tpu_torch.ops import integrate_kernel
from .constants import FAR_PLANE
from .preprocessing import norm

PATCH = integrate_kernel.PATCH


def _alloc_decimation(m: VoxelMap, depth_shape) -> int:
    """Pixel stride of the allocation march: 2 while a block's footprint at
    the far plane stays >= 4 px (fx bounded below by W/3)."""
    foot_far = BLOCK_SIDE * m.voxel_size * (depth_shape[1] / 3.0) / FAR_PLANE
    return 2 if foot_far >= 4.0 else 1


def _pixel_rays(depth, pose, K, decim: int, row0: int = 0):
    """Per-(decimated-)pixel world vertex at the measured depth + unit
    direction toward the camera.  The strided set always includes the last
    row and column.  ``row0`` offsets the pixel rows when ``depth`` is a
    row strip of the camera's image."""
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
    if row0:
        y = y + float(row0)
    kpose = pose @ inv(K)
    hom = torch.stack([x * d, y * d, d, torch.ones_like(d)], dim=-1)
    vertex = matvec(kpose[:3], hom)
    camera = pose[:3, 3]
    to_cam = camera - vertex
    dist = norm(to_cam, keepdim=True)
    direction = to_cam / torch.clamp(dist, min=1e-12)
    return d, vertex, direction, dist[..., 0], camera


def _share_rows(d, row_share):
    """``d`` with the ray rows of other ranks zeroed: ``row_share = (rank,
    D)`` keeps every D-th ray row from row ``rank`` (a zero depth never
    requests), so the OR of the D shares' masks is the full mask."""
    if row_share is None:
        return d
    rank, n = row_share
    own = (torch.arange(d.shape[0], device=d.device) % n) == rank
    return d * own[:, None].to(d.dtype)


def sdf_wanted_mask(depth, pose, K, *, size: int, dim: float, band: float,
                    decim: int = 1, stride: float = 1.0, row0: int = 0,
                    row_share=None) -> torch.Tensor:
    """Dense bool[B,B,B] block-request mask of the band march: every pixel
    with depth > 0 samples a ``band``-long segment centred on its surface
    point at voxel spacing (times ``stride``).  For the multi-device map
    (JAX `integration.py:147-170`): ``row0`` is the first image row of a
    ``depth`` strip, ``row_share = (rank, D)`` marches one rank's
    round-robin share of the ray rows (:func:`_share_rows`)."""
    inv_vs = size / dim
    d, vertex, direction, _, _ = _pixel_rays(depth, pose, K, decim, row0)
    d = _share_rows(d, row_share)
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


#: the coarse march's stride-2 ray-grid offsets, rotated by the phase
_PHASE_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def ofusion_wanted_masks(m: VoxelMap, depth, pose, K, band: float,
                         coarse_stride: bool = True,
                         phase: Optional[int] = None,
                         row_share=None) -> List[torch.Tensor]:
    """Per-level dense octant-request masks bool[2^l]^3 of the occupancy
    march (`integration.py:ofusion_wanted_masks`).  Each pixel marches from
    half a band behind its surface point toward the camera: voxel steps
    through the band request blocks, 10-voxel steps to 1.5 bands travelled
    request 16-voxel octants, 30-voxel steps to the camera 32-voxel ones.
    With ``coarse_stride`` the two coarse zones march every second ray row
    and column when their octants' far-plane footprint is >= 4 px and the
    ray grid is not already decimated; ``phase`` (the allocation count)
    rotates that grid through its 4 offsets, ``None`` pins (0, 0).
    ``row_share = (rank, D)`` marches one rank's round-robin share of the
    ray rows, whose masks OR into the full ones (JAX `integration.py:
    212-235`)."""
    decim = _alloc_decimation(m, depth.shape)
    d, vertex, direction, dist, _ = _pixel_rays(depth, pose, K, decim)
    d = _share_rows(d, row_share)
    vs = m.voxel_size
    inv_vs = m.inverse_voxel_size
    origin = vertex - (0.5 * band) * direction
    ok0 = d > 0
    dev = depth.device
    masks = [torch.zeros((1 << l,) * 3, dtype=torch.bool, device=dev)
             for l in range(m.block_level + 1)]
    fx_min = depth.shape[1] / 3.0

    def zone_stride(level: int) -> int:
        if not coarse_stride or decim > 1:
            return 1
        edge_m = float((1 << (m.max_depth - level)) * vs)
        return 2 if edge_m * fx_min / FAR_PLANE >= 4.0 else 1

    def scatter_zone(level: int, t, extra_ok=None, stride: int = 1):
        """Request the level-``level`` octants of the samples at
        ``origin + t * direction`` (``t`` [n] distances travelled)."""
        n = 1 << level
        oy, ox = (0, 0)
        if stride > 1 and phase is not None:
            oy, ox = _PHASE_OFFSETS[phase % 4]
        sl = (slice(oy, None, stride), slice(ox, None, stride))
        org, dr, okz, dst = origin[sl], direction[sl], ok0[sl], dist[sl]
        pts = org[..., None, :] + dr[..., None, :] * t[:, None]
        vox = trunc_i32(torch.floor(pts * inv_vs))
        ok = (okz[..., None] & (vox >= 0).all(-1) & (vox < m.size).all(-1)
              & (t < dst[..., None]))
        if extra_ok is not None:
            ok = ok & extra_ok
        oc = (vox >> (m.max_depth - level)).clamp(0, n - 1).reshape(-1, 3)
        lin = (oc[:, 0] * n + oc[:, 1]) * n + oc[:, 2]
        # scatter True at the ok entries only (duplicates all write True)
        masks[level] = octree.scatter_drop(
            masks[level].reshape(-1),
            torch.where(ok.reshape(-1), lin, n * n * n), True).reshape(n, n, n)

    f32 = dict(dtype=torch.float32, device=dev)
    # zone 1: voxel steps through the band -> blocks
    n1 = max(int(np.ceil(band * inv_vs)), 1)
    scatter_zone(m.block_level, (band / n1) * torch.arange(n1, **f32))

    step_mid = compute_stepsize(band, band, vs)                 # 10 voxels
    lvl_mid = max(step_to_depth(step_mid, m.max_depth, vs), 0)
    step_far = compute_stepsize(1.6 * band, band, vs)           # 30 voxels
    lvl_far = max(step_to_depth(step_far, m.max_depth, vs), 0)

    # zone 2: 10-voxel steps, band .. 1.5 band travelled
    n2 = max(int(np.ceil(0.5 * band / step_mid)), 1)
    t2 = band + step_mid * torch.arange(n2, **f32)
    scatter_zone(lvl_mid, t2, extra_ok=t2 < 1.5 * band,
                 stride=zone_stride(lvl_mid))

    # zone 3: 30-voxel steps to the camera (frustum-diagonal bound)
    t3_start = band + n2 * step_mid
    n3 = max(int(np.ceil((1.42 * FAR_PLANE + band - t3_start) / step_far)),
             1)
    scatter_zone(lvl_far, t3_start + step_far * torch.arange(n3, **f32),
                 stride=zone_stride(lvl_far))
    return masks


def allocate_ofusion(m: VoxelMap, depth, pose, K, band: float,
                     coarse_stride: bool = True,
                     phase: Optional[int] = None) -> VoxelMap:
    """Occupancy multi-scale allocation: the octant march's masks, then
    blocks and node cells (`octree.allocate_octant_masks`)."""
    masks = ofusion_wanted_masks(m, depth, pose, K, band,
                                 coarse_stride=coarse_stride, phase=phase)
    return octree.allocate_octant_masks(m, masks)


def unallocated_fraction(m: VoxelMap, depth, pose, K, decim: int = 4,
                         border: float = 0.0) -> torch.Tensor:
    """float32[]: the fraction of the (decimated) valid depth pixels whose
    surface block is not allocated, the signal of the on-demand allocation
    gate.  ``border`` crops that fraction of the image on each side
    first."""
    d, vertex, _, _, _ = _pixel_rays(depth, pose, K, decim)
    if border > 0.0:
        Hd, Wd = d.shape
        by, bx = int(Hd * border), int(Wd * border)
        d, vertex = d[by:Hd - by, bx:Wd - bx], vertex[by:Hd - by, bx:Wd - bx]
    bc = trunc_i32(torch.floor(vertex * m.inverse_voxel_size)) \
        >> octree.BLOCK_BITS
    B = m.blocks_per_edge
    inside = (bc >= 0).all(-1) & (bc < B).all(-1) & (d > 0)
    b = bc.clamp(0, B - 1).long()
    unalloc = (m.block_index[b[..., 0], b[..., 1], b[..., 2]] < 0) & inside
    return unalloc.sum().to(torch.float32) \
        / inside.sum().clamp(min=1).to(torch.float32)


def fusion_operands(m: VoxelMap, pose, K, frame_hw, budget: int = 0):
    """The operands of a fusion of this map from ``pose``: ``(slots,
    overflow, T_cw)``, ``T_cw`` = ``inv(pose)``.  With ``0 < budget <
    capacity``: ``integrate_kernel.frustum_select``'s (one launch on the
    card, the inverse inside it): int32 [budget] slots (the first
    ``budget`` frustum candidates in ascending slot order, -1 past their
    count), the overflow plus the candidates past the budget, and
    ``T_cw``, all on the device.  Otherwise ``(None, m.overflow,
    inv(pose))``: every live slot fuses."""
    if budget and budget < m.capacity:
        return integrate_kernel.frustum_select(m, pose, K, frame_hw, budget)
    return None, m.overflow, inv(pose)


def fuse(field, m: VoxelMap, slots, depth, T_cw, K, timestamp: float,
         patch: int = PATCH, view=None) -> VoxelMap:
    """The field's fusion kernel on the map ``m``, in place: its channel
    tables and ``active`` (and ``view``'s fused rows) take the update of
    the ``slots`` of ``fusion_operands``, and the coarse node pyramid its
    update (``integrate_kernel.update_nodes``' values), in the same launch
    on the card.  Returns the map with the new ``node_values``."""
    if field.name == "ofusion":
        nodes = integrate_kernel.fuse_ofusion(
            m, depth, T_cw, K, field.mu, field.sigma_lo, timestamp, slots,
            patch, nodes=True)
    else:
        nodes = integrate_kernel.fuse_sdf(
            m, depth, T_cw, K, field.mu, field.max_weight, slots, view, patch,
            nodes=True)
    return m.replace(node_values=nodes)


def integrate(m: VoxelMap, field, depth, pose, K, timestamp: float = 0.0,
              budget: int = 0, patch: int = PATCH, view=None):
    """Fuse one depth frame taken at ``timestamp`` (a float32 value) with
    the field's kernel.  With ``0 < budget < capacity`` only the first
    ``budget`` frustum candidates (in slot order) fuse; the rest keep their
    voxels and active flag and count into ``overflow``.  Fused rows refresh
    ``active`` from visibility.

    The update is made in place: the returned map holds the voxel tables
    and ``active`` of ``m``, updated, so ``m`` itself must not be read as
    the map before this frame afterwards (clone its tables first to keep
    it).  That is the update JAX's ``.at[slots].set`` makes when XLA
    donates the table.

    ``view`` (single-scale fields): the raycaster's held read view; the
    kernel writes the fused live rows' encoding into it in place, and
    ``(map, view)`` is returned.  Bricks change only here, so the view
    stays equal to ``raycast.pack_view`` of the map."""
    if view is not None and field.multiscale_alloc:
        raise ValueError("a held view is updated by fusion for single-scale "
                         "fields only (the multiscale view is rebuilt)")
    K = K.contiguous()
    depth = depth.contiguous()
    slots, overflow, T_cw = fusion_operands(m, pose, K, depth.shape, budget)
    m = fuse(field, m, slots, depth, T_cw, K, timestamp, patch,
             view).replace(overflow=overflow)
    return m if view is None else (m, view)
