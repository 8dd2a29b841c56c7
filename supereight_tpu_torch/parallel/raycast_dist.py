"""Distributed raycast: the frustum-limited brick exchange and the
image-strip scan (counterpart of `supereight_tpu/parallel/raycast_dist.py`).

With the brick table split over the ranks by slot range, rays cross
ownership boundaries, so each rank's sampling view needs bricks it does
not own.  Each owner ships only the bricks that can affect this frame:

1. every rank encodes its own slot range into NaN-coded sample rows (the
   encoding of ``raycast.pack_view``) and tests its live blocks against
   the camera frustum (conservative: half a block diagonal in depth, the
   splat footprint and the projected diagonal in pixels);
2. the visible rows, compacted in slot order into a fixed budget of
   ``max_visible_per_device`` rows a rank, ride ONE ``all_gather`` with
   their block rows, beside the per-slot inside-voxel flags the splat
   phase needs; visible blocks past the budget are counted
   (``n_dropped``), never silently lost;
3. every rank scatters the gathered rows into a local brick-tiled view
   and runs the per-ray phases for its own image rows
   (``raycast.raycast(row_range=...)``); the strips all_gather back into
   the full maps.

Multiscale (OFusion) fields: the node-pyramid show-through of
``pack_view`` is a per-cell select on replicated metadata, so only leaf
rows ride the exchange.  Rows travel as bfloat16 where the field inverts
its normals or is multiscale (JAX `:109-110`), else as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.core.numerics import inv
from supereight_tpu_torch.core.octree import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu_torch.pipeline import camera, raycast
from supereight_tpu_torch.pipeline.preprocessing import norm
from .sharding import Comm


def _frustum_mask(bc, view, vs: float, H: int, W: int, near: float,
                  far: float) -> torch.Tensor:
    """Conservative bool[n] (JAX `:52-75`): block coords ``bc`` int[n, 3]
    whose block could affect a ray of the frame from ``view`` (= pose @
    inv(K)): half a block diagonal in depth, 16 px (two dilated splat
    cells) plus the projected diagonal in pixels."""
    centers = (bc.to(torch.float32) + 0.5) * (BLOCK_SIDE * vs)
    hom = camera.transform_points(inv(view), centers)
    z = hom[:, 2]
    zsafe = torch.where(z == 0, 1.0, z)
    px = hom[:, 0] / zsafe
    py = hom[:, 1] / zsafe
    diag = 1.7320508 * BLOCK_SIDE * vs
    fx = 1.0 / torch.clamp(norm(view[:3, 0]), min=1e-9)
    marg = 16.0 + diag * fx / torch.clamp(z, min=1e-3)
    return ((z > near - diag) & (z < far + diag)
            & (px >= -marg) & (px <= W - 1 + marg)
            & (py >= -marg) & (py <= H - 1 + marg))


def scan_far_extension(field, vs: float, far: float, *,
                       span_factor: float = 1.6,
                       scan_stride: float = 0.5) -> float:
    """Depth bound of the frustum test (JAX `:78-89`): rays sample up to
    two fine-scan windows past the far plane (the second window), the
    window span computed as ``raycast.raycast`` computes it."""
    thickness = field.mu if field.invert_normals else 2.0 * vs
    diag = 1.7320508 * BLOCK_SIDE * vs
    fine_step = scan_stride * thickness
    fine_span = span_factor * diag + 2.0 * thickness
    n_fine = int(np.clip(np.ceil(fine_span / fine_step) + 1, 8, 48))
    return far + 2.0 * n_fine * fine_step


def exchange_dtype(field) -> torch.dtype:
    return torch.bfloat16 if (field.invert_normals
                              or field.multiscale_alloc) else torch.float32


def exchange_view(vox_local, meta, field, view, H: int, W: int,
                  near: float, far_ext: float, *, comm: Comm, budget: int,
                  stats=None):
    """Steps 1 and 2 of the exchange (JAX `:92-168`): encode this rank's
    rows ``vox_local`` ({channel: [capacity / D, 512]}), select the
    frustum's live blocks, all_gather them and build the local view.

    ``meta``: the map's replicated metadata (its ``voxels`` are not read).
    Returns ``(dense, inside_any, n_dropped)``: the view {"F": [B^3, 512]}
    for ``raycast.raycast(dense=...)``, bool[capacity] inside-voxel flags
    for its ``inside_any`` and int64[D] each rank's visible blocks past
    the budget.  ``stats`` (a dict) accumulates the refreshes, the visible
    rows shipped (all ranks), the rows the budget ships and the bytes each
    rank receives."""
    B = meta.blocks_per_edge
    cap_d = next(iter(vox_local.values())).shape[0]
    slot0 = comm.rank * cap_d
    dev = meta.device
    dtype = exchange_dtype(field)

    # encode this rank's rows (pack_view's encoding)
    data = {k: v.to(torch.float32) for k, v in vox_local.items()}
    fsel = data[field.select_channel]
    enc = torch.where(field.sample_valid(data), fsel, float("nan")) \
        .to(dtype)
    inside_loc = field.is_inside(fsel).any(1)
    # frustum visibility of this rank's live slots
    bc_loc = torch.stack(morton.block_key_decode(
        meta.keys[slot0:slot0 + cap_d]), dim=-1)
    live_loc = octree.slot_mask(meta)[slot0:slot0 + cap_d]
    vis = live_loc & _frustum_mask(bc_loc, view, meta.voxel_size, H, W,
                                   near, far_ext)
    # the first `budget` visible slots in slot order, without a host sync
    pos = torch.cumsum(vis, 0, dtype=torch.int32) - 1
    keep = vis & (pos < budget)
    idx = octree.scatter_drop(
        torch.full((budget,), -1, dtype=torch.int64, device=dev),
        torch.where(keep, pos, budget),
        torch.arange(cap_d, dtype=torch.int64, device=dev))
    dropped = torch.clamp(vis.sum(dtype=torch.int64) - budget, min=0)
    sel = idx.clamp(min=0)
    bsel = bc_loc[sel].long()
    tgt = torch.where(idx >= 0, (bsel[:, 0] * B + bsel[:, 1]) * B
                      + bsel[:, 2], B * B * B)

    # THE exchange: the visible rows, their block rows (and each rank's
    # dropped count), the inside flags
    rows_all = comm.all_gather_cat(enc[sel])
    tgt_all = comm.all_gather_cat(torch.cat([tgt, dropped.reshape(1)])) \
        .reshape(comm.size, budget + 1)
    inside_any = comm.all_gather_cat(inside_loc)
    n_dropped = tgt_all[:, budget]
    tgt_all = tgt_all[:, :budget].reshape(-1)
    if stats is not None:
        got = (rows_all, tgt_all, inside_any)
        for key, v in (("refreshes", 1),
                       ("rows", int((tgt_all < B * B * B).sum())),
                       ("budget_rows", comm.size * budget),
                       ("bytes", sum(t.numel() * t.element_size()
                                     for t in got) + 8 * comm.size)):
            stats[key] = stats.get(key, 0) + v

    # the local brick-tiled view from the gathered rows
    if field.multiscale_alloc:
        fills = {c.name: octree.node_fill(meta, c.name).to(torch.float32)
                 for c in meta.channels}
        fill = torch.where(field.sample_valid(fills),
                           fills[field.select_channel], float("nan"))
        has_leaf = (meta.block_index >= 0).reshape(-1)
        fill = torch.where(has_leaf, float("nan"), fill)
    else:
        fill = torch.full((B * B * B,),
                          raycast._fill_value(meta, field, "empty"),
                          device=dev)
    flat = torch.empty((B * B * B + 1, BLOCK_VOXELS), dtype=dtype,
                       device=dev)
    flat[:-1] = fill.to(dtype)[:, None]
    flat[tgt_all] = rows_all
    return {"F": flat[:-1]}, inside_any, n_dropped


def sharded_raycast(comm: Comm, field, H: int, W: int, near: float,
                    far: float, *, max_visible_per_device: int = 1024,
                    normals: str = "volume", second_window: bool = True,
                    span_factor: float = 1.6, scan_stride: float = 0.5,
                    midsolve: bool = False, near_rescue: bool = True,
                    w2_budget: int = 8192, grad_decim: int = 1):
    """``fn(m, view) -> (vertex, normal, t_hit, n_dropped)`` (JAX
    `:171-231`): ``m`` is this rank's map (its slot range of ``voxels``,
    the rest replicated, as ``sharding.map_sharding`` gives it); the maps
    come back whole on every rank, ``n_dropped`` int64[D].  ``normals``
    "volume" or "hybrid"."""
    if normals not in ("volume", "hybrid"):
        raise ValueError(f"sharded_raycast: volume/hybrid normals only, "
                         f"not {normals!r}")
    n = comm.size
    if H % n:
        raise ValueError(f"image height {H} not divisible by {n}")
    rows = H // n

    def fn(m, view):
        if m.capacity % n:
            raise ValueError(f"capacity {m.capacity} not divisible by {n}")
        far_ext = scan_far_extension(field, m.voxel_size, far,
                                     span_factor=span_factor,
                                     scan_stride=scan_stride)
        dense, inside_any, n_dropped = exchange_view(
            m.voxels, m, field, view, H, W, near, far_ext, comm=comm,
            budget=max_visible_per_device)
        rc = raycast.raycast(
            m, field, view, H, W, near, far, dense=dense,
            inside_any=inside_any, row_range=(comm.rank * rows, rows),
            normals=normals, second_window=second_window,
            span_factor=span_factor, scan_stride=scan_stride,
            midsolve=midsolve, near_rescue=near_rescue, w2_budget=w2_budget,
            grad_decim=grad_decim)
        vn = comm.all_gather_cat(torch.cat(
            [rc.vertex, rc.normal, rc.t_hit[..., None]], dim=-1))
        return vn[..., :3], vn[..., 3:6], vn[..., 6], n_dropped

    return fn
