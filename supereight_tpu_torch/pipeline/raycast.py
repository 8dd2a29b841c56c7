"""Surface raycasting: splat bounds + short-window scan (counterpart of
`supereight_tpu/pipeline/raycast.py`, for both fields).

Phase 1 (`_splat_bounds`) projects the blocks holding an inside voxel into
a coarse image grid and takes min/max camera depths as each ray's start and
far bounds.  Phase 2 (`_fine_scan`) samples a short window per ray at half
ray resolution (or every pixel, ``full_res_scan``), finds the first valid
outside -> inside crossing and solves it linearly; a compacted second
window re-scans the rays whose far bound reaches deeper.  After a half-res
scan a full-resolution secant re-solve (`_refine`, optionally from
trilinear samples, or from the stored surface plane) gives per-pixel depth;
``midsolve`` re-solves the scan's crossing at half resolution before it.
Normals come from 6-tap central differences (hybrid: at quarter resolution
with a per-pixel along-ray correction), from the stored gradient table
(`gradmap.py`) or from the blended gradient of the brick table (exact).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.numerics import div, dot3, inv, trunc_i32
from supereight_tpu_torch.core.octree import BLOCK_SIDE, VoxelMap
from supereight_tpu_torch.utils.perfstats import Stats
from . import camera, gradmap
from .constants import INVALID
from .preprocessing import norm


class RaycastResult(NamedTuple):
    vertex: torch.Tensor   # [H, W, 3] world-space hit points (0 on miss)
    normal: torch.Tensor   # [H, W, 3] unit normals (x = INVALID on miss)
    t_hit: torch.Tensor    # [H, W] ray distance of the hit (0 on miss)


def ray_directions(view: torch.Tensor, H: int, W: int):
    """Per-pixel world ray origin + direction with unit camera z (``view`` =
    camera-to-world pose @ inv(K))."""
    x = torch.arange(W, dtype=torch.float32, device=view.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=view.device)[:, None]
    dirs = torch.stack([
        (view[0, 0] * x + view[0, 1] * y + view[0, 2]).expand(H, W),
        (view[1, 0] * x + view[1, 1] * y + view[1, 2]).expand(H, W),
        (view[2, 0] * x + view[2, 1] * y + view[2, 2]).expand(H, W),
    ], dim=-1)
    return view[:3, 3], dirs


def view_dtype(field) -> torch.dtype:
    """Storage dtype of the read view: bf16 for a normalised TSDF."""
    return torch.bfloat16 if field.invert_normals else torch.float32


def encode_view_rows(field, rows):
    """NaN-encode channel rows for the read view: invalid samples (weight
    0, never observed) become NaN, so one array carries value and
    validity."""
    vals = {k: v.to(torch.float32) for k, v in rows.items()}
    return torch.where(field.sample_valid(vals), vals[field.select_channel],
                       float("nan")).to(view_dtype(field))


def _fill_value(m: VoxelMap, field, attr: str) -> float:
    """The view's encoding of a voxel whose channels all hold their
    ``attr`` value ("empty" or "init"): that value of the select channel,
    or NaN where the field does not count it as a valid sample."""
    vals = {c.name: torch.full((), getattr(c, attr)) for c in m.channels}
    if bool(field.sample_valid(vals)):
        return float(vals[field.select_channel])
    return float("nan")


def pack_view(m: VoxelMap, field):
    """Brick-tiled read view ``{"F": [B^3, 512]}``: one row per block-grid
    cell, the NaN-encoded select channel for allocated blocks and the
    field's empty value (NaN if empty is not a valid sample) elsewhere.
    For a multiscale field (OFusion) the view is bf16 and rows without a
    block read the NaN-encoded node-pyramid value of their cell
    (``octree.node_fill``).  Both encode on the ``[capacity, 512]`` table
    and scatter its live rows once (``octree.tile_rows``)."""
    if field.multiscale_alloc:
        return {"F": _pack_view_multiscale(m, field)}
    B = m.blocks_per_edge
    fill = torch.full((B * B * B,), _fill_value(m, field, "empty"),
                      device=m.device)
    return {"F": octree.tile_rows(fill, m, encode_view_rows(field, m.voxels))}


def _pack_view_multiscale(m: VoxelMap, field) -> torch.Tensor:
    """bf16 ``[B^3, 512]``: the NaN-encoded select channel of the live
    blocks' voxels at their rows, every other row the NaN-encoded
    :func:`octree.node_fill` value of its cell (the JAX form,
    `raycast.py:pack_view`)."""
    fills = {c.name: octree.node_fill(m, c.name).to(torch.float32)
             for c in m.channels}
    fill_cell = torch.where(field.sample_valid(fills),
                            fills[field.select_channel], float("nan"))
    return octree.tile_rows(fill_cell, m, encode_view_rows(
        field, m.voxels).to(torch.bfloat16))


def view_alloc_fill(view: torch.Tensor, m: VoxelMap, live_before,
                    field) -> torch.Tensor:
    """The held view after an allocation, updated in place: the rows of
    the blocks that became live since ``live_before`` (bool[capacity])
    flip from the unallocated fill to the encoding of fresh voxels (weight
    0 -> NaN).  Fusion updates every later change
    (``integration.integrate(view=)``)."""
    new = octree.slot_mask(m) & ~live_before
    with Stats.host_read("view_fill"):
        newly = torch.nonzero(new)[:, 0]
    return view.index_fill_(0, octree.block_rows(m)[newly],
                            _fill_value(m, field, "init"))


def _sample_volume(vol, pos_vox, size: int, fill: float):
    """Nearest-voxel lookup in the tiled view with out-of-bounds ``fill``;
    returns (value f32, in-bounds)."""
    v = trunc_i32(torch.floor(pos_vox))
    inb = ((v >= 0) & (v < size)).all(-1)
    val = vol[_tiled_index(v.clamp(0, size - 1), size)].to(torch.float32)
    return torch.where(inb, val, fill), inb


def _tiled_index(vc, size: int):
    """(row, column) of in-bounds int32 voxels ``vc`` [..., 3] in the
    tiled view."""
    B = size // BLOCK_SIDE
    b = vc >> 3
    l = vc & 7
    row = (b[..., 0] * B + b[..., 1]) * B + b[..., 2]
    col = l[..., 0] + l[..., 1] * 8 + l[..., 2] * 64
    return row.long(), col.long()


def _sample_volume_interp(vol, pos_vox, size: int, nan_sub: float):
    """Trilinear sample of the tiled view: 8 corner reads blended by the
    fractional position; NaN (unobserved) and out-of-bounds taps read
    ``nan_sub``."""
    base = trunc_i32(torch.floor(pos_vox))
    frac = pos_vox - base
    out = 0.0
    for i in range(8):
        off = (i & 1, (i >> 1) & 1, (i >> 2) & 1)
        v = base + torch.tensor(off, dtype=torch.int32, device=base.device)
        inb = ((v >= 0) & (v < size)).all(-1)
        val = vol[_tiled_index(v.clamp(0, size - 1), size)].to(torch.float32)
        val = torch.where(inb & ~torch.isnan(val), val, nan_sub)
        w = [frac[..., a] if off[a] else 1.0 - frac[..., a] for a in range(3)]
        out = out + val * (w[0] * w[1] * w[2])
    return out


def _max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max filter, stride 1, -inf padding (``reduce_window`` SAME)."""
    return F.max_pool2d(x[None, None], k, stride=1, padding=k // 2)[0, 0]


def splat_cell(H: int, W: int) -> int:
    """The splat grid's cell edge in pixels: the largest of 8, 4, 2, 1
    dividing both H and W."""
    for g in (8, 4, 2, 1):
        if H % g == 0 and W % g == 0:
            return g
    return 1


def _splat_bounds(m: VoxelMap, field, view, H: int, W: int, near: float,
                  far: float, near_rescue: bool = True, inside_any=None):
    """Phase 1: per-cell start and far depth from splatting the blocks that
    contain an inside voxel (``inside_any`` bool[capacity], from the brick
    table when None) into a coarse grid.  Returns (tmin, tmax, g) with
    [H/g, W/g] grids.  A CPU view takes :func:`_splat_bounds_twin`, a CUDA
    view the kernel R1 (`ops/raycast_kernel.splat_bounds`), which raises if
    it cannot launch."""
    if view.device.type == "cpu":
        return _splat_bounds_twin(m, field, view, H, W, near, far,
                                  near_rescue, inside_any)
    from supereight_tpu_torch.ops import raycast_kernel
    return raycast_kernel.splat_bounds(m, field, view, H, W, near, far,
                                       near_rescue, inside_any)


def _splat_bounds_twin(m: VoxelMap, field, view, H: int, W: int,
                       near: float, far: float, near_rescue: bool = True,
                       inside_any=None):
    """:func:`_splat_bounds` in plain PyTorch on any device.  CUDA
    multiplies by the reciprocal of a Python-scalar divisor: by the power
    of two ``g`` that is exact, and the blind-zone depth divides through
    ``numerics.div``, so the twin rounds alike on every device."""
    g = splat_cell(H, W)
    gh, gw = H // g, W // g
    dev = view.device

    inv_view = inv(view)          # = K @ inv(pose)
    vs = m.voxel_size
    bc = octree.block_coords_table(m).to(torch.float32)
    hom = camera.transform_points(inv_view, (bc + 0.5) * (BLOCK_SIDE * vs))
    z = hom[:, 2]
    zsafe = torch.where(z == 0, 1.0, z)
    px = hom[:, 0] / zsafe
    py = hom[:, 1] / zsafe

    if inside_any is None:
        raw = m.voxels[field.select_channel].to(torch.float32)
        inside_any = field.is_inside(raw).any(1)
    diag = 1.7320508 * BLOCK_SIDE * vs
    marg = 2.0 * g
    ok = (octree.slot_mask(m) & inside_any & (z > 1e-3)
          & (px >= -marg) & (px <= W - 1 + marg)
          & (py >= -marg) & (py <= H - 1 + marg))

    z_lo = torch.clamp(z - 0.5 * diag, min=near)
    z_hi = z + 0.5 * diag
    cxf = px / g
    cyf = py / g
    tmin = torch.full((gh * gw + 1,), float("inf"), device=dev)
    tmax = torch.full((gh * gw + 1,), float("-inf"), device=dev)
    # fx recovered from view = pose @ inv(K): ||view[:3,0]|| == 1/fx
    fx = 1.0 / torch.clamp(norm(view[:3, 0]), min=1e-9)
    foot_r = 0.5 * diag * fx / torch.clamp(z, min=1e-3) / g
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            okc = ok & (foot_r >= float(np.hypot(dx, dy)) - 0.71)
            cx = trunc_i32(cxf + dx).clamp(0, gw - 1)
            cy = trunc_i32(cyf + dy).clamp(0, gh - 1)
            # dropped entries go to the scratch cell gh*gw
            tgt = torch.where(okc, cy * gw + cx, gh * gw).long()
            tmin = tmin.scatter_reduce(0, tgt, z_lo, "amin")
            tmax = tmax.scatter_reduce(0, tgt, z_hi, "amax")
    tmin = -_max_pool_same(-tmin[:-1].reshape(gh, gw), 3)
    tmax = _max_pool_same(tmax[:-1].reshape(gh, gw), 3)
    if not near_rescue:
        return tmin, tmax, g

    # near-field blind zone: cells with no splat next to a block closer than
    # z_blind inherit that neighbourhood's start depth
    R = 12
    twide = -_max_pool_same(-tmin, 2 * R + 1)
    z_blind = div(0.5 * diag * fx, 2.4 * g)
    fallback = ~torch.isfinite(tmin) & (twide < z_blind)
    tmin = torch.where(fallback, twide, tmin)
    tmax = torch.where(fallback, twide + diag, tmax)
    return tmin, tmax, g


class _Fine(NamedTuple):
    hit: torch.Tensor
    z_hit: torch.Tensor


def _fine_scan(m, dense, field, origin, dirs, z_start, span: float,
               n_samples: int, active):
    """Phase 2: first valid outside -> inside crossing over
    ``n_samples + 1`` samples from ``z_start``, solved linearly between the
    two bracketing valid samples (invalid samples neither cross nor reset
    the last valid one)."""
    dz = span / n_samples
    nF = n_samples + 1
    rshape = dirs.shape[:-1]
    stepshape = (nF,) + (1,) * len(rshape)
    z = z_start[None] + dz * torch.arange(
        nF, dtype=torch.float32, device=dirs.device).reshape(stepshape)
    pos = (origin + dirs[None] * z[..., None]) * m.inverse_voxel_size
    f, _ = _sample_volume(dense["F"], pos, m.size, float("nan"))
    ok = ~torch.isnan(f)

    # forward-fill (index, outside-bit) of the last valid sample by cummax
    steps = torch.arange(nF, dtype=torch.int32,
                         device=dirs.device).reshape(stepshape)
    inside = field.is_inside(f)
    enc = torch.where(ok, steps * 2 + (ok & ~inside).to(torch.int32), -1)
    last_enc = torch.cummax(enc, dim=0).values
    prev_enc = torch.cat([torch.full_like(last_enc[:1], -1), last_enc[:-1]])
    prev_idx = torch.clamp(prev_enc >> 1, min=0).long()

    crossing = ok & (prev_enc >= 0) & inside & ((prev_enc & 1) == 1) \
        & active[None]
    hit = crossing.any(0)
    j_star = crossing.to(torch.uint8).argmax(0)[None].long()   # first True

    f_hi = f.gather(0, j_star)[0]
    j_lo = prev_idx.gather(0, j_star)
    z_lo = z_start + dz * j_lo[0].to(torch.float32)
    f_lo = torch.where(ok, f, 0.0).gather(0, j_lo)[0]
    z_hi = z.gather(0, j_star)[0]

    denom = f_lo - f_hi
    denom = torch.where(torch.abs(denom) < 1e-12, -1e-12, denom)
    frac = (f_hi - field.surf_boundary) / denom
    z_ref = z_hi + (z_hi - z_lo) * frac
    return _Fine(hit=hit, z_hit=torch.where(hit, z_ref, 0.0))


def _up2(a: torch.Tensor) -> torch.Tensor:
    return a.repeat_interleave(2, 0).repeat_interleave(2, 1)


class ScanPlan(NamedTuple):
    """The numbers every phase of a raycast shares (Python scalars)."""
    H: int
    W: int
    near: float
    far: float
    half_res: bool       # the scan runs at half resolution
    thickness: float     # the surface band: mu (SDF) or 2 voxels
    diag: float          # a block's diagonal (m)
    n_fine: int          # a window's steps (n_fine + 1 samples)
    fine_span: float     # a window's depth span (m)
    r0: int              # the first image row of the strip
    rows: int            # the strip's image rows


def scan_plan(m: VoxelMap, field, H: int, W: int, near: float, far: float,
              span_factor: float, scan_stride: float, full_res_scan: bool,
              row_range=None) -> ScanPlan:
    """The scan's resolution, band and windows (see :func:`raycast`)."""
    vs = m.voxel_size
    thickness = field.mu if field.invert_normals else 2.0 * vs
    diag = 1.7320508 * BLOCK_SIDE * vs
    half_res = H % 2 == 0 and W % 2 == 0 and W >= 160 and not full_res_scan
    fine_step = scan_stride * thickness
    fine_span = span_factor * diag + 2.0 * thickness
    n_fine = int(np.clip(np.ceil(fine_span / fine_step) + 1, 8, 48))
    r0, rows = (0, H) if row_range is None else row_range
    return ScanPlan(H, W, near, far, half_res, thickness, diag, n_fine,
                    n_fine * fine_step, r0, rows)


def _scan_dirs(view, plan: ScanPlan):
    """(origin, the strip's full-resolution directions [rows, W, 3], the
    strip's scan directions [h, w, 3]: the 2x2 mean at half resolution)."""
    origin, dirs = ray_directions(view, plan.H, plan.W)
    if plan.half_res:
        fd = 0.25 * (dirs[0::2, 0::2] + dirs[1::2, 0::2]
                     + dirs[0::2, 1::2] + dirs[1::2, 1::2])
        f = 2
    else:
        fd, f = dirs, 1
    r0, nr = plan.r0, plan.rows
    return origin, dirs[r0:r0 + nr], fd[r0 // f:(r0 + nr) // f]


class Scan(NamedTuple):
    """A scan's rays [h, w] (the strip's, at the scan's resolution)."""
    hit: torch.Tensor
    z: torch.Tensor          # the crossing's ray depth (0 on miss)
    need2: object            # the second window's rays (the first
                             # window's twin only; else None)
    z_start: object          # the first window's start depth (likewise)


def ray_scan(m: VoxelMap, dense, field, view, plan: ScanPlan, tmin, tmax,
             g: int, second_window: bool = False, w2_budget: int = 0,
             midsolve: bool = False) -> Scan:
    """Phase 2: the first window, then with ``second_window`` or
    ``midsolve`` the second window and the midsolve (see
    :func:`ray_scan_windows_twin`).  A CPU view takes the twins, a CUDA
    view the kernel R2 with R3 in one launch
    (`ops/raycast_kernel.ray_scan`), which ranks the flagged rays on the
    card and raises if it cannot launch."""
    if view.device.type == "cpu":
        return ray_scan_windows_twin(m, dense, field, view, plan, tmin, tmax,
                                     g, second_window, w2_budget, midsolve)
    from supereight_tpu_torch.ops import raycast_kernel
    return raycast_kernel.ray_scan(m, dense, field, view, plan, tmin, tmax,
                                   g, second_window, w2_budget, midsolve)


def ray_scan_windows_twin(m: VoxelMap, dense, field, view, plan: ScanPlan,
                          tmin, tmax, g: int, second_window: bool = False,
                          w2_budget: int = 0,
                          midsolve: bool = False) -> Scan:
    """:func:`ray_scan` in plain PyTorch: :func:`ray_scan_twin`, then
    with ``second_window`` or ``midsolve`` :func:`ray_scan_second_twin`."""
    scan = ray_scan_twin(m, dense, field, view, plan, tmin, tmax, g)
    if second_window or midsolve:
        scan = ray_scan_second_twin(m, dense, field, view, plan, scan,
                                    second_window, w2_budget, midsolve)
    return scan


def ray_scan_twin(m: VoxelMap, dense, field, view, plan: ScanPlan, tmin,
                  tmax, g: int) -> Scan:
    """The strip's rays from the splat cells' bounds: active where the
    start bound is finite, each scanned over one window from its start
    depth; ``need2`` marks the rays without a hit whose far bound reaches
    past the window."""
    origin, _, fd = _scan_dirs(view, plan)
    rep = g // 2 if plan.half_res else g
    t0 = tmin.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    t1 = tmax.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    f = 2 if plan.half_res else 1
    rows = slice(plan.r0 // f, (plan.r0 + plan.rows) // f)
    t0, t1 = t0[rows, :fd.shape[1]], t1[rows, :fd.shape[1]]
    active = torch.isfinite(t0)
    z_start = torch.clamp(torch.where(active, t0, plan.near), plan.near,
                          plan.far)
    f1 = _fine_scan(m, dense, field, origin, fd, z_start, plan.fine_span,
                    plan.n_fine, active)
    need2 = active & ~f1.hit & (z_start + plan.fine_span < t1 + plan.diag)
    return Scan(f1.hit, f1.z_hit, need2, z_start)


def ray_scan_second_twin(m: VoxelMap, dense, field, view, plan: ScanPlan,
                         scan: Scan, second_window: bool, w2_budget: int,
                         midsolve: bool) -> Scan:
    """With ``second_window``, the rays of ``scan.need2``, the first
    ``w2_budget`` of them in raster order, scanned one window deeper, the
    first window's hit kept; with ``midsolve``, every hit re-solved from
    two samples inside the band."""
    origin, _, fd = _scan_dirs(view, plan)
    hit, z_hit = scan.hit, scan.z
    h, w = hit.shape
    if second_window:
        # rays whose far bound reaches past window 1, compacted (the first
        # w2_budget of them in raster order) and scanned one window deeper
        idx = torch.nonzero(scan.need2.reshape(-1))[:, 0][
            :min(w2_budget, h * w)]
        f2 = _fine_scan(m, dense, field, origin, fd.reshape(-1, 3)[idx],
                        (scan.z_start + plan.fine_span).reshape(-1)[idx],
                        plan.fine_span, plan.n_fine,
                        torch.ones_like(idx, dtype=torch.bool))
        hit2 = torch.zeros(h * w, dtype=torch.bool, device=idx.device) \
            .index_copy(0, idx, f2.hit).reshape(h, w)
        z2 = torch.zeros(h * w, device=idx.device) \
            .index_copy(0, idx, f2.z_hit).reshape(h, w)
        z_hit = torch.where(hit, z_hit, z2)
        hit = hit | hit2
    if midsolve:
        z_hit = _midsolve(m, dense, field, origin, fd, z_hit, hit,
                          0.35 * plan.thickness)
    return Scan(hit, z_hit, None, None)


class Finish(NamedTuple):
    """The full-resolution maps [rows, W] of the strip."""
    vertex: torch.Tensor     # [.., 3] world-space hit points (0 on miss)
    normal: object           # [.., 3] (x = INVALID on miss), or None
    t_hit: torch.Tensor      # ray distance of the hit (0 on miss)
    hit: torch.Tensor


#: ray_refine_normals' re-solve: none, from nearest samples, from
#: trilinear samples
RESOLVE = ("none", "secant", "interp")
#: ray_refine_normals' normals: left to :func:`gradient_normals` (stored,
#: exact), the 6-tap gradient at the vertex, the hybrid gradient
NORMALS = ("none", "volume", "hybrid")


def ray_refine_normals(m: VoxelMap, dense, field, view, plan: ScanPlan,
                       z, hit, resolve: str, normals: str,
                       grad_decim: int = 1) -> Finish:
    """The full-resolution re-solve, vertices, ray distances and normals
    (see :func:`ray_refine_normals_twin`): a CPU view takes the twin, a
    CUDA view the kernel R4 (`ops/raycast_kernel.ray_refine_normals`),
    which raises if it cannot launch."""
    if view.device.type == "cpu":
        return ray_refine_normals_twin(m, dense, field, view, plan, z, hit,
                                       resolve, normals, grad_decim)
    from supereight_tpu_torch.ops import raycast_kernel
    return raycast_kernel.ray_refine_normals(m, dense, field, view, plan, z,
                                             hit, resolve, normals,
                                             grad_decim)


def ray_refine_normals_twin(m: VoxelMap, dense, field, view,
                            plan: ScanPlan, z, hit, resolve: str,
                            normals: str, grad_decim: int = 1) -> Finish:
    """From the scan's ``z`` and ``hit`` (at half resolution where
    ``resolve`` is not "none", each pixel taking its 2x2 parent's; else
    full resolution): the secant re-solve (:func:`_refine`, nearest or
    trilinear samples), the vertex and ray distance, and the ``normals``
    (:data:`NORMALS`; "hybrid" takes the half-resolution ``z`` and ``hit``
    as its lateral gradient's points, decimated by ``grad_decim``)."""
    if normals == "hybrid" and resolve == "none":
        raise ValueError("the hybrid normals need the half-resolution "
                         "re-solve")
    origin, dirs, fd = _scan_dirs(view, plan)
    inv_vs = m.inverse_voxel_size
    z_half, hit_half = z, hit
    if resolve != "none":
        # interp: unobserved taps blend the select channel's raw init
        sub = next(c.init for c in m.channels
                   if c.name == field.select_channel) \
            if resolve == "interp" else None
        delta = 0.7 * plan.thickness
        z, hit, rf_lo, rf_hi, rf_pair = _refine(
            m, dense, field, origin, dirs, _up2(z), _up2(hit), delta, sub)

    vertex = origin + dirs * z[..., None]
    ray_norm = norm(dirs)
    t_hit = torch.where(hit, z * ray_norm, 0.0)
    if normals == "none":
        return Finish(torch.where(hit[..., None], vertex, 0.0), None, t_hit,
                      hit)
    bad_grad = torch.zeros_like(hit)
    if normals == "hybrid":
        h, w = hit_half.shape
        vert_h = origin + fd * z_half[..., None]
        gd = int(grad_decim)
        if gd > 1 and h % gd == 0 and w % gd == 0:
            g_q = _grad6(m, dense, field, vert_h[::gd, ::gd]) * inv_vs
            g_h = g_q.repeat_interleave(gd, 0).repeat_interleave(gd, 1)
            grad_ok_h = hit_half[::gd, ::gd].repeat_interleave(gd, 0) \
                .repeat_interleave(gd, 1)
        else:
            g_h = _grad6(m, dense, field, vert_h) * inv_vs
            grad_ok_h = torch.ones_like(hit_half)
        g_m = _up2(g_h)
        rn = torch.clamp(ray_norm, min=1e-12)
        rhat = dirs / rn[..., None]
        d_ray = (rf_hi - rf_lo) / (2.0 * delta * rn)
        have = rf_pair & hit & _up2(hit_half)
        corr = torch.where(have, d_ray - dot3(g_m, rhat), 0.0)
        g_ = g_m + corr[..., None] * rhat
        bad_grad = ~_up2(grad_ok_h)
    else:
        g_ = _grad6(m, dense, field, vertex)
    return Finish(torch.where(hit[..., None], vertex, 0.0),
                  _encode_normals(field, g_, hit, bad_grad), t_hit, hit)


def _encode_normals(field, g_, hit, bad_grad=None):
    """Unit normals from the gradient ``g_`` (negated for a field with
    ``invert_normals``), (INVALID, 0, 0) where the ray missed, the
    gradient is 0 or ``bad_grad``."""
    if field.invert_normals:
        g_ = -g_
    gn = norm(g_, keepdim=True)
    normal = g_ / torch.clamp(gn, min=1e-12)
    bad = ~hit | (gn[..., 0] == 0)
    if bad_grad is not None:
        bad = bad | bad_grad
    invalid = torch.zeros_like(normal)
    invalid[..., 0] = INVALID
    return torch.where(bad[..., None], invalid, normal)


def gradient_normals(m: VoxelMap, field, fin: Finish, normals: str,
                     grad_table=None) -> torch.Tensor:
    """The normals of the hit vertices from the stored gradient table
    (``normals="stored"``, at the hit voxel) or from ``octree.grad``, the
    blended gradient of the brick table ("exact"), in PyTorch on every
    device."""
    pos = fin.vertex * m.inverse_voxel_size
    if normals == "stored":
        g_, _, _ = gradmap.sample(m, grad_table, pos)
    else:
        g_ = octree.grad(m, field.select_channel, pos)
    return _encode_normals(field, g_, fin.hit)


def _plane_refine(m: VoxelMap, grad_table, view, plan: ScanPlan,
                  scan: Scan):
    """The "plane" re-solve with stored normals, in PyTorch on every
    device: each full-resolution ray meets the plane of its half-res
    parent's hit (the stored normal there), inside the refine window.
    Returns the full-resolution (z, hit)."""
    origin, dirs, fd = _scan_dirs(view, plan)
    delta = 0.7 * plan.thickness
    vert_h = origin + fd * scan.z[..., None]
    g_h, _, _ = gradmap.sample(m, grad_table, vert_h * m.inverse_voxel_size)
    n_f, v_f = _up2(g_h), _up2(vert_h)
    z_hit, hit = _up2(scan.z), _up2(scan.hit)
    denom = dot3(dirs, n_f)
    numer = dot3(v_f - origin, n_f)
    okp = torch.abs(denom) > 1e-9
    z_pl = torch.where(okp, numer / torch.where(okp, denom, 1.0), z_hit)
    z_hit = torch.where(hit, torch.minimum(torch.maximum(
        z_pl, z_hit - delta), z_hit + delta), z_hit)
    return z_hit, hit


def ray_finish(m: VoxelMap, dense, field, view, plan: ScanPlan, scan: Scan,
               *, normals: str = "volume", refine: str = "secant",
               grad_decim: int = 1, grad_table=None,
               refine_normals=None) -> Finish:
    """The scan's rays to full-resolution maps: the "plane" re-solve where
    it applies (:func:`_plane_refine`), then ``refine_normals``
    (:func:`ray_refine_normals` by default; its normals "none" for stored
    and exact normals, which :func:`gradient_normals` computes)."""
    z, hit, resolve = scan.z, scan.hit, "none"
    if plan.half_res:
        if normals == "stored" and refine == "plane":
            z, hit = _plane_refine(m, grad_table, view, plan, scan)
        else:
            resolve = "interp" if refine == "interp" else "secant"
    mode = "none" if normals in ("stored", "exact") else \
        "hybrid" if normals == "hybrid" and resolve != "none" else "volume"
    return (refine_normals or ray_refine_normals)(
        m, dense, field, view, plan, z, hit, resolve, mode, grad_decim)


#: the phases of :func:`raycast`, each dispatching on the view's device,
#: and of :func:`raycast_twin`, the plain PyTorch twins
_PHASES = dict(splat=_splat_bounds, scan=ray_scan, finish=ray_refine_normals)
_TWINS = dict(splat=_splat_bounds_twin, scan=ray_scan_windows_twin,
              finish=ray_refine_normals_twin)


def raycast(m: VoxelMap, field, view, H: int, W: int, near: float,
            far: float, dense=None, *, normals: str = "volume",
            second_window: bool = True, span_factor: float = 1.6,
            w2_budget: int = 8192, scan_stride: float = 0.5,
            near_rescue: bool = True, grad_decim: int = 1,
            refine: str = "secant", full_res_scan: bool = False,
            midsolve: bool = False, grad_table=None, inside_any=None,
            row_range=None) -> RaycastResult:
    """Vertex + normal maps from ``view`` (= pose @ inv(K)).

    The fine scan runs at half ray resolution when H and W are even,
    W >= 160 and not ``full_res_scan``; ``midsolve`` then re-solves its
    crossings from two samples inside the band, and the full-res re-solve
    follows: ``refine`` "secant" (`_refine`'s two-sample re-solve),
    "interp" (the same from trilinear samples) or "plane" (with stored
    normals: each pixel's ray meets the surface plane at its half-res
    parent's hit, no field samples).  ``normals`` is "volume" (full-res
    6-tap gradient), "hybrid" (half-res, or 1/``grad_decim`` of that,
    lateral gradient + per-pixel along-ray correction; without the half-res
    scan it falls back to "volume"), "stored" (the gradient table
    ``grad_table``, built from the map if None, at the hit voxel) or
    "exact" (``octree.grad``, the trilinearly blended gradient of the raw
    brick table).

    For the multi-device map (`parallel/raycast_dist.py`, JAX
    `raycast.py:255-295`, `:525-532`): ``inside_any`` (bool[capacity])
    gives the splat phase each slot's inside-voxel flag, so that with a
    ``dense`` view the brick table is never read; ``row_range = (r0,
    nrows)`` runs the per-ray phases (scan, refine, normals) for the image
    rows ``[r0, r0 + nrows)`` only (both even with the half-res scan,
    whose rows are ``r0 // 2``) and returns maps of ``nrows`` rows.  The
    splat grid still covers the whole image.

    The phases dispatch on ``view``'s device: on the CPU the plain PyTorch
    twins (:func:`raycast_twin`), on the card the three kernels of
    `csrc/raycast.cu` (R1, R2 with R3, R4), which read nothing back to the
    host; the plane
    re-solve and the stored and exact normals' gradients run in PyTorch on
    both."""
    return _raycast(_PHASES, m, field, view, H, W, near, far, dense,
                    normals=normals, second_window=second_window,
                    span_factor=span_factor, w2_budget=w2_budget,
                    scan_stride=scan_stride, near_rescue=near_rescue,
                    grad_decim=grad_decim, refine=refine,
                    full_res_scan=full_res_scan, midsolve=midsolve,
                    grad_table=grad_table, inside_any=inside_any,
                    row_range=row_range)


def raycast_twin(m: VoxelMap, field, view, H: int, W: int, near: float,
                 far: float, dense=None, **knobs) -> RaycastResult:
    """:func:`raycast` in plain PyTorch on any device: every phase its
    twin (what :func:`raycast` runs on the CPU)."""
    return _raycast(_TWINS, m, field, view, H, W, near, far, dense, **knobs)


def _raycast(phases, m: VoxelMap, field, view, H: int, W: int, near: float,
             far: float, dense=None, *, normals: str = "volume",
             second_window: bool = True, span_factor: float = 1.6,
             w2_budget: int = 8192, scan_stride: float = 0.5,
             near_rescue: bool = True, grad_decim: int = 1,
             refine: str = "secant", full_res_scan: bool = False,
             midsolve: bool = False, grad_table=None, inside_any=None,
             row_range=None) -> RaycastResult:
    if normals not in ("volume", "hybrid", "exact", "stored"):
        raise ValueError(f"unknown normals mode {normals!r}")
    if refine not in ("secant", "interp", "plane"):
        raise ValueError(f"unknown refine mode {refine!r}")
    with Stats.span("se.raycasting.plan"):
        plan = scan_plan(m, field, H, W, near, far, span_factor,
                         scan_stride, full_res_scan, row_range)
    if dense is None:
        with Stats.span("se.raycasting.pack_view"):
            dense = pack_view(m, field)
    if normals == "stored" and grad_table is None:
        grad_table = gradmap.build_table(m, field)
    with Stats.span("se.raycasting.splat"):
        tmin, tmax, g = phases["splat"](m, field, view, H, W, near, far,
                                        near_rescue=near_rescue,
                                        inside_any=inside_any)
    with Stats.span("se.raycasting.scan"):
        scan = phases["scan"](m, dense, field, view, plan, tmin, tmax, g,
                              second_window, w2_budget, midsolve)
    with Stats.span("se.raycasting.finish"):
        fin = ray_finish(m, dense, field, view, plan, scan, normals=normals,
                         refine=refine, grad_decim=grad_decim,
                         grad_table=grad_table,
                         refine_normals=phases["finish"])
        normal = fin.normal
        if normal is None:
            normal = gradient_normals(m, field, fin, normals, grad_table)
    return RaycastResult(vertex=fin.vertex, normal=normal, t_hit=fin.t_hit)


def _refine(m: VoxelMap, dense, field, origin, dirs, z_hit, hit,
            delta: float, interp_sub=None):
    """Full-res re-solve within +/-delta of ``z_hit``: a valid outside ->
    inside pair re-solves the crossing, a valid pair without a crossing
    drops the hit.  With ``interp_sub`` the samples are trilinear, with
    that value for unobserved taps (so they always pair).  Also returns
    the two samples and the pair flag (the hybrid normals' along-ray
    derivative)."""
    def sample(z):
        pos = (origin + dirs * z[..., None]) * m.inverse_voxel_size
        if interp_sub is not None:
            return _sample_volume_interp(dense["F"], pos, m.size, interp_sub)
        return _sample_volume(dense["F"], pos, m.size, float("nan"))[0]

    f_lo = sample(z_hit - delta)
    f_hi = sample(z_hit + delta)
    pair = ~torch.isnan(f_lo) & ~torch.isnan(f_hi)
    crossing = pair & ~field.is_inside(f_lo) & field.is_inside(f_hi)
    miss = pair & ~crossing
    denom = f_lo - f_hi
    denom = torch.where(torch.abs(denom) < 1e-12, -1e-12, denom)
    frac = (f_hi - field.surf_boundary) / denom
    z_new = z_hit + delta + 2.0 * delta * frac
    return torch.where(crossing, z_new, z_hit), hit & ~miss, f_lo, f_hi, pair


def _midsolve(m: VoxelMap, dense, field, origin, dirs, z_hit, hit,
              delta: float):
    """Half-res secant correction of the scan's crossings: a valid outside
    -> inside pair at ``z_hit`` +/- ``delta`` re-solves the crossing; it
    never drops a hit (the rays are the scan's own)."""
    def sample(z):
        pos = (origin + dirs * z[..., None]) * m.inverse_voxel_size
        return _sample_volume(dense["F"], pos, m.size, float("nan"))[0]

    f_lo = sample(z_hit - delta)
    f_hi = sample(z_hit + delta)
    pair = ~torch.isnan(f_lo) & ~torch.isnan(f_hi)
    crossing = pair & ~field.is_inside(f_lo) & field.is_inside(f_hi) & hit
    denom = f_lo - f_hi
    denom = torch.where(torch.abs(denom) < 1e-12, -1e-12, denom)
    frac = (f_hi - field.surf_boundary) / denom
    z_new = z_hit + delta + 2.0 * delta * frac
    return torch.where(crossing, z_new, z_hit)


def _grad6(m: VoxelMap, dense, field, pos_world):
    """Central-difference gradient from 6 nearest-voxel taps of the view;
    NaN taps read the channel's init value, out-of-volume taps its empty
    value."""
    spec = next(c for c in m.channels if c.name == field.select_channel)
    base = pos_world * m.inverse_voxel_size
    offs = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], dtype=torch.float32,
                        device=base.device)
    pos6 = base[None] + offs.reshape((6,) + (1,) * (base.ndim - 1) + (3,))
    vals, _ = _sample_volume(dense["F"], pos6, m.size, spec.empty)
    vals = torch.nan_to_num(vals, nan=spec.init)
    g = torch.stack([vals[0] - vals[1], vals[2] - vals[3],
                     vals[4] - vals[5]], dim=-1)
    return g * 0.5
