"""Projective point-to-plane ICP tracking (counterpart of
`supereight_tpu/pipeline/tracking.py`: nearest or bilinear association,
plain, symmetric or per-frame gated symmetric residual, optional Huber or
Tukey IRLS weights; image-row strips over D ranks with ``track(shard=)``).

Each pyramid level runs as the JAX ``lax.while_loop`` does, with its carry
on the device (:class:`TrackState`: pose, error2, count, converged,
iteration) and nothing read back inside the level loops.  On one device
:func:`track_levels` is one call of
:func:`~supereight_tpu_torch.ops.icp_kernel.icp_track_levels`: on the card
one launch of a persistent CUDA kernel that forms the view from the raycast
pose and runs every trip of every level, on the CPU its twin (each level's
loop as :func:`_level_loop` runs it).
Sharded (``track(shard=)``), each level runs :func:`_level_loop`: the host
queues all ``n_iters`` trips, a trip after ``converged`` is set changes
nothing, and a trip is one call of `ops/icp_kernel.py`'s
:func:`~supereight_tpu_torch.ops.icp_kernel.icp_track_reduce`: the
previous trip's solve and pose update from its all-reduced sums, then the
association, residuals and the normal equations' sums, which are
all-reduced before the next trip, so every rank issues the same
collectives and takes the same decisions; one
:func:`~supereight_tpu_torch.ops.icp_kernel.icp_update` applies a level's
last update.  On the card these are two CUDA kernels (one launch a trip,
one a level), on the CPU their twins, which run this module's functions
in the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from supereight_tpu_torch.core.numerics import fma, trunc_i32
from supereight_tpu_torch.ops import icp_kernel
from . import camera
from .constants import (DIST_THRESHOLD, INVALID, NORMAL_THRESHOLD,
                        TRACK_THRESHOLD)
from .preprocessing import cross, norm


class TrackData(NamedTuple):
    """Per-pixel ICP result. ``result`` codes: 1 ok, -1 no input normal,
    -2 out of frame, -3 no reference normal, -4 too far, -5 bad normal
    agreement."""
    result: torch.Tensor   # int32[H, W]
    error: torch.Tensor    # f32[H, W]
    J: torch.Tensor        # f32[H, W, 6]


def _project(Ttrack, view, in_vertex, rH: int, rW: int):
    """World-space input vertices + their pixel coords in the reference
    frame (+0.5, so the int cast rounds)."""
    proj_vertex = camera.transform_points(Ttrack, in_vertex)
    proj_pos = camera.transform_points(view, proj_vertex)
    z = proj_pos[..., 2]
    zsafe = torch.where(z == 0, 1.0, z)
    px = proj_pos[..., 0] / zsafe + 0.5
    py = proj_pos[..., 1] / zsafe + 0.5
    in_frame = (px >= 0) & (px <= rW - 1) & (py >= 0) & (py <= rH - 1)
    return proj_vertex, px, py, in_frame


def _gather_ref(ref_vertex, ref_normal, px, py, rH: int, rW: int,
                assoc: str = "nearest"):
    """Reference vertex/normal rows at the projected pixels: the nearest
    row (``assoc="nearest"``; the +0.5 of ``_project`` makes the cast a
    round), or ``"bilinear"``: the 4 neighbouring rows blended where all
    four carry a valid normal (the normal renormalised), else the nearest
    of them."""
    if assoc == "nearest":
        ix = trunc_i32(px).clamp(0, rW - 1).long()
        iy = trunc_i32(py).clamp(0, rH - 1).long()
        return ref_vertex[iy, ix], ref_normal[iy, ix]
    if assoc != "bilinear":
        raise ValueError(f"assoc {assoc!r}")
    table = torch.cat([ref_vertex, ref_normal], dim=-1)
    pxc, pyc = px - 0.5, py - 0.5
    x0 = trunc_i32(torch.floor(pxc)).clamp(0, rW - 1)
    y0 = trunc_i32(torch.floor(pyc)).clamp(0, rH - 1)
    x1 = (x0 + 1).clamp(max=rW - 1)
    y1 = (y0 + 1).clamp(max=rH - 1)
    wx = (pxc - x0.to(pxc.dtype)).clamp(0.0, 1.0)[..., None]
    wy = (pyc - y0.to(pyc.dtype)).clamp(0.0, 1.0)[..., None]
    x0, y0, x1, y1 = (a.long() for a in (x0, y0, x1, y1))
    t00, t01 = table[y0, x0], table[y0, x1]
    t10, t11 = table[y1, x0], table[y1, x1]
    ux, uy = 1 - wx, 1 - wy
    # the four-term blend as XLA contracts it: the first term's last
    # product fused into the second term, then each later term's
    blend = fma(t00 * ux, uy, t01 * wx * uy)
    blend = fma(t10 * ux, wy, blend)
    blend = fma(t11 * wx, wy, blend)
    n = blend[..., 3:]
    nn = norm(n, keepdim=True)
    blend = torch.cat([blend[..., :3], n / torch.where(nn == 0, 1.0, nn)],
                      dim=-1)
    valid4 = ((t00[..., 3] != INVALID) & (t01[..., 3] != INVALID)
              & (t10[..., 3] != INVALID) & (t11[..., 3] != INVALID))
    # >= : the int cast of px (= pxc + 0.5) rounds half up
    right, down = wx >= 0.5, wy >= 0.5
    nearest = torch.where(right, torch.where(down, t11, t01),
                          torch.where(down, t10, t00))
    ref_vn = torch.where(valid4[..., None], blend, nearest)
    return ref_vn[..., :3], ref_vn[..., 3:]


def _residuals(proj_vertex, proj_normal, ref_v, ref_n, in_frame,
               no_in_normal, dist_threshold, normal_threshold,
               symmetric=False) -> TrackData:
    """Residual, Jacobian and status codes.  ``symmetric`` projects the
    residual onto the renormalised bisector of the two normals: True,
    False, or a bool tensor (the per-frame gate of ``icp_symmetric=
    "auto"``) that selects between the two."""
    no_ref_normal = ref_n[..., 0] == INVALID
    diff = ref_v - proj_vertex
    too_far = norm(diff) > dist_threshold
    bad_normal = (proj_normal * ref_n).sum(-1) < normal_threshold

    result = torch.ones(proj_vertex.shape[:-1], dtype=torch.int32,
                        device=proj_vertex.device)
    result = torch.where(bad_normal, -5, result)
    result = torch.where(too_far, -4, result)
    result = torch.where(no_ref_normal, -3, result)
    result = torch.where(~in_frame, -2, result)
    result = torch.where(no_in_normal, -1, result)

    n_c = ref_n
    if symmetric is not False:
        n_s = ref_n + proj_normal
        nn = norm(n_s, keepdim=True)
        n_s = n_s / torch.where(nn == 0, 1.0, nn)
        n_c = n_s if symmetric is True else torch.where(symmetric, n_s,
                                                        ref_n)
    error = (n_c * diff).sum(-1)
    J = torch.cat([n_c, cross(proj_vertex, n_c)], dim=-1)
    ok = result == 1
    return TrackData(result=result, error=torch.where(ok, error, 0.0),
                     J=torch.where(ok[..., None], J, 0.0))


def track_kernel(in_vertex, in_normal, ref_vertex, ref_normal, Ttrack, view,
                 dist_threshold=DIST_THRESHOLD,
                 normal_threshold=NORMAL_THRESHOLD,
                 symmetric=False, assoc: str = "nearest") -> TrackData:
    """Per-pixel projective data association; ``view`` = K @
    inv(raycast_pose) at the reference maps' resolution."""
    rH, rW = ref_vertex.shape[:2]
    proj_vertex, px, py, in_frame = _project(Ttrack, view, in_vertex, rH, rW)
    no_in_normal = in_normal[..., 0] == INVALID
    ref_v, ref_n = _gather_ref(ref_vertex, ref_normal, px, py, rH, rW, assoc)
    proj_normal = camera.rotate_vectors(Ttrack, in_normal)
    return _residuals(proj_vertex, proj_normal, ref_v, ref_n, in_frame,
                      no_in_normal, dist_threshold, normal_threshold,
                      symmetric=symmetric)


def robust_weights(td: TrackData, robust: str = "none",
                   robust_delta: float = 0.01) -> torch.Tensor:
    """IRLS weight of each pixel (0 where the status is not ok): 1
    (``"none"``), Huber's min(1, delta / |r|) or Tukey's (1 - (r/c)^2)^2
    inside c, 0 outside."""
    ok = (td.result == 1).to(torch.float32)
    if robust == "none":
        return ok
    f32 = lambda v: torch.full((), v, dtype=torch.float32,
                               device=td.error.device)
    if robust == "huber":
        ae = torch.abs(td.error)
        # a tensor divisor: PyTorch takes ``scalar / t`` as a reciprocal
        # times the scalar, two roundings
        return ok * torch.where(ae > robust_delta,
                                f32(robust_delta)
                                / torch.clamp(ae, min=1e-12), 1.0)
    if robust == "tukey":
        # XLA rewrites x / c as x * (1 / c), the reciprocal in float32
        r = td.error * f32(np.float32(1.0) / np.float32(robust_delta))
        r2 = r * r
        return ok * torch.where(r2 < 1.0, (1.0 - r2) * (1.0 - r2), 0.0)
    raise ValueError(f"robust {robust!r}")


def reduce_kernel(td: TrackData, robust: str = "none",
                  robust_delta: float = 0.01):
    """Normal-equation sums: (error2, JTe[6], JTJ[6,6], count).  The IRLS
    weights (``robust``) enter only JTe and JTJ; ``error2`` and ``count``
    stay unweighted, so the divergence gate keeps its meaning.  JTJ is a
    reduction of the per-pixel outer products, as JTe is of its terms: a
    float32 GEMM over the pixels (one chain each entry on the CPU) is
    ~1e-5 off the exact sums, XLA's and a reduction's ~1e-7."""
    ok = (td.result == 1).to(torch.float32)
    error2 = (ok * td.error * td.error).sum()
    J = td.J.reshape(-1, 6)
    w = robust_weights(td, robust, robust_delta).reshape(-1, 1)
    JTe = (w * td.error.reshape(-1, 1) * J).sum(0)
    JTJ = ((w * J)[:, :, None] * J[:, None, :]).sum(0)
    return error2, JTe, JTJ, ok.sum()


def solve_normal_equations(JTe, JTJ):
    """6x6 Cholesky solve; a zero twist where JTJ is not positive definite
    or the solution is not finite (JAX's Cholesky returns NaN there)."""
    L, info = torch.linalg.cholesky_ex(JTJ)
    x = torch.cholesky_solve(JTe[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.isfinite(x).all()
    return torch.where(bad, torch.zeros_like(x), x)


class TrackState(NamedTuple):
    """The level loop's carry (JAX `tracking.py:203-208`)."""
    pose: torch.Tensor       # [4,4]
    error2: torch.Tensor     # last reduction's error^2 sum
    count: torch.Tensor      # last reduction's inlier count
    converged: torch.Tensor  # bool: the last trip's twist was below the
    #                          threshold
    iteration: torch.Tensor  # int32: trips run at this level


def all_reduce_sums(comm, error2, JTe, JTJ, count):
    """The normal-equation sums of every rank's strip: one all_reduce of
    the 44 float32 values (the JAX ``psum``, `tracking.py:247-253`)."""
    flat = torch.cat([error2.reshape(1), JTe, JTJ.reshape(-1),
                      count.reshape(1)])
    flat = comm.all_reduce_sum(flat)
    return flat[0], flat[1:7], flat[7:43].reshape(6, 6), flat[43]


def _level_loop(st: TrackState, n_iters: int, in_vertex, in_normal,
                ref_vertex, ref_normal, view, icp_threshold: float,
                symmetric=False, robust: str = "none",
                robust_delta: float = 0.01, assoc: str = "nearest",
                comm=None):
    """Track + reduce + update with the early exit on ||twist|| <
    icp_threshold, as JAX's ``lax.while_loop``: ``converged`` and
    ``iteration`` restart at 0, then all ``n_iters`` trips are queued and
    those after the exit change nothing.  A trip is one call of
    ``icp_kernel.icp_track_reduce``, which applies the previous trip's
    update (from its sums) before its own pass, and one ``icp_update``
    applies the last trip's: n_iters + 1 calls a level.  With ``comm`` the
    sums are all-reduced over its ranks every trip.  Returns (state,
    status image of the last trip that ran, zeros if none ran)."""
    dev = in_vertex.device
    st = st._replace(converged=torch.zeros((), dtype=torch.bool, device=dev),
                     iteration=torch.zeros((), dtype=torch.int32,
                                           device=dev))
    result = torch.zeros(in_vertex.shape[:-1], dtype=torch.int32, device=dev)
    # a trip writes one buffer while it reads the other's pending sums
    bufs = [torch.zeros(icp_kernel.N_SUMS, dtype=torch.float32, device=dev)
            for _ in range(2)]
    scratch = icp_kernel.make_scratch(result.numel(), dev)
    pending = None
    for trip in range(n_iters):
        st, result, sums = icp_kernel.icp_track_reduce(
            in_vertex, in_normal, ref_vertex, ref_normal, view, st, n_iters,
            result, bufs[trip % 2], symmetric=symmetric, robust=robust,
            robust_delta=robust_delta, assoc=assoc, scratch=scratch,
            pending=pending, icp_threshold=icp_threshold)
        if comm is not None:
            sums = comm.all_reduce_sum(sums)
        pending = sums
    if pending is not None:
        st = icp_kernel.icp_update(pending, st, n_iters, icp_threshold)
    return st, result


def track_levels(pose, vertices, normals, ref_vertex, ref_normal,
                 raycast_pose, k, iterations: Sequence[int],
                 icp_threshold: float, finest_decimate: int = 1,
                 symmetric=False, robust: str = "none",
                 robust_delta: float = 0.01, assoc: str = "nearest",
                 shard=None):
    """The coarse-to-fine level loops of :func:`track` from ``pose``
    against the reference maps seen from ``raycast_pose`` through the
    intrinsics ``k``: no host read.  Returns (final :class:`TrackState`,
    status image of the last level's last trip, pixels of the finest level
    actually run, or None when they are the status image's).  On one device
    (``shard`` None) one call of ``icp_kernel.icp_track_levels``, which
    forms the view K @ inv(raycast_pose) itself (on the card inside its
    launch); sharded, the view (``icp_kernel.tracking_view``), then
    :func:`_level_loop` a level with the sums all-reduced every trip."""
    d = finest_decimate
    knobs = dict(symmetric=symmetric, robust=robust,
                 robust_delta=robust_delta, assoc=assoc)
    levels = [(vertices[level], normals[level])
              for level in range(len(iterations))]
    if d > 1:
        levels[0] = tuple(a[::d, ::d] for a in levels[0])
    if shard is None:
        st, result = icp_kernel.icp_track_levels(
            pose, levels, ref_vertex, ref_normal, raycast_pose, k,
            iterations, icp_threshold, **knobs)
        return st, result, None
    view = icp_kernel.tracking_view(raycast_pose, k)
    dev = pose.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    st = TrackState(pose=pose.clone(), error2=zero, count=zero.clone(),
                    converged=torch.zeros((), dtype=torch.bool, device=dev),
                    iteration=torch.zeros((), dtype=torch.int32, device=dev))
    comm, rank, n = shard
    result = None
    n_px = None
    for level in range(len(iterations) - 1, -1, -1):
        iv, inm = levels[level]
        level_comm = None
        if iv.shape[0] % n == 0:
            level_comm = comm
            rows = iv.shape[0] // n
            if level == 0:
                n_px = iv.shape[0] * iv.shape[1]
            iv, inm = (a[rank * rows:(rank + 1) * rows] for a in (iv, inm))
        st, result = _level_loop(st, iterations[level], iv, inm, ref_vertex,
                                 ref_normal, view, icp_threshold,
                                 comm=level_comm, **knobs)
    return st, result, n_px


def track(pose, depths, vertices, normals, ref_vertex, ref_normal,
          raycast_pose, k, iterations: Sequence[int], icp_threshold: float,
          track_threshold: float = TRACK_THRESHOLD,
          finest_decimate: int = 1, symmetric=False, robust: str = "none",
          robust_delta: float = 0.01, assoc: str = "nearest", shard=None):
    """Coarse-to-fine tracking.  Returns (new_pose, tracked: bool tensor,
    full-res status image of the last level-0 iteration).
    ``finest_decimate`` strides the finest level's input maps; ``symmetric``
    (a bool or a bool tensor), ``robust`` / ``robust_delta`` and ``assoc``
    as in :func:`_residuals`, :func:`robust_weights` and
    :func:`_gather_ref`.

    ``shard = (comm, rank, D)`` (JAX `tracking.py:274-330`): each level
    whose rows divide by D computes the residuals of this rank's row strip
    only and all-reduces the sums over ``comm`` (a
    ``parallel.sharding.Comm``) once an iteration; the other levels run
    whole on every rank.  Both give every rank the same sums.  The status
    image is then this rank's strip of the finest level when its rows
    divide by D (the caller gathers the strips)."""
    st, result, n_px = track_levels(
        pose, vertices, normals, ref_vertex, ref_normal, raycast_pose, k,
        iterations, icp_threshold, finest_decimate=finest_decimate, symmetric=symmetric,
        robust=robust, robust_delta=robust_delta, assoc=assoc, shard=shard)
    d = finest_decimate

    # divergence check over the finest level actually executed
    if n_px is None:
        n_px = result.shape[0] * result.shape[1]
    rmse = torch.sqrt(st.error2 / torch.clamp(st.count, min=1.0))
    ok = (rmse <= 2e-2) & (st.count / n_px >= track_threshold)
    new_pose = torch.where(ok, st.pose, pose)
    if d > 1:
        H, W = vertices[0].shape[:2]
        result = result.repeat_interleave(d, 0).repeat_interleave(d, 1)[:H, :W]
    return new_pose, ok, result
