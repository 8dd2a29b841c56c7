"""Projective point-to-plane ICP tracking (counterpart of
`supereight_tpu/pipeline/tracking.py`: nearest association, plain or
symmetric residual, no IRLS weights, single device).

The per-level iteration loop is a host loop: each iteration reads the
convergence test back, as the JAX ``lax.while_loop`` evaluates it in-graph,
and the status image is the last executed iteration's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from supereight_tpu_torch.core.numerics import inv, trunc_i32
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


def _gather_ref(ref_vertex, ref_normal, px, py, rH: int, rW: int):
    """Reference vertex/normal rows at the nearest projected pixel."""
    ix = trunc_i32(px).clamp(0, rW - 1).long()
    iy = trunc_i32(py).clamp(0, rH - 1).long()
    return ref_vertex[iy, ix], ref_normal[iy, ix]


def _residuals(proj_vertex, proj_normal, ref_v, ref_n, in_frame,
               no_in_normal, dist_threshold, normal_threshold,
               symmetric: bool = False) -> TrackData:
    """Residual, Jacobian and status codes.  ``symmetric`` projects the
    residual onto the renormalised bisector of the two normals."""
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
    if symmetric:
        n_s = ref_n + proj_normal
        nn = norm(n_s, keepdim=True)
        n_c = n_s / torch.where(nn == 0, 1.0, nn)
    error = (n_c * diff).sum(-1)
    J = torch.cat([n_c, cross(proj_vertex, n_c)], dim=-1)
    ok = result == 1
    return TrackData(result=result, error=torch.where(ok, error, 0.0),
                     J=torch.where(ok[..., None], J, 0.0))


def track_kernel(in_vertex, in_normal, ref_vertex, ref_normal, Ttrack, view,
                 dist_threshold=DIST_THRESHOLD,
                 normal_threshold=NORMAL_THRESHOLD,
                 symmetric: bool = False) -> TrackData:
    """Per-pixel projective data association; ``view`` = K @
    inv(raycast_pose) at the reference maps' resolution."""
    rH, rW = ref_vertex.shape[:2]
    proj_vertex, px, py, in_frame = _project(Ttrack, view, in_vertex, rH, rW)
    no_in_normal = in_normal[..., 0] == INVALID
    ref_v, ref_n = _gather_ref(ref_vertex, ref_normal, px, py, rH, rW)
    proj_normal = camera.rotate_vectors(Ttrack, in_normal)
    return _residuals(proj_vertex, proj_normal, ref_v, ref_n, in_frame,
                      no_in_normal, dist_threshold, normal_threshold,
                      symmetric=symmetric)


def reduce_kernel(td: TrackData):
    """Normal-equation sums: (error2, JTe[6], JTJ[6,6], count)."""
    ok = (td.result == 1).to(torch.float32)
    error2 = (ok * td.error * td.error).sum()
    J = td.J.reshape(-1, 6)
    w = ok.reshape(-1, 1)
    JTe = (w * td.error.reshape(-1, 1) * J).sum(0)
    JTJ = (w * J).T @ J
    return error2, JTe, JTJ, ok.sum()


def solve_normal_equations(JTe, JTJ):
    """6x6 Cholesky solve; a zero twist where JTJ is not positive definite
    or the solution is not finite (JAX's Cholesky returns NaN there)."""
    L, info = torch.linalg.cholesky_ex(JTJ)
    x = torch.cholesky_solve(JTe[:, None], L)[:, 0]
    bad = (info != 0) | ~torch.isfinite(x).all()
    return torch.where(bad, torch.zeros_like(x), x)


class TrackState(NamedTuple):
    pose: torch.Tensor      # [4,4]
    error2: torch.Tensor    # last reduction's error^2 sum
    count: torch.Tensor     # last reduction's inlier count


def _level_loop(st: TrackState, n_iters: int, in_vertex, in_normal,
                ref_vertex, ref_normal, view, icp_threshold: float,
                symmetric: bool = False):
    """Iterate track + reduce + update with the early exit on
    ||twist|| < icp_threshold.  Returns (state, status image of the last
    executed iteration, zeros if none ran)."""
    result = torch.zeros(in_vertex.shape[:-1], dtype=torch.int32,
                         device=in_vertex.device)
    for _ in range(n_iters):
        td = track_kernel(in_vertex, in_normal, ref_vertex, ref_normal,
                          st.pose, view, symmetric=symmetric)
        error2, JTe, JTJ, count = reduce_kernel(td)
        x = solve_normal_equations(JTe, JTJ)
        st = TrackState(pose=camera.se3_exp(x) @ st.pose, error2=error2,
                        count=count)
        result = td.result
        if bool(norm(x) < icp_threshold):
            break
    return st, result


def track(pose, depths, vertices, normals, ref_vertex, ref_normal,
          raycast_pose, k, iterations: Sequence[int], icp_threshold: float,
          track_threshold: float = TRACK_THRESHOLD,
          finest_decimate: int = 1, symmetric: bool = False):
    """Coarse-to-fine tracking.  Returns (new_pose, tracked: bool tensor,
    full-res status image of the last level-0 iteration).
    ``finest_decimate`` strides the finest level's input maps."""
    view = camera.camera_matrix(k) @ inv(raycast_pose)
    zero = torch.zeros((), dtype=torch.float32, device=pose.device)
    st = TrackState(pose=pose, error2=zero, count=zero)
    d = finest_decimate
    result = None
    for level in range(len(iterations) - 1, -1, -1):
        iv, inm = vertices[level], normals[level]
        if level == 0 and d > 1:
            iv, inm = iv[::d, ::d], inm[::d, ::d]
        st, result = _level_loop(st, iterations[level], iv, inm, ref_vertex,
                                 ref_normal, view, icp_threshold,
                                 symmetric=symmetric)

    # divergence check over the finest level actually executed
    n_px = result.shape[0] * result.shape[1]
    rmse = torch.sqrt(st.error2 / torch.clamp(st.count, min=1.0))
    ok = (rmse <= 2e-2) & (st.count / n_px >= track_threshold)
    new_pose = torch.where(ok, st.pose, pose)
    if d > 1:
        H, W = vertices[0].shape[:2]
        result = result.repeat_interleave(d, 0).repeat_interleave(d, 1)[:H, :W]
    return new_pose, ok, result
