"""Trajectory evaluation: ATE and RPE vs ground truth (a copy of
`supereight_tpu/apps/evaluate.py`).

Reference: `se_apps/scripts/evaluate_ate.py` / `evaluate_rpe.py` (the TUM
benchmark scripts, Python 2) and the harness glue in
`se_apps/scripts/_run.py:107-179`.  Re-implemented for Python 3 / numpy:
Horn closed-form alignment (SVD), RMSE statistics, optional scale search.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment model->data (Horn 1987; the method of
    `evaluate_ate.py:align`).  ``model``/``data``: [n, 3].

    Returns (R, t, s) minimizing ||s*R@model + t - data||.
    """
    model = np.asarray(model, np.float64).T   # [3, n]
    data = np.asarray(data, np.float64).T
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d
    W = mc @ dc.T
    U, _, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    if with_scale:
        s = float(np.trace(np.diag(np.linalg.svd(W)[1]) @ S)
                  / (mc * mc).sum())
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return R, t[:, 0], s


def ate(estimated: Sequence[np.ndarray], groundtruth: Sequence[np.ndarray],
        with_scale: bool = False) -> Dict[str, float]:
    """Absolute trajectory error of aligned positions
    (`evaluate_ate.py:99-126`).  Inputs: lists of 4x4 poses (associated)."""
    est = np.stack([np.asarray(T)[:3, 3] for T in estimated])
    gt = np.stack([np.asarray(T)[:3, 3] for T in groundtruth])
    R, t, s = horn_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n": len(err),
    }


def golden_section_search(lower: float, upper: float, epsilon: float, func):
    """Golden-section minimisation of a unimodal 1-D function on
    [lower, upper] to ``epsilon`` bracket width (the reference harness's
    scale optimiser, `se_apps/scripts/_util.py:4`).

    Returns (argmin, func(argmin))."""
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    while abs(upper - lower) > epsilon:
        a = upper - phi * (upper - lower)
        b = lower + phi * (upper - lower)
        if func(a) < func(b):
            upper = b
        else:
            lower = a
    center = (upper + lower) / 2.0
    return center, func(center)


def ate_scale_search(estimated: Sequence[np.ndarray],
                     groundtruth: Sequence[np.ndarray],
                     lower: float = 0.0, upper: float = 4.0,
                     epsilon: float = 0.01) -> Dict[str, float]:
    """ATE with a golden-section search over a global trajectory scale
    (`se_apps/scripts/_run.py:366-380`): each candidate scale multiplies
    the ESTIMATED positions, then a rigid (scale-free) Horn alignment is
    applied and the RMSE scored.  Used for scale-ambiguous (monocular)
    trajectories; for metric SLAM the optimum sits at ~1.0.

    Returns the :func:`ate` stats at the optimum plus ``scale``."""
    est = np.stack([np.asarray(T)[:3, 3] for T in estimated])
    gt = np.stack([np.asarray(T)[:3, 3] for T in groundtruth])

    def rmse_at(scale: float) -> float:
        R, t, _ = horn_align(scale * est, gt)
        aligned = (R @ (scale * est).T).T + t
        return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))

    scale, _ = golden_section_search(lower, upper, epsilon, rmse_at)
    scaled = [np.asarray(T).copy() for T in estimated]
    for T in scaled:
        T[:3, 3] *= scale
    out = ate(scaled, groundtruth)
    out["scale"] = float(scale)
    return out


def rpe(estimated: Sequence[np.ndarray], groundtruth: Sequence[np.ndarray],
        delta: int = 1) -> Dict[str, float]:
    """Relative pose error over a fixed frame delta
    (`evaluate_rpe.py` semantics, fixed_delta mode)."""
    trans_errs, rot_errs = [], []
    n = len(estimated)
    for i in range(n - delta):
        e_rel = np.linalg.inv(np.asarray(estimated[i])) @ \
            np.asarray(estimated[i + delta])
        g_rel = np.linalg.inv(np.asarray(groundtruth[i])) @ \
            np.asarray(groundtruth[i + delta])
        err = np.linalg.inv(g_rel) @ e_rel
        trans_errs.append(np.linalg.norm(err[:3, 3]))
        ang = (np.trace(err[:3, :3]) - 1.0) / 2.0
        rot_errs.append(np.arccos(np.clip(ang, -1.0, 1.0)))
    trans_errs = np.asarray(trans_errs)
    rot_errs = np.asarray(rot_errs)
    return {
        "trans_rmse": float(np.sqrt(np.mean(trans_errs ** 2))),
        "trans_mean": float(trans_errs.mean()),
        "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(rot_errs ** 2)))),
        "rot_mean_deg": float(np.degrees(rot_errs.mean())),
        "n": len(trans_errs),
    }


def associate(ts_a: Sequence[float], ts_b: Sequence[float],
              max_difference: float = 0.02):
    """Greedy nearest-timestamp association (`associate.py` semantics).
    Returns list of (ia, ib) index pairs."""
    pairs = [(abs(a - b), i, j) for i, a in enumerate(ts_a)
             for j, b in enumerate(ts_b) if abs(a - b) < max_difference]
    pairs.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, j in pairs:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            out.append((i, j))
    out.sort()
    return out
