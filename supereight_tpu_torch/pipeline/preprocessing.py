"""Depth preprocessing over whole images (counterpart of
`supereight_tpu/pipeline/preprocessing.py`)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from supereight_tpu_torch.core.numerics import fma, sqrt
from . import camera
from .constants import E_DELTA, GAUSSIAN_DELTA, INVALID, RADIUS

#: 1 / 1000 in float32
MM_TO_M = float(np.float32(1e-3))


def mm_to_meters(depth_mm: torch.Tensor,
                 out_hw: Tuple[int, int]) -> torch.Tensor:
    """Integer mm depth -> float32 m, decimated by pixel striding (output
    pixel (x, y) samples input pixel (x*ratio, y*ratio); no averaging).
    The millimetres are multiplied by float32(0.001), as jitted XLA
    rewrites the JAX package's division by 1000."""
    H, W = out_hw
    ih, iw = depth_mm.shape
    ratio = iw // W
    if ih // H != ratio or W * ratio != iw or H * ratio != ih:
        raise ValueError(f"invalid decimation {tuple(depth_mm.shape)} -> "
                         f"{out_hw}")
    return depth_mm[::ratio, ::ratio].to(torch.float32) * MM_TO_M


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``img`` sampled at the clamped pixel (y+dy, x+dx)."""
    H, W = img.shape[:2]
    rows = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    cols = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[rows][:, cols]


def gaussian_weights(radius: int = RADIUS,
                     delta: float = GAUSSIAN_DELTA) -> torch.Tensor:
    """Spatial Gaussian row (the reference's ``x = i - 2`` whatever the
    radius)."""
    x = torch.arange(2 * radius + 1, dtype=torch.float32) - 2.0
    return torch.exp(-(x * x) / (2.0 * delta * delta))


def bilateral_filter(depth: torch.Tensor, e_d: float = E_DELTA,
                     radius: int = RADIUS) -> torch.Tensor:
    """5x5 bilateral filter: spatial Gaussian times intensity Gaussian over
    the neighbours with depth > 0; zero depth stays 0."""
    g = gaussian_weights(radius).to(depth.device)
    inv_2ed2 = 1.0 / (2.0 * e_d * e_d)
    t = torch.zeros_like(depth)
    s = torch.zeros_like(depth)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            cur = _shifted(depth, j, i)      # i over x, j over y
            diff = cur - depth
            factor = (g[i + radius] * g[j + radius]) \
                * torch.exp(-(diff * diff) * inv_2ed2)
            valid = cur > 0
            t = t + torch.where(valid, factor * cur, 0.0)
            s = s + torch.where(valid, factor, 0.0)
    out = t / torch.clamp(s, min=1e-20)
    return torch.where(depth == 0, 0.0, out)


def half_sample_robust(depth: torch.Tensor, e_d: float = E_DELTA * 3,
                       radius: int = 1) -> torch.Tensor:
    """Edge-preserving 2x downsample: average the 2x2 neighbourhood pixels
    within ``e_d`` of the centre sample."""
    center = depth[::2, ::2]
    t = torch.zeros_like(center)
    s = torch.zeros_like(center)
    for i in range(-radius + 1, radius + 1):
        for j in range(-radius + 1, radius + 1):
            cur = _shifted(depth, i, j)[::2, ::2]
            ok = torch.abs(cur - center) < e_d
            t = t + torch.where(ok, cur, 0.0)
            s = s + ok.to(depth.dtype)
    return t / torch.clamp(s, min=1e-20)


def depth_to_vertex(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Back-project depth to camera-space vertices [H, W, 3]; each pixel
    ray's coordinate is one multiply-add, as jitted XLA contracts it."""
    H, W = depth.shape
    x = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    vx = depth * fma(inv_K[0, 0], x, inv_K[0, 2])
    vy = depth * fma(inv_K[1, 1], y, inv_K[1, 2])
    v = torch.stack([vx, vy, depth], dim=-1)
    return torch.where(depth[..., None] > 0, v, 0.0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, rounded as ``jnp.cross`` rounds
    it (one multiply-add per component)."""
    def comp(i, j):
        return fma(a[..., i], b[..., j], -(a[..., j] * b[..., i]))
    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the (short) last axis, rounded as
    ``jnp.linalg.norm`` rounds it: a multiply-add chain."""
    acc = v[..., 0] * v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = fma(v[..., i], v[..., i], acc)
    n = sqrt(acc)
    return n[..., None] if keepdim else n


def vertex_to_normal(vertex: torch.Tensor, neg_y: bool) -> torch.Tensor:
    """Cross-product normals from neighbouring vertices [H, W, 3]; invalid
    pixels get x = INVALID.  ``neg_y`` swaps up/down for a flipped y."""
    left = _shifted(vertex, 0, -1)
    right = _shifted(vertex, 0, 1)
    if neg_y:
        up, down = _shifted(vertex, -1, 0), _shifted(vertex, 1, 0)
    else:
        up, down = _shifted(vertex, 1, 0), _shifted(vertex, -1, 0)
    n = cross(right - left, up - down)
    n = n / torch.clamp(norm(n, keepdim=True), min=1e-20)
    ok = ((vertex[..., 2] != 0) & (left[..., 2] != 0) & (right[..., 2] != 0)
          & (up[..., 2] != 0) & (down[..., 2] != 0))
    invalid = torch.zeros_like(n)
    invalid[..., 0] = INVALID
    return torch.where(ok[..., None], n, invalid)


def build_pyramid(depth: torch.Tensor, k: torch.Tensor, levels: int,
                  neg_y: bool):
    """Depth pyramid + per-level vertex/normal maps for coarse-to-fine ICP:
    a half-sample chain, then per level back-projection with the
    intrinsics scaled by 2^-level."""
    depths: List[torch.Tensor] = [depth]
    for _ in range(1, levels):
        depths.append(half_sample_robust(depths[-1]))
    vertices, normals = [], []
    for i, d in enumerate(depths):
        v = depth_to_vertex(d, camera.inverse_camera_matrix(k / (1 << i)))
        vertices.append(v)
        normals.append(vertex_to_normal(v, neg_y))
    return depths, vertices, normals
