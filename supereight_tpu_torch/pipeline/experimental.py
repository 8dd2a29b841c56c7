"""Pipeline variants measured negative in the JAX package, kept runnable
and wired to nothing (counterpart of `supereight_tpu/pipeline/experimental.py`,
whose docstring carries each measurement):

* :func:`warp_maps`: forward-warp the reference maps to a new viewpoint
  on frames that skip the raycast (ICP lost constraints to splat holes);
* :func:`image_normals`: normals from vertex-map cross products
  (silhouette normals broke the point-to-plane solve);
* :func:`grad3`: a 3-tap forward difference anchored at the surface value
  (too noisy for ICP).
"""

from __future__ import annotations

import torch

from supereight_tpu_torch.core.numerics import trunc_i32
from supereight_tpu_torch.core.octree import VoxelMap
from . import camera
from .constants import INVALID
from .preprocessing import cross, norm
from .raycast import _sample_volume


def warp_maps(vertex, normal, view, H: int, W: int):
    """World-space reference maps splatted into the view ``view`` = K @
    inv(new_pose) with a z-buffer: each pixel takes the nearest point that
    lands on it (the nearest-pixel rounding of the ICP association; among
    equal depths the last in raster order, as a sequential scatter
    writes).  Pixels no point lands on stay invalid."""
    HW = H * W
    v = vertex.reshape(HW, 3)
    n = normal.reshape(HW, 3)
    p = camera.transform_points(view, v)
    z = p[:, 2]
    valid = (n[:, 0] != INVALID) & (z > 1e-4) & torch.isfinite(z)
    zsafe = torch.where(valid, z, 1.0)
    ix = trunc_i32(torch.floor(p[:, 0] / zsafe + 0.5))
    iy = trunc_i32(torch.floor(p[:, 1] / zsafe + 0.5))
    ok = valid & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    lin = torch.where(ok, iy * W + ix, HW).long()        # HW: dump slot
    inf = torch.full((HW + 1,), float("inf"), device=v.device)
    zbuf = inf.scatter_reduce(0, lin, torch.where(ok, z, float("inf")),
                              "amin")
    win = ok & (z <= zbuf[lin])
    src = torch.full((HW + 1,), -1, dtype=torch.long, device=v.device) \
        .scatter_reduce(0, torch.where(win, lin, HW),
                        torch.arange(HW, device=v.device), "amax")[:HW]
    rows = torch.cat([v, n], dim=1)
    empty = torch.zeros(6, device=v.device)
    empty[3] = INVALID
    out = torch.where((src >= 0)[:, None], rows[src.clamp(min=0)], empty)
    return out[:, :3].reshape(H, W, 3), out[:, 3:].reshape(H, W, 3)


def image_normals(vertex, hit, dirs):
    """Normals from central differences of the vertex map (edge pixels
    repeat their neighbour), oriented against the rays ``dirs``.  Returns
    (normal, bad)."""
    H, W = hit.shape
    dev = vertex.device
    r = torch.arange(W, device=dev)
    c = torch.arange(H, device=dev)
    right, left = (r + 1).clamp(max=W - 1), (r - 1).clamp(min=0)
    down, up = (c + 1).clamp(max=H - 1), (c - 1).clamp(min=0)
    dx = vertex[:, right] - vertex[:, left]
    dy = vertex[down] - vertex[up]
    n = cross(dy, dx)
    okn = hit[:, right] & hit[:, left] & hit[down] & hit[up]
    nn = norm(n, keepdim=True)
    n = n / torch.clamp(nn, min=1e-12)
    flip = (n * dirs).sum(-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return n, ~hit | ~okn | (nn[..., 0] < 1e-12)


def grad3(m: VoxelMap, dense, field, pos_world):
    """Forward-difference gradient from the 3 taps one voxel up each axis,
    less ``field.surf_boundary`` (NaN taps read the channel's init value,
    out-of-volume taps its empty value)."""
    spec = next(c for c in m.channels if c.name == field.select_channel)
    base = pos_world * m.inverse_voxel_size
    grads = []
    for axis in range(3):
        e = torch.zeros(3, device=base.device)
        e[axis] = 1.0
        val, _ = _sample_volume(dense["F"], base + e, m.size, spec.empty)
        grads.append(torch.nan_to_num(val, nan=spec.init)
                     - field.surf_boundary)
    return torch.stack(grads, dim=-1)
