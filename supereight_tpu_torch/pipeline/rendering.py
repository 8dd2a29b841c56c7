"""Render kernels: depth colormap, ICP status map, shaded volume
(counterpart of `supereight_tpu/pipeline/rendering.py`, which the JAX
system runs op by op: each operation here rounds as one XLA op does).

Reference: `se_denseslam/src/rendering.cpp:111-283` and the `gs2rgb`
HSV-ramp colormap (`se_denseslam/include/se/commons.h:105-160`).  All
produce uint8 [H, W, 4] RGBW images on the device of their inputs.
"""

from __future__ import annotations

import torch

from supereight_tpu_torch.core.numerics import div, sqrt
from supereight_tpu_torch.utils.perfstats import Stats
from . import raycast as _raycast
from .constants import AMBIENT, FAR_PLANE, INVALID, LIGHT, NEAR_PLANE


def gs2rgb(h: torch.Tensor) -> torch.Tensor:
    """Grayscale [0,1] -> HSV ramp rgb (commons.h:105-160; v=0.75, m=0.25,
    sv=2/3), branch-free over the 6 sextants."""
    v, m, sv = 0.75, 0.25, 0.6667
    h6 = h * 6.0
    sextant = h6.to(torch.int32).clamp(0, 5)
    fract = h6 - sextant.to(torch.float32)
    vsf = (v * sv) * fract
    mid1 = m + vsf
    mid2 = v - vsf
    vv = torch.full_like(h, v)
    mm = torch.full_like(h, m)
    # per-sextant (r, g, b) table
    rs = torch.stack([vv, mid2, mm, mm, mid1, vv], -1)
    gs = torch.stack([mid1, vv, vv, mid2, mm, mm], -1)
    bs = torch.stack([mm, mm, mid1, vv, vv, mid2], -1)
    idx = sextant[..., None].long()
    return torch.cat([torch.gather(c, -1, idx) for c in (rs, gs, bs)], -1)


def render_depth(depth: torch.Tensor, near: float = NEAR_PLANE,
                 far: float = FAR_PLANE) -> torch.Tensor:
    """renderDepthKernel (`rendering.cpp:111-152`): white below near, black
    beyond far, HSV ramp in between.  Returns uint8 [H, W, 4]."""
    d = div(depth - near, far - near)
    rgb = (gs2rgb(d.clamp(0.0, 1.0)) * 255.0).to(torch.uint8)
    rgb = torch.where((depth < near)[..., None], 255,
                      torch.where((depth > far)[..., None], 0, rgb))
    return torch.cat([rgb, torch.zeros_like(rgb[..., :1])], -1)


#: ICP status colours, row = result + 6 (results -6..1)
_TRACK_COLORS = (
    (255, 128, 128),   # default / other
    (255, 255, 0),     # -5 bad normal
    (0, 0, 255),       # -4 too far
    (0, 255, 0),       # -3 no ref normal
    (255, 0, 0),       # -2 out of frame
    (0, 0, 0),         # -1 no input normal
    (255, 128, 128),   # 0 (unused)
    (128, 128, 128),   # 1 ok
)


def render_track(result: torch.Tensor) -> torch.Tensor:
    """renderTrackKernel (`rendering.cpp:154-212`): ICP status colors."""
    with Stats.host_read("track_colors"):
        table = torch.tensor(_TRACK_COLORS, dtype=torch.uint8,
                             device=result.device)
    rgb = table[(result + 6).clamp(0, 7).long()]
    return torch.cat([rgb, torch.zeros_like(rgb[..., :1])], -1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v / max(|v|, 1e-12)`` over the last axis, the sum of squares in
    order."""
    sq = v * v
    n = sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    return v / n.clamp(min=1e-12)[..., None]


def render_volume(m, field, view, H: int, W: int, light=LIGHT,
                  ambient=AMBIENT, vertex=None, normal=None,
                  near: float = NEAR_PLANE,
                  far: float = FAR_PLANE) -> torch.Tensor:
    """renderVolumeKernel (`rendering.cpp:214-283`): Lambertian shading of
    the raycast surface.  Pass ``vertex``/``normal`` to reuse the tracking
    raycast; otherwise it raycasts from ``view`` (= pose @ inv(K))."""
    if vertex is None or normal is None:
        rc = _raycast.raycast(m, field, view, H, W, near, far)
        vertex, normal = rc.vertex, rc.normal
    dev = vertex.device
    # host values copied to the device: each copy waits for its stream
    with Stats.host_read("light"):
        light = torch.tensor(light, dtype=torch.float32, device=dev)
    with Stats.host_read("ambient"):
        ambient = torch.tensor(ambient, dtype=torch.float32, device=dev)
    diff = _unit(vertex - light)
    n = _unit(normal)
    prod = n * diff
    lam = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]).clamp(min=0.0)
    col = (lam[..., None] + ambient).clamp(0.0, 1.0) * 255.0
    ok = (normal[..., 0] != INVALID)[..., None]
    rgb = torch.where(ok, col, 0.0).to(torch.uint8)
    return torch.cat([rgb, torch.zeros_like(rgb[..., :1])], -1)
