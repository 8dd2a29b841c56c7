"""The plain reference of OFusion's stages: the octant allocation march,
the log-odds fusion of the blocks and of the coarse node pyramid, and the
occupancy raycast with its normals, in plain float32 PyTorch on any
device.  Preprocessing, ICP and the renders are the SDF reference's
(:mod:`slambench.reference.slam`), and so are the raycast's windows,
secant re-solve and near-rescue switch, which read the OFusion field as a
:class:`slam.Surface` of negated log-odds: upstream's surface, the first
- -> + crossing of 0 log-odds (``bfusion/rendering_impl.hpp:35-68``), is
the + -> - crossing of its negation, the SDF's.

Like ``slam.py`` it imports nothing of the port or of the JAX package and
follows the semantics the port documents, written out again:

- Allocation (upstream's ``buildOctantList``, ``bfusion/alloc_impl.hpp:
  37-129``; the port's ``integration.ofusion_wanted_masks``): each
  (decimated) pixel marches from half a band (band = 6 mu) behind its
  surface point toward the camera, never past it: voxel steps through the
  band request blocks, 10-voxel steps to 1.5 bands travelled 16-voxel
  octants, 30-voxel steps on 32-voxel octants.  The two coarse zones take
  every second ray row and column from an offset that rotates with the
  allocation count where their octants' far-plane footprint is >= 4 px and
  the ray grid is not decimated already.  A request at level l below the
  blocks' marks the 2 x 2 x 2 child cells of ``node_alloc[l + 1]``.
- Fusion (upstream's ``bfusion_update``, ``bfusion/mapping_impl.hpp:
  94-191``), on every allocated active block's voxels as ``slam.fuse``
  samples them and on every allocated node cell at its corner: sigma =
  clamp(mu z^2, max 0.05) floored at max(2 voxels, ``ofusion_sigma_floor``),
  the bspline-CDF inverse sensor model (no update where it reads 0.5),
  samples clamped to [0.03, 0.97], the log2 odds added to the occupancy
  decayed by max(0.5, 1 / (1 + dt / 4)), clamped to +-1000, and the
  frame's time as the timestamp.
- Raycast: a valid sample has timestamp > 0 and occupancy > -100; where no
  block is allocated a cell reads its deepest allocated node's value.
  Normals ``"volume"`` (6 taps of the view, 0 where none is valid) or
  ``"exact"`` (upstream's ``volume.grad`` on the raw occupancy).

Departures from upstream, as the port has them: the timestamp is the
float32 product float32(1/30) x frame, where upstream keeps a double; the
sensor model's CDF is computed, where upstream reads it from a memoized
table; a voxel samples the nearest depth pixel on its block's patch grid,
where upstream interpolates the depth bilinearly; the coarse octants are a
dense pyramid of cells, where upstream keeps an octree; the raycast starts
from splatted bounds and reads a window, where upstream marches the ray.

The reader samples occupancy in float32, where the port's multiscale read
view is bfloat16: the check measures that difference.  ``prec="bf16"`` is
the control, as in ``slam.py``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from slambench.reference import slam
from slambench.reference.slam import BLOCK, FAR, i32, inv4, rounder, vnorm

#: upstream's constants (``volume_traits.hpp``, ``mapping_impl.hpp``)
CAPITAL_T, CLAMP, SIGMA_MAX = 4.0, 1000.0, 0.05
SAMPLE_LO, SAMPLE_HI = 0.03, 0.97
#: a sample is valid above this occupancy (and with a timestamp > 0)
FREE_LOCK = -100.0
#: the coarse zones' ray-grid offsets, rotated by the allocation count
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


class Map(NamedTuple):
    """An OFusion map as a frame starts or ends: the block table
    (``block_index`` int32 [B, B, B], ``n_blocks``, ``active`` bool [cap],
    ``occupancy`` / ``timestamp`` float32 [cap, 512]) and the node pyramid,
    one entry a level 0..block level: ``node_alloc`` bool [2^l]^3 and
    ``node_occ`` / ``node_ts`` float32 [2^l]^3."""
    size: int
    dim: float
    block_index: torch.Tensor
    n_blocks: int
    active: torch.Tensor
    occupancy: torch.Tensor
    timestamp: torch.Tensor
    node_alloc: List[torch.Tensor]
    node_occ: List[torch.Tensor]
    node_ts: List[torch.Tensor]

    @property
    def vs(self):
        return self.dim / self.size

    @property
    def levels(self) -> int:
        """The blocks' level, log2(size / 8)."""
        return len(self.node_alloc) - 1


def frame_time(frame: int) -> float:
    """The frame's timestamp: float32(1/30) x frame in float32."""
    return float(np.float32(1.0 / 30.0) * np.float32(frame))


# ---------------------------------------------------------------- fusion


def bspline_cdf(t):
    """The integral of the cubic bspline kernel over [-3, t]."""
    return torch.where(
        t <= -3.0, 0.0, torch.where(
            t <= -1.0, (3.0 + t) ** 3 / 48.0, torch.where(
                t <= 1.0, 0.5 + t * (3.0 + t) * (3.0 - t) / 24.0,
                torch.where(t <= 3.0, 1.0 - (3.0 - t) ** 3 / 48.0, 1.0))))


def update(occ, ts, pc, ds, valid, mu: float, sigma_lo: float, now: float,
           prec="f32"):
    """``bfusion_update`` on cells at camera positions ``pc`` [..., 3] with
    their depth samples ``ds``: (occupancy', timestamp')."""
    q = rounder(prec)
    z = pc[..., 2]
    zs = torch.where(z == 0, 1.0, z)
    scale = torch.sqrt(1.0 + (pc[..., 0] / zs) ** 2 + (pc[..., 1] / zs) ** 2)
    diff = (z - ds) * scale
    sigma = torch.clamp(torch.clamp(mu * z * z, max=SIGMA_MAX), min=sigma_lo)
    val = diff / sigma
    p = bspline_cdf(val) - 0.5 * bspline_cdf(val - 3.0)
    do = valid & (ds > 0) & (p != 0.5)
    p = torch.clamp(p, SAMPLE_LO, SAMPLE_HI)
    decay = torch.clamp(1.0 / (1.0 + (now - ts) / CAPITAL_T), min=0.5)
    new = q(torch.clamp(occ * decay + torch.log2(p / (1.0 - p)), -CLAMP,
                        CLAMP))
    return torch.where(do, new, occ), torch.where(do, now, ts)


def fuse(m: Map, depth, pose, K, mu: float, sigma_lo: float, now: float,
         prec="f32"):
    """The log-odds update of every allocated active block's voxels
    (``slam.voxel_samples``; ``active`` turns to whether any voxel was in
    frame and in the patch) and then of every allocated node cell whose
    corner projects into the frame, at the nearest depth pixel.  Returns
    (the map, the node cells updated)."""
    slots, pc, ds, valid = slam.voxel_samples(m, depth, pose, K, prec)
    occ, ts = update(m.occupancy[slots], m.timestamp[slots], pc, ds, valid,
                        mu, sigma_lo, now, prec)
    occupancy, timestamp = m.occupancy.clone(), m.timestamp.clone()
    active = m.active.clone()
    occupancy[slots], timestamp[slots] = occ, ts
    active[slots] = valid.any(1)
    H, W = depth.shape
    T_cw = inv4(pose)
    node_occ, node_ts = list(m.node_occ), list(m.node_ts)
    updated = 0
    for level in range(1, m.levels + 1):
        s = 1 << level
        g = torch.arange(s, dtype=torch.float32, device=depth.device)
        corner = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1) \
            * ((m.size // s) * m.vs)
        pc, px, py = slam.project(T_cw, K, corner)
        ok = (m.node_alloc[level] & (pc[..., 2] >= 1e-4) & (px >= 0.5)
              & (px <= W - 1.5) & (py >= 0.5) & (py <= H - 1.5))
        d = depth[i32(py).clamp(0, H - 1).long(),
                  i32(px).clamp(0, W - 1).long()]
        node_occ[level], node_ts[level] = update(
            m.node_occ[level], m.node_ts[level], pc, torch.where(ok, d, 0.0),
            ok, mu, sigma_lo, now, prec)
        updated += int(ok.sum())
    return m._replace(occupancy=occupancy, timestamp=timestamp, active=active,
                      node_occ=node_occ, node_ts=node_ts), updated


# ------------------------------------------------------------ allocation


def octant_level(step: float, size: int, vs: float) -> int:
    """upstream's ``step_to_depth``: the level whose octants an allocation
    step of ``step`` metres requests."""
    return int(math.floor(math.log2(vs / step))) + int(math.log2(size))


def wanted_masks(depth, pose, K, size: int, dim: float, band: float,
                 phase: int, prec="f32") -> List[torch.Tensor]:
    """bool [2^l]^3 a level 0..block level: the octants the march of every
    (decimated) pixel requests."""
    q = rounder(prec)
    H, W = depth.shape
    dev = depth.device
    dec = slam.alloc_decimation(size, dim, W)
    extra = 1 if dec > 1 else 0
    iy = torch.clamp(torch.arange((H + dec - 1) // dec + extra, device=dev)
                     * dec, max=H - 1)
    ix = torch.clamp(torch.arange((W + dec - 1) // dec + extra, device=dev)
                     * dec, max=W - 1)
    d = depth[iy][:, ix]
    x = (ix.float() + 0.5)[None, :]
    y = (iy.float() + 0.5)[:, None]
    hom = torch.stack([x * d, y * d, d, torch.ones_like(d)], -1)
    vertex = q(hom @ (pose @ inv4(K))[:3].T)
    to_cam = pose[:3, 3] - vertex
    dist = vnorm(to_cam)
    dirn = to_cam / torch.clamp(dist[..., None], min=1e-12)
    origin = vertex - (0.5 * band) * dirn
    vs, inv_vs = dim / size, size / dim
    depth_bits = int(math.log2(size))
    top = depth_bits - 3
    masks = [torch.zeros((1 << l,) * 3, dtype=torch.bool, device=dev)
             for l in range(top + 1)]

    def request(level: int, t, stride: int = 1):
        oy, ox = PHASES[phase % 4] if stride > 1 else (0, 0)
        o, r = origin[oy::stride, ox::stride], dirn[oy::stride, ox::stride]
        pts = q(o[..., None, :] + r[..., None, :] * t[:, None])
        vox = i32(torch.floor(pts * inv_vs))
        ok = ((d[oy::stride, ox::stride] > 0)[..., None]
              & (vox >= 0).all(-1) & (vox < size).all(-1)
              & (t < dist[oy::stride, ox::stride, None]))
        n = 1 << level
        oc = (vox[ok] >> (depth_bits - level)).long()
        masks[level].view(-1)[(oc[:, 0] * n + oc[:, 1]) * n + oc[:, 2]] = True

    def stride_of(level: int) -> int:
        edge = (1 << (depth_bits - level)) * vs
        return 2 if dec == 1 and edge * (W / 3.0) / FAR >= 4.0 else 1

    f32 = dict(dtype=torch.float32, device=dev)
    n1 = max(int(math.ceil(band * inv_vs)), 1)
    request(top, (band / n1) * torch.arange(n1, **f32))
    mid, far = float(np.float32(10.0 * vs)), float(np.float32(30.0 * vs))
    l_mid = max(octant_level(mid, size, vs), 0)
    l_far = max(octant_level(far, size, vs), 0)
    n2 = max(int(math.ceil(0.5 * band / mid)), 1)
    t2 = band + mid * torch.arange(n2, **f32)
    request(l_mid, t2[t2 < 1.5 * band], stride_of(l_mid))
    t3 = band + n2 * mid
    n3 = max(int(math.ceil((1.42 * FAR + band - t3) / far)), 1)
    request(l_far, t3 + far * torch.arange(n3, **f32), stride_of(l_far))
    return masks


def allocate(m: Map, masks) -> Map:
    """New slots for the requested blocks (``slam.allocate``) and the
    requested coarse octants' child cells marked in the node pyramid."""
    m = slam.allocate(m, masks[m.levels])
    node_alloc = list(m.node_alloc)
    for level in range(m.levels):
        up = masks[level].repeat_interleave(2, 0).repeat_interleave(2, 1) \
            .repeat_interleave(2, 2)
        node_alloc[level + 1] = node_alloc[level + 1] | up
    return m._replace(node_alloc=node_alloc)


# --------------------------------------------------------------- raycast


def _valid(occ, ts):
    return (occ > FREE_LOCK) & (ts > 0)


def node_fill(m: Map):
    """(occupancy, timestamp) [B^3] of each block-grid cell's deepest
    allocated node, (0, 0) where none is."""
    B = m.size // BLOCK
    occ = torch.zeros((B, B, B), device=m.occupancy.device)
    ts = torch.zeros_like(occ)
    b = torch.arange(B, device=occ.device)
    for level in range(1, m.levels + 1):
        a = b >> (m.levels - level)
        cell = (a[:, None, None], a[None, :, None], a[None, None, :])
        alloc = m.node_alloc[level][cell]
        occ = torch.where(alloc, m.node_occ[level][cell], occ)
        ts = torch.where(alloc, m.node_ts[level][cell], ts)
    return occ.reshape(-1), ts.reshape(-1)


def surface(m: Map) -> slam.Surface:
    """The negated log-odds as the raycast reads them, in float32: a live
    block's valid voxels, elsewhere its cell's node value where valid; NaN
    where no valid sample is."""
    B = m.size // BLOCK
    occ, ts = node_fill(m)
    view = torch.where(_valid(occ, ts), -occ, float("nan"))[:, None] \
        .expand(B ** 3, BLOCK ** 3).clone()
    slots, bc = slam.live_coords(m)
    rows = (bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]
    view[rows] = torch.where(_valid(m.occupancy[slots], m.timestamp[slots]),
                             -m.occupancy[slots], float("nan"))
    return slam.Surface(view, -m.occupancy, 0.0)


def raycast(m: Map, pose, k, H: int, W: int, span_factor=1.6,
            scan_stride=0.5, w2_budget=8192, prec="f32",
            near_rescue: bool = True, normals: str = "volume"):
    """``slam.raycast`` of the occupancy surface; its band is 2 voxels."""
    return slam.raycast(m, pose, k, H, W, 2.0 * m.vs, span_factor,
                        scan_stride, w2_budget, prec, near_rescue, normals,
                        surface(m))
