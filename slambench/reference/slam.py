"""The plain reference of one SLAM frame: preprocessing, ICP tracking, SDF
block allocation and fusion, the raycast and the three renders, in plain
PyTorch on any device.  The raycast reads any field given as a
:class:`Surface` (OFusion's, ``ofusion.py``).

It imports nothing of the port (``supereight_tpu_torch``) or of the JAX
package, and takes nothing the port derived: it reads the port's map and
pose state only as the state a frame starts from.  It follows the semantics
the port documents (its pure-PyTorch twins are the CPU path the JAX package
checks), written out again with plain float32 operations (float64 for the
ICP sums and the 4x4 inverses) and none of the port's rounding emulation,
so the two agree to rounding and differ in a few discrete decisions.

``prec="bf16"`` is the control: every stage's inputs, outputs and working
points rounded to bfloat16, the precision below the float32 the
configuration states.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

BLOCK = 8
INVALID = -2.0
NEAR, FAR = 0.4, 4.0
E_DELTA, RADIUS, GAUSS_DELTA = 0.1, 2, 4.0
DIST_THRESHOLD, NORMAL_THRESHOLD, TRACK_THRESHOLD = 0.1, 0.8, 0.15
PATCH, N_STRIDES = 16, 4
LIGHT, AMBIENT = (1.0, 1.0, -1.0), (0.1, 0.1, 0.1)


def rounder(prec: str):
    """The identity for float32, a round trip through bfloat16 for the
    control."""
    if prec == "f32":
        return lambda t: t
    if prec == "bf16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision {prec!r}")


def i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, saturating, NaN -> 0."""
    return x.nan_to_num(0.0).clamp(-2147483648.0, 2147483520.0) \
        .to(torch.int32)


def inv4(M: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(M.double()).float()


def camera_matrix(k) -> torch.Tensor:
    K = torch.eye(4, dtype=torch.float32, device=k.device)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = k[0], k[2], k[1], k[3]
    return K


def inverse_camera_matrix(k) -> torch.Tensor:
    iK = torch.eye(4, dtype=torch.float32, device=k.device)
    iK[0, 0], iK[0, 2] = 1.0 / k[0], -k[2] / k[0]
    iK[1, 1], iK[1, 2] = 1.0 / k[1], -k[3] / k[1]
    return iK


def transform(T, p):
    return p @ T[:3, :3].T + T[:3, 3]


def vnorm(v, keepdim=False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


# ---------------------------------------------------------------- stage 1


def shifted(img, dy: int, dx: int):
    """``img`` at the clamped pixel (y + dy, x + dx)."""
    H, W = img.shape[:2]
    r = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    c = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[r][:, c]


def bilateral(depth):
    """5x5 bilateral filter over the neighbours with depth > 0 (spatial
    weights at x = i - 2 for i in 0..4, as upstream computes them)."""
    x = torch.arange(2 * RADIUS + 1, dtype=torch.float32,
                     device=depth.device) - 2.0
    g = torch.exp(-(x * x) / (2.0 * GAUSS_DELTA * GAUSS_DELTA))
    t = torch.zeros_like(depth)
    s = torch.zeros_like(depth)
    for i in range(-RADIUS, RADIUS + 1):
        for j in range(-RADIUS, RADIUS + 1):
            cur = shifted(depth, j, i)
            diff = cur - depth
            w = g[i + RADIUS] * g[j + RADIUS] * torch.exp(
                -(diff * diff) / (2.0 * E_DELTA * E_DELTA))
            ok = cur > 0
            t = t + torch.where(ok, w * cur, 0.0)
            s = s + torch.where(ok, w, 0.0)
    return torch.where(depth == 0, 0.0, t / torch.clamp(s, min=1e-20))


def preprocess(depth_mm: torch.Tensor, bilateral_filter: bool, prec="f32"):
    """Integer millimetres -> (metric depth, the tracking pyramid's depth)."""
    q = rounder(prec)
    d = q(depth_mm.to(torch.float32) * 1e-3)
    return d, (q(bilateral(d)) if bilateral_filter else d)


def half_sample(depth):
    center = depth[::2, ::2]
    t = torch.zeros_like(center)
    s = torch.zeros_like(center)
    for i in (0, 1):
        for j in (0, 1):
            cur = shifted(depth, i, j)[::2, ::2]
            ok = torch.abs(cur - center) < 3 * E_DELTA
            t = t + torch.where(ok, cur, 0.0)
            s = s + ok.to(depth.dtype)
    return t / torch.clamp(s, min=1e-20)


def depth_to_vertex(depth, k):
    H, W = depth.shape
    x = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    v = torch.stack([depth * (x - k[2]) / k[0], depth * (y - k[3]) / k[1],
                     depth], -1)
    return torch.where(depth[..., None] > 0, v, 0.0)


def vertex_to_normal(v):
    left, right = shifted(v, 0, -1), shifted(v, 0, 1)
    up, down = shifted(v, 1, 0), shifted(v, -1, 0)
    n = torch.linalg.cross(right - left, up - down)
    n = n / torch.clamp(vnorm(n, True), min=1e-20)
    ok = ((v[..., 2] != 0) & (left[..., 2] != 0) & (right[..., 2] != 0)
          & (up[..., 2] != 0) & (down[..., 2] != 0))
    bad = torch.zeros_like(n)
    bad[..., 0] = INVALID
    return torch.where(ok[..., None], n, bad)


def pyramid(depth, k, levels: int, prec="f32"):
    q = rounder(prec)
    depths = [depth]
    for _ in range(1, levels):
        depths.append(q(half_sample(depths[-1])))
    verts = [q(depth_to_vertex(d, k / (1 << i))) for i, d in
             enumerate(depths)]
    return depths, verts, [q(vertex_to_normal(v)) for v in verts]


# ---------------------------------------------------------------- stage 2


def se3_exp(x: torch.Tensor) -> torch.Tensor:
    """float64 SE(3) exponential of (v, w)."""
    v, w = x[:3], x[3:]
    th = float(torch.linalg.norm(w))
    Wm = torch.zeros((3, 3), dtype=torch.float64, device=x.device)
    Wm[0, 1], Wm[0, 2], Wm[1, 2] = -w[2], w[1], -w[0]
    Wm[1, 0], Wm[2, 0], Wm[2, 1] = w[2], -w[1], w[0]
    if th < 1e-6:
        a, b, c = 1.0 - th * th / 6, 0.5 - th * th / 24, 1 / 6 - th * th / 120
    else:
        a = math.sin(th) / th
        b = (1 - math.cos(th)) / th ** 2
        c = (th - math.sin(th)) / th ** 3
    I = torch.eye(3, dtype=torch.float64, device=x.device)
    W2 = Wm @ Wm
    T = torch.eye(4, dtype=torch.float64, device=x.device)
    T[:3, :3] = I + a * Wm + b * W2
    T[:3, 3] = (I + b * Wm + c * W2) @ v
    return T


class Track(NamedTuple):
    pose: torch.Tensor      # float32 [4, 4]
    tracked: bool
    status: torch.Tensor    # int32 [H, W], the last trip at the finest level


def track_pixels(iv, inn, ref_v, ref_n, pose, view):
    """Status codes, residuals and Jacobians of one trip's association."""
    rH, rW = ref_v.shape[:2]
    pv = transform(pose, iv)
    pp = transform(view, pv)
    z = pp[..., 2]
    zs = torch.where(z == 0, 1.0, z)
    px = pp[..., 0] / zs + 0.5
    py = pp[..., 1] / zs + 0.5
    in_frame = (px >= 0) & (px <= rW - 1) & (py >= 0) & (py <= rH - 1)
    ix = i32(px).clamp(0, rW - 1).long()
    iy = i32(py).clamp(0, rH - 1).long()
    rv, rn = ref_v[iy, ix], ref_n[iy, ix]
    pn = inn @ pose[:3, :3].T
    diff = rv - pv
    status = torch.ones(iv.shape[:-1], dtype=torch.int32, device=iv.device)
    status = torch.where((pn * rn).sum(-1) < NORMAL_THRESHOLD, -5, status)
    status = torch.where(vnorm(diff) > DIST_THRESHOLD, -4, status)
    status = torch.where(rn[..., 0] == INVALID, -3, status)
    status = torch.where(~in_frame, -2, status)
    status = torch.where(inn[..., 0] == INVALID, -1, status)
    ok = status == 1
    e = torch.where(ok, (rn * diff).sum(-1), 0.0)
    J = torch.where(ok[..., None], torch.cat(
        [rn, torch.linalg.cross(pv, rn)], -1), 0.0)
    return status, e, J


def icp(pose, verts, norms, ref_v, ref_n, raycast_pose, k,
        iterations: Sequence[int], threshold: float, prec="f32") -> Track:
    """Coarse-to-fine point-to-plane ICP (levels coarsest first, each until
    ||twist|| < threshold or its iteration count), then the divergence
    gate on the finest level's last trip."""
    q = rounder(prec)
    view = camera_matrix(k) @ inv4(raycast_pose)
    ref_v, ref_n = q(ref_v), q(ref_n)
    cur = pose.clone()
    status = None
    for level in range(len(iterations) - 1, -1, -1):
        iv, inn = verts[level], norms[level]
        for _ in range(iterations[level]):
            status, e, J = track_pixels(iv, inn, ref_v, ref_n, cur, view)
            Jd, ed = J.reshape(-1, 6).double(), e.reshape(-1).double()
            error2 = (ed * ed).sum()
            count = float((status == 1).sum())
            JTe, JTJ = Jd.T @ ed, Jd.T @ Jd
            if prec != "f32":
                JTe, JTJ = q(JTe.float()).double(), q(JTJ.float()).double()
            L, info = torch.linalg.cholesky_ex(JTJ)
            x = torch.cholesky_solve(JTe[:, None], L)[:, 0]
            if int(info) != 0 or not bool(torch.isfinite(x).all()):
                x = torch.zeros_like(x)
            cur = q((se3_exp(x) @ cur.double()).float())
            if float(torch.linalg.norm(x)) < threshold:
                break
    rmse = math.sqrt(float(error2) / max(count, 1.0))
    ok = rmse <= 2e-2 and count / status.numel() >= TRACK_THRESHOLD
    return Track(cur if ok else pose.clone(), ok, status)


# ---------------------------------------------------------------- stage 3


class Map(NamedTuple):
    """A map's block table as a frame starts or ends: ``block_index``
    int32 [B, B, B] (slot or -1), ``n_blocks``, ``active`` bool [cap],
    ``tsdf`` / ``weight`` float32 [cap, 512]."""
    size: int
    dim: float
    block_index: torch.Tensor
    n_blocks: int
    active: torch.Tensor
    tsdf: torch.Tensor
    weight: torch.Tensor

    @property
    def vs(self):
        return self.dim / self.size


def alloc_decimation(size: int, dim: float, W: int) -> int:
    foot_far = BLOCK * (dim / size) * (W / 3.0) / FAR
    return 2 if foot_far >= 4.0 else 1


def wanted_blocks(depth, pose, K, size: int, dim: float, band: float,
                  prec="f32"):
    """bool [B, B, B]: the blocks the band march of every (decimated)
    pixel's surface point requests."""
    q = rounder(prec)
    H, W = depth.shape
    dec = alloc_decimation(size, dim, W)
    extra = 1 if dec > 1 else 0
    dev = depth.device
    iy = torch.clamp(torch.arange((H + dec - 1) // dec + extra, device=dev)
                     * dec, max=H - 1)
    ix = torch.clamp(torch.arange((W + dec - 1) // dec + extra, device=dev)
                     * dec, max=W - 1)
    d = depth[iy][:, ix]
    x = (ix.float() + 0.5)[None, :]
    y = (iy.float() + 0.5)[:, None]
    kp = pose @ inv4(K)
    hom = torch.stack([x * d, y * d, d, torch.ones_like(d)], -1)
    vertex = q(hom @ kp[:3].T)
    to_cam = pose[:3, 3] - vertex
    dirn = to_cam / torch.clamp(vnorm(to_cam, True), min=1e-12)
    inv_vs = size / dim
    n = max(int(math.ceil(band * inv_vs)), 1)
    t = -0.5 * band + (band / n) * torch.arange(n, dtype=torch.float32,
                                                device=dev)
    pts = q(vertex[..., None, :] + dirn[..., None, :] * t[:, None])
    bc = i32(torch.floor(pts.reshape(-1, 3) * inv_vs)) >> 3
    B = size // BLOCK
    ok = ((d > 0)[..., None].expand(d.shape + (n,)).reshape(-1)
          & (bc >= 0).all(1) & (bc < B).all(1))
    lin = ((bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]).long()[ok]
    wanted = torch.zeros(B * B * B, dtype=torch.bool, device=dev)
    wanted[lin] = True
    return wanted.reshape(B, B, B)


def allocate(m: Map, wanted) -> Map:
    """New slots for the wanted unallocated blocks in flat block order, as
    far as the capacity reaches; every wanted allocated block turns active."""
    cap = m.active.shape[0]
    bi = m.block_index.reshape(-1).clone()
    new = torch.nonzero((wanted.reshape(-1)) & (bi < 0))[:, 0]
    new = new[:max(cap - m.n_blocks, 0)]
    bi[new] = torch.arange(m.n_blocks, m.n_blocks + len(new), device=bi.device,
                           dtype=bi.dtype)
    active = m.active.clone()
    touched = wanted.reshape(-1) & (bi >= 0)
    active[bi[touched].long()] = True
    return m._replace(block_index=bi.reshape(m.block_index.shape),
                      n_blocks=m.n_blocks + len(new), active=active)


def live_coords(m: Map):
    """(slots, block coordinates int64 [n, 3]) of the allocated blocks."""
    B = m.size // BLOCK
    lin = torch.nonzero(m.block_index.reshape(-1) >= 0)[:, 0]
    slots = m.block_index.reshape(-1)[lin].long()
    bc = torch.stack([lin // (B * B), (lin // B) % B, lin % B], -1)
    return slots, bc


def project(T_cw, K, p):
    pc = transform(T_cw, p)
    hom = pc @ K[:2, :3].T
    z = pc[..., 2]
    zs = torch.where(z == 0, 1.0, z)
    return pc, hom[..., 0] / zs + 0.5, hom[..., 1] / zs + 0.5


def voxel_samples(m, depth, pose, K, prec="f32"):
    """The projection of every allocated active block's voxels: each voxel
    (at its corner) samples the depth at its pixel on the block's patch
    grid (the block's footprint sets a stride of 1, 2, 4 or 8 px and a
    16 x 16 patch round its centre).  Returns (slots, camera positions
    [n, 512, 3], depth samples [n, 512], in frame and in the patch
    [n, 512])."""
    q = rounder(prec)
    H, W = depth.shape
    dev = depth.device
    slots, bc = live_coords(m)
    sel = m.active[slots]
    slots, bc = slots[sel], bc[sel]
    T_cw = inv4(pose)
    vs = m.vs
    i = torch.arange(BLOCK ** 3, device=dev)
    off = torch.stack([i % 8, (i // 8) % 8, i // 64], -1).float()
    base = (bc * BLOCK).float()
    pos = q((base[:, None, :] + off) * vs)
    pc, px, py = project(T_cw, K, pos)
    valid = ((pc[..., 2] >= 1e-4) & (px >= 0.5) & (px <= W - 1.5)
             & (py >= 0.5) & (py <= H - 1.5))
    cc, cpx, cpy = project(T_cw, K, (base + 0.5 * BLOCK) * vs)
    diag = 1.7320508 * BLOCK * vs
    ratio = torch.abs(K[0, 0]) * diag / torch.clamp(cc[..., 2], min=1e-3) \
        / PATCH
    lvl = sum((ratio > float(1 << s)).to(torch.int32)
              for s in range(N_STRIDES - 1))
    stride = (1 << lvl).float()
    p0r = torch.minimum(torch.clamp(i32(cpy / stride) - PATCH // 2, min=0),
                        (H >> lvl) - PATCH)
    p0c = torch.minimum(torch.clamp(i32(cpx / stride) - PATCH // 2, min=0),
                        (W >> lvl) - PATCH)
    lv = lvl[:, None]
    iy, ix = i32(py) >> lv, i32(px) >> lv
    lr, lc = iy - p0r[:, None], ix - p0c[:, None]
    valid = valid & (lr >= 0) & (lr < PATCH) & (lc >= 0) & (lc < PATCH)
    ds = depth[(iy << lv).clamp(0, H - 1).long(),
               (ix << lv).clamp(0, W - 1).long()]
    return slots, pc, torch.where(valid, ds, 0.0), valid


def fuse(m: Map, depth, pose, K, mu: float, max_weight: float,
         prec="f32") -> Map:
    """The projective TSDF update of every allocated active block
    (:func:`voxel_samples`); the fused blocks' ``active`` turns to whether
    any voxel was in frame and in the patch."""
    q = rounder(prec)
    slots, pc, ds, valid = voxel_samples(m, depth, pose, K, prec)
    z = pc[..., 2]
    zs = torch.where(z == 0, 1.0, z)
    scale = torch.sqrt(1.0 + (pc[..., 0] / zs) ** 2 + (pc[..., 1] / zs) ** 2)
    diff = (ds - z) * scale
    do = valid & (ds > 0) & (diff > -mu)
    sdf = torch.clamp(diff / mu, max=1.0)
    w, f = m.weight[slots], m.tsdf[slots]
    new_f = q(torch.clamp((w * f + sdf) / (w + 1.0), -1.0, 1.0))
    new_w = torch.clamp(w + 1.0, max=max_weight)
    tsdf, weight, active = m.tsdf.clone(), m.weight.clone(), m.active.clone()
    tsdf[slots] = torch.where(do, new_f, f)
    weight[slots] = torch.where(do, new_w, w)
    active[slots] = valid.any(1)
    return m._replace(tsdf=tsdf, weight=weight, active=active)


# ---------------------------------------------------------------- stage 4


class Surface(NamedTuple):
    """What the raycast reads of a field, signed so that the inside is
    below 0 (the tsdf; OFusion's negated log-odds): ``view`` [B^3, 512],
    one row a block-grid cell, NaN where a sample is not valid; ``table``
    [cap, 512], the raw slots (the inside flags of the splat, the exact
    normals); ``empty``, the value of a normal's tap where the view has no
    valid sample and the table's outside the allocated blocks."""
    view: torch.Tensor
    table: torch.Tensor
    empty: float


def read_view(m: Map):
    """The map as the raycast reads it, one row a block-grid cell: the
    tsdf in bfloat16 where observed (NaN where allocated and never fused),
    the empty value 1 where no block is allocated."""
    B = m.size // BLOCK
    v = torch.full((B ** 3, BLOCK ** 3), 1.0, device=m.tsdf.device)
    slots, bc = live_coords(m)
    rows = (bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]
    v[rows] = torch.where(m.weight[slots] != 0, m.tsdf[slots], float("nan"))
    return v.to(torch.bfloat16)


def sample(view, pos_vox, size: int, fill: float):
    """The nearest voxel's value (``fill`` out of the volume)."""
    v = i32(torch.floor(pos_vox))
    inb = ((v >= 0) & (v < size)).all(-1)
    vc = v.clamp(0, size - 1)
    B = size // BLOCK
    b, l = vc >> 3, vc & 7
    row = ((b[..., 0] * B + b[..., 1]) * B + b[..., 2]).long()
    col = (l[..., 0] + l[..., 1] * 8 + l[..., 2] * 64).long()
    return torch.where(inb, view[row, col].float(), fill)


def min_filter(x, k):
    return -F.max_pool2d(-x[None, None], k, stride=1, padding=k // 2)[0, 0]


def splat_bounds(m: Map, view_m, H: int, W: int, table,
                 near_rescue: bool):
    """Start and far depth of each 8 x 8 px cell from the blocks holding an
    inside voxel (below 0 in ``table``), widened by a 3 x 3 cell
    neighbourhood; with ``near_rescue``, near-field cells with no splat
    take a 25 x 25 neighbourhood's start."""
    g = next(c for c in (8, 4, 2, 1) if H % c == 0 and W % c == 0)
    gh, gw = H // g, W // g
    dev = view_m.device
    vs = m.vs
    slots, bc = live_coords(m)
    inside = (table[slots] < 0).any(1)
    hom = transform(inv4(view_m), (bc.float() + 0.5) * (BLOCK * vs))
    z = hom[:, 2]
    zs = torch.where(z == 0, 1.0, z)
    px, py = hom[:, 0] / zs, hom[:, 1] / zs
    diag = 1.7320508 * BLOCK * vs
    marg = 2.0 * g
    ok = (inside & (z > 1e-3) & (px >= -marg) & (px <= W - 1 + marg)
          & (py >= -marg) & (py <= H - 1 + marg))
    z_lo = torch.clamp(z - 0.5 * diag, min=NEAR)
    z_hi = z + 0.5 * diag
    fx = 1.0 / torch.clamp(vnorm(view_m[:3, 0]), min=1e-9)
    foot = 0.5 * diag * fx / torch.clamp(z, min=1e-3) / g
    tmin = torch.full((gh * gw + 1,), float("inf"), device=dev)
    tmax = torch.full((gh * gw + 1,), float("-inf"), device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            okc = ok & (foot >= math.hypot(dx, dy) - 0.71)
            cx = i32(px / g + dx).clamp(0, gw - 1)
            cy = i32(py / g + dy).clamp(0, gh - 1)
            tgt = torch.where(okc, cy * gw + cx, gh * gw).long()
            tmin = tmin.scatter_reduce(0, tgt, z_lo, "amin")
            tmax = tmax.scatter_reduce(0, tgt, z_hi, "amax")
    tmin = min_filter(tmin[:-1].reshape(gh, gw), 3)
    tmax = F.max_pool2d(tmax[:-1].reshape(1, 1, gh, gw), 3, 1, 1)[0, 0]
    if not near_rescue:
        return tmin, tmax, g
    twide = min_filter(tmin, 25)
    fb = ~torch.isfinite(tmin) & (twide < 0.5 * diag * fx / (2.4 * g))
    return (torch.where(fb, twide, tmin), torch.where(fb, twide + diag, tmax),
            g)


def window_scan(view, size, inv_vs, origin, dirs, z0, span, n, active):
    """The first valid outside -> inside crossing over ``n + 1`` samples
    from ``z0``, solved linearly between its two valid samples."""
    dz = span / n
    k = torch.arange(n + 1, dtype=torch.float32, device=dirs.device)
    shape = (n + 1,) + (1,) * (dirs.dim() - 1)
    z = z0[None] + dz * k.reshape(shape)
    f = sample(view, (origin + dirs[None] * z[..., None]) * inv_vs, size,
               float("nan"))
    ok = ~torch.isnan(f)
    steps = torch.arange(n + 1, dtype=torch.int32,
                         device=dirs.device).reshape(shape)
    inside = f < 0
    enc = torch.where(ok, steps * 2 + (ok & ~inside).to(torch.int32), -1)
    last = torch.cummax(enc, 0).values
    prev = torch.cat([torch.full_like(last[:1], -1), last[:-1]])
    cross = ok & (prev >= 0) & inside & ((prev & 1) == 1) & active[None]
    hit = cross.any(0)
    j = cross.to(torch.uint8).argmax(0)[None].long()
    f_hi = f.gather(0, j)[0]
    j_lo = torch.clamp(prev >> 1, min=0).long().gather(0, j)
    z_lo = z0 + dz * j_lo[0].float()
    f_lo = torch.where(ok, f, 0.0).gather(0, j_lo)[0]
    z_hi = z.gather(0, j)[0]
    den = f_lo - f_hi
    den = torch.where(torch.abs(den) < 1e-12, -1e-12, den)
    return hit, torch.where(hit, z_hi + (z_hi - z_lo) * (f_hi / den), 0.0)


def blended_gradient(m: Map, surface: Surface, pos):
    """Upstream's ``volume.grad``: at each of the 8 voxels round ``pos``
    (voxel units) the central difference of ``surface.table`` along each
    axis (its taps clamped into the volume, ``surface.empty`` outside the
    allocated blocks), blended by the trilinear weights of ``pos``; half
    the difference, in table units a voxel."""
    size = m.size
    base = torch.floor(pos)
    frac = pos - base
    lower = i32(base).clamp(min=0)

    def value(v):
        v = v.clamp(0, size - 1)
        b, l = v >> 3, v & 7
        slot = m.block_index[b[..., 0].long(), b[..., 1].long(),
                             b[..., 2].long()]
        col = (l[..., 0] + l[..., 1] * 8 + l[..., 2] * 64).long()
        val = surface.table[slot.clamp(min=0).long(), col]
        return torch.where(slot >= 0, val, surface.empty)

    grad = torch.zeros_like(pos)
    unit = torch.eye(3, dtype=torch.int32, device=pos.device)
    for c in range(8):
        bits = [(c >> a) & 1 for a in range(3)]
        w = torch.ones_like(frac[..., 0])
        for a in range(3):
            w = w * (frac[..., a] if bits[a] else 1.0 - frac[..., a])
        corner = lower + torch.tensor(bits, dtype=torch.int32,
                                      device=pos.device)
        for a in range(3):
            d = value(corner + unit[a]) - value(corner - unit[a])
            grad[..., a] += w * d
    return 0.5 * grad


def up2(a):
    return a.repeat_interleave(2, 0).repeat_interleave(2, 1)


def raycast(m: Map, pose, k, H: int, W: int, mu: float,
            span_factor=1.6, scan_stride=0.5, w2_budget=8192, prec="f32",
            near_rescue: bool = True, normals: str = "volume",
            surface: Surface = None):
    """Vertex and normal maps of the surface seen from ``pose``: the
    cells' bounds, a half-resolution scan of one window from each cell's
    start (a second window deeper for the first ``w2_budget`` rays, in
    raster order, that found nothing and reach further), the full-
    resolution secant re-solve within +/- 0.7 mu (``mu``: the surface's
    band), and normals: ``"volume"`` from the 6-tap central difference at
    the vertex, ``"exact"`` the trilinearly blended gradient of the raw
    table (:func:`blended_gradient`).  ``surface``: the field as the
    raycast reads it, by default the tsdf's."""
    q = rounder(prec)
    view_m = pose @ inverse_camera_matrix(k)
    if surface is None:
        surface = Surface(read_view(m), m.tsdf, 1.0)
    view = surface.view
    size, inv_vs, vs = m.size, m.size / m.dim, m.vs
    diag = 1.7320508 * BLOCK * vs
    step = scan_stride * mu
    n = int(min(max(math.ceil((span_factor * diag + 2.0 * mu) / step) + 1,
                    8), 48))
    span = n * step
    tmin, tmax, g = splat_bounds(m, view_m, H, W, surface.table,
                                 near_rescue)
    x = torch.arange(W, dtype=torch.float32, device=pose.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=pose.device)[:, None]
    dirs = torch.stack([(view_m[r, 0] * x + view_m[r, 1] * y
                         + view_m[r, 2]).expand(H, W) for r in range(3)], -1)
    origin = view_m[:3, 3]
    half = H % 2 == 0 and W % 2 == 0 and W >= 160
    if not half:
        raise ValueError("the reference covers the half-resolution scan")
    fd = 0.25 * (((dirs[0::2, 0::2] + dirs[1::2, 0::2]) + dirs[0::2, 1::2])
                 + dirs[1::2, 1::2])
    rep = g // 2
    t0 = tmin.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    t1 = tmax.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    active = torch.isfinite(t0)
    z0 = torch.clamp(torch.where(active, t0, NEAR), NEAR, FAR)
    hit, z = window_scan(view, size, inv_vs, origin, fd, z0, span, n, active)
    need2 = active & ~hit & (z0 + span < t1 + diag)
    idx = torch.nonzero(need2.reshape(-1))[:, 0][:w2_budget]
    hit2, z2 = window_scan(view, size, inv_vs, origin, fd.reshape(-1, 3)[idx],
                           (z0 + span).reshape(-1)[idx], span, n,
                           torch.ones_like(idx, dtype=torch.bool))
    h2 = torch.zeros(hit.numel(), dtype=torch.bool, device=hit.device)
    h2[idx] = hit2
    zz2 = torch.zeros(hit.numel(), device=hit.device)
    zz2[idx] = z2
    z = torch.where(hit, z, zz2.reshape(hit.shape))
    hit = hit | h2.reshape(hit.shape)
    # full-resolution secant re-solve
    z, hit = up2(z), up2(hit)
    delta = 0.7 * mu
    f_lo = sample(view, (origin + dirs * (z - delta)[..., None]) * inv_vs,
                  size, float("nan"))
    f_hi = sample(view, (origin + dirs * (z + delta)[..., None]) * inv_vs,
                  size, float("nan"))
    pair = ~torch.isnan(f_lo) & ~torch.isnan(f_hi)
    cross = pair & (f_lo >= 0) & (f_hi < 0)
    den = f_lo - f_hi
    den = torch.where(torch.abs(den) < 1e-12, -1e-12, den)
    z = torch.where(cross, z + delta + 2.0 * delta * (f_hi / den), z)
    hit = hit & ~(pair & ~cross)
    vertex = q(origin + dirs * z[..., None])
    base = vertex * inv_vs
    if normals == "exact":
        grad = -blended_gradient(m, surface, base)
    else:
        e = surface.empty
        taps = []
        for a in range(3):
            o = torch.zeros(3, device=base.device)
            o[a] = 1.0
            taps.append([torch.nan_to_num(sample(view, base + s * o, size, e),
                                          nan=e) for s in (1.0, -1.0)])
        grad = -0.5 * torch.stack([p - mm for p, mm in taps], -1)
    gn = vnorm(grad, True)
    normal = q(grad / torch.clamp(gn, min=1e-12))
    bad = ~hit | (gn[..., 0] == 0)
    inval = torch.zeros_like(normal)
    inval[..., 0] = INVALID
    return (torch.where(hit[..., None], vertex, 0.0),
            torch.where(bad[..., None], inval, normal))


# ---------------------------------------------------------------- renders


def _gs2rgb(h):
    v, m, sv = 0.75, 0.25, 0.6667
    h6 = h * 6.0
    sx = h6.to(torch.int32).clamp(0, 5)
    fr = h6 - sx.float()
    vsf = (v * sv) * fr
    mid1, mid2 = m + vsf, v - vsf
    vv, mm = torch.full_like(h, v), torch.full_like(h, m)
    tables = (torch.stack([vv, mid2, mm, mm, mid1, vv], -1),
              torch.stack([mid1, vv, vv, mid2, mm, mm], -1),
              torch.stack([mm, mm, mid1, vv, vv, mid2], -1))
    idx = sx[..., None].long()
    return torch.cat([torch.gather(t, -1, idx) for t in tables], -1)


def _rgbw(rgb):
    return torch.cat([rgb, torch.zeros_like(rgb[..., :1])], -1)


def render_depth(depth):
    d = (depth - NEAR) / torch.full((), FAR - NEAR, device=depth.device)
    rgb = (_gs2rgb(d.clamp(0.0, 1.0)) * 255.0).to(torch.uint8)
    rgb = torch.where((depth < NEAR)[..., None], 255,
                      torch.where((depth > FAR)[..., None], 0, rgb))
    return _rgbw(rgb.to(torch.uint8))


_TRACK = ((255, 128, 128), (255, 255, 0), (0, 0, 255), (0, 255, 0),
          (255, 0, 0), (0, 0, 0), (255, 128, 128), (128, 128, 128))


def render_track(status):
    table = torch.tensor(_TRACK, dtype=torch.uint8, device=status.device)
    return _rgbw(table[(status + 6).clamp(0, 7).long()])


def render_volume(vertex, normal):
    dev = vertex.device
    light = torch.tensor(LIGHT, device=dev)
    ambient = torch.tensor(AMBIENT, device=dev)
    unit = lambda v: v / torch.clamp(vnorm(v, True), min=1e-12)
    p = unit(normal) * unit(vertex - light)
    lam = ((p[..., 0] + p[..., 1]) + p[..., 2]).clamp(min=0.0)
    col = (lam[..., None] + ambient).clamp(0.0, 1.0) * 255.0
    ok = (normal[..., 0] != INVALID)[..., None]
    return _rgbw(torch.where(ok, col, 0.0).to(torch.uint8))
