"""Projective fusion over compacted block rows: the hand-written CUDA
kernels (`csrc/integrate.cu`) and their plain PyTorch twins, for the SDF
(:func:`fuse_sdf`) and the OFusion field (:func:`fuse_ofusion`).

Counterparts of `supereight_tpu/ops/integrate_kernel.py` (the Pallas TPU
kernel K1, SDF only) and of the body of `supereight_tpu/pipeline/
integration.py:fuse_rows`, which computes both.  A wrapper launches its
kernel for CUDA tensors and takes its twin only for CPU tensors; there is no
fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from supereight_tpu_torch.core.numerics import matvec, trunc_i32
from supereight_tpu_torch.core.octree import BLOCK_SIDE, BLOCK_VOXELS
from supereight_tpu_torch.fields.ofusion import OFusionField
from supereight_tpu_torch.fields.sdf import SDFField

PATCH = 16          # depth patch side per block, in strided pixels
N_STRIDES = 4       # patch strides 1, 2, 4, 8

#: kernel launches so far, one counter per kernel (the chip smoke test reads
#: them to show that the main path went through the kernels)
LAUNCHES = {"fuse_sdf": 0, "fuse_ofusion": 0}


def _local_offsets(device) -> torch.Tensor:
    """[512, 3] float voxel offsets inside a brick, x fastest."""
    i = torch.arange(BLOCK_VOXELS, device=device)
    return torch.stack([i % BLOCK_SIDE, (i // BLOCK_SIDE) % BLOCK_SIDE,
                        i // (BLOCK_SIDE * BLOCK_SIDE)], -1).to(torch.float32)


def project(T_cw, K, pos_world):
    """World points [..., 3] -> (camera coordinates [..., 3], pixel x, pixel
    y), the pixel +0.5 so that the int cast rounds.  Both products are
    multiply-add chains (``matvec``), as XLA's CPU dot computes the JAX
    einsums and as the kernel's ``fmaf`` chains do."""
    pos_cam = matvec(T_cw[:3, :3], pos_world) + T_cw[:3, 3]
    hom = matvec(K[:2, :3], pos_cam)
    z = pos_cam[..., 2]
    zsafe = torch.where(z == 0, 1.0, z)
    return pos_cam, hom[..., 0] / zsafe + 0.5, hom[..., 1] / zsafe + 0.5


def _sample_rows(bc, live, depth, T_cw, K, voxel_size: float, patch: int):
    """``fuse_rows``' projection and depth sampling, with the sample read
    directly at ``depth[(iy>>lvl)<<lvl, (ix>>lvl)<<lvl]`` (the pixel the
    strided atlas patch resolves to).  Returns (camera positions [n,512,3],
    depth samples [n,512] (0 where not fused), fuse mask [n,512], visible
    [n])."""
    H, W = depth.shape
    base = (bc * BLOCK_SIDE).to(torch.float32)
    pos = (base[:, None, :] + _local_offsets(bc.device)) * voxel_size
    pos_cam, px, py = project(T_cw, K, pos)
    valid = ((pos_cam[..., 2] >= 1e-4) & (px >= 0.5) & (px <= W - 1.5)
             & (py >= 0.5) & (py <= H - 1.5))

    ccam, cpx, cpy = project(T_cw, K, (base + 0.5 * BLOCK_SIDE) * voxel_size)
    diag = 1.7320508 * BLOCK_SIDE * voxel_size
    ratio = torch.abs(K[0, 0]) * diag / torch.clamp(ccam[..., 2], min=1e-3) \
        / patch
    # clip(ceil(log2(max(ratio, 1))), 0, N_STRIDES - 1) without a log
    lvl = sum((ratio > float(1 << s)).to(torch.int32)
              for s in range(N_STRIDES - 1))
    stride = (1 << lvl).to(torch.float32)
    # jnp.clip semantics: the upper bound wins when it is below the lower
    p0r = torch.minimum(torch.clamp(trunc_i32(cpy / stride) - patch // 2,
                                    min=0), (H >> lvl) - patch)
    p0c = torch.minimum(torch.clamp(trunc_i32(cpx / stride) - patch // 2,
                                    min=0), (W >> lvl) - patch)

    lv = lvl[:, None]
    iy = trunc_i32(py) >> lv
    ix = trunc_i32(px) >> lv
    lr = iy - p0r[:, None]
    lc = ix - p0c[:, None]
    valid = valid & (lr >= 0) & (lr < patch) & (lc >= 0) & (lc < patch)
    do = valid & live[:, None]
    ds = depth[(iy << lv).clamp(0, H - 1), (ix << lv).clamp(0, W - 1)]
    return pos_cam, torch.where(do, ds, 0.0), do, valid.any(1)


def fuse_sdf_reference(bc, live, tsdf, weight, depth, T_cw, K, mu: float,
                       max_weight: float, voxel_size: float,
                       patch: int = PATCH):
    """Plain PyTorch version of the SDF kernel: ``fuse_rows``' function
    with :class:`SDFField`.

    ``bc`` int32[n,3] block coords, ``live`` bool[n], ``tsdf``/``weight``
    f32[n,512], ``depth`` f32[H,W], ``T_cw``/``K`` f32[4,4].  Returns
    (tsdf', weight', visible bool[n]); rows that are not live come back
    unchanged, ``visible`` is any voxel in frame and in its block's patch.
    """
    pos_cam, ds, do, visible = _sample_rows(bc, live, depth, T_cw, K,
                                            voxel_size, patch)
    field = SDFField(mu=mu, max_weight=max_weight)
    new = field.update({"tsdf": tsdf, "weight": weight}, pos_cam, ds, do)
    return new["tsdf"], new["weight"], visible


def fuse_sdf(bc, live, tsdf, weight, depth, T_cw, K, mu: float,
             max_weight: float, voxel_size: float, patch: int = PATCH):
    """SDF fusion of block rows (see :func:`fuse_sdf_reference` for the
    arguments).  CPU tensors go through the plain twin; CUDA tensors
    launch the kernel, which raises if it cannot."""
    if tsdf.device.type == "cpu":
        return fuse_sdf_reference(bc, live, tsdf, weight, depth, T_cw, K,
                                  mu, max_weight, voxel_size, patch)
    return _launch("fuse_sdf", bc, live, tsdf, weight, depth, T_cw, K,
                   (mu, max_weight), voxel_size, patch)


def fuse_ofusion_reference(bc, live, occupancy, timestamp, depth, T_cw, K,
                           mu: float, sigma_lo: float, now: float,
                           voxel_size: float, patch: int = PATCH):
    """Plain PyTorch version of the OFusion kernel: ``fuse_rows``' function
    with :class:`OFusionField` (``sigma_lo`` its sensor-model sigma's lower
    bound, ``now`` the frame's float32 timestamp).  Arguments and results as
    :func:`fuse_sdf_reference`, with the channels occupancy and
    timestamp."""
    pos_cam, ds, do, visible = _sample_rows(bc, live, depth, T_cw, K,
                                            voxel_size, patch)
    # with voxel_size 0 the field's sigma lower bound is sigma_floor
    field = OFusionField(mu=mu, voxel_size=0.0, sigma_floor=sigma_lo)
    new = field.update({"occupancy": occupancy, "timestamp": timestamp},
                       pos_cam, ds, do, now)
    return new["occupancy"], new["timestamp"], visible


def fuse_ofusion(bc, live, occupancy, timestamp, depth, T_cw, K, mu: float,
                 sigma_lo: float, now: float, voxel_size: float,
                 patch: int = PATCH):
    """OFusion fusion of block rows (see :func:`fuse_ofusion_reference`).
    CPU tensors go through the plain twin; CUDA tensors launch the kernel,
    which raises if it cannot."""
    if occupancy.device.type == "cpu":
        return fuse_ofusion_reference(bc, live, occupancy, timestamp, depth,
                                      T_cw, K, mu, sigma_lo, now, voxel_size,
                                      patch)
    return _launch("fuse_ofusion", bc, live, occupancy, timestamp, depth,
                   T_cw, K, (mu, sigma_lo, now), voxel_size, patch)


def _launch(fn: str, bc, live, a, b, depth, T_cw, K, params, voxel_size,
            patch):
    """Check the operands, launch kernel ``fn`` of `csrc/integrate.cu` on
    two channels ``a``/``b`` with the field's float ``params``, and return
    (a', b', visible)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    n = bc.shape[0]
    H, W = depth.shape
    for name, t, dt, shape in (("bc", bc, torch.int32, (n, 3)),
                               ("live", live, torch.bool, (n,)),
                               ("channel 0", a, torch.float32,
                                (n, BLOCK_VOXELS)),
                               ("channel 1", b, torch.float32,
                                (n, BLOCK_VOXELS)),
                               ("depth", depth, torch.float32, (H, W)),
                               ("T_cw", T_cw, torch.float32, (4, 4)),
                               ("K", K, torch.float32, (4, 4))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    a_out = torch.empty_like(a)
    b_out = torch.empty_like(b)
    visible = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return a_out, b_out, visible

    from . import _build
    c_fn = getattr(_build.load("integrate"), fn)
    P = ctypes.c_void_p
    c_fn.argtypes = [P] * 10 + [ctypes.c_int] * 3 \
        + [ctypes.c_float] * (len(params) + 2) + [ctypes.c_int, P]
    c_fn.restype = ctypes.c_int
    diag = 1.7320508 * BLOCK_SIDE * voxel_size
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = c_fn(bc.data_ptr(), live.data_ptr(), a.data_ptr(), b.data_ptr(),
                   depth.data_ptr(), T_cw.data_ptr(), K.data_ptr(),
                   a_out.data_ptr(), b_out.data_ptr(), visible.data_ptr(), n,
                   H, W, *params, voxel_size, diag, patch, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1
    return a_out, b_out, visible
