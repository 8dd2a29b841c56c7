"""Projective fusion in place on the block table: the hand-written CUDA
kernels (`csrc/integrate.cu`) and their plain PyTorch twins, for the SDF
(:func:`fuse_sdf`) and the OFusion field (:func:`fuse_ofusion`).

Counterparts of `supereight_tpu/ops/integrate_kernel.py` (the Pallas TPU
kernel K1, SDF only) and of the body of `supereight_tpu/pipeline/
integration.py:fuse_rows`, which computes both, with the row gather before
it and the scatter after it.  A call updates the map's two channel tables
and its ``active`` flags in place (and, for the SDF, the rows of a held read
view): on the budget branch the listed ``slots``, else every live slot.
That is the update JAX's ``.at[slots].set`` makes when XLA donates the
table.  A wrapper launches its kernel for CUDA tensors and takes its twin
only for CPU tensors; there is no fallback between the two.

``fuse_sdf_reference`` and ``fuse_ofusion_reference`` are the row function
the twins apply to the gathered rows (``fuse_rows``' function, held against
the JAX package by the CPU tests).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.core.numerics import matvec, trunc_i32
from supereight_tpu_torch.core.octree import (BLOCK_SIDE, BLOCK_VOXELS,
                                              VoxelMap)
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
    """The SDF row function: ``fuse_rows``' function with
    :class:`SDFField`, on gathered rows.

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


def fuse_ofusion_reference(bc, live, occupancy, timestamp, depth, T_cw, K,
                           mu: float, sigma_lo: float, now: float,
                           voxel_size: float, patch: int = PATCH):
    """The OFusion row function: ``fuse_rows``' function with
    :class:`OFusionField` (``sigma_lo`` its sensor-model sigma's lower
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


#: each field's two channels, in the kernels' order
SDF_CHANNELS = ("tsdf", "weight")
OFUSION_CHANNELS = ("occupancy", "timestamp")


def _twin(row_fn, names, m: VoxelMap, depth, T_cw, K, params,
          slots: Optional[torch.Tensor], patch: int):
    """The in-place contract in plain PyTorch: gather the rows of ``slots``
    (every live slot when None), apply ``row_fn``, scatter the channels and
    ``active`` back with ``index_copy_``.  Returns (block coordinates,
    channel 0', channel 1') of the fused rows."""
    if slots is None:
        slots = torch.nonzero(octree.slot_mask(m) & m.active)[:, 0]
    slots = slots.long()
    bc = torch.stack(morton.block_key_decode(m.keys[slots]), dim=-1)
    a, b = (m.voxels[name] for name in names)
    ones = torch.ones(slots.shape, dtype=torch.bool, device=slots.device)
    a_new, b_new, visible = row_fn(bc, ones, a[slots], b[slots], depth, T_cw,
                                   K, *params, m.voxel_size, patch)
    a.index_copy_(0, slots, a_new)
    b.index_copy_(0, slots, b_new)
    m.active.index_copy_(0, slots, visible)
    return bc, a_new, b_new


def fuse_sdf_twin(m: VoxelMap, depth, T_cw, K, mu: float, max_weight: float,
                  slots: Optional[torch.Tensor] = None,
                  view: Optional[torch.Tensor] = None,
                  patch: int = PATCH) -> None:
    """Plain PyTorch version of the SDF kernel, with its in-place contract
    (see :func:`fuse_sdf`)."""
    bc, tsdf, weight = _twin(fuse_sdf_reference, SDF_CHANNELS, m, depth,
                             T_cw, K, (mu, max_weight), slots, patch)
    if view is not None:
        B = m.blocks_per_edge
        rows = ((bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]).long()
        enc = torch.where(weight != 0, tsdf, float("nan")).to(view.dtype)
        view.index_copy_(0, rows, enc)


def fuse_sdf(m: VoxelMap, depth, T_cw, K, mu: float, max_weight: float,
             slots: Optional[torch.Tensor] = None,
             view: Optional[torch.Tensor] = None,
             patch: int = PATCH) -> None:
    """SDF fusion of one depth frame into the map ``m``, in place.

    ``slots`` int32[n], ascending and unique, inside the table (the budget
    branch): the slots to fuse, live or not; at most ``capacity`` of them
    (checked), and on the card a repeated slot races and a slot outside
    the table is skipped.  None (the whole-table branch): every live slot
    (``octree.slot_mask`` and active); the others keep their voxels and
    ``active``.  Each fused slot's ``tsdf``/``weight`` rows take the update
    of :func:`fuse_sdf_reference` and its ``active`` flag becomes its
    visibility (any voxel in frame and in its block's patch).  ``view``: a
    held bf16 read view ``[B^3, 512]`` holding the encoding (``weight != 0
    ? tsdf : NaN``) of the table's rows, as a held view does; the fused
    blocks' rows take their new encoding (the kernel rewrites only the
    entries of updated voxels, which is the same while that holds).
    ``depth`` f32[H,W], ``T_cw``/``K`` f32[4,4].  CPU tensors take the
    plain twin; CUDA tensors launch the kernel, which raises if it
    cannot."""
    if m.voxels["tsdf"].device.type == "cpu":
        return fuse_sdf_twin(m, depth, T_cw, K, mu, max_weight, slots, view,
                             patch)
    _launch("fuse_sdf", m, SDF_CHANNELS, slots, view, depth, T_cw, K,
            (mu, max_weight), patch)


def fuse_ofusion_twin(m: VoxelMap, depth, T_cw, K, mu: float,
                      sigma_lo: float, now: float,
                      slots: Optional[torch.Tensor] = None,
                      patch: int = PATCH) -> None:
    """Plain PyTorch version of the OFusion kernel, with its in-place
    contract (see :func:`fuse_ofusion`)."""
    _twin(fuse_ofusion_reference, OFUSION_CHANNELS, m, depth, T_cw, K,
          (mu, sigma_lo, now), slots, patch)


def fuse_ofusion(m: VoxelMap, depth, T_cw, K, mu: float, sigma_lo: float,
                 now: float, slots: Optional[torch.Tensor] = None,
                 patch: int = PATCH) -> None:
    """OFusion fusion of one depth frame taken at ``now`` (a float32 value)
    into the map ``m``, in place: the contract of :func:`fuse_sdf` with the
    channels occupancy and timestamp and the update of
    :func:`fuse_ofusion_reference` (no view: a multiscale view is
    rebuilt).  CPU tensors take the plain twin; CUDA tensors launch the
    kernel, which raises if it cannot."""
    if m.voxels["occupancy"].device.type == "cpu":
        return fuse_ofusion_twin(m, depth, T_cw, K, mu, sigma_lo, now, slots,
                                 patch)
    _launch("fuse_ofusion", m, OFUSION_CHANNELS, slots, None, depth, T_cw, K,
            (mu, sigma_lo, now), patch)


def _check(fn: str, dev, specs) -> None:
    for name, t, dt, shape, align in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, {align}-byte aligned,"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(fn: str, m: VoxelMap, names: Tuple[str, str],
            slots: Optional[torch.Tensor], view: Optional[torch.Tensor],
            depth, T_cw, K, params, patch: int) -> None:
    """Check the operands and launch kernel ``fn`` of `csrc/integrate.cu`
    on the map's channels ``names`` with the field's float ``params``:
    one CTA per listed slot, or per slot of the table."""
    a, b = (m.voxels[name] for name in names)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    if slots is None and m.partitions > 1:
        # the whole-table branch takes the live slots as a prefix of the
        # table: list a partitioned map's live slots instead
        slots = torch.nonzero(octree.slot_mask(m) & m.active)[:, 0].int()
    cap = m.capacity
    H, W = depth.shape
    specs = [("channel 0", a, torch.float32, (cap, BLOCK_VOXELS), 16),
             ("channel 1", b, torch.float32, (cap, BLOCK_VOXELS), 16),
             ("active", m.active, torch.bool, (cap,), 1),
             ("keys", m.keys, torch.int64, (cap,), 8),
             ("n_blocks", m.n_blocks, torch.int32, (), 4),
             ("depth", depth, torch.float32, (H, W), 4),
             ("T_cw", T_cw, torch.float32, (4, 4), 4),
             ("K", K, torch.float32, (4, 4), 4)]
    if slots is not None:
        if slots.dim() != 1 or slots.shape[0] > cap:
            raise ValueError(f"{fn}: slots must list at most the {cap} "
                             f"slots of the table, got {tuple(slots.shape)}")
        specs.append(("slots", slots, torch.int32, (slots.shape[0],), 4))
    B = m.blocks_per_edge
    if view is not None:
        specs.append(("view", view, torch.bfloat16,
                      (B * B * B, BLOCK_VOXELS), 8))
    _check(fn, dev, specs)
    n_rows = cap if slots is None else slots.shape[0]
    if n_rows == 0:
        return

    from . import _build
    c_fn = getattr(_build.load("integrate"), fn)
    P = ctypes.c_void_p
    ptrs = [slots, m.keys, m.n_blocks, m.active, a, b] \
        + ([view] if fn == "fuse_sdf" else []) + [depth, T_cw, K]
    ints = [n_rows, cap, H, W] + ([B] if fn == "fuse_sdf" else [])
    c_fn.argtypes = [P] * len(ptrs) + [ctypes.c_int] * len(ints) \
        + [ctypes.c_float] * (len(params) + 2) + [ctypes.c_int, P]
    c_fn.restype = ctypes.c_int
    diag = 1.7320508 * BLOCK_SIDE * m.voxel_size
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = c_fn(*(None if t is None else t.data_ptr() for t in ptrs),
                   *ints, *params, m.voxel_size, diag, patch, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")
    LAUNCHES[fn] += 1
