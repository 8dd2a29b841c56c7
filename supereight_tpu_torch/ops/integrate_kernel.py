"""Projective fusion in place on the block table: the hand-written CUDA
kernels (`csrc/integrate.cu`) and their plain PyTorch twins, for the SDF
(:func:`fuse_sdf`) and the OFusion field (:func:`fuse_ofusion`), with the
budget branch's frustum selection (:func:`frustum_select`) before them
(which also inverts the pose into the fusion's ``T_cw``) and the coarse
node pyramid's update (:func:`update_nodes`), which runs inside their
launch (``nodes=True``).

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
the JAX package by the CPU tests).  :func:`frustum_select` and
:func:`update_nodes` are the rest of JAX's ``integrate``
(`supereight_tpu/pipeline/integration.py:515-536` and ``_update_nodes``,
`:581-600`), which the port ran as chains of small launches with a host
read; on the card the selection is one launch with the fusion's inverse
inside it, the node update part of the fusion's launch, and neither reads
anything back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.core.numerics import inv_twin, matvec, trunc_i32
from supereight_tpu_torch.core.octree import (BLOCK_SIDE, BLOCK_VOXELS,
                                              VoxelMap)
from supereight_tpu_torch.fields.ofusion import OFusionField
from supereight_tpu_torch.fields.sdf import SDFField
from . import _build, look_back

PATCH = 16          # depth patch side per block, in strided pixels
N_STRIDES = 4       # patch strides 1, 2, 4, 8
#: slots a CTA (a tile) of frustum_select's look-back takes
_SELECT_TILE = (_build.constants("integrate")["kSelectThreads"]
                * _build.constants("integrate")["kSelectSlots"])

#: kernel launches so far, one counter per kernel (the chip smoke test reads
#: them to show that the main path went through the kernels; update_nodes
#: counts each node update, which runs inside a fusion's launch)
LAUNCHES = {"fuse_sdf": 0, "fuse_ofusion": 0, "frustum_select": 0,
            "update_nodes": 0}


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
    slots = slots[slots >= 0]           # frustum_select's -1 padding
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
                  patch: int = PATCH, nodes: bool = False):
    """Plain PyTorch version of the SDF kernel, with its in-place contract
    (see :func:`fuse_sdf`): the fusion, then with ``nodes``
    :func:`update_nodes_twin`, whose node values it returns."""
    bc, tsdf, weight = _twin(fuse_sdf_reference, SDF_CHANNELS, m, depth,
                             T_cw, K, (mu, max_weight), slots, patch)
    if view is not None:
        B = m.blocks_per_edge
        rows = ((bc[:, 0] * B + bc[:, 1]) * B + bc[:, 2]).long()
        enc = torch.where(weight != 0, tsdf, float("nan")).to(view.dtype)
        view.index_copy_(0, rows, enc)
    if nodes:
        return update_nodes_twin(m, SDFField(mu=mu, max_weight=max_weight),
                                 depth, T_cw, K, 0.0)


def fuse_sdf(m: VoxelMap, depth, T_cw, K, mu: float, max_weight: float,
             slots: Optional[torch.Tensor] = None,
             view: Optional[torch.Tensor] = None,
             patch: int = PATCH, nodes: bool = False):
    """SDF fusion of one depth frame into the map ``m``, in place; with
    ``nodes``, also the node pyramid's update (:func:`update_nodes`), whose
    new ``node_values`` it returns, in the same launch on the card.

    ``slots`` int32[n], ascending and unique, inside the table (the budget
    branch): the slots to fuse, live or not, then any -1 entries
    (:func:`frustum_select`'s padding), which are skipped; at most
    ``capacity`` of them (checked), and on the card a repeated slot races
    and a slot outside the table is skipped.  None (the whole-table
    branch): every live slot (``octree.slot_mask`` and active); the others
    keep their voxels and ``active``.  Each fused slot's ``tsdf``/``weight`` rows take the update
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
                             patch, nodes)
    return _launch("fuse_sdf", m, SDF_CHANNELS, slots, view, depth, T_cw, K,
                   (mu, max_weight), patch, nodes)


def fuse_ofusion_twin(m: VoxelMap, depth, T_cw, K, mu: float,
                      sigma_lo: float, now: float,
                      slots: Optional[torch.Tensor] = None,
                      patch: int = PATCH, nodes: bool = False):
    """Plain PyTorch version of the OFusion kernel, with its in-place
    contract (see :func:`fuse_ofusion`): the fusion, then with ``nodes``
    :func:`update_nodes_twin`, whose node values it returns."""
    _twin(fuse_ofusion_reference, OFUSION_CHANNELS, m, depth, T_cw, K,
          (mu, sigma_lo, now), slots, patch)
    if nodes:
        # with voxel_size 0 the field's sigma lower bound is sigma_floor
        field = OFusionField(mu=mu, voxel_size=0.0, sigma_floor=sigma_lo)
        return update_nodes_twin(m, field, depth, T_cw, K, now)


def fuse_ofusion(m: VoxelMap, depth, T_cw, K, mu: float, sigma_lo: float,
                 now: float, slots: Optional[torch.Tensor] = None,
                 patch: int = PATCH, nodes: bool = False):
    """OFusion fusion of one depth frame taken at ``now`` (a float32 value)
    into the map ``m``, in place: the contract of :func:`fuse_sdf` with the
    channels occupancy and timestamp and the update of
    :func:`fuse_ofusion_reference` (no view: a multiscale view is
    rebuilt), and with ``nodes`` the node pyramid's new ``node_values``
    returned, from the same launch on the card.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel, which raises if it
    cannot."""
    if m.voxels["occupancy"].device.type == "cpu":
        return fuse_ofusion_twin(m, depth, T_cw, K, mu, sigma_lo, now, slots,
                                 patch, nodes)
    return _launch("fuse_ofusion", m, OFUSION_CHANNELS, slots, None, depth,
                   T_cw, K, (mu, sigma_lo, now), patch, nodes)


def frustum_candidates(m: VoxelMap, T_cw, K, frame_hw) -> torch.Tensor:
    """bool[capacity]: live active blocks whose centre projects into the
    frame dilated by the block's footprint and that are not fully behind
    the camera (a superset of the blocks with a voxel in frame)."""
    H, W = frame_hw
    vs = m.voxel_size
    bc = octree.block_coords_table(m)
    centers = ((bc * BLOCK_SIDE).to(torch.float32) + 0.5 * BLOCK_SIDE) * vs
    ccam, cpx, cpy = project(T_cw, K, centers)
    diag = 1.7320508 * BLOCK_SIDE * vs
    foot = torch.abs(K[0, 0]) * diag / torch.clamp(ccam[..., 2], min=1e-3)
    return (octree.slot_mask(m) & m.active & (ccam[..., 2] > -0.5 * diag)
            & (cpx >= -foot) & (cpx <= W - 1 + foot)
            & (cpy >= -foot) & (cpy <= H - 1 + foot))


def frustum_select_twin(m: VoxelMap, pose, K, frame_hw, budget: int):
    """Plain PyTorch version of :func:`frustum_select`: ``T_cw`` by
    ``numerics.inv_twin``, then the candidates' first ``budget``."""
    T_cw = inv_twin(pose)
    cand = frustum_candidates(m, T_cw, K, frame_hw)
    idx = torch.nonzero(cand)[:budget, 0].to(torch.int32)
    slots = torch.full((budget,), -1, dtype=torch.int32, device=cand.device)
    slots[:idx.numel()] = idx
    dropped = torch.clamp(cand.sum(dtype=torch.int32) - budget, min=0)
    return slots, m.overflow + dropped, T_cw


def frustum_select(m: VoxelMap, pose, K, frame_hw, budget: int):
    """The budget branch's operands: ``(slots, overflow, T_cw)``.  ``T_cw``
    float32 [4, 4] is ``inv(pose)`` (``numerics.inv``'s bits), ``slots``
    int32 [budget] the first ``budget`` :func:`frustum_candidates` at that
    ``T_cw`` in ascending slot order, -1 past their count
    (``jnp.nonzero``'s fill), and ``overflow`` int32[] the map's overflow
    plus the candidates past the budget, all on the map's device.
    ``pose`` / ``K`` float32 [4, 4], ``0 < budget``.  CPU tensors take the
    plain twin; CUDA tensors launch one kernel, which inverts the pose in
    each CTA and ranks the candidates by a look-back over its tiles, and
    read nothing back (new ``slots``, ``overflow`` and ``T_cw`` each call;
    the look-back's status words and tickets in :func:`look_back.scratch`,
    which the kernel leaves zero), raising if it cannot."""
    if m.device.type == "cpu":
        return frustum_select_twin(m, pose, K, frame_hw, budget)
    dev = m.device
    cap = m.capacity
    counts = octree.partition_counts(m)
    _check("frustum_select", dev,
           [("keys", m.keys, torch.int64, (cap,), 8),
            ("active", m.active, torch.bool, (cap,), 1),
            ("partition counts", counts, torch.int32, (m.partitions,), 4),
            ("overflow", m.overflow, torch.int32, (), 4),
            ("pose", pose, torch.float32, (4, 4), 4),
            ("K", K, torch.float32, (4, 4), 4)])
    if not 0 < budget:
        raise ValueError(f"frustum_select: budget must be > 0, got {budget}")
    H, W = frame_hw
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.empty((budget,), **i32)
    overflow = torch.empty((), **i32)
    T_cw = torch.empty((4, 4), dtype=torch.float32, device=dev)
    sc = look_back.scratch(dev)
    status = sc.words(select_tiles(cap))
    fn = _build.load("integrate").frustum_select
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 11 + [I] * 5 + [F, F, P]
    fn.restype = I
    with torch.cuda.device(dev):
        err = fn(m.keys.data_ptr(), m.active.data_ptr(), counts.data_ptr(),
                 pose.data_ptr(), K.data_ptr(), slots.data_ptr(),
                 T_cw.data_ptr(), status.data_ptr(), sc.ctl.data_ptr(),
                 m.overflow.data_ptr(), overflow.data_ptr(),
                 cap, cap // m.partitions, H, W, budget, m.voxel_size,
                 1.7320508 * BLOCK_SIDE * m.voxel_size,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"frustum_select kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["frustum_select"] += 1
    return slots, overflow, T_cw


def select_tiles(capacity: int) -> int:
    """The tiles (CTAs) of :func:`frustum_select`'s launch at
    ``capacity`` slots: the look-back's status words it needs."""
    return -(-capacity // _SELECT_TILE)


def _pixel_valid(px, py, pos_cam, frame_hw):
    H, W = frame_hw
    return ((pos_cam[..., 2] >= 1e-4) & (px >= 0.5) & (px <= W - 1.5)
            & (py >= 0.5) & (py <= H - 1.5))


def _sample_depth(depth, px, py, valid):
    """Nearest depth sample at int(pixel), 0 where not ``valid``."""
    H, W = depth.shape
    ix = trunc_i32(px).clamp(0, W - 1).long()
    iy = trunc_i32(py).clamp(0, H - 1).long()
    return torch.where(valid, depth[iy, ix], 0.0)


def update_nodes_twin(m: VoxelMap, field, depth, T_cw, K, timestamp: float):
    """Plain PyTorch version of :func:`update_nodes`."""
    node_values = list(m.node_values)
    for level in range(1, m.block_level + 1):
        s = 1 << level
        g = torch.arange(s, dtype=torch.float32, device=m.device)
        grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1)
        corners = grid * ((m.size // s) * m.voxel_size)
        pos_cam, px, py = project(T_cw, K, corners)
        alloc = m.node_alloc[level]
        ok = _pixel_valid(px, py, pos_cam, depth.shape) & alloc
        vals = m.node_values[level]
        new = field.update(vals, pos_cam, _sample_depth(depth, px, py, ok),
                           ok, timestamp)
        node_values[level] = {name: torch.where(alloc, new[name], vals[name])
                              for name in vals}
    return node_values


def update_nodes(m: VoxelMap, field, depth, T_cw, K, timestamp: float):
    """The coarse node pyramid after one depth frame taken at
    ``timestamp``: the map's ``node_values`` list with levels
    1..block_level replaced by new tables, where every allocated cell whose
    corner projects into the frame took its depth sample through the
    field's update (SDF or OFusion).  CPU tensors take the plain twin; on
    the card the fusion runs it (``fuse_sdf`` / ``fuse_ofusion`` with
    ``nodes``), and this call launches that kernel with no rows, which
    raises if it cannot."""
    if m.device.type == "cpu":
        return update_nodes_twin(m, field, depth, T_cw, K, timestamp)
    empty = torch.empty((0,), dtype=torch.int32, device=m.device)
    if field.name == "ofusion":
        return _launch("fuse_ofusion", m, OFUSION_CHANNELS, empty, None,
                       depth, T_cw, K, (field.mu, field.sigma_lo, timestamp),
                       PATCH, True)
    return _launch("fuse_sdf", m, SDF_CHANNELS, empty, None, depth, T_cw, K,
                   (field.mu, field.max_weight), PATCH, True)


def _node_operands(m: VoxelMap, names, dev, specs):
    """The node pyramid's operands of a fusion launch: (a ctypes array of
    the 3 x L table pointers ``make_nodes`` takes, the new tables in one
    allocation (each level's two channels, level after level), the L cell
    edges, L, the new node values: views of it), for the map's levels
    1..L = block_level; ``specs`` gains their checks."""
    levels = range(1, m.block_level + 1)
    tables = [[], [], []]
    for level in levels:
        s = 1 << level
        vals = m.node_values[level]
        for k, n in enumerate(names):
            specs.append((f"level {level} {n}", vals[n], torch.float32,
                          (s, s, s), 4))
            tables[k].append(vals[n])
        specs.append((f"level {level} alloc", m.node_alloc[level],
                      torch.bool, (s, s, s), 1))
        tables[2].append(m.node_alloc[level])
    cells = [1 << (3 * level) for level in levels]
    out = torch.empty((2 * sum(cells),), dtype=torch.float32, device=dev)
    new = out.split([n for n in cells for _ in names]) if cells else ()
    tables = [t for ts in tables for t in ts]
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    cell = (ctypes.c_float * len(cells))(*(float(np.float32(
        (m.size // (1 << level)) * m.voxel_size)) for level in levels))
    node_values = list(m.node_values)
    for i, level in enumerate(levels):
        s = (1 << level,) * 3
        node_values[level] = {name: new[2 * i + k].view(s)
                              for k, name in enumerate(names)}
    return ptrs, out, cell, len(cells), node_values


def _check(fn: str, dev, specs) -> None:
    for name, t, dt, shape, align in specs:
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{fn}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {dev}, {align}-byte aligned,"
                             f" got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(fn: str, m: VoxelMap, names: Tuple[str, str],
            slots: Optional[torch.Tensor], view: Optional[torch.Tensor],
            depth, T_cw, K, params, patch: int, nodes: bool = False):
    """Check the operands and launch kernel ``fn`` of `csrc/integrate.cu`
    on the map's channels ``names`` with the field's float ``params``:
    one CTA per listed slot, or per slot of the table, and with ``nodes``
    the node pyramid's CTAs after them, whose new ``node_values`` it
    returns."""
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
    node_ptrs, node_out, cell, n_levels = None, None, None, 0
    if nodes:
        node_ptrs, node_out, cell, n_levels, node_values = _node_operands(
            m, names, dev, specs)
    _check(fn, dev, specs)
    n_rows = cap if slots is None else slots.shape[0]
    if n_rows or n_levels:
        c_fn = getattr(_build.load("integrate"), fn)
        P, I = ctypes.c_void_p, ctypes.c_int
        ptrs = [slots, m.keys, m.n_blocks, m.active, a, b] \
            + ([view] if fn == "fuse_sdf" else []) + [depth, T_cw, K]
        ints = [n_rows, cap, H, W] + ([B] if fn == "fuse_sdf" else [])
        c_fn.argtypes = [P] * len(ptrs) + [I] * len(ints) \
            + [ctypes.c_float] * (len(params) + 2) + [I, P, P, P, I, P]
        c_fn.restype = I
        diag = 1.7320508 * BLOCK_SIDE * m.voxel_size
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = c_fn(*(None if t is None else t.data_ptr() for t in ptrs),
                       *ints, *params, m.voxel_size, diag, patch, node_ptrs,
                       None if node_out is None else node_out.data_ptr(),
                       cell, n_levels, stream)
        if err != 0:
            raise RuntimeError(f"{fn} kernel launch failed: CUDA error "
                               f"{err}")
        if n_rows:
            LAUNCHES[fn] += 1
    if not nodes:
        return None
    if n_levels:    # once a fusion, inside the fusion's launch
        LAUNCHES["update_nodes"] += 1
    return node_values
