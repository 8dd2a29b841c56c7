"""The raycast on the card: the hand-written CUDA kernels of
`csrc/raycast.cu`, each beside its plain PyTorch twin in
:mod:`supereight_tpu_torch.pipeline.raycast`:

- :func:`splat_bounds` (R1, one launch with the view's inverse inside it)
  for ``raycast._splat_bounds_twin``;
- :func:`ray_scan` (R2 with R3, one launch) for ``raycast.ray_scan_twin``
  and, with the second window or the midsolve, then
  ``raycast.ray_scan_second_twin``;
- :func:`ray_refine_normals` (R4) for ``raycast.ray_refine_normals_twin``.

``pipeline/raycast.py`` dispatches: CPU tensors take the twins, CUDA
tensors these kernels, with no fallback between the two.  Each wrapper
checks its operands and raises for another device, dtype or shape, and
when a launch fails; each queues its launch on the current stream and
reads nothing back.  R1's encoded grid and ticket (:class:`Scratch`) and
the scan's look-back state (:mod:`.look_back`, shared with the fusion's
frustum selection) live in scratches of each (device, stream), zeroed
once: the kernels leave them zero."""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.octree import BLOCK_SIDE, BLOCK_VOXELS
from . import _build, look_back

_K = _build.constants("raycast")
#: rays a tile of R2 (the second window's ranks count by tile)
SCAN_TILE = _K["kScanThreads"]
#: slots a CTA of R1
SPLAT_SLOTS = _K["kSplatThreads"] // _K["kSlotLanes"]
#: the largest splat grid R1 pools in shared memory (else in a scratch)
POOL_SMEM_CELLS = _K["kPoolSmemCells"]

#: kernel launches so far, one a call: ``ray_scan`` counts every launch of
#: the scan, ``ray_scan_second`` those that also ran the second window or
#: the midsolve (R3's work, in the same launch: not a launch of its own)
LAUNCHES = {"splat_bounds": 0, "ray_scan": 0, "ray_scan_second": 0,
            "ray_refine_normals": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Scratch:
    """R1's state on one (device, stream), allocated zeroed at first use
    and never read back; each launch leaves what it used zero: its encoded
    grid and ticket (``enc``).  The scan's look-back state is
    :func:`look_back.scratch`'s."""

    def __init__(self, device):
        self.device = device
        self.enc = torch.zeros(0, dtype=torch.int32, device=device)

    def splat(self, cells: int) -> torch.Tensor:
        """R1's zero [>= 2 cells + 1] int32."""
        if self.enc.numel() < 2 * cells + 1:
            self.enc = torch.zeros(2 * cells + 1, dtype=torch.int32,
                                   device=self.device)
        return self.enc


_SCRATCH: Dict[tuple, Scratch] = {}


def scratch(dev) -> Scratch:
    """The :class:`Scratch` of ``dev`` and its current stream (one for the
    CPU, where no kernel runs)."""
    dev = torch.device(dev)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream
           if dev.type == "cuda" else None)
    if key not in _SCRATCH:
        _SCRATCH[key] = Scratch(dev)
    return _SCRATCH[key]


def _check(fn: str, dev, specs) -> None:
    for name, t, dts, shape in specs:
        dts = dts if isinstance(dts, tuple) else (dts,)
        if (t.device != dev or t.dtype not in dts
                or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous "
                             f"{' or '.join(map(str, dts))} {tuple(shape)} "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _device(fn: str, view) -> torch.device:
    dev = view.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    return dev


def _launch(fn: str, dev, name: str, argtypes, *args) -> None:
    """Call ``csrc/raycast.cu``'s entry point ``name`` with ``args`` and
    ``dev``'s current stream; raise if it reports an error."""
    f = getattr(_build.load("raycast"), name)
    f.argtypes = [*argtypes, _P]
    f.restype = _I
    with torch.cuda.device(dev):
        err = f(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def _inside_below(field) -> int:
    """1 where ``field.is_inside`` is ``f < surf_boundary`` (SDF), 0 where
    it is ``f > surf_boundary`` (OFusion); raises for another test."""
    b = field.surf_boundary
    lo, hi = (bool(field.is_inside(torch.tensor(v))) for v in (b - 1.0,
                                                                b + 1.0))
    if lo == hi:
        raise ValueError(f"raycast kernels: {field.name}'s is_inside is "
                         "not a threshold at surf_boundary")
    return int(lo)


def _volume(fn: str, m, dense, dev):
    """The tiled view's operands: (pointer, bf16 flag, size, inv_vs)."""
    F = dense["F"]
    B = m.blocks_per_edge
    _check(fn, dev, [("the view", F, (torch.bfloat16, torch.float32),
                      (B * B * B, BLOCK_VOXELS))])
    return (F.data_ptr(), int(F.dtype == torch.bfloat16), m.size,
            m.inverse_voxel_size)


def _view(fn: str, view, dev) -> torch.Tensor:
    view = view.to(torch.float32).contiguous()
    _check(fn, dev, [("view", view, torch.float32, (4, 4))])
    return view


def splat_bounds(m, field, view, H: int, W: int, near: float, far: float,
                 near_rescue: bool = True, inside_any=None):
    """``raycast._splat_bounds`` on the card: (tmin, tmax, g), the [H/g,
    W/g] start and far depth grids, by R1's one launch, which inverts the
    view itself (``numerics.inv``'s bits).  The slots' inside flags come
    from ``inside_any`` (bool[capacity]) or from the select channel's
    float32 table."""
    from supereight_tpu_torch.pipeline.raycast import splat_cell
    fn = "splat_bounds"
    dev = _device(fn, view)
    view = _view(fn, view, dev)
    if not near > 0:
        raise ValueError(f"{fn}: near must be > 0, got {near}")
    g = splat_cell(H, W)
    gh, gw = H // g, W // g
    cells = gh * gw
    cap = m.capacity
    counts = octree.partition_counts(m)
    specs = [("keys", m.keys, torch.int64, (cap,)),
             ("partition counts", counts, torch.int32, (m.partitions,))]
    voxels = None
    if inside_any is None:
        voxels = m.voxels[field.select_channel]
        specs.append(("the select channel", voxels, torch.float32,
                      (cap, BLOCK_VOXELS)))
    else:
        specs.append(("inside_any", inside_any, torch.bool, (cap,)))
    _check(fn, dev, specs)
    if voxels is not None and voxels.data_ptr() % 16:
        raise ValueError(f"{fn}: the select channel must be 16-byte aligned")
    f32 = dict(dtype=torch.float32, device=dev)
    enc = scratch(dev).splat(cells)
    tmin = torch.empty((gh, gw), **f32)
    tmax = torch.empty((gh, gw), **f32)
    pool = torch.empty((4, cells), **f32) \
        if cells > POOL_SMEM_CELLS else None
    vs = m.voxel_size
    diag = 1.7320508 * BLOCK_SIDE * vs
    marg = 2.0 * g
    # the footprint radius each of the 3x3 cells needs, by |dx| + |dy|
    thr = [float(np.float32(np.hypot(*d) - 0.71))
           for d in ((0, 0), (1, 0), (1, 1))]
    ptr = lambda t: None if t is None else t.data_ptr()
    _launch(fn, dev, "splat_bounds",
            [_P] * 9 + [_I] * 6 + [_F, _I] + [_F] * 11,
            m.keys.data_ptr(), counts.data_ptr(), ptr(voxels),
            ptr(inside_any), view.data_ptr(), enc.data_ptr(),
            tmin.data_ptr(), tmax.data_ptr(), ptr(pool),
            cap, cap // m.partitions, g, gh, gw, int(near_rescue),
            field.surf_boundary, _inside_below(field),
            BLOCK_SIDE * vs, 0.5 * diag, diag, near, marg, W - 1 + marg,
            H - 1 + marg, thr[0], thr[1], thr[2], 2.4 * g)
    LAUNCHES["splat_bounds"] += 1
    return tmin, tmax, g


def _rays(plan):
    """(half, the strip's first scan row, its scan rays h, w)."""
    f = 2 if plan.half_res else 1
    return (int(plan.half_res), plan.r0 // f, plan.rows // f, plan.W // f)


def ray_scan(m, dense, field, view, plan, tmin, tmax, g: int,
             second_window: bool = False, w2_budget: int = 0,
             midsolve: bool = False):
    """``raycast.ray_scan`` on the card (R2 with R3, one launch): the first
    window of every ray; with ``second_window`` the flagged rays ranked in
    raster order on the card (the look-back), those of rank below
    ``w2_budget`` scanned one window deeper; with ``midsolve`` every hit
    re-solved.  A :class:`raycast.Scan` of new tensors (hit and z)."""
    from supereight_tpu_torch.pipeline.raycast import Scan
    fn = "ray_scan"
    dev = _device(fn, view)
    view = _view(fn, view, dev)
    vol = _volume(fn, m, dense, dev)
    half, r0s, h, w = _rays(plan)
    gh, gw = plan.H // g, plan.W // g
    _check(fn, dev, [("tmin", tmin, torch.float32, (gh, gw)),
                     ("tmax", tmax, torch.float32, (gh, gw))])
    if w2_budget < 0:
        raise ValueError(f"{fn}: w2_budget must be >= 0, got {w2_budget}")
    b8 = dict(dtype=torch.bool, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hit, z = torch.empty((h, w), **b8), torch.empty((h, w), **f32)
    tiles = -(-(h * w) // SCAN_TILE)
    sc = look_back.scratch(dev)
    status = sc.words(tiles) if second_window else None
    delta = 0.35 * plan.thickness
    ptr = lambda t: None if t is None else t.data_ptr()
    _launch(fn, dev, "ray_scan",
            [_P, _P, _I, _I, _F, _F] + [_I] * 7 + [_P, _P] + [_F] * 5
            + [_I] * 4 + [_F, _F] + [_P] * 4,
            view.data_ptr(), *vol, field.surf_boundary,
            _inside_below(field), half, r0s, h, w,
            g // 2 if plan.half_res else g, gw, tmin.data_ptr(),
            tmax.data_ptr(), plan.near, plan.far, plan.fine_span,
            plan.fine_span / plan.n_fine, plan.diag, plan.n_fine + 1,
            int(second_window), min(w2_budget, h * w), int(midsolve), delta,
            2.0 * delta, ptr(status), sc.ctl.data_ptr(), hit.data_ptr(),
            z.data_ptr())
    LAUNCHES["ray_scan"] += 1
    if second_window or midsolve:
        LAUNCHES["ray_scan_second"] += 1
    return Scan(hit, z, None, None)


def ray_refine_normals(m, dense, field, view, plan, z, hit, resolve: str,
                       normals: str, grad_decim: int = 1):
    """``raycast.ray_refine_normals`` on the card (R4, a thread a pixel): a
    :class:`raycast.Finish` of new tensors (``normal`` None where
    ``normals`` is "none")."""
    from supereight_tpu_torch.pipeline.raycast import (NORMALS, RESOLVE,
                                                       Finish)
    fn = "ray_refine_normals"
    dev = _device(fn, view)
    view = _view(fn, view, dev)
    vol = _volume(fn, m, dense, dev)
    if resolve not in RESOLVE or normals not in NORMALS:
        raise ValueError(f"{fn}: resolve {resolve!r}, normals {normals!r}")
    up = resolve != "none"
    if up and not plan.half_res or normals == "hybrid" and not up:
        raise ValueError(f"{fn}: the re-solve and the hybrid normals need "
                         "the half-resolution scan's rays")
    _, _, hs, ws = _rays(plan)
    rows, W = plan.rows, plan.W
    shape = (hs, ws) if up else (rows, W)
    _check(fn, dev, [("z", z, torch.float32, shape),
                     ("hit", hit, torch.bool, shape)])
    f32 = dict(dtype=torch.float32, device=dev)
    vertex = torch.empty((rows, W, 3), **f32)
    normal = torch.empty((rows, W, 3), **f32) if normals != "none" else None
    t_hit = torch.empty((rows, W), **f32)
    hit_out = torch.empty((rows, W), dtype=torch.bool, device=dev)
    spec = next(c for c in m.channels if c.name == field.select_channel)
    delta = 0.7 * plan.thickness
    _launch(fn, dev, "ray_refine_normals",
            [_P, _P, _I, _I, _F, _F] + [_I] * 6 + [_P, _P, _I, _I]
            + [_F] * 3 + [_I, _I, _F, _F, _I] + [_P] * 4,
            view.data_ptr(), *vol, field.surf_boundary,
            _inside_below(field), W, plan.r0, rows, hs, ws, z.data_ptr(),
            hit.data_ptr(), int(up), RESOLVE.index(resolve), delta,
            2.0 * delta, spec.init, NORMALS.index(normals), int(grad_decim),
            spec.empty, spec.init, int(field.invert_normals),
            vertex.data_ptr(), None if normal is None else normal.data_ptr(),
            t_hit.data_ptr(), hit_out.data_ptr())
    LAUNCHES["ray_refine_normals"] += 1
    return Finish(vertex, normal, t_hit, hit_out)
