"""The tracking pyramid on the card: the hand-written CUDA kernel
``build_pyramid`` (`csrc/pyramid.cu`), every level in one launch, beside
its plain PyTorch twin :func:`supereight_tpu_torch.pipeline.preprocessing.
build_pyramid_twin`.  ``preprocessing.build_pyramid`` dispatches: CPU
tensors take the twin, CUDA tensors this kernel, with no fallback between
the two.  :func:`tile_plan` is the kernel's geometry (which CTA owns which
pixels, which region of each level it holds), which the CPU tests run."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from supereight_tpu_torch.pipeline.constants import E_DELTA
from . import _build

_GEOMETRY = _build.constants("pyramid")
#: a CTA's tile of the coarsest level is TILE x TILE pixels
TILE = _GEOMETRY["kTile"]
#: the most levels one launch builds
MAX_LEVELS = _GEOMETRY["kMaxLevels"]
#: a CTA's shared memory at MAX_LEVELS levels, in floats
SMEM_FLOATS = _GEOMETRY["kSmemFloats"]

#: the half sample's range (``half_sample_robust``'s default ``e_d``), as
#: the float32 the twin compares in
E_D = float(np.float32(E_DELTA * 3))

#: kernel launches so far (one a call)
LAUNCHES = {"build_pyramid": 0}


class Level(NamedTuple):
    """One level of a :class:`TilePlan`: its image, the side of the square
    a CTA owns (at ``(by * side, bx * side)``), the halo the CTA holds
    around it and the region that makes (rows, columns each; level 0's
    columns widened to whole 16-byte loads), and where the level's depth
    (from level 1; else None), vertex and normal images start in the
    output (floats)."""
    shape: Tuple[int, int]
    side: int
    halo: Tuple[int, int]
    region: Tuple[int, int]
    depth: int
    vertex: int
    normal: int


class TilePlan(NamedTuple):
    """The kernel's geometry for a depth [H, W] and a level count: the
    levels, the grid of CTAs (rows, columns), the output's floats, a CTA's
    shared memory (floats), and the output's images as (shape, stride,
    offset): every level's depth from level 1, then the vertices, then the
    normals."""
    levels: Tuple[Level, ...]
    grid: Tuple[int, int]
    size: int
    smem: int
    images: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]

    def region(self, level: int, by: int, bx: int) -> Tuple[int, int]:
        """The global (row, column) of CTA (by, bx)'s region's first cell
        at ``level``."""
        lv = self.levels[level]
        return by * lv.side - lv.halo[0], bx * lv.side - lv.halo[1]


def _ceil4(x: int) -> int:
    return (x + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def tile_plan(H: int, W: int, levels: int) -> TilePlan:
    """``csrc/pyramid.cu``'s geometry (``geometry``, ``build_pyramid``):
    level l's tile is TILE * 2^(L-1-l) square with a halo of 2^(L-1-l)
    (level 0's columns widened to multiples of four), the grid covers the
    coarsest level in TILE x TILE tiles, and the output holds, level by
    level, the depth (from level 1), the vertices and the normals.  Raises
    for a level count the kernel does not take."""
    if not 1 <= levels <= MAX_LEVELS or H <= 0 or W <= 0:
        raise ValueError(f"build_pyramid: 1 to {MAX_LEVELS} levels of a "
                         f"non-empty image, got {levels} of {H}x{W}")
    out, off, smem = [], 0, 0
    h, w = H, W
    for level in range(levels):
        if level:
            h, w = (h + 1) // 2, (w + 1) // 2
        side = TILE << (levels - 1 - level)
        halo = 1 << (levels - 1 - level)
        hx = _ceil4(halo) if level == 0 else halo
        cols = _ceil4(side + halo) + _ceil4(halo) if level == 0 \
            else side + 2 * halo
        rows = side + 2 * halo
        depth = None
        if level:
            depth, off = off, off + h * w
        out.append(Level((h, w), side, (halo, hx), (rows, cols), depth, off,
                         off + 3 * h * w))
        off += 6 * h * w
        smem += rows * cols
    smem += 4 * levels          # each level's inverse intrinsics
    assert smem <= SMEM_FLOATS
    grid = (-(-h // TILE), -(-w // TILE))
    images = []
    for kind in ("depth", "vertex", "normal"):
        for lv in out[1:] if kind == "depth" else out:
            h, w = lv.shape
            if kind == "depth":
                images.append(((h, w), (w, 1), lv.depth))
            else:
                images.append(((h, w, 3), (3 * w, 3, 1), getattr(lv, kind)))
    return TilePlan(tuple(out), grid, off, smem, tuple(images))


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("pyramid").build_pyramid
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, ctypes.c_int64, P, I, I, I, ctypes.c_float, I, P]
    fn.restype = I
    return fn


def build_pyramid(depth: torch.Tensor, k: torch.Tensor, levels: int,
                  neg_y: bool):
    """``preprocessing.build_pyramid`` on the card: (depths, vertices,
    normals), one launch for every level, queued on the current stream.
    ``depth`` float32 [H, W] and ``k`` float32 [4] (fx, fy, cx, cy) CUDA
    tensors; level 0's depth is ``depth`` itself, the other images are
    views of one output tensor.  Raises for other operands, for more than
    MAX_LEVELS levels, or when the launch fails."""
    dev = depth.device
    if dev.type != "cuda" or k.device != dev:
        raise ValueError(f"build_pyramid: no kernel for depth on {dev} and "
                         f"k on {k.device}")
    if depth.dim() != 2 or tuple(k.shape) != (4,):
        raise ValueError(f"build_pyramid: depth [H, W] and k [4], got "
                         f"{tuple(depth.shape)} and {tuple(k.shape)}")
    depth = depth.to(torch.float32).contiguous()
    k = k.to(torch.float32).contiguous()
    H, W = depth.shape
    plan = tile_plan(H, W, max(levels, 1))
    fn = _kernel()
    out = torch.empty(plan.size, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = fn(depth.data_ptr(), out.data_ptr(), plan.size, k.data_ptr(),
                 H, W, len(plan.levels), E_D, int(neg_y),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"build_pyramid kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["build_pyramid"] += 1
    images = [out.as_strided(*im) for im in plan.images]
    n = len(plan.levels)
    return ([depth] + images[:n - 1], images[n - 1:2 * n - 1],
            images[2 * n - 1:])
