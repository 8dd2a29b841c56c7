"""The tracking pyramid on the card: the hand-written CUDA kernel
``pyramid_level`` (`csrc/pyramid.cu`), launched once a level, beside its
plain PyTorch twin :func:`supereight_tpu_torch.pipeline.preprocessing.
build_pyramid_twin`.  ``preprocessing.build_pyramid`` dispatches: CPU
tensors take the twin, CUDA tensors this kernel, with no fallback between
the two."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from supereight_tpu_torch.pipeline.constants import E_DELTA
from . import _build

#: the half sample's range (``half_sample_robust``'s default ``e_d``), as
#: the float32 the twin compares in
E_D = float(np.float32(E_DELTA * 3))

#: kernel launches so far (one a level)
LAUNCHES = {"build_pyramid": 0}


def build_pyramid(depth: torch.Tensor, k: torch.Tensor, levels: int,
                  neg_y: bool):
    """``preprocessing.build_pyramid`` on the card: (depths, vertices,
    normals), one launch a level, queued on the current stream.  ``depth``
    float32 [H, W] and ``k`` float32 [4] (fx, fy, cx, cy) CUDA tensors;
    level 0's depth is ``depth`` itself.  Raises for other operands or when
    a launch fails."""
    dev = depth.device
    if dev.type != "cuda" or k.device != dev:
        raise ValueError(f"build_pyramid: no kernel for depth on {dev} and "
                         f"k on {k.device}")
    if depth.dim() != 2 or tuple(k.shape) != (4,):
        raise ValueError(f"build_pyramid: depth [H, W] and k [4], got "
                         f"{tuple(depth.shape)} and {tuple(k.shape)}")
    depth = depth.to(torch.float32).contiguous()
    k = k.to(torch.float32).contiguous()
    fn = _build.load("pyramid").pyramid_level
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 5 + [I] * 6 + [ctypes.c_float, I, P]
    fn.restype = I
    depths, vertices, normals = [depth], [], []
    src = depth
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for level in range(max(levels, 1)):
            Hs, Ws = src.shape
            H, W = ((Hs + 1) // 2, (Ws + 1) // 2) if level else (Hs, Ws)
            f32 = dict(dtype=torch.float32, device=dev)
            d = torch.empty((H, W), **f32) if level else None
            v = torch.empty((H, W, 3), **f32)
            n = torch.empty((H, W, 3), **f32)
            err = fn(src.data_ptr(), None if d is None else d.data_ptr(),
                     v.data_ptr(), n.data_ptr(), k.data_ptr(), Hs, Ws, H, W,
                     level, int(level > 0), E_D, int(neg_y), stream)
            if err != 0:
                raise RuntimeError("build_pyramid kernel launch failed: "
                                   f"CUDA error {err}")
            LAUNCHES["build_pyramid"] += 1
            if d is not None:
                depths.append(d)
                src = d
            vertices.append(v)
            normals.append(n)
    return depths, vertices, normals
