"""The inverse of a small matrix on the card: the hand-written CUDA kernel
``pose_inv`` (`csrc/numerics.cu`), the device form of
:func:`supereight_tpu_torch.core.numerics.inv`, whose host LU is its twin.
``numerics.inv`` dispatches: a CPU matrix takes the twin, a CUDA matrix
this kernel, so a pose on the card is inverted without a host read."""

from __future__ import annotations

import ctypes

import torch

from supereight_tpu_torch.core.numerics import check_inv_size
from . import _build

#: kernel launches so far
LAUNCHES = {"pose_inv": 0}


def pose_inv(M: torch.Tensor) -> torch.Tensor:
    """``numerics.inv(M)`` of a square float32 CUDA matrix of INV_SIZES
    (1, 2 or 4) rows, the sizes at which the steps are XLA's, computed on
    the card by one thread (a new tensor on M's device, queued on the
    current stream).  Raises for another device or shape, or when the
    launch fails."""
    if M.device.type != "cuda":
        raise ValueError(f"pose_inv: no kernel for device {M.device}")
    check_inv_size("pose_inv", M)
    n = M.shape[0]
    M = M.detach().to(torch.float32).contiguous()
    out = torch.empty_like(M)
    fn = _build.load("numerics").pose_inv
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(M.device):
        err = fn(M.data_ptr(), out.data_ptr(), n,
                 torch.cuda.current_stream(M.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_inv kernel launch failed: CUDA error {err}")
    LAUNCHES["pose_inv"] += 1
    return out
