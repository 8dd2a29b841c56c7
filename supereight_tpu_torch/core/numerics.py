"""Numerics that keep the JAX package's semantics on the CPU, where XLA
converts floats to ints by truncating and saturating, and computes its dots
and its fused elementwise code with fused multiply-adds."""

from __future__ import annotations

import torch

_I32_MAX = 2147483647
_F32_BELOW_2_31 = 2147483520.0     # largest float32 below 2^31


def trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 the way XLA converts: truncate toward zero, saturate
    at the int32 range, NaN -> 0.  (A plain ``.to(torch.int32)`` of an
    out-of-range value is undefined and gives INT_MIN on x86.)"""
    i = x.nan_to_num(0.0).clamp(-2147483648.0, _F32_BELOW_2_31) \
        .to(torch.int32)
    return torch.where(x >= 2147483648.0, _I32_MAX, i)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as a true division on every device (on CUDA,
    PyTorch multiplies by the reciprocal of a Python-scalar divisor)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as a fused multiply-add (the float32
    product is exact in float64)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def matvec(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``M @ p`` for vectors ``p`` [..., n] (``M`` [m, n], small), each row
    a multiply-add chain over n: the rounding of XLA's CPU dot, which
    computes the JAX package's einsums."""
    rows = []
    for r in range(M.shape[0]):
        acc = M[r, 0] * p[..., 0]
        for j in range(1, M.shape[1]):
            acc = fma(M[r, j], p[..., j], acc)
        rows.append(acc)
    return torch.stack(rows, dim=-1)
