"""Numerics that keep the JAX package's semantics on the CPU, where XLA
converts floats to ints by truncating and saturating, and computes its dots
and its fused elementwise code with fused multiply-adds."""

from __future__ import annotations

import functools
import math
import struct

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _addcmul_fuses(device_type: str) -> bool:
    """Whether ``addcmul`` computes a fused multiply-add on devices of this
    type (PyTorch's CPU kernels use ``fmadd`` and nvcc contracts the CUDA
    one; checked once on (1 + 2^-12)^2 - (1 + 2^-11), which is 2^-24
    rounded once and 0 rounded twice)."""
    x = torch.full((1,), 1 + 2 ** -12, dtype=torch.float32,
                   device=device_type)
    y = torch.addcmul(torch.full_like(x, -(1 + 2 ** -11)), x, x)
    return float(y[0]) == 2 ** -24


def _fma_round_to_odd(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, in float64: the float32 product is exact
    there, and the sum is rounded to odd (an inexact sum with an even last
    bit steps one ulp toward the part it lost, found by TwoSum), so that
    the cast to float32 rounds as the exact sum would."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    inexact = (err != 0) & torch.isfinite(err) & even
    s = torch.where(inexact, torch.nextafter(s, torch.where(
        err > 0, torch.inf, -torch.inf).to(s.dtype)), s)
    return s.to(torch.float32)


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as ``fmaf`` and
    XLA's contracted code round it: one ``addcmul`` where it fuses, else
    :func:`_fma_round_to_odd`."""
    a, b, c = (x.to(torch.float32) for x in (a, b, c))
    if _addcmul_fuses(torch.broadcast_tensors(a, b, c)[0].device.type):
        return torch.addcmul(c, a, b)
    return _fma_round_to_odd(a, b, c)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of float32 ``x`` (PyTorch's vectorised
    float32 ``sqrt`` on the CPU is off by one ulp for some inputs; the
    float64 root rounds to the float32 one exactly)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _fma_host(a, b, c) -> np.float32:
    """:func:`fma` of three float32 scalars on the host (round to odd in
    float64, as :func:`_fma_round_to_odd`)."""
    p, c = float(a) * float(b), float(c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0 and math.isfinite(err) and \
            struct.unpack("<q", struct.pack("<d", s))[0] & 1 == 0:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return np.float32(s)


def inv(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a small square float32 matrix, rounded as XLA's CPU
    ``jnp.linalg.inv`` rounds it: LAPACK's ``getrf`` and ``getrs`` (an
    identity right-hand side) as the OpenBLAS that the JAX package calls
    computes them.  The LU is left-looking with partial pivoting (the
    first largest pivot), the dot products of its triangular solve taken
    from the last term to the first, those of its column update from the
    first, each a multiply-add chain from 0, and the column scaled by the
    pivot's reciprocal; the solves run column-wise axpys of multiply-adds,
    the upper one multiplying by the diagonal's reciprocals.  Computed on
    the host (the same bits for a matrix on any device) and returned on
    ``M``'s device."""
    A = M.detach().to("cpu", torch.float32).numpy()
    n = A.shape[0]
    A = [[np.float32(A[i, j]) for j in range(n)] for i in range(n)]
    one, zero = np.float32(1.0), np.float32(0.0)

    def dot(row, col, ks):
        t = zero
        for k in ks:
            t = _fma_host(row[k], col[k], t)
        return t

    piv = []
    for j in range(n):
        b = [A[i][j] for i in range(n)]
        for i, p in enumerate(piv):
            b[i], b[p] = b[p], b[i]
        for i in range(1, j):
            b[i] = b[i] - dot(A[i], b, range(i - 1, -1, -1))
        for i in range(j, n):
            b[i] = b[i] - dot(A[i], b, range(j))
        p = j + max(range(n - j), key=lambda i: (abs(b[j + i]), -i))
        piv.append(p)
        for i in range(n):
            A[i][j] = b[i]
        if A[p][j] != 0:
            r = one / A[p][j]
            A[j][:j + 1], A[p][:j + 1] = A[p][:j + 1], A[j][:j + 1]
            for i in range(j + 1, n):
                A[i][j] = A[i][j] * r
    X = [[one if i == c else zero for c in range(n)] for i in range(n)]
    for i, p in enumerate(piv):
        X[i], X[p] = X[p], X[i]
    for c in range(n):
        x = [X[i][c] for i in range(n)]
        for i in range(n):
            for k in range(i + 1, n):
                x[k] = _fma_host(-x[i], A[k][i], x[k])
        for i in range(n - 1, -1, -1):
            x[i] = x[i] * (one / A[i][i])
            for k in range(i):
                x[k] = _fma_host(-x[i], A[k][i], x[k])
        for i in range(n):
            X[i][c] = x[i]
    return torch.tensor(np.array(X, np.float32), device=M.device)


def matvec(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``M @ p`` for vectors ``p`` [..., n] (``M`` [m, n], small), each row
    a multiply-add chain over n: the rounding of XLA's CPU dot, which
    computes the JAX package's einsums.  All m rows advance together."""
    acc = M[:, 0] * p[..., 0:1]
    for j in range(1, M.shape[1]):
        acc = fma(M[:, j], p[..., j:j + 1], acc)
    return acc
