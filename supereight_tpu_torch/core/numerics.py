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


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dot product over a last axis of 3, its rounded products added
    as ``(x + y) + z`` on every device (``(a * b).sum(-1)`` adds in the
    order the device's reduction chooses, which differs on CUDA)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


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


#: the float32 constants of XLA's CPU ``exp`` (Cephes' ``expf``): the
#: argument's clamp, log2(e), log(2) split in two, and the polynomial
_EXP_LO, _EXP_HI = np.float32(-87.80000305), np.float32(88.80000305)
_LOG2E = np.float32(1.44269502162933349609375)
_EXP_C1, _EXP_C2 = np.float32(0.693359375), np.float32(-2.12194440e-4)
_EXP_P = tuple(np.float32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                       8.3334519073e-3, 4.1665795894e-2,
                                       1.6666665459e-1, 0.5))


def exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of float32 ``x`` rounded as XLA's CPU code computes it (the
    JAX package's ``jnp.exp``): Cephes' range reduction by n = floor(x
    log2(e) + 1/2) clamped to [-127, 127], its degree-5 polynomial in
    multiply-adds, and 2^n from the exponent bits; XLA flushes subnormal
    results to 0.  PyTorch's own CPU ``exp`` parts from it in the last bit
    for some inputs."""
    f = lambda v: torch.full((), float(v), dtype=torch.float32,
                             device=x.device)
    x = x.to(torch.float32).clamp(float(_EXP_LO), float(_EXP_HI))
    n = torch.floor(fma(x, f(_LOG2E), f(0.5))).clamp(-127.0, 127.0)
    r = fma(f(-_EXP_C2), n, fma(f(-_EXP_C1), n, x))
    p = f(_EXP_P[0]).expand_as(r)
    for c in _EXP_P[1:]:
        p = fma(p, r, f(c))
    y = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    return torch.where(out < np.finfo(np.float32).tiny, 0.0, out)


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


#: the sizes (rows) at which :func:`inv_twin` is XLA's inverse
INV_SIZES = (1, 2, 4)


def check_inv_size(fn: str, M: torch.Tensor) -> None:
    """Raise ValueError unless ``M`` is square with INV_SIZES rows."""
    if M.dim() != 2 or M.shape[0] != M.shape[1] or \
            M.shape[0] not in INV_SIZES:
        raise ValueError(f"{fn}: a square matrix of {INV_SIZES} rows, where "
                         "the inverse is XLA's, got "
                         f"{tuple(M.shape)}")


def inv(M: torch.Tensor) -> torch.Tensor:
    """Inverse of a square float32 matrix of 1, 2 or 4 rows, rounded as
    XLA's CPU ``jnp.linalg.inv`` rounds it (see :func:`inv_twin`); raises
    ValueError for another size.  A CPU matrix takes the twin; a CUDA
    matrix the kernel ``pose_inv`` (`ops/numerics_kernel.py`), which takes
    the same steps on the card, so the inverse needs no host read; it
    raises if it cannot launch."""
    if M.device.type == "cpu":
        return inv_twin(M)
    from supereight_tpu_torch.ops import numerics_kernel
    return numerics_kernel.pose_inv(M)


_FLT_MIN = np.float32(np.finfo(np.float32).tiny)


def _flush(x) -> np.float32:
    """A subnormal float32 as the signed zero that x86's flush-to-zero and
    denormals-are-zero modes make of it; any other value unchanged."""
    x = np.float32(x)
    if x != 0 and abs(x) < _FLT_MIN:
        return np.float32(math.copysign(0.0, float(x)))
    return x


def _fma_ftz(a, b, c) -> np.float32:
    with np.errstate(all="ignore"):
        return _flush(_fma_host(_flush(a), _flush(b), _flush(c)))


def _sub_ftz(a, b) -> np.float32:
    with np.errstate(all="ignore"):
        return _flush(_flush(a) - _flush(b))


def _mul_ftz(a, b) -> np.float32:
    with np.errstate(all="ignore"):
        return _flush(_flush(a) * _flush(b))


def _div_ftz(a, b) -> np.float32:
    with np.errstate(all="ignore"):
        return _flush(_flush(a) / _flush(b))


def _max_sse(d, s):
    """x86's ``maxss d, s``: the second operand where either is NaN."""
    return d if d > s else s


def _isamax(a) -> int:
    """OpenBLAS's ``isamax`` (0-based) on the magnitudes ``a`` of a column
    of at most 4 entries, NaN included: the lanes padded with zeros to 4,
    the largest taken as ``maxps`` pairs them (lane 2 with lane 0 and lane
    3 with lane 1, then the two), each pair giving its second operand where
    either is NaN; then the first entry that is not below that largest.  So
    a NaN can win (where the largest is NaN, or where it comes before the
    largest), and an entry after a NaN can win over one before it.  Read
    from ``jax.lax.linalg.lu``'s pivots on every column of 0, 1, 2, 3, NaN
    and +-inf of 1 to 4 entries, the same under OpenBLAS's SkylakeX,
    Haswell, Sandybridge and Nehalem kernels (``OPENBLAS_CORETYPE``); with
    no NaN it is the first largest."""
    v = list(a) + [np.float32(0.0)] * (4 - len(a))
    m = _max_sse(_max_sse(v[2], v[0]), _max_sse(v[3], v[1]))
    return next((i for i, x in enumerate(a) if not x < m), 0)


def inv_twin(M: torch.Tensor) -> torch.Tensor:
    """:func:`inv` in plain Python on the host: LAPACK's ``getrf`` and
    ``getrs`` (an identity right-hand side) as the OpenBLAS that the JAX
    package calls computes them.  The LU is left-looking with partial
    pivoting (the pivot as OpenBLAS's ``isamax`` picks it: the first largest,
    but for a NaN, :func:`_isamax`), the dot products of its triangular
    solve taken from the last term to the first (a zero result is +0, as a
    sum over vector lanes leaves it), those of its column update from the
    first, each a multiply-add chain from 0, and the column scaled by the
    pivot's reciprocal (neither swapped nor scaled where the pivot is 0 or
    NaN; set to 0 where the reciprocal is 0, as BLAS ``scal`` by 0 does);
    the solves run column-wise axpys of multiply-adds, the upper one
    multiplying by the diagonal's reciprocals.  XLA runs its CPU code with
    flush-to-zero and denormals-are-zero set, so every operation here reads
    a subnormal operand as a signed zero and flushes a subnormal result to
    one (a subnormal pivot is a zero pivot; LAPACK's ``sfmin`` branch, which
    divides by a pivot below FLT_MIN, is never taken).  The same bits for a
    matrix on any device (read back to the host), returned on ``M``'s
    device.  These are XLA's bits for matrices of 1, 2 or 4 rows (every
    pivot order; zero, NaN, subnormal, infinite and huge pivots; singular
    matrices; ``tests/test_torch_glue.py``), not for 3 or more than 4 rows,
    where OpenBLAS's triangular solve takes the rows in blocks of 1, 2 and
    4 with a rounded product between blocks and its LU adds dot products of
    three terms or more in another order: so it raises ValueError at any
    other size."""
    check_inv_size("inv", M)
    A = M.detach().to("cpu", torch.float32).numpy()
    n = A.shape[0]
    A = [[np.float32(A[i, j]) for j in range(n)] for i in range(n)]
    one, zero = np.float32(1.0), np.float32(0.0)

    def dot(row, col, ks):
        t = zero
        for k in ks:
            t = _fma_ftz(row[k], col[k], t)
        return t

    piv = []
    for j in range(n):
        b = [A[i][j] for i in range(n)]
        for i, p in enumerate(piv):
            b[i], b[p] = b[p], b[i]
        for i in range(1, j):
            b[i] = _sub_ftz(b[i], dot(A[i], b, range(i - 1, -1, -1)) + zero)
        for i in range(j, n):
            b[i] = _sub_ftz(b[i], dot(A[i], b, range(j)))
        p = j + _isamax([abs(_flush(x)) for x in b[j:]])
        piv.append(p)
        for i in range(n):
            A[i][j] = b[i]
        pivot = _flush(A[p][j])
        if pivot != 0 and pivot == pivot:
            r = _div_ftz(one, pivot)
            A[j][:j + 1], A[p][:j + 1] = A[p][:j + 1], A[j][:j + 1]
            for i in range(j + 1, n):
                A[i][j] = _mul_ftz(A[i][j], r) if r != 0 else zero
    X = [[one if i == c else zero for c in range(n)] for i in range(n)]
    for i, p in enumerate(piv):
        X[i], X[p] = X[p], X[i]
    for c in range(n):
        x = [X[i][c] for i in range(n)]
        for i in range(n):
            for k in range(i + 1, n):
                x[k] = _fma_ftz(-x[i], A[k][i], x[k])
        for i in range(n - 1, -1, -1):
            x[i] = _mul_ftz(x[i], _div_ftz(one, A[i][i]))
            for k in range(i):
                x[k] = _fma_ftz(-x[i], A[k][i], x[k])
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
