"""``supereight_tpu_torch.core.numerics``: the single-rounding multiply-add
(``addcmul`` where it fuses, else the float64 round-to-odd fallback) and
the correctly rounded root, held against exact rational arithmetic, and
the small-matrix inverse, held against XLA's."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu_torch.core import numerics
from supereight_tpu_torch.core.numerics import fma, matvec, sqrt
from supereight_tpu_torch.pipeline import camera

from torch_port_util import K_FULL, load_frames

torch.set_num_threads(1)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest ``q``, ties to even."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - q),
                                     int(np.float32(x).view(np.int32)) & 1))


@pytest.mark.parametrize("fn", [fma, numerics._fma_round_to_odd])
def test_fma_rounds_once(fn):
    """1.5 * (1 + 2^-23) - 2^-60 is just below the tie between 1.5 + 2^-23
    and 1.5 + 2^-22: rounded once it is the former (``fmaf``); a float64
    sum rounded again to float32 lands on the tie and gives the latter."""
    got = fn(_f32(1.5), _f32(1 + 2 ** -23), _f32(-2.0 ** -60))
    assert got.dtype == torch.float32
    assert float(got) == 1.5 + 2 ** -23


def test_addcmul_fuses_on_the_cpu():
    """This CPU's ``addcmul`` is a fused multiply-add, so ``fma`` takes it
    (the fallback is held below all the same)."""
    assert numerics._addcmul_fuses("cpu")


@pytest.mark.parametrize("fn", [fma, numerics._fma_round_to_odd])
def test_fma_matches_exact_rounding(fn):
    rng = np.random.default_rng(0)
    n = 4000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    # c nearly cancels the product: the cases where rounding twice differs
    c = (-(a.astype(np.float64) * b)
         * (1 + rng.standard_normal(n) * 1e-7)).astype(np.float32)
    c[:100] = rng.standard_normal(100).astype(np.float32)
    got = fn(torch.from_numpy(a), torch.from_numpy(b),
             torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_sqrt_is_correctly_rounded():
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 10, 100000).astype(np.float32))
    got = sqrt(x).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.sqrt(x.numpy()))


def test_exp_matches_jitted_jax():
    """``numerics.exp`` is XLA's CPU ``exp`` bit for bit: over the bilateral
    filter's arguments, the whole float32 range (clamped ends, subnormal
    results flushed to 0) and tiny arguments; PyTorch's own ``exp`` is
    not."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-20, 0, 200000),
                        rng.uniform(-120, 120, 200000),
                        rng.standard_normal(50000) * 1e-3,
                        [0.0, -0.0, -87.5, 88.7, -1e30, 1e30]]) \
        .astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = numerics.exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.exp(torch.from_numpy(x)).numpy() != want).any()


def test_matvec_rows_are_fma_chains():
    rng = np.random.default_rng(2)
    M = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal((50, 7, 3)).astype(np.float32))
    got = matvec(M, p)
    assert got.shape == (50, 7, 4)
    for r in range(4):
        want = fma(M[r, 2], p[..., 2],
                   fma(M[r, 1], p[..., 1], M[r, 0] * p[..., 0]))
        assert torch.equal(got[..., r], want)


def test_inv_matches_jitted_jax():
    """The 4x4 inverses of the cached poses, of random matrices and of the
    camera matrices at three scales equal XLA's CPU inverse bit for bit."""
    mats = [p for s in ("synthetic_256_frames", "synthetic_256_frames_trans")
            for p in load_frames(s)[1][::4]]
    mats += list(np.random.default_rng(3).standard_normal((40, 4, 4))
                 .astype(np.float32))
    mats += [camera.camera_matrix(torch.from_numpy(K_FULL / s)).numpy()
             for s in (1, 2, 4)]
    jinv = jax.jit(jnp.linalg.inv)
    for m in mats:
        m = np.asarray(m, np.float32)
        got = numerics.inv(torch.from_numpy(m))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jinv(m)))


def test_dot3_adds_in_a_fixed_order():
    """``numerics.dot3`` is ``(x + y) + z`` of the rounded float32
    products (numpy's float32 arithmetic rounds each step), over values of
    mixed magnitude and sign, signed zeros among them, where the order of
    the sum decides the last bits."""
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(20000, 3))
            * 10.0 ** rng.integers(-6, 7, (20000, 3)) for _ in range(2))
    a[::7, 1] = -0.0
    b[::5] = -0.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    p = a * b
    want = (p[:, 0] + p[:, 1]) + p[:, 2]
    got = numerics.dot3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert ((p[:, 0] + p[:, 2]) + p[:, 1] != want).any()
