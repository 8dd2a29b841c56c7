"""ICP tracking of the PyTorch port against the JAX package on fixed
reference maps built from the cached frames (160x120).

Status codes must match apart from near-gate flips (a pixel on the edge of
a gate or of a rounding boundary), which are counted and held to 0.1 %;
the normal-equation sums agree to 1e-4 relative, poses to 1e-5.

The bilinear association's blended rows equal the jitted JAX function's
(``_gather_ref`` on the same pixels) bit for bit, and so does the status
image of a jitted JAX association (nearest or bilinear).  The Huber and Tukey normal-equation sums agree
within rtol 1e-5, plus 1e-6 times the sum of the terms' absolute values
(float32 sums in another order, for entries near zero).  The per-frame
gated symmetric residual equals JAX's status codes bit for bit, errors
within 1e-6 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu.pipeline import tracking as jtr
from supereight_tpu_torch.pipeline import tracking

from torch_port_util import K_FULL, load_frames

torch.set_num_threads(1)

REF, CUR = 20, 22
K = K_FULL / 2
ITERS = (10, 5, 4)


@pytest.fixture(scope="module")
def maps():
    """Reference maps: frame REF's vertices/normals in world space at its
    true pose; input: frame CUR's pyramid, starting from pose REF+1."""
    depths, poses = load_frames()
    pyr = {}
    for f in (REF, CUR):
        d = jpre.mm_to_meters(jnp.asarray(depths[f]), (120, 160))
        pyr[f] = jpre.build_pyramid(d, jnp.asarray(K), 3, neg_y=False)
    rp = jnp.asarray(poses[REF])
    ref_v = jcam.transform_points(rp, pyr[REF][1][0])
    ref_n = pyr[REF][2][0]
    ref_n = jnp.where(ref_n[..., :1] == -2.0, ref_n,
                      jcam.rotate_vectors(rp, ref_n))
    ref_v = jnp.where(ref_n[..., :1] == -2.0, 0.0, ref_v)
    a = lambda x: np.asarray(x)
    return dict(ref_v=a(ref_v), ref_n=a(ref_n), rpose=poses[REF],
                start=poses[REF + 1].astype(np.float32), true=poses[CUR],
                depths=[a(x) for x in pyr[CUR][0]],
                vertices=[a(x) for x in pyr[CUR][1]],
                normals=[a(x) for x in pyr[CUR][2]])


def _t(x):
    return torch.from_numpy(np.array(x))


def _view(m):
    return np.asarray(jcam.camera_matrix(jnp.asarray(K))
                      @ jnp.linalg.inv(jnp.asarray(m["rpose"])))


def _flips(a, b):
    return float((a != b).mean())


@pytest.fixture(scope="module")
def jax_track_data(maps):
    view = _view(maps)
    return jtr.track_kernel(
        jnp.asarray(maps["vertices"][0]), jnp.asarray(maps["normals"][0]),
        jnp.asarray(maps["ref_v"]), jnp.asarray(maps["ref_n"]),
        jnp.asarray(maps["start"]), jnp.asarray(view))


def test_track_kernel_matches_jax(maps, jax_track_data):
    want = jax_track_data
    got = tracking.track_kernel(
        _t(maps["vertices"][0]), _t(maps["normals"][0]), _t(maps["ref_v"]),
        _t(maps["ref_n"]), _t(maps["start"]), _t(_view(maps)))
    res_w, res_g = np.asarray(want.result), got.result.numpy()
    # every status code occurs, and they agree but for near-gate flips
    assert set(np.unique(res_w).tolist()) >= {1, -1, -2, -3, -4}
    assert _flips(res_g, res_w) <= 1e-3
    both = (res_g == 1) & (res_w == 1)
    np.testing.assert_allclose(got.error.numpy()[both],
                               np.asarray(want.error)[both], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.J.numpy()[both], np.asarray(want.J)[both],
                               rtol=0, atol=1e-4)


def test_symmetric_residuals_match_jax(maps):
    rng = np.random.default_rng(0)
    n = 2048
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)
                      ).astype(np.float32)
    pv = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rv = (pv + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    pn = unit(rng.normal(0, 1, (n, 3)))
    rn = unit(pn + rng.normal(0, 0.5, (n, 3)))
    rn[:64, 0] = -2.0
    in_frame = rng.random(n) < 0.95
    no_in = rng.random(n) < 0.05
    args = (pv, pn, rv, rn, in_frame, no_in)
    want = jtr._residuals(*(jnp.asarray(x) for x in args), 0.1, 0.8,
                          symmetric=True)
    got = tracking._residuals(*(_t(x) for x in args), 0.1, 0.8,
                              symmetric=True)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.J.numpy(), np.asarray(want.J), rtol=0,
                               atol=1e-5)


def test_reduce_kernel_matches_jax(jax_track_data):
    td = jax_track_data
    want = jtr.reduce_kernel(td)
    got = tracking.reduce_kernel(tracking.TrackData(
        _t(td.result), _t(td.error), _t(td.J)))
    for w, g in zip(want, got):
        w, g = np.asarray(w, np.float64), g.numpy().astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert float(got[3]) > 1000


def test_solve_normal_equations_matches_jax(jax_track_data):
    _, JTe, JTJ, _ = jtr.reduce_kernel(jax_track_data)
    want = np.asarray(jtr.solve_normal_equations(JTe, JTJ))
    got = tracking.solve_normal_equations(_t(JTe), _t(JTJ)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    # not positive definite: JAX's Cholesky gives NaN -> zero twist
    rank1 = np.outer(np.arange(1, 7), np.arange(1, 7)).astype(np.float32)
    for bad in (np.zeros((6, 6), np.float32), rank1,
                -np.eye(6, dtype=np.float32)):
        b = np.ones(6, np.float32)
        jx = np.asarray(jtr.solve_normal_equations(jnp.asarray(b),
                                                   jnp.asarray(bad)))
        tx = tracking.solve_normal_equations(_t(b), _t(bad)).numpy()
        np.testing.assert_array_equal(jx, np.zeros(6))
        np.testing.assert_array_equal(tx, np.zeros(6))


@pytest.mark.parametrize("symmetric", [False, True])
def test_track_matches_jax(maps, symmetric):
    args = ([maps[k] for k in ("depths", "vertices", "normals")]
            + [maps["ref_v"], maps["ref_n"], maps["rpose"]])
    jpose, jok, jres = jtr.track(
        jnp.asarray(maps["start"]),
        *[[jnp.asarray(x) for x in a] if isinstance(a, list)
          else jnp.asarray(a) for a in args],
        jnp.asarray(K), ITERS, 1e-5, finest_decimate=2, symmetric=symmetric)
    tpose, tok, tres = tracking.track(
        _t(maps["start"]),
        *[[_t(x) for x in a] if isinstance(a, list) else _t(a)
          for a in args],
        _t(K), ITERS, 1e-5, finest_decimate=2, symmetric=symmetric)
    assert bool(jok) and bool(tok)
    jpose = np.asarray(jpose)
    # ICP moved the pose toward the truth, and both agree
    assert np.abs(jpose[:3, 3] - maps["true"][:3, 3]).max() \
        < np.abs(maps["start"][:3, 3] - maps["true"][:3, 3]).max()
    np.testing.assert_allclose(tpose.numpy(), jpose, rtol=0, atol=1e-5)
    assert tres.shape == (120, 160)
    assert _flips(tres.numpy(), np.asarray(jres)) <= 1e-3


def _jax_association(maps, assoc):
    """The JAX association at the start pose, jitted as the system runs
    it: (projected pixels, gathered reference rows, TrackData)."""
    def f(iv, inn, rv, rn, T, view):
        rH, rW = rv.shape[:2]
        pv, px, py, in_frame = jtr._project(T, view, iv, rH, rW)
        ref = jtr._gather_ref(rv, rn, px, py, rH, rW, assoc=assoc)
        td = jtr._residuals(pv, jcam.rotate_vectors(T, inn), *ref, in_frame,
                            inn[..., 0] == -2.0, 0.1, 0.8)
        return (px, py), ref, td
    return jax.jit(f)(*(jnp.asarray(maps[k]) for k in ("in_v", "in_n",
                                                      "ref_v", "ref_n",
                                                      "start")),
                      jnp.asarray(_view(maps)))


@pytest.fixture(scope="module")
def level0(maps):
    return dict(maps, in_v=maps["vertices"][0], in_n=maps["normals"][0])


def test_bilinear_gather_matches_jax(level0):
    """Blended rows, the renormalised normal and the nearest fallback at
    discontinuities, bit for bit."""
    (px, py), _, _ = _jax_association(level0, "bilinear")
    jv, jn = jax.jit(jtr._gather_ref, static_argnames=("rH", "rW", "assoc"))(
        jnp.asarray(level0["ref_v"]), jnp.asarray(level0["ref_n"]), px, py,
        rH=120, rW=160, assoc="bilinear")
    tv, tn = tracking._gather_ref(_t(level0["ref_v"]), _t(level0["ref_n"]),
                                  _t(px), _t(py), 120, 160, "bilinear")
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    # both branches ran: blends off the pixel grid and nearest fallbacks
    nv, _ = tracking._gather_ref(_t(level0["ref_v"]), _t(level0["ref_n"]),
                                 _t(px), _t(py), 120, 160, "nearest")
    blended = (tv != nv).any(-1) & (tn[..., 0] != -2.0)
    assert 1000 < int(blended.sum()) < blended.numel()


@pytest.mark.parametrize("assoc", ["nearest", "bilinear"])
def test_status_image_matches_jax(level0, assoc):
    _, _, want = _jax_association(level0, assoc)
    got = tracking.track_kernel(
        *(_t(level0[k]) for k in ("in_v", "in_n", "ref_v", "ref_n", "start")),
        _t(_view(level0)), assoc=assoc)
    np.testing.assert_array_equal(got.result.numpy(),
                                  np.asarray(want.result))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("robust", ["huber", "tukey"])
def test_robust_sums_match_jax(jax_track_data, robust):
    td = jax_track_data
    delta = 0.01
    want = jtr.reduce_kernel(td, robust=robust, robust_delta=delta)
    ttd = tracking.TrackData(_t(td.result), _t(td.error), _t(td.J))
    got = tracking.reduce_kernel(ttd, robust=robust, robust_delta=delta)
    w = tracking.robust_weights(ttd, robust, delta).numpy().astype(
        np.float64).reshape(-1)
    e = np.asarray(td.error, np.float64).reshape(-1)
    J = np.asarray(td.J, np.float64).reshape(-1, 6)
    ok = (np.asarray(td.result) == 1).reshape(-1)
    # the IRLS weights cut some pixels down and leave the sums unweighted
    assert 0 < (w[ok] < 1).sum() < ok.sum()
    abs_sums = (np.sum(ok * e * e), np.abs(w[:, None] * e[:, None] * J).sum(0),
                np.abs(w[:, None, None] * J[:, :, None] * J[:, None, :])
                .sum(0), ok.sum())
    for wt, g, a in zip(want, got, abs_sums):
        wt, g = np.asarray(wt, np.float64), g.numpy().astype(np.float64)
        bad = np.abs(g - wt) > 1e-5 * np.abs(wt) + 1e-6 * np.asarray(a)
        assert not bad.any(), (g[bad], wt[bad])
    assert float(got[0]) == pytest.approx(float(tracking.reduce_kernel(
        ttd)[0]), rel=0) and float(got[3]) == float(want[3])


@pytest.mark.parametrize("gate", [False, True])
def test_gated_symmetric_residuals_match_jax(gate):
    """``symmetric`` as a bool tensor, the form the ``"auto"`` gate
    passes: each value selects the same normal as JAX's."""
    rng = np.random.default_rng(1)
    n = 2048
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)
                      ).astype(np.float32)
    pv = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rv = (pv + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    pn = unit(rng.normal(0, 1, (n, 3)))
    rn = unit(pn + rng.normal(0, 0.5, (n, 3)))
    args = (pv, pn, rv, rn, rng.random(n) < 0.95, rng.random(n) < 0.05)
    want = jtr._residuals(*(jnp.asarray(x) for x in args), 0.1, 0.8,
                          symmetric=jnp.asarray(gate))
    got = tracking._residuals(*(_t(x) for x in args), 0.1, 0.8,
                              symmetric=torch.tensor(gate))
    plain = tracking._residuals(*(_t(x) for x in args), 0.1, 0.8,
                                symmetric=gate)
    np.testing.assert_array_equal(got.result.numpy(), np.asarray(want.result))
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error),
                               rtol=0, atol=1e-6)
    assert torch.equal(got.error, plain.error)


@pytest.mark.parametrize("knobs", [dict(assoc="bilinear"),
                                   dict(robust="huber"),
                                   dict(robust="tukey", robust_delta=0.02)],
                         ids=["bilinear", "huber", "tukey"])
def test_track_knobs_match_jax(maps, knobs):
    args = ([maps[k] for k in ("depths", "vertices", "normals")]
            + [maps["ref_v"], maps["ref_n"], maps["rpose"]])
    jpose, jok, jres = jtr.track(
        jnp.asarray(maps["start"]),
        *[[jnp.asarray(x) for x in a] if isinstance(a, list)
          else jnp.asarray(a) for a in args],
        jnp.asarray(K), ITERS, 1e-5, finest_decimate=2, **knobs)
    tpose, tok, tres = tracking.track(
        _t(maps["start"]),
        *[[_t(x) for x in a] if isinstance(a, list) else _t(a)
          for a in args],
        _t(K), ITERS, 1e-5, finest_decimate=2, **knobs)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=0,
                               atol=1e-5)
    assert _flips(tres.numpy(), np.asarray(jres)) <= 1e-3
