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

The level loop runs as JAX's ``lax.while_loop`` does, its carry on the
device: every trip queued, those after the exit frozen.  On the CPU it
equals the host loop it replaced (reading the convergence test back every
trip, kept here as ``_host_level_loop``) bit for bit, trips included, in
every knob group; against JAX's jitted ``_level_loop`` it runs the same
trips and ends with the same ``converged``, poses within 1e-5, status flips
within 0.1 %.  The ICP kernels' twins (`ops/icp_kernel.py`) hold against
JAX's ``track_kernel`` and ``reduce_kernel`` (statuses bit for bit, sums
within rtol 1e-5 + 1e-6 times the sum of the terms' absolute values), and
the strip-sharded loop over 2 gloo ranks against the one-device loop
(poses within 1e-4, the multi-device tests' tolerance, the same trips).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu.pipeline import tracking as jtr
from supereight_tpu_torch.ops import icp_kernel
from supereight_tpu_torch.parallel import multihost
from supereight_tpu_torch.pipeline import camera, tracking
from supereight_tpu_torch.pipeline.preprocessing import norm

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


def _cam(m):
    """The raycast pose and the intrinsics, as ``track_levels`` and
    ``icp_track_levels`` take them in place of the view."""
    return _t(m["rpose"]), _t(K)


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


# ----------------------------------------------------------------------
# The level loop on the device (the JAX carry) and the ICP kernels' twins
# ----------------------------------------------------------------------

#: iterations by level (coarsest last) and the exit threshold of the loop
#: tests: level 2 exits early, level 1's one trip runs out
LOOP_ITERS = (16, 1, 16)
LOOP_THRESHOLD = 1e-4


def _carry(pose):
    zero = torch.zeros(())
    return tracking.TrackState(
        pose=pose, error2=zero, count=zero.clone(),
        converged=torch.zeros((), dtype=torch.bool),
        iteration=torch.zeros((), dtype=torch.int32))


def _host_level_loop(pose, error2, count, n_iters, iv, inm, rv, rn, view,
                     threshold, symmetric=False, robust="none",
                     robust_delta=0.01, assoc="nearest"):
    """The host loop the level loop replaced: the convergence test read
    back every trip.  Returns (pose, error2, count, status image, trips,
    converged)."""
    result = torch.zeros(iv.shape[:-1], dtype=torch.int32)
    trips, converged = 0, False
    for _ in range(n_iters):
        td = tracking.track_kernel(iv, inm, rv, rn, pose, view,
                                   symmetric=symmetric, assoc=assoc)
        error2, JTe, JTJ, count = tracking.reduce_kernel(td, robust,
                                                         robust_delta)
        x = tracking.solve_normal_equations(JTe, JTJ)
        pose = camera.se3_exp(x) @ pose
        result = td.result
        trips += 1
        converged = bool(norm(x) < threshold)
        if converged:
            break
    return pose, error2, count, result, trips, converged


def _levels(maps):
    """(level, input vertices, input normals) coarsest first, the finest
    strided by 2 as the system's ``icp_finest_decimate`` does."""
    out = []
    for level in (2, 1, 0):
        iv, inm = _t(maps["vertices"][level]), _t(maps["normals"][level])
        if level == 0:
            iv, inm = iv[::2, ::2], inm[::2, ::2]
        out.append((level, iv, inm))
    return out


def _knobs(symmetric, robust, assoc):
    return dict(symmetric={"off": False, "on": True,
                           "gate": torch.tensor(True)}[symmetric],
                robust=robust, assoc=assoc,
                robust_delta=0.02 if robust == "tukey" else 0.01)


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
@pytest.mark.parametrize("symmetric", ["off", "on", "gate"])
@pytest.mark.parametrize("assoc", ["nearest", "bilinear"])
def test_device_loop_equals_host_loop(maps, assoc, symmetric, robust):
    """Level by level, the device form's pose, error2, count and status
    image equal the host loop's bit for bit, with as many trips and the
    same exit; one level exits early and one runs out of trips; and
    ``track_levels`` over the same levels ends in the same carry."""
    kn = _knobs(symmetric, robust, assoc)
    rv, rn, view = _t(maps["ref_v"]), _t(maps["ref_n"]), _t(_view(maps))
    start = _t(maps["start"])
    st = _carry(start)
    host = (start, torch.zeros(()), torch.zeros(()))
    ran = []
    for level, iv, inm in _levels(maps):
        n = LOOP_ITERS[level]
        st, res = tracking._level_loop(st, n, iv, inm, rv, rn, view,
                                       LOOP_THRESHOLD, **kn)
        *host, hres, trips, conv = _host_level_loop(
            *host, n, iv, inm, rv, rn, view, LOOP_THRESHOLD, **kn)
        for got, want in zip((st.pose, st.error2, st.count, res),
                             (*host, hres)):
            assert torch.equal(got, want), level
        assert (int(st.iteration), bool(st.converged)) == (trips, conv)
        ran.append((trips, conv, n))
    assert any(conv and trips < n for trips, conv, n in ran), ran
    assert any(trips == n and not conv for trips, conv, n in ran), ran
    whole, res, _ = tracking.track_levels(
        start, [_t(v) for v in maps["vertices"]],
        [_t(v) for v in maps["normals"]], rv, rn, *_cam(maps), LOOP_ITERS,
        LOOP_THRESHOLD, finest_decimate=2, **kn)
    for got, want in zip(whole, st):
        assert torch.equal(got, want)
    assert torch.equal(res, hres)


#: the sharded loop's exits: the threshold that ends the coarsest level's
#: loop after its first trip, in the middle of its trips, or never
LOOP_EXITS = {"trip 0": 1e9, "middle": LOOP_THRESHOLD, "never": 0.0}


@pytest.mark.parametrize("exit_at", LOOP_EXITS)
def test_level_loop_order(maps, monkeypatch, exit_at):
    """The sharded frame's level loop on the CPU: n_iters calls of
    ``icp_track_reduce`` (the first with no pending sums, each other with
    the previous trip's) and one ``icp_update``, n_iters + 1 calls a
    level; each trip's update runs before the next trip's pass, and the
    passes and updates alternate until the exit, after which nothing runs;
    the carry and the status image equal the host loop's bit for bit."""
    level, iv, inm = _levels(maps)[0]
    n = LOOP_ITERS[level]
    rv, rn, view = _t(maps["ref_v"]), _t(maps["ref_n"]), _t(_view(maps))
    start = _t(maps["start"])
    events, calls = [], []
    track, update = tracking.track_kernel, icp_kernel.icp_update_twin
    reduce, last = icp_kernel.icp_track_reduce, icp_kernel.icp_update

    def track_kernel(*a, **kw):
        events.append("pass")
        return track(*a, **kw)

    def update_twin(sums, st, n_iters, *a, **kw):
        if bool(icp_kernel.live(st, n_iters)):
            events.append("update")
        return update(sums, st, n_iters, *a, **kw)

    def track_reduce(*a, pending=None, **kw):
        calls.append(("trip", pending is not None))
        return reduce(*a, pending=pending, **kw)

    def icp_update(*a, **kw):
        calls.append(("update", True))
        return last(*a, **kw)

    monkeypatch.setattr(tracking, "track_kernel", track_kernel)
    monkeypatch.setattr(icp_kernel, "icp_update_twin", update_twin)
    monkeypatch.setattr(icp_kernel, "icp_track_reduce", track_reduce)
    monkeypatch.setattr(icp_kernel, "icp_update", icp_update)
    threshold = LOOP_EXITS[exit_at]
    st, res = tracking._level_loop(_carry(start), n, iv, inm, rv, rn, view,
                                   threshold)
    assert calls == [("trip", False)] + [("trip", True)] * (n - 1) \
        + [("update", True)]
    trips = int(st.iteration)
    assert events == ["pass", "update"] * trips
    assert {"trip 0": trips == 1, "middle": 1 < trips < n,
            "never": trips == n}[exit_at], trips
    assert bool(st.converged) == (trips < n)
    monkeypatch.undo()
    *host, hres, h_trips, h_conv = _host_level_loop(
        start, torch.zeros(()), torch.zeros(()), n, iv, inm, rv, rn, view,
        threshold)
    for got, want in zip((st.pose, st.error2, st.count, res), (*host, hres)):
        assert torch.equal(got, want)
    assert (trips, bool(st.converged)) == (h_trips, h_conv)


def _composed_levels(start, levels, iters, rv, rn, view, threshold, **kn):
    """The one-device level loops as ``track_levels`` composed them before
    ``icp_track_levels``: ``_level_loop`` a level, coarsest first."""
    st = _carry(start.clone())
    res = None
    for level in range(len(levels) - 1, -1, -1):
        iv, inm = levels[level]
        st, res = tracking._level_loop(st, iters[level], iv, inm, rv, rn,
                                       view, threshold, **kn)
    return st, res


def _pyramid(maps, d):
    """The levels by index, the finest strided by ``d``."""
    levels = [(_t(v), _t(n)) for v, n in zip(maps["vertices"],
                                              maps["normals"])]
    levels[0] = tuple(a[::d, ::d] for a in levels[0])
    return levels


@pytest.mark.parametrize("decimate", [1, 2])
@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
@pytest.mark.parametrize("symmetric", ["off", "on", "gate"])
@pytest.mark.parametrize("assoc", ["nearest", "bilinear"])
def test_levels_twin_equals_level_loops(maps, assoc, symmetric, robust,
                                        decimate):
    """``icp_track_levels``' twin (the CPU path of ``track_levels``) equals
    the ``_level_loop`` composition it replaced bit for bit: the carry
    (pose, error2, count, converged, iteration) and the finest level's
    status image, with the finest level whole or strided by 2."""
    kn = _knobs(symmetric, robust, assoc)
    rv, rn, view = _t(maps["ref_v"]), _t(maps["ref_n"]), _t(_view(maps))
    start = _t(maps["start"])
    levels = _pyramid(maps, decimate)
    want, wres = _composed_levels(start, levels, LOOP_ITERS, rv, rn, view,
                                  LOOP_THRESHOLD, **kn)
    got, res = icp_kernel.icp_track_levels_twin(
        start, levels, rv, rn, view, LOOP_ITERS, LOOP_THRESHOLD, **kn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(res, wres) and res.shape == levels[0][0].shape[:2]
    # the wrapper takes the twin for CPU tensors; track_levels takes it
    again, ares = icp_kernel.icp_track_levels(
        start, levels, rv, rn, *_cam(maps), LOOP_ITERS, LOOP_THRESHOLD,
        **kn)
    whole, tres, n_px = tracking.track_levels(
        start, [_t(v) for v in maps["vertices"]],
        [_t(v) for v in maps["normals"]], rv, rn, *_cam(maps), LOOP_ITERS,
        LOOP_THRESHOLD, finest_decimate=decimate, **kn)
    assert n_px is None
    for st, r in ((again, ares), (whole, tres)):
        for a, b in zip(st, want):
            assert torch.equal(a, b)
        assert torch.equal(r, wres)


@pytest.mark.parametrize("iters", [(0, 5, 4), (4, 0, 10), (0, 0, 0)])
def test_levels_without_trips(maps, iters):
    """A level configured with 0 iterations runs no trip: the carry passes
    through it (its ``converged`` and ``iteration`` restart at 0), and where
    it is the finest level the status image is zeros, as JAX's
    ``_level_loop`` leaves it."""
    rv, rn, view = _t(maps["ref_v"]), _t(maps["ref_n"]), _t(_view(maps))
    start = _t(maps["start"])
    levels = _pyramid(maps, 2)
    want, wres = _composed_levels(start, levels, iters, rv, rn, view,
                                  LOOP_THRESHOLD)
    got, res = icp_kernel.icp_track_levels(start, levels, rv, rn,
                                           *_cam(maps), iters,
                                           LOOP_THRESHOLD)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(res, wres)
    if iters[0] == 0:
        assert not res.any() and int(got.iteration) == 0
        assert not bool(got.converged)
    if not any(iters):
        assert torch.equal(got.pose, start)
        assert float(got.error2) == float(got.count) == 0.0
    else:
        assert not torch.equal(got.pose, start)


def test_levels_twin_sums_are_the_last_trips(maps):
    """``sums`` takes the last trip's sums: one trip at the finest level
    from the start pose gives ``reduce_kernel``'s sums of that pose, and the
    carry's error2 and count are two of them."""
    rv, rn, view = _t(maps["ref_v"]), _t(maps["ref_n"]), _t(_view(maps))
    start = _t(maps["start"])
    levels = _pyramid(maps, 1)
    sums = torch.full((icp_kernel.N_SUMS,), float("nan"))
    st, res = icp_kernel.icp_track_levels(start, levels, rv, rn,
                                          *_cam(maps), (1, 0, 0),
                                          LOOP_THRESHOLD, sums=sums)
    td = tracking.track_kernel(*levels[0], rv, rn, start, view)
    want = icp_kernel.pack_sums(*tracking.reduce_kernel(td))
    assert torch.equal(sums, want) and torch.equal(res, td.result)
    assert float(st.error2) == float(sums[0])
    assert float(st.count) == float(sums[-1]) > 1000
    assert int(st.iteration) == 1


@pytest.mark.parametrize("frame", [0, REF, 57, 95])
def test_levels_wrapper_forms_the_view(maps, frame):
    """The wrapper takes the raycast pose and the intrinsics: on the CPU it
    forms the view (``tracking_view``, which ``view=`` takes) equal to
    JAX's ``camera_matrix(k) @ inv(raycast_pose)`` bit for bit, and runs
    the twin on it; ``track_levels`` passes both through."""
    _, poses = load_frames()
    rpose = poses[frame].astype(np.float32)
    want_view = np.asarray(jcam.camera_matrix(jnp.asarray(K))
                           @ jnp.linalg.inv(jnp.asarray(rpose)))
    rv, rn = _t(maps["ref_v"]), _t(maps["ref_n"])
    start = _t(maps["start"])
    levels = _pyramid(maps, 2)
    view = torch.full((4, 4), float("nan"))
    got, res = icp_kernel.icp_track_levels(start, levels, rv, rn, _t(rpose),
                                           _t(K), (2, 1, 1), LOOP_THRESHOLD,
                                           view=view)
    assert np.array_equal(view.numpy().view(np.int32),
                          want_view.view(np.int32))
    want, wres = icp_kernel.icp_track_levels_twin(
        start, levels, rv, rn, _t(want_view), (2, 1, 1), LOOP_THRESHOLD)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(res, wres)
    whole, tres, _ = tracking.track_levels(
        start, [_t(v) for v in maps["vertices"]],
        [_t(v) for v in maps["normals"]], rv, rn, _t(rpose), _t(K),
        (2, 1, 1), LOOP_THRESHOLD, finest_decimate=2)
    for a, b in zip(whole, want):
        assert torch.equal(a, b)
    assert torch.equal(tres, wres)


def test_levels_wrapper_rejects_a_device_without_kernel(maps):
    """Tensors on neither the CPU nor a CUDA device: ``icp_track_levels``
    raises rather than falling back to the twin (the CPU's view would
    need the twin's inverse), with or without a ``view`` to fill."""
    rv, rn = _t(maps["ref_v"]), _t(maps["ref_n"])
    start = _t(maps["start"])
    levels = _pyramid(maps, 2)
    meta = lambda t: t.to("meta")
    rpose, k = _cam(maps)
    for kw in (dict(), dict(view=torch.empty((4, 4), device="meta"))):
        with pytest.raises(ValueError, match="no kernel"):
            icp_kernel.icp_track_levels(
                meta(start), [tuple(map(meta, lv)) for lv in levels],
                meta(rv), meta(rn), meta(rpose), meta(k), LOOP_ITERS,
                LOOP_THRESHOLD, **kw)


def _jax_carry(pose):
    return jtr.TrackState(pose=jnp.asarray(pose), error2=jnp.zeros(()),
                          count=jnp.zeros(()),
                          converged=jnp.zeros((), bool),
                          iteration=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("knobs", [dict(), dict(symmetric=True),
                                   dict(assoc="bilinear", robust="huber",
                                        robust_delta=0.01)],
                         ids=["plain", "symmetric", "bilinear-huber"])
def test_level_loop_matches_jax(maps, knobs):
    """Each level's loop against the jitted JAX ``_level_loop``, each
    package carrying its own state: the same trips and exit, poses within
    1e-5, status flips within 0.1 %; then ``track`` against JAX's."""
    rv, rn, view = (maps["ref_v"], maps["ref_n"], _view(maps))
    st, jst = _carry(_t(maps["start"])), _jax_carry(maps["start"])
    exits = []
    for level, iv, inm in _levels(maps):
        n = LOOP_ITERS[level]
        jloop = jax.jit(lambda s, a, b, c, d, e, n=n: jtr._level_loop(
            s, n, a, b, c, d, e, LOOP_THRESHOLD, **knobs))
        jst, jres = jloop(jst, *(jnp.asarray(x.numpy()) for x in (iv, inm)),
                          jnp.asarray(rv), jnp.asarray(rn),
                          jnp.asarray(view))
        st, res = tracking._level_loop(st, n, iv, inm, _t(rv), _t(rn),
                                       _t(view), LOOP_THRESHOLD, **knobs)
        assert (int(st.iteration), bool(st.converged)) == \
            (int(jst.iteration), bool(jst.converged)), level
        np.testing.assert_allclose(st.pose.numpy(), np.asarray(jst.pose),
                                   rtol=0, atol=1e-5)
        assert _flips(res.numpy(), np.asarray(jres)) <= 1e-3
        exits.append(bool(st.converged) and int(st.iteration) < n)
    assert any(exits)
    args = ([maps[k] for k in ("depths", "vertices", "normals")]
            + [maps["ref_v"], maps["ref_n"], maps["rpose"]])
    jpose, jok, jres = jtr.track(
        jnp.asarray(maps["start"]),
        *[[jnp.asarray(x) for x in a] if isinstance(a, list)
          else jnp.asarray(a) for a in args],
        jnp.asarray(K), LOOP_ITERS, LOOP_THRESHOLD, finest_decimate=2,
        **knobs)
    tpose, tok, tres = tracking.track(
        _t(maps["start"]),
        *[[_t(x) for x in a] if isinstance(a, list) else _t(a)
          for a in args],
        _t(K), LOOP_ITERS, LOOP_THRESHOLD, finest_decimate=2, **knobs)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose), rtol=0,
                               atol=1e-5)
    assert _flips(tres.numpy(), np.asarray(jres)) <= 1e-3


def _abs_sums(result, error, J, w):
    """Per sum of the N_SUMS, the sum of its terms' absolute values."""
    ok = (result == 1).reshape(-1).astype(np.float64)
    e = error.astype(np.float64).reshape(-1)
    J = J.astype(np.float64).reshape(-1, 6)
    w = w.astype(np.float64).reshape(-1)
    jtj = np.abs(w[:, None, None] * J[:, :, None] * J[:, None, :]).sum(0)
    return np.concatenate([[np.sum(ok * e * e)],
                           np.abs(w[:, None] * e[:, None] * J).sum(0),
                           [jtj[b, a] for a, b in icp_kernel.TRIU],
                           [ok.sum()]])


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
@pytest.mark.parametrize("assoc", ["nearest", "bilinear"])
def test_icp_twins_match_jax(level0, assoc, robust):
    """Kernel A's twin at the start pose against the jitted JAX
    association and ``reduce_kernel``: the status image bit for bit, the
    sums within rtol 1e-5 + 1e-6 times their terms' absolute sum; kernel
    B's twin against JAX's solve and ``se3_exp``: pose within 1e-5."""
    delta = 0.02 if robust == "tukey" else 0.01
    _, _, td = _jax_association(level0, assoc)
    want = jtr.reduce_kernel(td, robust=robust, robust_delta=delta)
    st = _carry(_t(level0["start"]))
    iv = _t(level0["in_v"])
    st0, res, sums = icp_kernel.icp_track_reduce(
        iv, _t(level0["in_n"]), _t(level0["ref_v"]), _t(level0["ref_n"]),
        _t(_view(level0)), st, 1, torch.zeros(iv.shape[:2],
                                              dtype=torch.int32),
        torch.zeros(icp_kernel.N_SUMS), robust=robust, robust_delta=delta,
        assoc=assoc)
    assert st0 is st
    np.testing.assert_array_equal(res.numpy(), np.asarray(td.result))
    w = tracking.robust_weights(
        tracking.TrackData(_t(td.result), _t(td.error), _t(td.J)), robust,
        delta).numpy()
    a = _abs_sums(np.asarray(td.result), np.asarray(td.error),
                  np.asarray(td.J), w)
    wv = icp_kernel.pack_sums(*(torch.from_numpy(np.array(x))
                                for x in want)).numpy().astype(np.float64)
    got = sums.numpy().astype(np.float64)
    bad = np.abs(got - wv) > 1e-5 * np.abs(wv) + 1e-6 * a
    assert not bad.any(), (got[bad], wv[bad])
    assert float(sums[-1]) == float(want[3]) > 1000

    nxt = icp_kernel.icp_update(sums, st, 1, 1e-5)
    x = jtr.solve_normal_equations(want[1], want[2])
    jpose = np.asarray(jcam.se3_exp(x) @ jnp.asarray(level0["start"]))
    np.testing.assert_allclose(nxt.pose.numpy(), jpose, rtol=0, atol=1e-5)
    assert int(nxt.iteration) == 1 and not bool(nxt.converged)
    assert float(nxt.error2) == float(sums[0])
    # the level has ended: both twins leave everything as it was
    assert icp_kernel.icp_update(sums, nxt, 1, 1e-5) is nxt
    again = icp_kernel.icp_track_reduce(
        iv, _t(level0["in_n"]), _t(level0["ref_v"]), _t(level0["ref_n"]),
        _t(_view(level0)), nxt, 1, res, sums, robust=robust,
        robust_delta=delta, assoc=assoc)
    assert again[0] is nxt and again[1] is res and again[2] is sums


#: the sharded loop's cases: ICP knobs over the level tests' inputs
SHARD_KNOBS = {"plain": dict(),
               "bilinear-tukey-symmetric": dict(
                   assoc="bilinear", robust="tukey", robust_delta=0.02,
                   symmetric=True)}


@pytest.fixture(scope="module")
def sharded(maps, tmp_path_factory):
    """``tracking.track`` on 2 gloo ranks on the CPU (``multihost``'s
    ``track`` job), every case in one spawn."""
    tmp = tmp_path_factory.mktemp("track_ranks")
    jobs = []
    for name, kw in SHARD_KNOBS.items():
        inp = dict(pose=maps["start"], depths=maps["depths"],
                   vertices=maps["vertices"], normals=maps["normals"],
                   ref_vertex=maps["ref_v"], ref_normal=maps["ref_n"],
                   raycast_pose=maps["rpose"].astype(np.float32),
                   k=np.asarray(K, np.float32), iterations=LOOP_ITERS,
                   icp_threshold=LOOP_THRESHOLD, finest_decimate=2, kw=kw)
        path = str(tmp / f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        jobs.append(dict(kind="track", inputs=path))
    res = multihost.launch_jobs(2, jobs, device="cpu", backend="gloo",
                                timeout=200, group_timeout=60)
    return dict(zip(SHARD_KNOBS, res))


@pytest.mark.parametrize("name", sorted(SHARD_KNOBS))
def test_sharded_device_loop_matches_one_device(maps, sharded, name):
    """Every level's rows split into 2 strips, the sums all-reduced every
    trip: both ranks end with the same pose, bit for bit, within 1e-4 of
    the one-device loop's, with the same trips and exit at the finest
    level and the same divergence decision; the gathered status strips
    flip within 0.1 % of the one-device image."""
    kw = SHARD_KNOBS[name]
    args = ([[_t(x) for x in maps[k]] for k in ("depths", "vertices",
                                                "normals")]
            + [_t(maps["ref_v"]), _t(maps["ref_n"])])
    pose, ok, res = tracking.track(
        _t(maps["start"]), *args, _t(maps["rpose"].astype(np.float32)),
        _t(K), LOOP_ITERS, LOOP_THRESHOLD, finest_decimate=2, **kw)
    st, _, _ = tracking.track_levels(
        _t(maps["start"]), *args[1:], *_cam(maps), LOOP_ITERS,
        LOOP_THRESHOLD, finest_decimate=2, **kw)
    ranks = sharded[name]
    np.testing.assert_array_equal(ranks[0]["pose"], ranks[1]["pose"])
    for r in ranks:
        np.testing.assert_allclose(r["pose"], pose.numpy(), rtol=0,
                                   atol=1e-4)
        assert r["ok"] == bool(ok)
        assert (r["iteration"], r["converged"]) == \
            (int(st.iteration), bool(st.converged))
    strips = np.concatenate([r["result"] for r in ranks])
    assert strips.shape == tuple(res.shape)
    assert _flips(strips, res.numpy()) <= 1e-3
