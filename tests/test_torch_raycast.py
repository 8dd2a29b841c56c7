"""Raycasting of the PyTorch port against the JAX package on a JAX map
carried over by ``convert.map_from_numpy`` (headline knobs, 160x120,
128^3, and an OFusion map of the ``ofusion-fidelity`` preset).

The bf16 read view must match bit for bit; hit masks agree on >= 99.9 % of
the pixels (the full-res scan, exact normals and interp refine, stored
normals, the plane refine and the midsolve: all of them), and where both
hit, vertices within 1e-4 m and normals within 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import raycast as jrc
from supereight_tpu.pipeline.constants import FAR_PLANE, NEAR_PLANE
from supereight_tpu_torch import convert
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.pipeline import raycast

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

FRAME = 8
H, W = 120, 160
K = K_FULL / 2
KNOBS = dict(second_window=True, span_factor=1.6, w2_budget=8192,
             scan_stride=1.0, near_rescue=True, grad_decim=2)


@pytest.fixture(scope="module")
def scene():
    depths, poses = load_frames()
    cfg = apply_preset("headline", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(FRAME):
        slam.step(depths[f], K, f)
    jm = slam.state.map
    view = np.asarray(jnp.asarray(poses[FRAME])
                      @ jcam.inverse_camera_matrix(jnp.asarray(K)))
    return dict(jmap=jm, tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"),
                view=view)


@pytest.fixture(scope="module")
def of_scene():
    """The JAX ``ofusion-fidelity`` map (mu 0.008) after its 5 bootstrap
    and tracked frames."""
    depths, poses = load_frames()
    cfg = apply_preset("ofusion-fidelity", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(5):
        slam.step(depths[f], K, f)
    jm = slam.state.map
    view = np.asarray(jnp.asarray(poses[5])
                      @ jcam.inverse_camera_matrix(jnp.asarray(K)))
    return dict(jmap=jm, tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"),
                view=view)


@pytest.fixture(scope="module")
def jax_raycasts(scene):
    """One JAX raycast per normals mode, shared by the tests."""
    return {n: jrc.raycast(scene["jmap"], JaxSDF(mu=0.1),
                           jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                           FAR_PLANE, normals=n, refine="secant", **KNOBS)
            for n in ("hybrid", "volume")}


def test_pack_view_matches_jax(scene):
    want = np.asarray(jrc.pack_view(scene["jmap"], JaxSDF(mu=0.1))["F"]
                      .astype(jnp.float32))
    got = raycast.pack_view(scene["tmap"], SDFField(mu=0.1))["F"]
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert np.isnan(want).any() and (want[ok] < 0).any()


def test_splat_bounds_match_jax(scene):
    jt = jrc._splat_bounds(scene["jmap"], JaxSDF(mu=0.1),
                           jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                           FAR_PLANE)
    tt = raycast._splat_bounds(scene["tmap"], SDFField(mu=0.1),
                               torch.from_numpy(scene["view"]), H, W,
                               NEAR_PLANE, FAR_PLANE)
    assert jt[2] == tt[2]
    for j, t in zip(jt[:2], tt[:2]):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        fin = np.isfinite(j)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("normals", ["hybrid", "volume"])
def test_raycast_matches_jax(scene, jax_raycasts, normals):
    want = jax_raycasts[normals]
    got = raycast.raycast(scene["tmap"], SDFField(mu=0.1),
                          torch.from_numpy(scene["view"]), H, W, NEAR_PLANE,
                          FAR_PLANE, normals=normals, **KNOBS)
    jv, tv = np.asarray(want.vertex), got.vertex.numpy()
    jn, tn = np.asarray(want.normal), got.normal.numpy()
    jhit, thit = jv.any(-1), tv.any(-1)
    assert jhit.mean() > 0.5
    assert (jhit == thit).mean() >= 0.999
    both = jhit & thit
    np.testing.assert_allclose(tv[both], jv[both], rtol=0, atol=1e-4)
    jok, tok = jn[..., 0] != -2.0, tn[..., 0] != -2.0
    assert (jok == tok).mean() >= 0.999
    ok = jok & tok
    np.testing.assert_allclose(tn[ok], jn[ok], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t_hit.numpy()[both],
                               np.asarray(want.t_hit)[both], rtol=0,
                               atol=1e-4)


FIELDS = {"sdf": (JaxSDF(mu=0.1), SDFField(mu=0.1)),
          "ofusion": (JaxOFusion(mu=0.008, voxel_size=4.8 / 128),
                      OFusionField(mu=0.008, voxel_size=4.8 / 128))}


@pytest.mark.parametrize("field,knobs", [
    ("sdf", dict(full_res_scan=True, normals="hybrid")),
    ("sdf", dict(normals="exact")),
    ("sdf", dict(refine="interp")),
    ("ofusion", dict(normals="exact", refine="interp")),
    ("ofusion", dict(full_res_scan=True, normals="volume"))])
def test_raycast_modes_match_jax(scene, of_scene, field, knobs):
    """The full-res scan (hybrid normals fall back to volume there), exact
    normals and the trilinear re-solve: every hit mask exactly."""
    sc = scene if field == "sdf" else of_scene
    jfield, tfield = FIELDS[field]
    base = dict(KNOBS, near_rescue=field == "sdf")
    want = jrc.raycast(sc["jmap"], jfield, jnp.asarray(sc["view"]), H, W,
                       NEAR_PLANE, FAR_PLANE, **base,
                       **dict(dict(normals="volume", refine="secant"),
                              **knobs))
    got = raycast.raycast(sc["tmap"], tfield, torch.from_numpy(sc["view"]),
                          H, W, NEAR_PLANE, FAR_PLANE, **base, **knobs)
    jv, tv = np.asarray(want.vertex), got.vertex.numpy()
    jn, tn = np.asarray(want.normal), got.normal.numpy()
    jhit, thit = jv.any(-1), tv.any(-1)
    assert jhit.mean() > 0.4
    np.testing.assert_array_equal(thit, jhit)
    np.testing.assert_allclose(tv[jhit], jv[jhit], rtol=0, atol=1e-4)
    jok, tok = jn[..., 0] != -2.0, tn[..., 0] != -2.0
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(tn[jok], jn[jok], rtol=0, atol=1e-3)


@pytest.mark.parametrize("field,knobs", [
    ("sdf", dict(normals="stored")),
    ("sdf", dict(normals="stored", refine="plane")),
    ("sdf", dict(normals="hybrid", midsolve=True)),
    ("ofusion", dict(normals="stored", refine="plane"))],
    ids=["stored", "stored-plane", "midsolve", "ofusion-stored-plane"])
def test_raycast_knobs_match_jax(scene, of_scene, field, knobs):
    """Stored normals (each package's table from the same map), the plane
    refine on them and the half-res midsolve: every hit mask exactly."""
    test_raycast_modes_match_jax(scene, of_scene, field, knobs)


# ---------------------------------------------------------------------------
# The raycast's phases as twins (the kernels R1-R4 of csrc/raycast.cu hold
# to them bit for bit on the card): each twin against its jitted JAX
# counterpart on the same inputs, and the twins composed against the
# composition the raycast had before it was cut into phases
# ---------------------------------------------------------------------------

import dataclasses
from types import SimpleNamespace

import jax

from supereight_tpu_torch.config import SlamConfig
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.pipeline import gradmap
from supereight_tpu_torch.pipeline.constants import INVALID
from supereight_tpu_torch.pipeline.preprocessing import norm

#: where jitted XLA and the twins round apart (XLA contracts multiply-adds
#: and rewrites divisions by constants), a sample point can land in the
#: next voxel: the share of rays or pixels whose hit may differ, and the
#: depth tolerance (m) where both hit
HIT_AGREE, Z_ATOL = 0.999, 1e-4


def _phase_inputs(sc, field, knobs=KNOBS):
    """The port's splat bounds, scan plan and scan inputs of a scene."""
    m, view = sc["tmap"], torch.from_numpy(sc["view"])
    dense = raycast.pack_view(m, field)
    plan = raycast.scan_plan(m, field, H, W, NEAR_PLANE, FAR_PLANE,
                             knobs["span_factor"], knobs["scan_stride"],
                             False)
    tmin, tmax, g = raycast._splat_bounds_twin(
        m, field, view, H, W, NEAR_PLANE, FAR_PLANE,
        near_rescue=knobs["near_rescue"])
    origin, dirs, fd = raycast._scan_dirs(view, plan)
    t0 = tmin.repeat_interleave(g // 2, 0).repeat_interleave(g // 2, 1)
    return SimpleNamespace(m=m, view=view, dense=dense, plan=plan, tmin=tmin,
                           tmax=tmax, g=g, origin=origin, dirs=dirs, fd=fd,
                           active=torch.isfinite(t0))


def _jax_dense(dense):
    return {"F": jnp.asarray(dense["F"].to(torch.float32).numpy())
            .astype(jnp.bfloat16)}


def _agree(hit_a, hit_b, z_a, z_b):
    """Hits agree on HIT_AGREE of the rays, depths within Z_ATOL where
    both hit."""
    hit_a, hit_b = np.asarray(hit_a), np.asarray(hit_b)
    assert (hit_a == hit_b).mean() >= HIT_AGREE
    both = hit_a & hit_b
    assert both.mean() > 0.2
    np.testing.assert_allclose(np.asarray(z_a)[both], np.asarray(z_b)[both],
                               rtol=0, atol=Z_ATOL)


@pytest.mark.parametrize("near_rescue", [True, False])
@pytest.mark.parametrize("given_inside", [False, True])
def test_splat_bounds_twin_matches_jitted_jax(scene, near_rescue,
                                              given_inside):
    """``_splat_bounds_twin`` (R1's twin) against jitted JAX
    ``_splat_bounds``, with and without the near-field rescue and the
    slots' inside flags given: the same finite cells, the depths within
    1e-5 m."""
    jm, tm = scene["jmap"], scene["tmap"]
    inside = None
    if given_inside:
        inside = SDFField(mu=0.1).is_inside(tm.voxels["tsdf"]).any(1)
    jfn = jax.jit(lambda v: jrc._splat_bounds(
        jm, JaxSDF(mu=0.1), v, H, W, NEAR_PLANE, FAR_PLANE,
        inside_any=None if inside is None else jnp.asarray(inside.numpy()),
        near_rescue=near_rescue))
    jt = jfn(jnp.asarray(scene["view"]))
    tt = raycast._splat_bounds_twin(tm, SDFField(mu=0.1),
                                    torch.from_numpy(scene["view"]), H, W,
                                    NEAR_PLANE, FAR_PLANE, near_rescue,
                                    inside)
    assert jt[2] == tt[2] == 8
    for j, t in zip(jt[:2], tt[:2]):
        j, t = np.asarray(j), t.numpy()
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        fin = np.isfinite(j)
        assert fin.mean() > 0.3
        np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-5)


def test_fine_scan_windows_match_jitted_jax(scene):
    """``ray_scan_twin`` (R2's twin) and ``ray_scan_second_twin`` (R3's,
    the second window) against jitted JAX ``_fine_scan`` on the same rays,
    start depths and active flags: hits on HIT_AGREE of the rays, depths
    within Z_ATOL."""
    field = SDFField(mu=0.1)
    p = _phase_inputs(scene, field)
    s1 = raycast.ray_scan_twin(p.m, p.dense, field, p.view, p.plan, p.tmin,
                               p.tmax, p.g)
    jm, jd = scene["jmap"], _jax_dense(p.dense)
    span, n = p.plan.fine_span, p.plan.n_fine
    jscan = jax.jit(lambda o, d, z0, a: jrc._fine_scan(
        jm, jd, JaxSDF(mu=0.1), o, d, z0, span, n, a))
    j = lambda t: jnp.asarray(t.numpy())
    j1 = jscan(j(p.origin), j(p.fd), j(s1.z_start), j(p.active))
    _agree(s1.hit.numpy(), j1.hit, s1.z.numpy(), j1.z_hit)

    idx = torch.nonzero(s1.need2.reshape(-1))[:, 0]
    assert idx.numel() > 100
    s2 = raycast.ray_scan_second_twin(p.m, p.dense, field, p.view, p.plan,
                                      s1, True, 8192, False)
    j2 = jscan(j(p.origin), j(p.fd.reshape(-1, 3)[idx]),
               j((s1.z_start + span).reshape(-1)[idx]),
               jnp.ones(idx.numel(), bool))
    _agree(s2.hit.reshape(-1)[idx].numpy(), j2.hit,
           s2.z.reshape(-1)[idx].numpy(), j2.z_hit)
    assert int(j2.hit.sum()) > 10
    rest = torch.ones(s1.hit.numel(), dtype=torch.bool)
    rest[idx] = False
    assert torch.equal(s2.hit.reshape(-1)[rest], s1.hit.reshape(-1)[rest])
    assert torch.equal(s2.z.reshape(-1)[rest], s1.z.reshape(-1)[rest])


@pytest.mark.parametrize("interp", [False, True])
def test_refine_matches_jitted_jax(scene, interp):
    """``_refine`` (R4's re-solve) against jitted JAX ``_refine`` on the
    scan's upsampled hits: the kept hits on HIT_AGREE of the pixels,
    depths within Z_ATOL, the pair flags on HIT_AGREE and the samples
    where both pair (nearest within 1e-6, trilinear within 1e-4)."""
    field = SDFField(mu=0.1)
    p = _phase_inputs(scene, field)
    s = raycast.ray_scan_twin(p.m, p.dense, field, p.view, p.plan, p.tmin,
                              p.tmax, p.g)
    z, hit = raycast._up2(s.z), raycast._up2(s.hit)
    delta = 0.7 * p.plan.thickness
    sub = 1.0 if interp else None
    got = raycast._refine(p.m, p.dense, field, p.origin, p.dirs, z, hit,
                          delta, sub)
    jm, jd = scene["jmap"], _jax_dense(p.dense)
    j = lambda t: jnp.asarray(t.numpy())
    want = jax.jit(lambda o, d, zz, hh: jrc._refine(
        jm, jd, JaxSDF(mu=0.1), o, d, zz, hh, delta, sub))(
        j(p.origin), j(p.dirs), j(z), j(hit))
    _agree(got[1].numpy(), want[1], got[0].numpy(), want[0])
    pair = got[4].numpy() & np.asarray(want[4])
    assert (got[4].numpy() == np.asarray(want[4])).mean() >= HIT_AGREE
    # the trilinear blend's sum XLA contracts into multiply-adds: 2e-5
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(a.numpy()[pair], np.asarray(b)[pair],
                                   rtol=0, atol=1e-4 if interp else 1e-6)


def test_grad6_matches_jitted_jax(scene):
    """``_grad6`` (R4's volume and hybrid gradient) against jitted JAX
    ``_grad6`` at the raycast's hit vertices: equal but where a tap's
    point lands in the next voxel (HIT_AGREE of the vertices)."""
    field = SDFField(mu=0.1)
    m, view = scene["tmap"], torch.from_numpy(scene["view"])
    rc = raycast.raycast(m, field, view, H, W, NEAR_PLANE, FAR_PLANE,
                         **KNOBS)
    dense = raycast.pack_view(m, field)
    got = raycast._grad6(m, dense, field, rc.vertex).numpy()
    want = np.asarray(jax.jit(lambda v: jrc._grad6(
        scene["jmap"], _jax_dense(dense), JaxSDF(mu=0.1), v))(
        jnp.asarray(rc.vertex.numpy())))
    hit = rc.vertex.abs().sum(-1).numpy() > 0
    assert hit.mean() > 0.5
    same = (got == want).all(-1)[hit]
    assert same.mean() >= HIT_AGREE


#: every normals and refine mode of the presets and of phase F, the
#: second window's budget cut, its absence and the midsolve without it
COMPOSE_CASES = [
    ("sdf", dict(raycast_normals="hybrid", raycast_grad_decim=2)),
    ("sdf", dict(raycast_normals="volume", raycast_near_rescue=False)),
    ("sdf", dict(raycast_normals="exact")),
    ("sdf", dict(raycast_normals="volume", raycast_refine="interp")),
    ("sdf", dict(raycast_normals="stored")),
    ("sdf", dict(raycast_normals="stored", raycast_refine="plane")),
    ("sdf", dict(raycast_normals="hybrid", raycast_midsolve=True)),
    ("sdf", dict(raycast_normals="hybrid", raycast_full_res_scan=True)),
    ("sdf", dict(raycast_normals="hybrid", raycast_w2_budget=16)),
    ("sdf", dict(raycast_normals="volume", raycast_second_window=False)),
    ("sdf", dict(raycast_normals="hybrid", raycast_second_window=False,
                 raycast_midsolve=True)),
    ("ofusion", dict(raycast_normals="hybrid", raycast_near_rescue=False)),
    ("ofusion", dict(raycast_normals="exact", raycast_refine="interp",
                     raycast_near_rescue=False)),
    ("ofusion", dict(raycast_normals="volume", raycast_near_rescue=False)),
]


def _composed_raycast(st, field, view, H, W, near, far, cfg):
    """The raycast as one composition of plain PyTorch, as it was before
    it was cut into phases (``st``: the map, held view and gradient
    table): (vertex, normal, t_hit)."""
    m, normals, refine = st.map, cfg.raycast_normals, cfg.raycast_refine
    dense = {"F": st.view} if st.view is not None else \
        raycast.pack_view(m, field)
    inside = field.is_inside(
        m.voxels[field.select_channel].to(torch.float32)).any(1)
    tgrid, tmax_grid, g = raycast._splat_bounds(
        m, field, view, H, W, near, far,
        near_rescue=cfg.raycast_near_rescue, inside_any=inside)
    vs, inv_vs = m.voxel_size, m.inverse_voxel_size
    thickness = field.mu if field.invert_normals else 2.0 * vs
    diag = 1.7320508 * octree.BLOCK_SIDE * vs
    half_res = H % 2 == 0 and W % 2 == 0 and W >= 160 and \
        not cfg.raycast_full_res_scan
    fine_step = cfg.raycast_scan_stride * thickness
    fine_span = cfg.raycast_span_factor * diag + 2.0 * thickness
    n_fine = int(np.clip(np.ceil(fine_span / fine_step) + 1, 8, 48))
    fine_span = n_fine * fine_step
    use_stored = normals == "stored"
    grad_table = st.grad

    def scan():
        origin, dirs = raycast.ray_directions(view, H, W)
        if half_res:
            fd = 0.25 * (dirs[0::2, 0::2] + dirs[1::2, 0::2]
                         + dirs[0::2, 1::2] + dirs[1::2, 1::2])
            rep = g // 2
        else:
            fd, rep = dirs, g
        h, w = fd.shape[:2]
        t0 = tgrid.repeat_interleave(rep, 0).repeat_interleave(rep, 1)[:h, :w]
        t1 = tmax_grid.repeat_interleave(rep, 0) \
            .repeat_interleave(rep, 1)[:h, :w]
        active = torch.isfinite(t0)
        z_start = torch.clamp(torch.where(active, t0, near), near, far)
        f1 = raycast._fine_scan(m, dense, field, origin, fd, z_start,
                                fine_span, n_fine, active)
        return origin, dirs, fd, z_start, active, t1, f1.hit, f1.z_hit

    origin, dirs, fd, z_start, active, t1, hit, z_hit = scan()
    h, w = fd.shape[:2]
    if cfg.raycast_second_window or cfg.raycast_midsolve:
        def window2():
            hit_, z_ = hit, z_hit
            if cfg.raycast_second_window:
                need2 = (active & ~hit_
                         & (z_start + fine_span < t1 + diag)).reshape(-1)
                idx = torch.nonzero(need2)[:, 0][
                    :min(cfg.raycast_w2_budget, h * w)]
                f2 = raycast._fine_scan(
                    m, dense, field, origin, fd.reshape(-1, 3)[idx],
                    (z_start + fine_span).reshape(-1)[idx], fine_span,
                    n_fine, torch.ones_like(idx, dtype=torch.bool))
                hit2 = torch.zeros(h * w, dtype=torch.bool,
                                   device=idx.device) \
                    .index_copy(0, idx, f2.hit).reshape(h, w)
                z2 = torch.zeros(h * w, device=idx.device) \
                    .index_copy(0, idx, f2.z_hit).reshape(h, w)
                z_ = torch.where(hit_, z_, z2)
                hit_ = hit_ | hit2
            if cfg.raycast_midsolve:
                z_ = raycast._midsolve(m, dense, field, origin, fd, z_, hit_,
                                       0.35 * thickness)
            return hit_, z_
        hit, z_hit = window2()

    z_half, hit_half = z_hit, hit
    rf = None
    if half_res:
        delta = 0.7 * thickness

        def refine_():
            if use_stored and refine == "plane":
                vert_h = origin + fd * z_half[..., None]
                g_h, _, _ = gradmap.sample(m, grad_table, vert_h * inv_vs)
                n_f, v_f = raycast._up2(g_h), raycast._up2(vert_h)
                z_, hit_ = raycast._up2(z_hit), raycast._up2(hit)
                denom = (dirs * n_f).sum(-1)
                numer = ((v_f - origin) * n_f).sum(-1)
                okp = torch.abs(denom) > 1e-9
                z_pl = torch.where(okp, numer / torch.where(okp, denom, 1.0),
                                   z_)
                z_ = torch.where(hit_, torch.minimum(torch.maximum(
                    z_pl, z_ - delta), z_ + delta), z_)
                return z_, hit_, None
            sub = next(c.init for c in m.channels
                       if c.name == field.select_channel) \
                if refine == "interp" else None
            z_, hit_, lo, hi, pair = raycast._refine(
                m, dense, field, origin, dirs, raycast._up2(z_hit),
                raycast._up2(hit), delta, sub)
            return z_, hit_, (lo, hi, pair)
        z_hit, hit, rf = refine_()

    def normals_():
        vertex = origin + dirs * z_hit[..., None]
        ray_norm = norm(dirs)
        t_hit = torch.where(hit, z_hit * ray_norm, 0.0)
        bad_grad = torch.zeros_like(hit)
        if use_stored:
            g_, _, _ = gradmap.sample(m, grad_table, vertex * inv_vs)
        elif normals == "hybrid" and half_res:
            rf_lo, rf_hi, rf_pair = rf
            vert_h = origin + fd * z_half[..., None]
            gd = int(cfg.raycast_grad_decim)
            if gd > 1 and h % gd == 0 and w % gd == 0:
                g_q = raycast._grad6(m, dense, field, vert_h[::gd, ::gd]) \
                    * inv_vs
                g_h = g_q.repeat_interleave(gd, 0).repeat_interleave(gd, 1)
                grad_ok_h = hit_half[::gd, ::gd].repeat_interleave(gd, 0) \
                    .repeat_interleave(gd, 1)
            else:
                g_h = raycast._grad6(m, dense, field, vert_h) * inv_vs
                grad_ok_h = torch.ones_like(hit_half)
            g_m = raycast._up2(g_h)
            rn = torch.clamp(ray_norm, min=1e-12)
            rhat = dirs / rn[..., None]
            d_ray = (rf_hi - rf_lo) / (2.0 * (0.7 * thickness) * rn)
            have = rf_pair & hit & raycast._up2(hit_half)
            corr = torch.where(have, d_ray - (g_m * rhat).sum(-1), 0.0)
            g_ = g_m + corr[..., None] * rhat
            bad_grad = ~raycast._up2(grad_ok_h)
        elif normals == "exact":
            g_ = octree.grad(m, field.select_channel, vertex * inv_vs)
        else:
            g_ = raycast._grad6(m, dense, field, vertex)
        if field.invert_normals:
            g_ = -g_
        gn = norm(g_, keepdim=True)
        normal = g_ / torch.clamp(gn, min=1e-12)
        bad = ~hit | (gn[..., 0] == 0) | bad_grad
        vertex = torch.where(hit[..., None], vertex, 0.0)
        invalid = torch.zeros_like(normal)
        invalid[..., 0] = INVALID
        return vertex, torch.where(bad[..., None], invalid, normal), t_hit

    return normals_()


@pytest.mark.parametrize("field,knobs", COMPOSE_CASES)
def test_twins_compose_the_raycast(scene, of_scene, field, knobs):
    """``raycast`` on the CPU (its phases' twins composed) equals, bit for
    bit, the raycast as one composition of plain PyTorch before it was cut
    into phases (:func:`_composed_raycast`)."""
    sc = scene if field == "sdf" else of_scene
    tfield = FIELDS[field][1]
    m, view = sc["tmap"], torch.from_numpy(sc["view"])
    cfg = dataclasses.replace(SlamConfig(), raycast_scan_stride=1.0,
                              **knobs)
    grad = gradmap.build_table(m, tfield) \
        if cfg.raycast_normals == "stored" else None
    st = SimpleNamespace(map=m, view=None, grad=grad)
    want = _composed_raycast(st, tfield, view, H, W, NEAR_PLANE,
                             FAR_PLANE, cfg)
    from chip_smoke import raycast_knobs
    got = raycast.raycast(m, tfield, view, H, W, NEAR_PLANE, FAR_PLANE,
                          grad_table=grad, **raycast_knobs(cfg))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float((got.vertex.abs().sum(-1) > 0).float().mean()) > 0.4


def test_second_window_budget_cuts_in_raster_order(scene):
    """A budget below the flagged rays' count (16 of them) scans exactly
    the first 16 in raster order, as ``nonzero(...)[:budget]`` (hazard of
    R3's ranks); the whole raycast at that budget agrees with jitted-free
    JAX's at the same budget."""
    field = SDFField(mu=0.1)
    p = _phase_inputs(scene, field)
    s1 = raycast.ray_scan_twin(p.m, p.dense, field, p.view, p.plan, p.tmin,
                               p.tmax, p.g)
    flagged = torch.nonzero(s1.need2.reshape(-1))[:, 0]
    assert flagged.numel() > 16
    s2 = raycast.ray_scan_second_twin(p.m, p.dense, field, p.view, p.plan,
                                      s1, True, 16, False)
    full = raycast.ray_scan_second_twin(p.m, p.dense, field, p.view, p.plan,
                                        s1, True, 8192, False)
    first = torch.zeros(s1.hit.numel(), dtype=torch.bool)
    first[flagged[:16]] = True
    new = (s2.hit & ~s1.hit).reshape(-1)
    assert bool(new.any()) and not bool((new & ~first).any())
    assert torch.equal(s2.hit.reshape(-1)[first], full.hit.reshape(-1)[first])
    assert int(full.hit.sum()) > int(s2.hit.sum())
    knobs = dict(KNOBS, w2_budget=16)
    want = jrc.raycast(scene["jmap"], JaxSDF(mu=0.1),
                       jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                       FAR_PLANE, normals="hybrid", **knobs)
    got = raycast.raycast(p.m, field, p.view, H, W, NEAR_PLANE, FAR_PLANE,
                          normals="hybrid", **knobs)
    jv, tv = np.asarray(want.vertex), got.vertex.numpy()
    _agree(tv.any(-1), jv.any(-1), got.t_hit.numpy(), want.t_hit)


def test_row_range_strip(scene):
    """Rank 1's strip of 2 (rows 60-119, the slots' inside flags given, as
    the sharded frame runs it) equals those rows of the whole image's
    raycast bit for bit, and JAX's strip within the tolerances."""
    field = SDFField(mu=0.1)
    m, view = scene["tmap"], torch.from_numpy(scene["view"])
    inside = field.is_inside(m.voxels["tsdf"]).any(1)
    strip = raycast.raycast(m, field, view, H, W, NEAR_PLANE, FAR_PLANE,
                            normals="hybrid", inside_any=inside,
                            row_range=(60, 60), **KNOBS)
    whole = raycast.raycast(m, field, view, H, W, NEAR_PLANE, FAR_PLANE,
                            normals="hybrid", **KNOBS)
    for a, b in zip(strip, whole):
        assert a.shape[0] == 60
        assert torch.equal(a, b[60:])
    want = jrc.raycast(scene["jmap"], JaxSDF(mu=0.1),
                       jnp.asarray(scene["view"]), H, W, NEAR_PLANE,
                       FAR_PLANE, normals="hybrid",
                       inside_any=jnp.asarray(inside.numpy()),
                       row_range=(60, 60), **KNOBS)
    _agree(strip.vertex.numpy().any(-1), np.asarray(want.vertex).any(-1),
           strip.t_hit.numpy(), want.t_hit)


def test_refine_moves_no_depth_that_is_read(scene):
    """``_refine`` may move the depth of a pixel whose parent missed (a
    crossing in its window); R4 skips those pixels, which is allowed
    because nothing reads that depth: ``ray_refine_normals_twin`` gives
    them vertex 0, ray distance 0 and the INVALID normal."""
    field = SDFField(mu=0.1)
    p = _phase_inputs(scene, field)
    s = raycast.ray_scan_twin(p.m, p.dense, field, p.view, p.plan, p.tmin,
                              p.tmax, p.g)
    hit = s.hit.clone()
    hit[::2] = False                       # half the parents' hits dropped
    z, _, _, _, _ = raycast._refine(
        p.m, p.dense, field, p.origin, p.dirs, raycast._up2(s.z),
        raycast._up2(hit), 0.7 * p.plan.thickness)
    missed = ~raycast._up2(hit)
    assert bool((z != raycast._up2(s.z))[missed].any())
    fin = raycast.ray_refine_normals_twin(p.m, p.dense, field, p.view,
                                          p.plan, s.z, hit, "secant",
                                          "hybrid", 2)
    assert not bool(fin.hit[missed].any())
    assert bool((fin.vertex[missed] == 0).all())
    assert bool((fin.t_hit[missed] == 0).all())
    assert bool((fin.normal[missed] == torch.tensor([-2.0, 0, 0])).all())
