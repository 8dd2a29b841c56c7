"""The frame's glue (the tracking pyramid, the 4x4 inverse, the fusion's
frustum selection and the node pyramid's update) in the PyTorch port
against the JAX package, on the CPU at small sizes (160x120, 64^3-128^3).

On the card each of these is a hand-written kernel held bit for bit to
its plain twin (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here the
twins, which are the CPU path, are held to the jitted JAX functions:
- ``preprocessing.build_pyramid_twin`` to ``build_pyramid``, bit for bit;
- the pyramid kernel's tiles (``pyramid_kernel.tile_plan``), emulated:
  each CTA's pixels from its own region of level 0 alone, stitched, equal
  the twin's bit for bit at every level count the kernel takes;
- ``numerics.inv_twin`` to ``jnp.linalg.inv`` on every pose of the three
  cached sequences and on K, and on matrices that drive every pivot
  pattern of its LU (``chip_smoke.pivot_matrices`` of 1, 2 and 4 rows),
  bit for bit;
- ``integrate_kernel.frustum_select_twin`` to the budget branch of JAX's
  ``integrate`` (`supereight_tpu/pipeline/integration.py:515-536`, its
  ``jnp.nonzero(..., size=budget, fill_value=-1)`` and the overflow), bit
  for bit;
- ``integrate_kernel.update_nodes_twin`` to JAX's ``_update_nodes``: the
  SDF bit for bit, OFusion's timestamps bit for bit and its log-odds
  within 1e-5 relative (1e-6 absolute; PyTorch's CPU ``log`` is not
  XLA's);
- ``integration.integrate`` with the padded slots and the device overflow
  to the jitted JAX ``integrate`` at a budget the candidates overflow and
  at one they do not: blocks, overflow, ``active`` and the SDF tables bit
  for bit;
- a stepped run at the headline's knobs (``torch_port_util.step_split``).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

import chip_smoke

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.core import octree as joct
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import integration as jint
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import numerics
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.ops import integrate_kernel as ik
from supereight_tpu_torch.ops import pyramid_kernel as pk
from supereight_tpu_torch.pipeline import (DenseSLAMSystem, camera,
                                           integration, preprocessing)
from supereight_tpu_torch.pipeline.constants import INVALID

from torch_port_util import (K_FULL, assert_split, load_frames, map_to_numpy,
                             split_want, state_to_numpy, step_split)

torch.set_num_threads(1)

K = K_FULL / 2
FRAME = 6
SEQUENCES = ("synthetic_256_frames", "synthetic_256_frames_trans",
             "synthetic_256_frames_noisy")


def _config(preset="headline", **kw):
    cfg = apply_preset(preset, Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="module")
def scene():
    """The JAX headline map after frames 0..FRAME-1 at 128^3, frame
    FRAME's depth and true pose, K and the pose's inverse."""
    depths, poses = load_frames()
    slam = JaxSLAM((240, 320), _config())
    slam.setPose(poses[0])
    for f in range(FRAME):
        slam.step(depths[f], K, f)
    depth = jpre.mm_to_meters(jnp.asarray(depths[FRAME]), (120, 160))
    pose = poses[FRAME].astype(np.float32)
    return dict(map=slam.state.map, depth=np.asarray(depth), pose=pose,
                K=np.asarray(jcam.camera_matrix(jnp.asarray(K))),
                T_cw=np.asarray(jax.jit(jnp.linalg.inv)(pose)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_map(jm):
    return convert.map_from_numpy(map_to_numpy(jm), "cpu")


@pytest.mark.parametrize("neg_y", [False, True])
@pytest.mark.parametrize("sequence,frame", [("synthetic_256_frames", 33),
                                            ("synthetic_256_frames_noisy",
                                             70)])
def test_pyramid_twin_matches_jax(sequence, frame, neg_y):
    """``build_pyramid_twin`` at 160x120, three levels, against the jitted
    JAX pyramid: every level's depth, vertices and normals bit for bit."""
    depth = np.asarray(jpre.mm_to_meters(
        jnp.asarray(load_frames(sequence)[0][frame]), (120, 160))).copy()
    depth[50:70, 20:45] = 0.0
    jd, jv, jn = jpre.build_pyramid(jnp.asarray(depth), jnp.asarray(K), 3,
                                    neg_y=neg_y)
    td, tv, tn = preprocessing.build_pyramid_twin(
        torch.from_numpy(depth), torch.from_numpy(K), 3, neg_y)
    for level in range(3):
        for got, want in ((td, jd), (tv, jv), (tn, jn)):
            np.testing.assert_array_equal(got[level].numpy(),
                                          np.asarray(want[level]))
        invalid = np.asarray(jn[level])[..., 0] == INVALID
        assert invalid.any() and not invalid.all()


def _region_read(buf, plan, level, cta, y, x):
    """Level ``level``'s depth at the global pixels (y, x) (inside the
    image) from the CTAs' regions ``buf`` [CTAs, rows, columns], by each
    CTA's own region only: a pixel outside it fails the test."""
    by, bx = cta // plan.grid[1], cta % plan.grid[1]
    y0, x0 = plan.region(level, by, bx)
    ly, lx = y - y0, x - x0
    rows, cols = plan.levels[level].region
    assert bool((ly >= 0).all() and (ly < rows).all()
                and (lx >= 0).all() and (lx < cols).all()), \
        f"level {level}: a read outside the CTA's region"
    return buf[cta, ly, lx]


def _tile_emulation(depth, k, levels, neg_y):
    """``build_pyramid`` as ``csrc/pyramid.cu`` computes it, CTA by CTA of
    ``pyramid_kernel.tile_plan``: each stages its region of level 0
    (rows and columns outside the image clamped to the edge), computes its
    region of each coarser level from its region of the level before at
    the cells inside the image (reading through each level's clamped
    coordinates), and its owned pixels of every level from its region of
    that level alone; the owned pixels are stitched into the images, each
    exactly once.  Returns (depths, vertices, normals) as the twin."""
    H, W = depth.shape
    plan = pk.tile_plan(H, W, levels)
    n_cta = plan.grid[0] * plan.grid[1]
    cta = torch.arange(n_cta)
    by, bx = cta // plan.grid[1], cta % plan.grid[1]

    rows, cols = plan.levels[0].region
    y0, x0 = plan.region(0, by, bx)
    ry = (y0[:, None] + torch.arange(rows)).clamp(0, H - 1)
    rx = (x0[:, None] + torch.arange(cols)).clamp(0, W - 1)
    bufs = [depth[ry[:, :, None], rx[:, None, :]]]
    for level in range(1, levels):
        hs, ws = plan.levels[level - 1].shape
        h, w = plan.levels[level].shape
        rows, cols = plan.levels[level].region
        buf = torch.full((n_cta, rows, cols), float("nan"))
        y0, x0 = plan.region(level, by, bx)
        c, r, q = torch.meshgrid(cta, torch.arange(rows), torch.arange(cols),
                                 indexing="ij")
        y, x = y0[c] + r, x0[c] + q
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        c, r, q, y, x = (t[inside] for t in (c, r, q, y, x))
        src = bufs[-1]
        center = _region_read(src, plan, level - 1, c, 2 * y, 2 * x)
        t = torch.zeros_like(center)
        s = torch.zeros_like(center)
        for i in range(2):
            for j in range(2):
                cur = _region_read(src, plan, level - 1, c,
                                   (2 * y + i).clamp(max=hs - 1),
                                   (2 * x + j).clamp(max=ws - 1))
                ok = torch.abs(cur - center) < pk.E_D
                t = t + torch.where(ok, cur, 0.0)
                s = s + ok.to(torch.float32)
        buf[c, r, q] = t / torch.clamp(s, min=1e-20)
        bufs.append(buf)

    depths, vertices, normals = [depth], [], []
    for level, lv in enumerate(plan.levels):
        h, w = lv.shape
        oy, ox = by * lv.side, bx * lv.side
        c, i, j = torch.meshgrid(cta, torch.arange(lv.side),
                                 torch.arange(lv.side), indexing="ij")
        y, x = oy[c] + i, ox[c] + j
        mine = (y < h) & (x < w)
        c, y, x = c[mine], y[mine], x[mine]
        seen = torch.zeros((h, w), dtype=torch.int64)
        seen.index_put_((y, x), torch.ones_like(y), accumulate=True)
        assert bool((seen == 1).all()), "a pixel owned by no CTA or by two"
        ik_ = camera.inverse_camera_matrix(k / (1 << level))

        def vertex(yy, xx):
            d = _region_read(bufs[level], plan, level, c, yy, xx)
            v = torch.stack([
                d * numerics.fma(ik_[0, 0], xx.to(torch.float32), ik_[0, 2]),
                d * numerics.fma(ik_[1, 1], yy.to(torch.float32), ik_[1, 2]),
                d], dim=-1)
            return d, torch.where(d[:, None] > 0, v, 0.0)

        d, v = vertex(y, x)
        left = vertex(y, (x - 1).clamp(min=0))[1]
        right = vertex(y, (x + 1).clamp(max=w - 1))[1]
        below, above = (y + 1).clamp(max=h - 1), (y - 1).clamp(min=0)
        up = vertex(above if neg_y else below, x)[1]
        down = vertex(below if neg_y else above, x)[1]
        nrm = preprocessing.cross(right - left, up - down)
        nrm = nrm / torch.clamp(preprocessing.norm(nrm, keepdim=True),
                                min=1e-20)
        ok = ((v[:, 2] != 0) & (left[:, 2] != 0) & (right[:, 2] != 0)
              & (up[:, 2] != 0) & (down[:, 2] != 0))
        invalid = torch.zeros_like(nrm)
        invalid[:, 0] = INVALID
        nrm = torch.where(ok[:, None], nrm, invalid)
        if level:
            img = torch.full((h, w), float("nan"))
            img[y, x] = d
            depths.append(img)
        for out, val in ((vertices, v), (normals, nrm)):
            img = torch.full((h, w, 3), float("nan"))
            img[y, x] = val
            out.append(img)
    return depths, vertices, normals


def _pyramid_input(case):
    """The depth and intrinsics of a pyramid case: a cached headline
    frame at 320x240 or 160x120, or the 61x83 random depth with holes."""
    if case == "61x83":
        d, k = chip_smoke.random_depth()
        return torch.from_numpy(d), torch.from_numpy(k)
    ratio = {"320x240": 1, "160x120": 2}[case]
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(load_frames()[0][40].astype(np.int32)),
        (240 // ratio, 320 // ratio))
    return depth, torch.from_numpy(K_FULL / ratio).to(torch.float32)


@pytest.mark.parametrize("neg_y", [False, True])
@pytest.mark.parametrize("levels", range(1, pk.MAX_LEVELS + 1))
@pytest.mark.parametrize("case", ["320x240", "160x120", "61x83"])
def test_pyramid_tiles_match_twin(case, levels, neg_y):
    """The kernel's tiling, emulated on the CPU (:func:`_tile_emulation`),
    against ``build_pyramid_twin``: every level's depth, vertices and
    normals bit for bit, so each CTA's region of level 0 holds every pixel
    its owned pixels need, at every level count the kernel takes."""
    depth, k = _pyramid_input(case)
    got = _tile_emulation(depth, k, levels, neg_y)
    want = preprocessing.build_pyramid_twin(depth, k, levels, neg_y)
    for g, w in zip(got, want):
        assert len(g) == len(w) == levels
        for a, b in zip(g, w):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          b.numpy().view(np.int32))


@pytest.mark.parametrize("levels", range(1, pk.MAX_LEVELS + 2))
def test_pyramid_tile_plan(levels):
    """``tile_plan``: level sizes halve with ceil, the grid's tiles cover
    the coarsest level, every level's outputs lie end to end in one
    buffer and its views take each float once, a CTA's shared memory is
    at most ``kSmemFloats`` (exactly at the largest level count), and
    above that count it raises."""
    if levels > pk.MAX_LEVELS:
        with pytest.raises(ValueError, match="levels"):
            pk.tile_plan(61, 83, levels)
        return
    plan = pk.tile_plan(61, 83, levels)
    shapes = [(61, 83)]
    for _ in range(1, levels):
        shapes.append(((shapes[-1][0] + 1) // 2, (shapes[-1][1] + 1) // 2))
    assert [lv.shape for lv in plan.levels] == shapes
    h, w = shapes[-1]
    assert plan.grid == (-(-h // pk.TILE), -(-w // pk.TILE))
    off = 0
    for level, lv in enumerate(plan.levels):
        halo = 1 << (levels - 1 - level)
        assert lv.side == pk.TILE << (levels - 1 - level)
        assert lv.halo[0] == halo and lv.region[0] == lv.side + 2 * halo
        if level:
            assert lv.halo[1] == halo and lv.region[1] == lv.side + 2 * halo
        else:       # whole 16-byte loads from a multiple of four
            assert lv.halo[1] % 4 == 0 and lv.region[1] % 4 == 0
            assert lv.halo[1] >= halo
            assert lv.region[1] >= lv.halo[1] + lv.side + halo
        px = lv.shape[0] * lv.shape[1]
        if level:
            assert lv.depth == off
            off += px
        assert (lv.vertex, lv.normal) == (off, off + 3 * px)
        off += 6 * px
    assert plan.size == off
    # the wrapper's views: contiguous, every float of the output once
    seen = torch.zeros(plan.size, dtype=torch.int64)
    buf = torch.arange(plan.size, dtype=torch.float64)
    for im in plan.images:
        view = buf.as_strided(*im)
        assert view.is_contiguous()
        seen[view.reshape(-1).long()] += 1
    assert bool((seen == 1).all())
    assert [im[0] for im in plan.images] == \
        shapes[1:] + [s + (3,) for s in shapes] * 2
    assert plan.smem <= pk.SMEM_FLOATS
    assert (plan.smem == pk.SMEM_FLOATS) == (levels == pk.MAX_LEVELS)


PIVOT_MATRICES = chip_smoke.pivot_matrices()


def _same_inverse(got, want):
    """Bit for bit, NaN where NaN (XLA and the host do not keep the same
    NaN payloads)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got) & np.isnan(want)
    np.testing.assert_array_equal(np.where(nan, 0, got.view(np.int32)),
                                  np.where(nan, 0, want.view(np.int32)))


def test_pivot_matrices_drive_every_pivot_order():
    """The 24 row orders of ``chip_smoke.pivot_matrices`` give the 24
    pivot sequences a 4x4 LU can take (JAX's own ``lu_factor``)."""
    pivots = {tuple(np.asarray(jax.jit(jsl.lu_factor)(m)[1]))
              for name, m in PIVOT_MATRICES.items()
              if name.startswith("rows")}
    assert pivots == set(itertools.product(range(4), range(1, 4),
                                           range(2, 4), (3,)))


@pytest.mark.parametrize("name", [n for n, m in PIVOT_MATRICES.items()
                                  if m.shape[0] in (1, 2, 4)])
def test_inv_twin_matches_jax_pivot_patterns(name):
    """``inv_twin`` against the jitted ``jnp.linalg.inv`` on a matrix of
    ``chip_smoke.pivot_matrices`` of 1, 2 or 4 rows (row orders; zero,
    NaN, subnormal, infinite and huge pivots; subnormal products and
    entries; singular matrices; a NaN below the first row, alone and with
    an infinity): XLA's CPU inverse bit for bit, with its flush-to-zero of
    subnormals and OpenBLAS's pivot for a NaN.  Not at
    3 or more than 4 rows, where OpenBLAS's triangular solve and LU take
    another order than the twin's (``numerics.inv_twin``); the port
    inverts 4x4 matrices only, and on the card ``pose_inv`` is held to the
    twin at every size (``tests/test_torch_gpu.py``)."""
    m = PIVOT_MATRICES[name]
    _same_inverse(numerics.inv_twin(torch.from_numpy(m)).numpy(),
                  jax.jit(jnp.linalg.inv)(m))


INV_SPECIALS = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-39, -3e38,
                         3e38, 1.0], np.float32)


@pytest.mark.parametrize("n", numerics.INV_SIZES)
def test_inv_twin_matches_jax_fuzz(n):
    """``inv_twin`` against the jitted ``jnp.linalg.inv`` on 9000 random
    matrices of ``n`` rows (27000 over 1, 2 and 4), a tenth to a half of
    their entries replaced by zeros, NaN, infinities, subnormal and huge
    values: XLA's CPU inverse bit for bit, NaN where NaN (a twin that lets
    no NaN win the pivot misses some where a NaN lies below the first
    row)."""
    rng = np.random.default_rng(40 + n)
    A = rng.normal(size=(9000, n, n)).astype(np.float32)
    mask = rng.random(A.shape) < rng.choice([0.1, 0.25, 0.5], (9000, 1, 1))
    A[mask] = rng.choice(INV_SPECIALS, int(mask.sum()))
    want = np.asarray(jax.jit(jnp.linalg.inv)(A))
    got = np.stack([numerics.inv_twin(torch.from_numpy(a)).numpy()
                    for a in A])
    _same_inverse(got, want)


def test_inv_twin_matches_jax_on_every_pose():
    """``inv_twin`` on all 288 poses of the three cached sequences and on
    K at the two ratios: XLA's CPU inverse bit for bit."""
    mats = [p for s in SEQUENCES for p in load_frames(s)[1]]
    mats += [camera.camera_matrix(torch.from_numpy(K_FULL / r)).numpy()
             for r in (1, 2)]
    jinv = jax.jit(jnp.linalg.inv)
    got = np.stack([numerics.inv_twin(torch.from_numpy(
        np.asarray(m, np.float32))).numpy() for m in mats])
    want = np.stack([np.asarray(jinv(np.asarray(m, np.float32)))
                     for m in mats])
    np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_candidates(m, T_cw, K):
    """The candidate mask of JAX ``integrate``'s budget branch
    (`supereight_tpu/pipeline/integration.py:515-531`), 120x160 frame."""
    H, W = 120, 160
    voxel_size = m.voxel_size
    bc_full = joct.block_coords_table(m)
    live_full = joct.slot_mask(m) & m.active
    base_f = (bc_full * 8).astype(jnp.float32)
    centers_f = (base_f + 0.5 * 8) * voxel_size
    ccam_f, cpix_f = jint._project(T_cw, K, centers_f)
    diag = 1.7320508 * 8 * voxel_size
    foot_f = jnp.abs(K[0, 0]) * diag / jnp.maximum(ccam_f[..., 2], 1e-3)
    return (live_full & (ccam_f[..., 2] > -0.5 * diag)
            & (cpix_f[..., 0] >= -foot_f)
            & (cpix_f[..., 0] <= W - 1 + foot_f)
            & (cpix_f[..., 1] >= -foot_f)
            & (cpix_f[..., 1] <= H - 1 + foot_f))


@pytest.mark.parametrize("budget", [40, 200, 1000, 4095])
def test_frustum_select_twin_matches_jax(scene, budget):
    """The slots (``jnp.nonzero(cand, size=budget, fill_value=-1)``) and
    the overflow (plus ``max(count - budget, 0)``) of JAX's budget branch,
    bit for bit, at budgets below and above the candidates' count, and its
    ``T_cw`` (``jnp.linalg.inv(pose)``), bit for bit; the port's overflow
    is a tensor."""
    jm = scene["map"]
    T_cw, Km = scene["T_cw"], scene["K"]
    cand = _jax_candidates(jm, T_cw, Km)
    want = np.asarray(jnp.nonzero(cand, size=budget, fill_value=-1)[0])
    n = int(cand.sum())
    assert 40 < n < 1000
    tm = _port_map(jm)
    slots, overflow, got_T = ik.frustum_select_twin(
        tm, _t(scene["pose"]), _t(Km), (120, 160), budget)
    assert slots.dtype == torch.int32 and overflow.dtype == torch.int32
    np.testing.assert_array_equal(slots.numpy(), want)
    assert int(overflow) == int(jm.overflow) + max(n - budget, 0)
    _same_inverse(got_T.numpy(), T_cw)
    # the dispatcher takes the twin for CPU tensors
    got = ik.frustum_select(tm, _t(scene["pose"]), _t(Km), (120, 160),
                            budget)
    for a, b in zip(got, (slots, overflow, got_T)):
        assert torch.equal(a, b)


def _node_maps(field, jfield, size, seed):
    """A JAX map of ``size``^3 and its port copy whose node levels hold
    random values, half of their cells allocated."""
    rng = np.random.default_rng(seed)
    jm = joct.init(size, 4.8, jfield.channels, capacity=64)
    values, alloc = list(jm.node_values), list(jm.node_alloc)
    for level in range(1, jm.block_level + 1):
        s = (1 << level,) * 3
        if field.name == "sdf":
            vals = (rng.uniform(-1, 1, s), rng.integers(0, 12, s))
        else:
            vals = (rng.uniform(-20, 20, s), rng.uniform(0, 0.3, s))
        values[level] = {c.name: jnp.asarray(v.astype(np.float32))
                         for c, v in zip(jfield.channels, vals)}
        alloc[level] = jnp.asarray(rng.random(s) < 0.5)
    jm = jm.replace(node_values=values, node_alloc=alloc)
    return jm, _port_map(jm)


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("field_name", ["sdf", "ofusion"])
def test_update_nodes_twin_matches_jax(scene, size, field_name):
    """``update_nodes_twin`` against the jitted JAX ``_update_nodes`` on
    random node tables and a frame of the headline sequence."""
    now = float(np.float32(1 / 30) * np.float32(FRAME))
    if field_name == "sdf":
        field, jfield = SDFField(mu=0.1), JaxSDF(mu=0.1)
    else:
        vs = 4.8 / size
        field = OFusionField(mu=0.008, voxel_size=vs)
        jfield = JaxOFusion(mu=0.008, voxel_size=vs)
    jm, tm = _node_maps(field, jfield, size, size)
    args = (scene["depth"], scene["T_cw"], scene["K"])
    jnew = jax.jit(lambda m, d, T, Km, ts: jint._update_nodes(
        m, jfield, d, T, Km, ts))(jm, *args, jnp.float32(now))
    got = ik.update_nodes_twin(tm, field, *(_t(a) for a in args), now)
    assert ik.update_nodes(tm, field, *(_t(a) for a in args), now)[1] \
        .keys() == got[1].keys()
    changed = 0
    for level in range(1, tm.block_level + 1):
        for name, g in got[level].items():
            want = np.asarray(jnew.node_values[level][name])
            if name == "occupancy":
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), want)
            changed += int((want != np.asarray(
                jm.node_values[level][name])).sum())
    assert changed > 20


@pytest.mark.parametrize("budget", [64, 1024])
def test_integrate_padded_slots_match_jitted_jax(scene, budget):
    """``integrate`` through ``frustum_select``'s padded slots and the
    overflow it carries as a tensor, against the jitted JAX ``integrate``
    at a budget the candidates overflow (64) and at one they do not
    (1024: slots padded with -1): blocks, overflow, ``active``, the SDF
    tables and the node levels bit for bit."""
    jm = scene["map"]
    args = (scene["depth"], scene["pose"], scene["K"])
    jfield = JaxSDF(mu=0.1)
    jm2 = jax.jit(lambda m, d, p, Km: jint.integrate(
        m, jfield, d, p, Km, budget=budget))(jm, *args)
    tm2 = integration.integrate(_port_map(jm), SDFField(mu=0.1),
                                *(_t(a) for a in args), budget=budget)
    assert isinstance(tm2.overflow, torch.Tensor)
    dropped = int(jm2.overflow) - int(jm.overflow)
    assert (dropped > 0) == (budget == 64)
    assert int(tm2.overflow) == int(jm2.overflow)
    assert int(tm2.n_blocks) == int(jm2.n_blocks)
    np.testing.assert_array_equal(tm2.active.numpy(), np.asarray(jm2.active))
    for name in ("tsdf", "weight"):
        np.testing.assert_array_equal(tm2.voxels[name].numpy(),
                                      np.asarray(jm2.voxels[name]))
    for level in range(1, tm2.block_level + 1):
        for name in ("tsdf", "weight"):
            np.testing.assert_array_equal(
                tm2.node_values[level][name].numpy(),
                np.asarray(jm2.node_values[level][name]))


@pytest.mark.parametrize("budget", [None, 96])
def test_headline_stepped_matches_jax(budget):
    """Six frames at the headline's knobs (its budget, 3072, past the
    candidates' count at 128^3: padded slots; and 96, which they overflow)
    through ``step_split`` from each JAX state: tracked, the pose within
    1e-3 m, and from JAX's pose the counts (overflow included) and the
    block tables bit for bit."""
    depths, poses = load_frames()
    kw = {} if budget is None else dict(integrate_budget=budget)
    cfg = _config(**kw)
    jax_slam = JaxSLAM((240, 320), cfg)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (jax_slam, port):
        s.setPose(poses[0])
    overflow = 0
    for f in range(6):
        before = state_to_numpy(jax_slam.state)
        after = state_to_numpy(jax_slam.step(depths[f], K, f))
        want = split_want(after)
        assert_split(step_split(port, before, after, depths[f], K, f), want,
                     f)
        overflow = want["overflow"]
    assert (overflow > 0) == (budget == 96)
