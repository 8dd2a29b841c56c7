"""The frame's glue (the tracking pyramid, the 4x4 inverse, the fusion's
frustum selection and the node pyramid's update) in the PyTorch port
against the JAX package, on the CPU at small sizes (160x120, 64^3-128^3).

On the card each of these is a hand-written kernel held bit for bit to
its plain twin (``tests/test_torch_gpu.py``, ``chip_smoke.py``); here the
twins, which are the CPU path, are held to the jitted JAX functions:
- ``preprocessing.build_pyramid_twin`` to ``build_pyramid``, bit for bit;
- ``numerics.inv_twin`` to ``jnp.linalg.inv`` on every pose of the three
  cached sequences and on K, bit for bit;
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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    bit for bit, at budgets below and above the candidates' count; the
    port's overflow is a tensor."""
    jm = scene["map"]
    T_cw, Km = scene["T_cw"], scene["K"]
    cand = _jax_candidates(jm, T_cw, Km)
    want = np.asarray(jnp.nonzero(cand, size=budget, fill_value=-1)[0])
    n = int(cand.sum())
    assert 40 < n < 1000
    tm = _port_map(jm)
    slots, overflow = ik.frustum_select_twin(tm, _t(T_cw), _t(Km),
                                             (120, 160), budget)
    assert slots.dtype == torch.int32 and overflow.dtype == torch.int32
    np.testing.assert_array_equal(slots.numpy(), want)
    assert int(overflow) == int(jm.overflow) + max(n - budget, 0)
    # the dispatcher takes the twin for CPU tensors
    got = ik.frustum_select(tm, _t(T_cw), _t(Km), (120, 160), budget)
    assert torch.equal(got[0], slots) and torch.equal(got[1], overflow)


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
