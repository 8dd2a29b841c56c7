"""The PyTorch port's SLAM frame against the JAX package, frame by frame.

Both DenseSLAMSystems run the first 8 cached frames at 160x120
(``compute_size_ratio=2``), 128^3 over 4.8 m, capacity 4096, with the
headline knobs, from ``setPose(poses[0])``.  Per frame: ``tracked``, the
raycast-fired pattern, ``n_blocks`` and ``overflow`` are equal and the
pose translations agree within 1e-3 m (ICP amplifies rounding: the JAX
package's own fused and staged runs part by ~3e-4 m over these frames).
The port's ``step_staged`` equals its ``step`` bit for bit.

The ``ofusion`` preset (OFusion, integration every 4th frame, held read
view) runs the same frames.  Its ICP moves by up to ~2.4e-4 m from one
identical state (the JAX system under ``jit`` against the port), and that
compounds over free-running frames, so each port frame starts from the JAX
state of the frame before (``torch_port_util.step_split``): tracked equal,
the pose within 1e-3 m, and, from the JAX frame's pose, the counts, the
fired patterns and the block tables bit for bit.  A free-running port keeps
the JAX run's tracked, integrated and block counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch import convert
from supereight_tpu_torch.pipeline import DenseSLAMSystem, SlamConfig
from supereight_tpu_torch.pipeline import raycast, system

from torch_port_util import (K_FULL, assert_split, load_frames, split_want,
                             state_to_numpy, step_split)

torch.set_num_threads(1)

N_FRAMES = 8
K = K_FULL / 2


def _config(preset="headline", **kw):
    cfg = apply_preset(preset, Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    return dataclasses.replace(cfg, **kw)


def _record(st):
    a = lambda x: np.array(x)
    return dict(pose=a(st.pose), raycast_pose=a(st.raycast_pose),
                tracked=bool(st.tracked), n_blocks=int(st.map.n_blocks),
                overflow=int(st.map.overflow))


def _kept(st):
    """``st`` with its own copy of the map tables that a later frame's
    fusion updates in place, so that it stays the state after its frame."""
    m = st.map
    return st.replace(map=m.replace(
        voxels={k: v.clone() for k, v in m.voxels.items()},
        active=m.active.clone()))


@pytest.fixture(scope="module")
def runs():
    """JAX ``step``, the port's ``step`` and the port's ``step_staged``
    over the same frames; the port's states are kept whole."""
    depths, poses = load_frames()
    cfg = _config()
    jax_slam = JaxSLAM((240, 320), cfg)
    fused = DenseSLAMSystem((240, 320), cfg, "cpu")
    staged = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (jax_slam, fused, staged):
        s.setPose(poses[0])
    out = dict(jax=[], fused=[], staged=[], times=[], poses=poses)
    for f in range(N_FRAMES):
        out["jax"].append(_record(jax_slam.step(depths[f], K, f)))
        out["fused"].append(_kept(fused.step(depths[f], K, f)))
        st, times = staged.step_staged(depths[f], K, f)
        out["staged"].append(_kept(st))
        out["times"].append(times)
    return out


def test_frames_match_jax(runs):
    fired = []
    for f, (j, st) in enumerate(zip(runs["jax"], runs["fused"])):
        t = _record(st)
        assert t["tracked"] == j["tracked"], f
        assert t["n_blocks"] == j["n_blocks"], f
        assert t["overflow"] == j["overflow"], f
        # the raycast fired on this frame iff it moved raycast_pose to pose
        j_fired = np.array_equal(j["raycast_pose"], j["pose"])
        assert np.array_equal(t["raycast_pose"], t["pose"]) == j_fired, f
        fired.append(j_fired)
        np.testing.assert_allclose(t["pose"][:3, 3], j["pose"][:3, 3],
                                   rtol=0, atol=1e-3, err_msg=f"frame {f}")
    # the run covers bootstrap, tracked frames and the adaptive gate
    assert [j["tracked"] for j in runs["jax"]][3:] == [False] + [True] * 4
    assert any(fired) and not all(fired[3:])


def test_step_staged_equals_step(runs):
    for f, (a, b) in enumerate(zip(runs["fused"], runs["staged"])):
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if field.name == "map":
                for name in ("block_index", "keys", "n_blocks", "active",
                             "overflow"):
                    assert torch.equal(getattr(x, name), getattr(y, name))
                for name in x.voxels:
                    assert torch.equal(x.voxels[name], y.voxels[name]), f
            elif isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (f, field.name)
            else:
                assert x == y, (f, field.name)
    assert set(runs["times"][0]) == {"preprocessing", "tracking",
                                     "integration", "raycasting"}


def test_pose_buffers_are_distinct(runs):
    st = runs["fused"][-1]
    ptrs = [t.data_ptr() for t in (st.pose, st.raycast_pose, st.alloc_pose,
                                   st.prev_pose)]
    assert len(set(ptrs)) == 4


def test_stage_from_jax_state():
    """A port stage starts from a JAX mid-sequence state
    (``convert.state_from_numpy``) and integrates as the JAX stage does."""
    depths, poses = load_frames()
    cfg = _config()
    jax_slam = JaxSLAM((240, 320), cfg)
    jax_slam.setPose(poses[0])
    for f in range(2):
        jax_slam.step(depths[f], K, f)
    st = convert.state_from_numpy(state_to_numpy(jax_slam.state), "cpu")
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    port.state = st
    jst = jax_slam.step(depths[2], K, 2)
    tst = port.step(depths[2], K, 2)
    assert int(tst.map.n_blocks) == int(jst.map.n_blocks)
    assert tst.alloc_count == int(jst.alloc_count)
    np.testing.assert_allclose(tst.map.voxels["tsdf"].numpy(),
                               np.asarray(jst.map.voxels["tsdf"]), rtol=0,
                               atol=1e-5)


def test_slam_config_defaults_match_configuration():
    cfg = Configuration()
    for f in dataclasses.fields(SlamConfig):
        assert getattr(SlamConfig(), f.name) == getattr(cfg, f.name), f.name


@pytest.mark.parametrize("knob", [dict(map_partitions=2)])
def test_unported_knobs_raise(knob):
    """``map_partitions`` > 1 raised until partitioned maps were ported;
    now it builds a partitioned map and steps.  What still raises: a
    partition count that does not divide the block grid edge."""
    slam = DenseSLAMSystem((240, 320), _config(**knob), "cpu")
    assert slam.state.map.partitions == 2
    depths, poses = load_frames()
    slam.setPose(poses[0])
    st = slam.step(depths[0], K, 0)
    assert st.map.part_counts.sum() == st.map.n_blocks > 0
    assert (st.map.part_counts > 0).all()
    with pytest.raises(ValueError, match="must divide"):
        DenseSLAMSystem((240, 320), _config(map_partitions=3), "cpu")


@pytest.mark.parametrize("knob", [dict(raycast_normals="stored"),
                                  dict(raycast_refine="plane"),
                                  dict(raycast_midsolve=True),
                                  dict(icp_symmetric="auto"),
                                  dict(icp_robust="huber")],
                         ids=["stored", "plane", "midsolve", "sym-auto",
                              "huber"])
def test_ported_knobs_build_and_step(knob):
    """The knobs that raised before they were ported: each maps to the
    JAX Configuration's fields, builds, and steps a frame on the CPU."""
    jcfg = _config(**knob)
    cfg = SlamConfig.of(jcfg)
    for f in dataclasses.fields(SlamConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    depths, poses = load_frames()
    slam = DenseSLAMSystem((240, 320), jcfg, "cpu")
    slam.setPose(poses[0])
    st = slam.step(depths[0], K, 0)
    assert st.integrated and int(st.map.n_blocks) > 0
    assert (st.grad is not None) == (cfg.raycast_normals == "stored")


def test_headline_config_is_ported():
    cfg = SlamConfig.of(_config())
    assert (cfg.raycast_normals, cfg.integrate_budget, cfg.alloc_rate,
            cfg.raycast_adaptive_deg) == ("hybrid", 3072, 3, 3.8)
    assert system.SlamConfig.of(cfg) == cfg


@pytest.fixture(scope="module")
def of_runs():
    """The JAX ``ofusion`` preset over N_FRAMES (its state after each frame
    as numpy), the port stepped from each of those states, and a
    free-running port (``step`` and ``step_staged``)."""
    depths, poses = load_frames()
    cfg = _config("ofusion")
    jax_slam = JaxSLAM((240, 320), cfg)
    free = DenseSLAMSystem((240, 320), cfg, "cpu")
    staged = DenseSLAMSystem((240, 320), cfg, "cpu")
    forced = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (jax_slam, free, staged, forced):
        s.setPose(poses[0])
    out = dict(jax=[], forced=[], free=[], staged=[])
    before = state_to_numpy(jax_slam.state)
    for f in range(N_FRAMES):
        jst = jax_slam.step(depths[f], K, f)
        out["jax"].append(dict(_record(jst), integrated=bool(jst.integrated),
                               alloc_count=int(jst.alloc_count)))
        after = state_to_numpy(jst)
        out["forced"].append((split_want(after), step_split(
            forced, before, after, depths[f], K, f)))
        before = after
        out["free"].append(_kept(free.step(depths[f], K, f)))
        out["staged"].append(_kept(staged.step_staged(depths[f], K, f)[0]))
    return out


def test_ofusion_frames_match_jax(of_runs):
    fired = []
    for f, (want, got) in enumerate(of_runs["forced"]):
        assert_split(got, want, f)
        assert got["overflow"] == 0, f
        fired.append(want["fired"])
    # bootstrap fusion, then tracked frames that integrate every 4th
    assert [j["integrated"] for j in of_runs["jax"]] == [True] * 5 \
        + [False] * 3
    assert [j["tracked"] for j in of_runs["jax"]][4:] == [True] * 4
    assert fired == [False] * 3 + [True] * 5


def test_ofusion_free_run_matches_jax(of_runs):
    for f, (j, st) in enumerate(zip(of_runs["jax"], of_runs["free"])):
        assert st.tracked == j["tracked"], f
        assert st.integrated == j["integrated"], f
        assert int(st.map.n_blocks) == j["n_blocks"], f
        assert int(st.map.overflow) == j["overflow"], f


def test_ofusion_view_and_staged_run(of_runs):
    """The held view is the view of the map it was built from, and
    ``step_staged`` equals ``step`` bit for bit."""
    field = DenseSLAMSystem((240, 320), _config("ofusion"), "cpu").field
    for f, (a, b) in enumerate(zip(of_runs["free"], of_runs["staged"])):
        assert a.view.dtype == torch.bfloat16
        rebuilt = raycast.pack_view(a.map, field)["F"]
        assert torch.equal(torch.isnan(a.view), torch.isnan(rebuilt)), f
        assert torch.equal(torch.nan_to_num(a.view),
                           torch.nan_to_num(rebuilt)), f
        assert torch.equal(a.pose, b.pose) and a.tracked == b.tracked, f
        for name in a.map.voxels:
            assert torch.equal(a.map.voxels[name], b.map.voxels[name]), f
        assert torch.equal(torch.nan_to_num(a.view),
                           torch.nan_to_num(b.view)), f
