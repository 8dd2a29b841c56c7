"""The port's multi-device map (``supereight_tpu_torch.parallel``) against
the JAX package's (``supereight_tpu.parallel``): the cases of
``tests/test_sharding.py`` at its sizes (48x64 frames, 64^3 over 4.8 m,
capacity 1024, the 4-frame orbit), D = 2 and 4, and D = 8 once.

The JAX side runs in this process on ``make_mesh(D)``; the port's ranks
are worker processes of ``parallel.multihost`` over gloo on the CPU, each
spawn under its own timeout, every case of one D in one spawn.  Two
comparisons per sharded frame (the JAX package's own 1-vs-N tolerances,
`tests/test_sharding.py:324-345`, and its bit-for-bit rule for what is
defined, `torch_port_util.step_split`):

* the port's D-rank frame against its own one-device frame with
  ``map_partitions = D``: ``n_blocks`` and ``part_counts`` equal, pose
  within 1e-4, ``ref_vertex`` within 1e-3, live voxels within 1e-4;
* the port's D-rank frame stepped from the JAX D-device frame's states:
  tracking within 1e-3 m, then from JAX's pose the counts and the
  ``block_index`` / ``keys`` / ``active`` / ``part_counts`` tables bit for
  bit on every rank, and the live voxels of the brick table bit for bit.
"""

import dataclasses
import functools
import inspect
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from supereight_tpu.config import Configuration
from supereight_tpu.core import octree as jo
from supereight_tpu.core.octree import ChannelSpec as JaxSpec
from supereight_tpu.io import serialise as jser
from supereight_tpu.io.synthetic import orbit_poses, render_depth
from supereight_tpu.parallel import frame_dist as jfd
from supereight_tpu.parallel import make_mesh
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline.system import process_frame

from supereight_tpu_torch import convert
from supereight_tpu_torch.config import SlamConfig
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.octree import ChannelSpec
from supereight_tpu_torch.io import serialise
from supereight_tpu_torch.parallel import frame_dist, multihost
from supereight_tpu_torch.parallel.sharding import Comm
from supereight_tpu_torch.pipeline import DenseSLAMSystem
from torch_port_util import (assert_split, map_to_numpy, split_want,
                             state_to_numpy)

H, W = 48, 64
K4 = np.asarray([48.0 * W / 160, 48.0 * H / 120, W / 2.0, H / 2.0],
                np.float32)
#: seconds each spawn of D ranks may take, the whole spawn
SPAWN_TIMEOUT = 200
MAX_VISIBLE = 256

#: the sharded-frame cases of tests/test_sharding.py: SlamConfig knobs over
#: the small configuration, frames, orbit sweep, ranks
FRAME_CASES = {
    "sdf-2": (dict(), 4, 0.02, 2),
    "sdf-4": (dict(), 4, 0.02, 4),
    "alloc-rate": (dict(alloc_rate=2), 8, 0.02, 2),
    "headline-knobs": (dict(alloc_rate=2, raycast_grad_decim=2,
                            raycast_normals="hybrid",
                            raycast_adaptive_deg=3.8,
                            raycast_adaptive_dist=0.07), 10, 0.03, 2),
    "ofusion": (dict(field_type="ofusion"), 4, 0.02, 2),
    "ofusion-adaptive": (dict(field_type="ofusion", alloc_adaptive_deg=2.0,
                              alloc_adaptive_dist=0.05), 8, 0.03, 2),
    "ofusion-on-demand": (dict(field_type="ofusion", alloc_on_demand=0.01),
                          8, 0.03, 2),
    "sym-auto": (dict(icp_symmetric="auto", icp_sym_min_deg=0.01), 4, 0.02,
                 2),
}
#: the one eight-rank case: the SDF frame against the one-device frame
EIGHT = (dict(), 4, 0.02, 8)


def small(**kw):
    return multihost.small_config(**kw)


def jax_config(D, **kw):
    return Configuration(**small(**kw), map_partitions=D)


def render(n, sweep):
    poses = orbit_poses(n, 4.8, sweep=sweep)
    depths = [np.clip(np.asarray(render_depth(
        jnp.asarray(p), jnp.asarray(K4), 4.8, H, W)) * 1000,
        0, 65535).astype(np.uint16) for p in poses]
    return np.stack(depths), np.asarray(poses)


def jax_sharded_states(D, knobs_cfg, depths):
    """The JAX D-device frame over ``depths``: the numpy state before and
    after every frame."""
    mesh = make_mesh(D)
    slam = JaxSLAM((H, W), jax_config(D, **knobs_cfg))
    st = jfd.frame_sharding(mesh)(slam.state)
    knobs = frame_dist.frame_knobs(SlamConfig(**small(**knobs_cfg)))
    step = jfd.make_process_frame_sharded(
        mesh, slam.field, H, W, max_visible_per_device=MAX_VISIBLE, **knobs)
    jstep = jax.jit(functools.partial(step, use_gt=False, neg_y=False))
    before, after = [], []
    for i, d in enumerate(depths):
        before.append(state_to_numpy(jax.device_get(st)))
        st = jstep(st, jnp.asarray(d), jnp.asarray(K4),
                   jnp.asarray(i, jnp.int32), jnp.eye(4, dtype=jnp.float32))
        after.append(state_to_numpy(jax.device_get(st)))
    return before, after


def jax_gt_state(depths, poses, partitions=1, field_type="sdf"):
    """A JAX map and reference state after ground-truth frames (the
    fixture of test_sharding.py's stage cases)."""
    cfg = jax_config(partitions, field_type=field_type)
    slam = JaxSLAM((H, W), cfg)
    fn = functools.partial(
        process_frame, field=slam.field, iterations=slam.iterations,
        tracking_rate=1, integration_rate=1, bilateral=False,
        icp_threshold=1e-5, use_gt=False, neg_y=False)
    step = jax.jit(fn)
    state = slam.state
    for i, d in enumerate(depths):
        state = step(state, jnp.asarray(d), jnp.asarray(K4),
                     jnp.asarray(i, jnp.int32), jnp.asarray(poses[i]))
    return slam, state


@pytest.fixture(scope="module")
def frames():
    return render(4, 0.02)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, frames):
    """Every spawn of the module: the JAX runs first, then one spawn of D
    ranks for all of D's jobs.  Returns {case: results}."""
    from supereight_tpu.pipeline import camera, preprocessing, raycast
    from supereight_tpu.pipeline import integration
    from supereight_tpu.pipeline.constants import FAR_PLANE, NEAR_PLANE
    tmp = tmp_path_factory.mktemp("ranks")
    jobs = {2: [], 4: [], 8: []}
    out = {}

    def add(ranks, name, job, **extra):
        jobs[ranks].append((name, job))
        out[name] = dict(extra)

    for name, (kw, n, sweep, D) in list(FRAME_CASES.items()) + [
            ("sdf-8", EIGHT)]:
        depths, poses = render(n, sweep)
        path = str(tmp / f"{name}.npz")
        np.savez(path, depths=depths, poses=poses, k=K4)
        frames_job = dict(kind="frames", config=small(**kw), frames=path,
                          max_visible=MAX_VISIBLE)
        add(D, name, frames_job, D=D, kw=kw)
        if D == 8:
            continue
        before, after = jax_sharded_states(D, kw, depths)
        spath = str(tmp / f"{name}.pkl")
        with open(spath, "wb") as f:
            pickle.dump(dict(depths=depths, k=K4, before=before,
                             after=after), f)
        add(D, name + "/split", dict(kind="split", config=small(**kw),
                                     states=spath, max_visible=MAX_VISIBLE),
            after=after)

    # the stage cases, from maps built with ground-truth poses
    depths, poses = frames
    kd = jnp.asarray(K4)
    K = np.asarray(camera.camera_matrix(kd))
    for D in (2, 4):
        inp = dict(depth=depths[1] / 1000.0, pose=poses[1], K=K, size=64,
                   dim=4.8, band=0.2)
        want = np.asarray(integration.sdf_wanted_mask(
            jnp.asarray(depths[1] / 1000.0, jnp.float32),
            jnp.asarray(poses[1]), jnp.asarray(K), size=64, dim=4.8,
            band=0.2, decim=1))
        path = str(tmp / f"mask{D}.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        add(D, f"mask-{D}", dict(kind="mask", inputs=path), want=want)

    slam, state = jax_gt_state(depths, poses)
    dp, vt, nm = preprocessing.build_pyramid(state.scaled_depth, kd, 3,
                                             neg_y=False)
    view = camera.camera_matrix(kd) @ jnp.linalg.inv(state.raycast_pose)
    from supereight_tpu.pipeline import tracking
    from supereight_tpu.parallel import tracking_dist
    td = tracking.track_kernel(vt[0], nm[0], state.ref_vertex,
                               state.ref_normal, state.pose, view)
    e2_s, JTe_s, JTJ_s, _ = tracking.reduce_kernel(td)
    x = tracking.solve_normal_equations(JTe_s, JTJ_s)
    pose_s = camera.se3_exp(x) @ state.pose
    pose_d, e2_d, _ = tracking_dist.track_step_sharded(
        make_mesh(2), state.pose, vt[0], nm[0], state.ref_vertex,
        state.ref_normal, view)
    inp = dict(pose=state.pose, in_vertex=vt[0], in_normal=nm[0],
               ref_vertex=state.ref_vertex, ref_normal=state.ref_normal,
               view=view)
    path = str(tmp / "reduce.pkl")
    with open(path, "wb") as f:
        pickle.dump({k: np.asarray(v) for k, v in inp.items()}, f)
    add(2, "reduce", dict(kind="reduce", inputs=path),
        pose_s=np.asarray(pose_s), e2_s=float(e2_s),
        pose_d=np.asarray(pose_d), e2_d=float(e2_d))

    def raycast_case(name, st, field_type, Hr=H, Wr=W, kr=K4, budget=256,
                     jax_ref=False, **kw):
        kk = jnp.asarray(kr)
        vw = st.pose @ camera.inverse_camera_matrix(kk)
        rc = None
        if jax_ref:
            # eager: the port's raycast follows JAX op by op (jitted XLA
            # fuses it into other roundings); ~13 s a call on this CPU
            with jax.disable_jit():
                rc = raycast.raycast(st.map, sl.field, vw, Hr, Wr,
                                     NEAR_PLANE, FAR_PLANE, **kw)
            rc = {k: np.asarray(getattr(rc, a)) for k, a in
                  (("t", "t_hit"), ("v", "vertex"), ("n", "normal"))}
        inp = dict(map=map_to_numpy(st.map), view=np.asarray(vw), H=Hr,
                   W=Wr, near=NEAR_PLANE, far=FAR_PLANE,
                   config=small(field_type=field_type),
                   kw=dict(kw, max_visible_per_device=budget))
        path = str(tmp / f"{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        add(2, name, dict(kind="raycast", inputs=path), jax=rc, inputs=inp)

    sl = slam
    raycast_case("frustum", state, "sdf", jax_ref=True)
    raycast_case("budget", state, "sdf", budget=2)
    k2 = np.asarray([48.0, 64.0, 80.0, 80.0], np.float32)
    raycast_case("hybrid", state, "sdf", Hr=160, Wr=160, kr=k2,
                 normals="hybrid")
    raycast_case("hybrid-gd2", state, "sdf", Hr=160, Wr=160, kr=k2,
                 normals="hybrid", grad_decim=2)
    sl, st8 = jax_gt_state(depths, poses, partitions=2)
    raycast_case("partitioned", st8, "sdf")
    sl, sto = jax_gt_state(depths, poses, field_type="ofusion")
    raycast_case("multiscale", sto, "ofusion", jax_ref=True)

    for D, js in jobs.items():
        res = multihost.launch_jobs(D, [j for _, j in js], device="cpu",
                                    backend="gloo", timeout=SPAWN_TIMEOUT,
                                    group_timeout=60)
        for (name, job), r in zip(js, res):
            out[name].update(job=job, ranks=r)
    return out


# ----------------------------------------------------------------------
# Owner-partitioned allocation on one device, bit for bit with JAX
# ----------------------------------------------------------------------

class TestOwnerPartitionedAllocation:
    """Morton-range (x-slab) owner partitioning of the slot space."""

    def _alloc_both(self):
        rng = np.random.default_rng(3)
        wanted = rng.random((8, 8, 8)) < 0.3
        out = []
        for parts in (1, 4):
            jm = jo.init(64, 4.8, (JaxSpec("v", jnp.float32, 0.0, 0.0),),
                         capacity=256, partitions=parts)
            jm = jo.allocate_block_mask(jm, jnp.asarray(wanted))
            tm = octree.init(64, 4.8, (ChannelSpec("v", torch.float32, 0.0,
                                                   0.0),), "cpu",
                             capacity=256, partitions=parts)
            tm = octree.allocate_block_mask(tm, torch.from_numpy(wanted))
            out.append((jm, tm))
        return out, wanted

    def test_same_block_set_and_counts(self):
        ((j1, t1), (j4, t4)), wanted = self._alloc_both()
        assert int(t1.n_blocks) == int(t4.n_blocks) == int(wanted.sum())
        for j, t in ((j1, t1), (j4, t4)):
            for name in ("block_index", "n_blocks", "part_counts", "active",
                         "overflow"):
                np.testing.assert_array_equal(
                    getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                    err_msg=name)
            np.testing.assert_array_equal(
                t.keys.numpy(), np.asarray(j.keys).astype(np.int64))
            np.testing.assert_array_equal(octree.slot_mask(t).numpy(),
                                          np.asarray(jo.slot_mask(j)))
        k1 = np.sort(t1.keys.numpy()[octree.slot_mask(t1).numpy()])
        k4 = np.sort(t4.keys.numpy()[octree.slot_mask(t4).numpy()])
        np.testing.assert_array_equal(k1, k4)

    def test_owner_locality(self):
        ((_, _), (_, t4)), _ = self._alloc_both()
        bc = octree.block_coords_table(t4).numpy()
        per_cap = t4.capacity // t4.partitions
        slab = t4.blocks_per_edge // t4.partitions
        for s in np.nonzero(octree.slot_mask(t4).numpy())[0]:
            owner = s // per_cap
            assert owner * slab <= bc[s, 0] < (owner + 1) * slab

    def test_incremental_and_overflow(self):
        spec = (ChannelSpec("v", torch.float32, 0.0, 0.0),)
        m = octree.init(64, 4.8, spec, "cpu", capacity=8, partitions=4)
        jm = jo.init(64, 4.8, (JaxSpec("v", jnp.float32, 0.0, 0.0),),
                     capacity=8, partitions=4)
        # 3 blocks in slab 0 -> one overflows its 2-slot partition
        w1 = np.zeros((8, 8, 8), bool)
        w1[0, 0, :3] = True
        w2 = np.zeros((8, 8, 8), bool)
        w2[7, 1, 1] = True
        for w in (w1, w2):
            m = octree.allocate_block_mask(m, torch.from_numpy(w))
            jm = jo.allocate_block_mask(jm, jnp.asarray(w))
            np.testing.assert_array_equal(m.part_counts.numpy(),
                                          np.asarray(jm.part_counts))
            assert int(m.overflow) == int(jm.overflow) == 1
            np.testing.assert_array_equal(m.block_index.numpy(),
                                          np.asarray(jm.block_index))
        assert m.part_counts.tolist() == [2, 0, 0, 1]
        with pytest.raises(ValueError, match="must divide"):
            octree.init(64, 4.8, spec, "cpu", capacity=8, partitions=3)


def test_partitioned_system_matches_jax_split(frames):
    """``map_partitions`` = 2 on one device through ``DenseSLAMSystem``,
    stepped from the JAX system's states (`torch_port_util.step_split`):
    tracking within 1e-3 m, then the counts and tables, ``part_counts``
    included, bit for bit."""
    from torch_port_util import step_split
    depths, _ = frames
    cfg = jax_config(2)
    jslam = JaxSLAM((H, W), cfg)
    port = DenseSLAMSystem((H, W), cfg, "cpu")
    assert port.state.map.partitions == 2
    for f, d in enumerate(depths):
        before = state_to_numpy(jslam.state)
        jslam.step(d, K4, f)
        after = state_to_numpy(jslam.state)
        got = step_split(port, before, after, d, K4, f)
        assert_split(got, split_want(after), f)
        np.testing.assert_array_equal(port.state.map.part_counts.numpy(),
                                      after["map"]["part_counts"])
    assert int(port.state.map.n_blocks) > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partitioned_checkpoint_both_ways(tmp_path, frames, writer):
    """A partitioned map's npz checkpoint, written by either package, loads
    in the other with the same tables and partitioning."""
    depths, poses = frames
    _, st = jax_gt_state(depths[:2], poses[:2], partitions=4)
    path = str(tmp_path / "map.npz")
    if writer == "jax":
        jser.save_map(path, st.map)
        m = serialise.load_map(path, device="cpu")
        j = st.map
    else:
        serialise.save_map(path, convert.map_from_numpy(
            map_to_numpy(st.map), "cpu"))
        m = convert.map_from_numpy(map_to_numpy(st.map), "cpu")
        j = jser.load_map(path)
    assert m.partitions == j.partitions == 4
    np.testing.assert_array_equal(m.part_counts.numpy(),
                                  np.asarray(j.part_counts))
    np.testing.assert_array_equal(m.block_index.numpy(),
                                  np.asarray(j.block_index))
    np.testing.assert_array_equal(m.keys.numpy(),
                                  np.asarray(j.keys).astype(np.int64))
    np.testing.assert_array_equal(octree.slot_mask(m).numpy(),
                                  np.asarray(jo.slot_mask(j)))
    for k, v in m.voxels.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j.voxels[k]))


# ----------------------------------------------------------------------
# Preconditions (JAX frame_dist.py:86-97, :140-150)
# ----------------------------------------------------------------------

def _port_state(D, partitions=None, capacity=1024):
    cfg = SlamConfig(**small(block_capacity=capacity,
                             map_partitions=partitions or D))
    return DenseSLAMSystem((H, W), cfg, "cpu")


@pytest.mark.parametrize("case", ["partitions", "capacity", "height",
                                  "half-res-rows", "normals"])
def test_preconditions_raise(case):
    comm = Comm(0, 4, "gloo")
    slam = _port_state(4)
    knobs = frame_dist.frame_knobs(slam.config)
    make = functools.partial(frame_dist.make_process_frame_sharded, comm,
                             slam.field, max_visible_per_device=64)
    if case == "partitions":
        with pytest.raises(ValueError, match="must equal"):
            frame_dist.frame_sharding(0, 4)(_port_state(2).state)
    elif case == "capacity":
        st = slam.state.replace(map=slam.state.map.replace(capacity=1023))
        with pytest.raises(ValueError, match="not divisible"):
            frame_dist.frame_sharding(0, 4)(st)
    elif case == "height":
        with pytest.raises(ValueError, match="image height"):
            make(50, W, **knobs)
    elif case == "half-res-rows":
        # 120x160 scans at half resolution: 8 ranks of 15 rows split the
        # half-res rows unevenly
        with pytest.raises(ValueError, match="even per-device"):
            frame_dist.make_process_frame_sharded(
                Comm(0, 8, "gloo"), slam.field, 120, 160,
                max_visible_per_device=64, **knobs)
    else:
        with pytest.raises(ValueError, match="volume/hybrid"):
            make(H, W, **dict(knobs, normals="stored"))


# ----------------------------------------------------------------------
# The sharded stages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4])
def test_sharded_mask_matches_single(runs, D):
    """Image-strip band march + one all_reduce == the full-frame mask of
    the JAX package, bit for bit, on every rank."""
    r = runs[f"mask-{D}"]
    for got in r["ranks"]:
        np.testing.assert_array_equal(got["mask"], r["want"])


def test_psum_reduction_matches_single_device(runs):
    """One ICP iteration with the all-reduced sums == the one-device
    iteration (JAX's tolerances) and == JAX's sharded one."""
    r = runs["reduce"]
    for got in r["ranks"]:
        np.testing.assert_allclose(got["pose"], r["pose_s"], atol=1e-5)
        np.testing.assert_allclose(got["error2"], r["e2_s"], rtol=1e-5)
        np.testing.assert_allclose(got["pose"], r["pose_d"], atol=1e-5)
    assert r["ranks"][0]["pose"].tobytes() == r["ranks"][1]["pose"].tobytes()


def _port_single_raycast(inp):
    from supereight_tpu_torch.pipeline import raycast
    from supereight_tpu_torch.pipeline.system import config_field
    m = convert.map_from_numpy(inp["map"], "cpu")
    kw = {k: v for k, v in inp["kw"].items()
          if k != "max_visible_per_device"}
    return raycast.raycast(m, config_field(SlamConfig(**inp["config"])),
                           torch.tensor(inp["view"]), inp["H"],
                           inp["W"], inp["near"], inp["far"], **kw)


@pytest.mark.parametrize("case", ["frustum", "partitioned", "multiscale",
                                  "hybrid", "hybrid-gd2"])
def test_exchange_raycast_matches_single(runs, case):
    """The frustum brick exchange + strip scan == the one-device raycast of
    the port, bit for bit, nothing dropped; for the SDF and the multiscale
    case also == the JAX package's (eager) at its tolerances (t_hit,
    vertex and normals 1e-4).  The port's one-device raycast is held to
    JAX's, hybrid normals included, in `tests/test_torch_raycast.py`."""
    r = runs[case]
    single = _port_single_raycast(r["inputs"])
    for got in r["ranks"]:
        assert int(got["dropped"].sum()) == 0
        np.testing.assert_array_equal(got["t_hit"], single.t_hit.numpy())
        np.testing.assert_array_equal(got["vertex"], single.vertex.numpy())
        np.testing.assert_array_equal(got["normal"], single.normal.numpy())
        if r["jax"] is not None:
            np.testing.assert_allclose(got["t_hit"], r["jax"]["t"],
                                       atol=1e-4)
            np.testing.assert_allclose(got["vertex"], r["jax"]["v"],
                                       atol=1e-4)
            np.testing.assert_allclose(got["normal"], r["jax"]["n"],
                                       atol=1e-4)
    assert (single.t_hit > 0).float().mean() > 0.3


def test_budget_overflow_reported(runs):
    """A too-small exchange budget counts the dropped blocks, on every
    rank alike."""
    r = runs["budget"]
    assert int(r["ranks"][0]["dropped"].sum()) > 0
    for got in r["ranks"]:
        np.testing.assert_array_equal(got["dropped"],
                                      r["ranks"][0]["dropped"])


# ----------------------------------------------------------------------
# The unified sharded frame
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(FRAME_CASES) + ["sdf-8"])
def test_frame_matches_single(runs, case):
    """The D-rank frame == the one-device frame with ``map_partitions = D``
    (`multihost.compare`: n_blocks and part_counts equal, pose 1e-4,
    ref_vertex 1e-3, live voxels 1e-4); the gates fired alike."""
    r = runs[case]
    multi = multihost.gather_ranks(r["ranks"])
    single = multihost.run_single(r["job"], r["D"], "cpu")
    multihost.compare(multi, single)
    a, b = multi["state"], single["state"]
    for key in ("alloc_count", "tracked", "integrated", "model_ref",
                "overflow"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(a["raycast_pose"], b["raycast_pose"],
                               atol=1e-4)
    np.testing.assert_allclose(a["prev_pose"], b["prev_pose"], atol=1e-4)
    np.testing.assert_allclose(a["alloc_pose"], b["alloc_pose"], atol=1e-4)
    assert a["overflow"] == 0
    if "adaptive" in case or case == "alloc-rate":
        assert a["alloc_count"] < len(multi["est"])   # the gate skipped
    # every rank holds the same replicated state
    for other in r["ranks"][1:]:
        for key in ("pose", "block_index", "keys", "active", "ref_vertex",
                    "track_result"):
            assert other["state"][key].tobytes() == \
                r["ranks"][0]["state"][key].tobytes(), key


@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_frame_matches_jax_split(runs, case):
    """The D-rank frame stepped from the JAX D-device frame's states:
    tracking within 1e-3 m, then from JAX's pose every count and table
    bit for bit (`torch_port_util.assert_split`, ``part_counts`` too) on
    every rank, and the live voxels bit for bit."""
    r = runs[case + "/split"]
    for f, want in enumerate(r["after"]):
        recs = [rk["records"][f] for rk in r["ranks"]]
        for rec in recs:
            assert_split(rec, split_want(want), f)
            np.testing.assert_array_equal(rec["part_counts"],
                                          want["map"]["part_counts"])
        m = want["map"]
        cap, D = m["capacity"], len(recs)
        per = cap // D
        live = (np.arange(cap) % per) < np.asarray(
            m["part_counts"])[np.arange(cap) // per]
        for name in m["voxels"]:
            table = np.concatenate([rec["voxels"][name] for rec in recs])
            want_t = np.asarray(m["voxels"][name])[live]
            if name == "occupancy":
                # log-odds: the port's OFusion rows within 1e-5 relative
                # (`tests/test_torch_integration.py`)
                np.testing.assert_allclose(table[live], want_t, rtol=1e-5,
                                           atol=1e-6,
                                           err_msg=f"frame {f}: {name}")
            else:
                np.testing.assert_array_equal(table[live], want_t,
                                              err_msg=f"frame {f}: {name}")


# ----------------------------------------------------------------------
# The launcher and the knob surface
# ----------------------------------------------------------------------

def test_launch_two_ranks_matches_single():
    """``multihost.launch``: 2 ranks over gloo on the CPU against the
    single-process control (the JAX launcher's small orbit), which it
    compares itself; no worker outlives it."""
    multi, single = multihost.launch(2, device="cpu", backend="gloo",
                                     timeout=SPAWN_TIMEOUT)
    assert multi["state"]["n_blocks"] == single["state"]["n_blocks"] > 0
    assert multi["diffs"]["pose"] <= 1e-4
    assert multi["launches_per_rank"] == [dict.fromkeys(
        ("fuse_sdf", "fuse_ofusion", "frustum_select", "update_nodes",
         "build_pyramid", "pose_inv", "splat_bounds", "ray_scan",
         "ray_scan_second", "ray_refine_normals"), 0)] * 2


def test_knob_surface_parity_is_pinned():
    """Every knob the one-device frame takes is either a keyword of the
    port's sharded frame or on the JAX package's own exclusion list
    (`tests/test_sharding.py:700-714`), and the port's sharded frame takes
    exactly the JAX sharded frame's keywords."""
    from supereight_tpu.parallel.frame_dist import \
        make_process_frame_sharded as jax_sharded
    jax_excluded = {"integrate_budget", "integrate_patch", "raycast_rate",
                    "coarse_alloc", "full_res_scan"}
    assert set(frame_dist.EXCLUDED) == jax_excluded
    # the SlamConfig fields that shape the state, the map or the field,
    # not a frame's stages
    state_fields = {"compute_size_ratio", "volume_resolution", "volume_size",
                    "initial_pos_factor", "mu", "block_capacity",
                    "incremental_view", "field_type", "ofusion_sigma_floor",
                    "map_partitions"}
    cfg_fields = {f.name for f in dataclasses.fields(SlamConfig)}
    assert set(frame_dist.KNOBS) == cfg_fields - state_fields
    port = set(inspect.signature(
        frame_dist.make_process_frame_sharded).parameters) \
        - {"comm", "field", "H", "W", "max_visible_per_device"}
    jax = set(inspect.signature(jax_sharded).parameters) \
        - {"mesh", "field", "H", "W", "axis", "_skip",
           "max_visible_per_device"}
    assert port == jax
    knobs = set(frame_dist.KNOBS.values())
    missing = knobs - port - jax_excluded
    assert not missing, f"knob(s) {sorted(missing)} not plumbed"
    assert not (jax_excluded & port), "exclusion list stale"
    assert not (port - knobs), f"sharded-only knobs {sorted(port - knobs)}"
