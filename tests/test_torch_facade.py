"""The port's ``DenseSLAMSystem`` facade against the JAX package's: the
ground-truth mode (``step(gt_pose=)``), the four per-stage methods and the
accessors, over 8 cached frames at 160x120, 64^3 over 4.8 m, for the SDF
(``headline``) and the OFusion (``ofusion``) preset.

In ground-truth mode ICP is bypassed, so the two runs see the same poses
and the map is held bit for bit on every frame: the block set, the slots,
``active``, ``overflow``, the node pyramid's allocation, the poses,
``tracked``, the ICP status image, the SDF tables and the OFusion
timestamps.  Occupancy is held within ATOL: its logarithm is XLA's own
(measured: up to 3.8e-6 apart).
"""

import dataclasses

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch.pipeline import DenseSLAMSystem

from torch_port_util import K_FULL, load_frames

torch.set_num_threads(1)

K = K_FULL / 2
N_FRAMES = 8
ATOL = 1e-5


def _config(preset):
    return apply_preset(preset, Configuration(
        volume_resolution=(64,) * 3, volume_size=(4.8,) * 3,
        compute_size_ratio=2))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_map_equal(t, j, f):
    tm, jm = t.map, j.map
    assert int(tm.n_blocks) == int(jm.n_blocks) > 0, f
    assert int(tm.overflow) == int(jm.overflow), f
    np.testing.assert_array_equal(_np(tm.keys),
                                  _np(jm.keys).astype(np.int64))
    for name in ("block_index", "active"):
        np.testing.assert_array_equal(_np(getattr(tm, name)),
                                      _np(getattr(jm, name)), f"{f} {name}")
    for a, b in zip(tm.node_alloc, jm.node_alloc):
        np.testing.assert_array_equal(_np(a), _np(b))
    for name in ("tsdf", "weight", "timestamp"):
        if name in jm.voxels:
            np.testing.assert_array_equal(_np(tm.voxels[name]),
                                          _np(jm.voxels[name]),
                                          f"{f} {name}")
    if "occupancy" in jm.voxels:
        np.testing.assert_allclose(_np(tm.voxels["occupancy"]),
                                   _np(jm.voxels["occupancy"]), rtol=0,
                                   atol=ATOL, err_msg=f"frame {f}")


@pytest.fixture(scope="module", params=["headline", "ofusion"])
def gt_runs(request):
    """The JAX and the port system over N_FRAMES in ground-truth mode,
    checked after each frame."""
    depths, poses = load_frames()
    cfg = _config(request.param)
    jax_slam = JaxSLAM((240, 320), cfg)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    for f in range(N_FRAMES):
        j = jax_slam.step(depths[f], K, f, gt_pose=poses[f])
        t = port.step(depths[f], K, f, gt_pose=poses[f])
        assert t.tracked and bool(j.tracked)
        assert t.integrated == bool(j.integrated)
        for name in ("pose", "prev_pose", "track_result", "float_depth"):
            np.testing.assert_array_equal(_np(getattr(t, name)),
                                          _np(getattr(j, name)),
                                          f"{f} {name}")
        np.testing.assert_array_equal(_np(t.pose), poses[f])
        _assert_map_equal(t, j, f)
    return dict(preset=request.param, port=port, jax=jax_slam)


def test_ground_truth_mode_matches_jax(gt_runs):
    m = gt_runs["port"].state.map
    assert int(m.n_blocks) > 40
    flag = "weight" if "weight" in m.voxels else "timestamp"
    assert int((m.voxels[flag] != 0).sum()) > 5000       # it fused


def test_stage_methods_equal_step():
    """``preprocessing`` .. ``raycasting`` called in turn equal ``step``
    bit for bit, in ICP mode and in ground-truth mode, and return what the
    JAX methods return."""
    depths, poses = load_frames()
    cfg = _config("headline")
    whole = DenseSLAMSystem((240, 320), cfg, "cpu")
    staged = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (whole, staged):
        s.setPose(poses[0])
    for f in range(6):
        gt = poses[f] if f % 2 else None
        a = whole.step(depths[f], K, f, gt_pose=gt)
        assert staged.preprocessing(depths[f]) is True
        assert staged.tracking(K, f, gt_pose=gt) == a.tracked
        assert staged.integration(K, f) == a.integrated
        assert staged.raycasting(K, f) == (f > 2)
        b = staged.state
        for field in dataclasses.fields(a):
            x, y = getattr(a, field.name), getattr(b, field.name)
            if field.name == "map":
                for name in ("block_index", "keys", "active"):
                    assert torch.equal(getattr(x, name), getattr(y, name))
                for name in x.voxels:
                    assert torch.equal(x.voxels[name], y.voxels[name]), f
            elif isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (f, field.name)
            else:
                assert x == y, (f, field.name)
    assert whole.state.tracked


def test_step_staged_ground_truth_equals_step():
    depths, poses = load_frames()
    cfg = _config("ofusion")
    a = DenseSLAMSystem((240, 320), cfg, "cpu")
    b = DenseSLAMSystem((240, 320), cfg, "cpu")
    for f in range(5):
        sa = a.step(depths[f], K, f, gt_pose=poses[f])
        sb, times = b.step_staged(depths[f], K, f, gt_pose=poses[f])
        assert torch.equal(sa.pose, sb.pose) and sb.tracked
        assert torch.equal(sa.map.voxels["occupancy"],
                           sb.map.voxels["occupancy"])
        assert set(times) == {"preprocessing", "tracking", "integration",
                              "raycasting"}


def test_accessors_match_jax():
    depths, poses = load_frames()
    cfg = _config("headline")
    j, t = JaxSLAM((240, 320), cfg), DenseSLAMSystem((240, 320), cfg, "cpu")
    np.testing.assert_array_equal(_np(t.getInitPos()), _np(j.getInitPos()))
    np.testing.assert_array_equal(_np(t.getPosition()),
                                  _np(j.getPosition()))
    t.setPose(poses[5])
    j.setPose(poses[5])
    np.testing.assert_array_equal(_np(t.getPose()), _np(j.getPose()))
    np.testing.assert_array_equal(_np(t.getPosition()), poses[5][:3, 3])
    vol = t.getVolume()
    assert vol.map is t.getMap() and vol.channel == "tsdf"
    assert (vol.dim, vol.size) == (4.8, 64)


def test_default_device_is_the_card():
    import inspect
    sig = inspect.signature(DenseSLAMSystem.__init__)
    assert sig.parameters["device"].default == "cuda"
    from supereight_tpu_torch.apps import benchmark, runner
    assert benchmark.parse_args(["-i", "x.raw"]).device == "cuda"
    assert inspect.signature(runner.run).parameters["device"].default \
        == "cuda"
