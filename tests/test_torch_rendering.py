"""The port's renderers and metric-space ``Volume`` against the JAX
package's, on the JAX system's state after 6 cached frames at 160x120,
64^3 over 4.8 m, for the SDF (``headline``) and the OFusion (``ofusion``)
map.

``render_depth`` and ``render_track`` must be bit-exact.  ``render_volume``
on the tracking raycast's maps is bit-exact too; from a free view it
raycasts first, and the port's raycast parts from the JAX one at a few
silhouette pixels, so there at most 0.1 % of the pixels may differ (the
shading of equal maps is checked bit for bit).  The ``Volume`` reads
(``get``, ``get_multiscale``, ``interp``, ``interp_multiscale``, ``grad``)
are bit-exact at positions all over the volume and near the surface.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.core.volume import Volume as JaxVolume
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import rendering as jrender
from supereight_tpu_torch import convert
from supereight_tpu_torch.pipeline import DenseSLAMSystem, rendering

from torch_port_util import K_FULL, load_frames, state_to_numpy

torch.set_num_threads(1)

K = K_FULL / 2
N_FRAMES = 6
MAX_VOLUME_PX = 1e-3


@pytest.fixture(scope="module", params=["headline", "ofusion"])
def systems(request):
    """The JAX system after N_FRAMES frames and a port system holding the
    same state."""
    depths, poses = load_frames()
    cfg = apply_preset(request.param, Configuration(
        volume_resolution=(64,) * 3, volume_size=(4.8,) * 3,
        compute_size_ratio=2))
    jax_slam = JaxSLAM((240, 320), cfg)
    jax_slam.setPose(poses[0])
    for f in range(N_FRAMES):
        st = jax_slam.step(depths[f], K, f)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    port.state = convert.state_from_numpy(state_to_numpy(st), "cpu")
    return jax_slam, port, poses


def _image(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 4
    return a


def test_render_depth_and_track_bit_exact(systems):
    jax_slam, port, _ = systems
    want, got = _image(jax_slam.renderDepth()), _image(port.renderDepth())
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want[..., :3].reshape(-1, 3), axis=0)) > 50
    want, got = _image(jax_slam.renderTrack()), _image(port.renderTrack())
    np.testing.assert_array_equal(got, want)
    # every status colour, out-of-range results included
    result = torch.arange(-8, 4, dtype=torch.int32).reshape(3, 4)
    np.testing.assert_array_equal(
        _image(rendering.render_track(result)),
        _image(jrender.render_track(jnp.asarray(result.numpy()))))
    # below near, beyond far, and the ramp's six sextants
    depth = torch.linspace(0.0, 4.5, 4096).reshape(64, 64)
    np.testing.assert_array_equal(
        _image(rendering.render_depth(depth)),
        _image(jrender.render_depth(jnp.asarray(depth.numpy()))))


def test_render_volume_of_reference_maps_bit_exact(systems):
    jax_slam, port, _ = systems
    want = _image(jax_slam.renderVolume())
    np.testing.assert_array_equal(_image(port.renderVolume()), want)
    assert (want[..., :3].max(-1) > 0).mean() > 0.5


def test_render_volume_free_view(systems):
    jax_slam, port, poses = systems
    view_pose = poses[N_FRAMES + 1]
    want = _image(jax_slam.renderVolume(view_pose, K)).astype(int)
    got = _image(port.renderVolume(view_pose, K)).astype(int)
    differ = (got != want).any(-1).mean()
    assert differ <= MAX_VOLUME_PX, differ
    assert (want[..., :3].max(-1) > 0).mean() > 0.5
    # the shading alone, of the same maps
    from supereight_tpu.pipeline import camera as jcam
    from supereight_tpu.pipeline import raycast as jrc
    view = jnp.asarray(view_pose, jnp.float32) @ \
        jcam.inverse_camera_matrix(jnp.asarray(K, jnp.float32))
    rc = jrc.raycast(jax_slam.state.map, jax_slam.field, view, port.H,
                     port.W, 0.4, 4.0)
    np.testing.assert_array_equal(
        _image(rendering.render_volume(
            None, None, None, port.H, port.W,
            vertex=torch.from_numpy(np.array(rc.vertex)),
            normal=torch.from_numpy(np.array(rc.normal)))),
        want.astype(np.uint8))


def test_volume_reads_match_jax(systems):
    jax_slam, port, _ = systems
    jv = JaxVolume(jax_slam.state.map, jax_slam.field.select_channel)
    tv = port.getVolume()
    assert (tv.dim, tv.size) == (jv.dim, jv.size)
    rng = np.random.default_rng(0)
    surface = np.asarray(jax_slam.state.ref_vertex).reshape(-1, 3)
    surface = surface[np.abs(surface).sum(-1) > 0]
    pos = np.concatenate([
        rng.uniform(-0.2, 5.0, (4000, 3)),
        surface[rng.integers(0, len(surface), 4000)]
        + rng.normal(0, 0.05, (4000, 3))]).astype(np.float32)
    for method in ("get", "get_multiscale", "interp", "interp_multiscale",
                   "grad"):
        want = np.asarray(getattr(jv, method)(jnp.asarray(pos)))
        got = getattr(tv, method)(torch.from_numpy(pos)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)
    changed = np.asarray(jv.get(jnp.asarray(pos))) \
        != jax_slam.state.map.channels[0].empty
    assert changed.mean() > 0.1


def test_accessors(systems):
    jax_slam, port, poses = systems
    np.testing.assert_array_equal(port.getPosition().numpy(),
                                  np.asarray(jax_slam.getPosition()))
    np.testing.assert_array_equal(port.getInitPos().numpy(),
                                  np.asarray(jax_slam.getInitPos()))
    view_pose = poses[3]
    port.setViewPose(view_pose)
    assert port._view_pose is view_pose
