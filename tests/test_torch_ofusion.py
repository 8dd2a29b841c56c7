"""OFusion of the PyTorch port against the JAX package: the field's update
(`fields/ofusion.py`), the octant march (`integration.ofusion_wanted_masks`),
multiscale allocation, the node fill and the multiscale read view.

The update runs on numpy inputs through both fields: occupancy within 1e-6
relative or absolute (jnp.log2 and torch.log round differently in the last
bit), timestamp bit for bit.  Masks, allocation, node fill and the bf16
view are integer, boolean or copied values and must match bit for bit.
The map is the JAX ``ofusion`` preset's after FRAME frames at 160x120,
128^3.  Each JAX function runs op by op (not under ``jit``, where XLA
contracts multiply-adds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.core import octree as joct
from supereight_tpu.fields import ofusion as jof
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import integration as jint
from supereight_tpu.pipeline import preprocessing as jpre
from supereight_tpu.pipeline import raycast as jrc
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.fields import ofusion
from supereight_tpu_torch.fields import make_field
from supereight_tpu_torch.pipeline import integration, raycast

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

FRAME = 5
MU, VS = 0.05, 4.8 / 128


@pytest.fixture(scope="module")
def scene():
    """The JAX map after frames 0..FRAME-1 (four bootstrap integrations and
    one tracked), frame FRAME's depth at 80x60 and its true pose."""
    depths, poses = load_frames()
    cfg = apply_preset("ofusion", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(FRAME):
        slam.step(depths[f], K_FULL / 2, f)
    jm = slam.state.map
    # 80x60 leaves the ray grid undecimated, so the coarse zones stride
    depth = jpre.mm_to_meters(jnp.asarray(depths[FRAME]), (60, 80))
    return dict(jmap=jm, tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"),
                depth=np.asarray(depth), pose=poses[FRAME].astype(np.float32),
                K=np.asarray(jcam.camera_matrix(jnp.asarray(K_FULL / 4))),
                field=slam.field)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("mu,vs,floor", [(0.05, 4.8 / 256, 0.0),
                                         (0.05, 4.8 / 128, 0.0),
                                         (0.008, 4.8 / 512, 0.0375)])
def test_update_matches_jax(mu, vs, floor):
    """Voxels from behind the surface to far in front, some without depth
    or out of frame, fused onto old log-odds at older timestamps.  At
    128^3 the floor 2 * voxel_size = 0.075 is above the cap 0.05, and the
    floor wins."""
    rng = np.random.default_rng(int(vs * 1e4))
    n = 20000
    z = rng.uniform(-0.2, 4.5, n).astype(np.float32)
    z[:50] = 0.0
    pos = np.stack([rng.uniform(-1, 1, n) * z, rng.uniform(-1, 1, n) * z, z],
                   -1).astype(np.float32)
    ds = (z + rng.normal(0, 0.1, n) * rng.uniform(0, 3, n)).astype(np.float32)
    ds[rng.random(n) < 0.1] = 0.0
    valid = rng.random(n) < 0.9
    data = dict(occupancy=rng.uniform(-30, 30, n).astype(np.float32),
                timestamp=rng.uniform(0, 3, n).astype(np.float32))
    now = float(np.float32(1 / 30) * np.float32(95))
    jf = jof.OFusionField(mu=mu, voxel_size=vs, sigma_floor=floor)
    tf = make_field("ofusion", mu=mu, voxel_size=vs, sigma_floor=floor)
    want = jf.update({k: jnp.asarray(v) for k, v in data.items()},
                     jnp.asarray(pos), jnp.asarray(ds), jnp.asarray(valid),
                     jnp.float32(now))
    got = tf.update({k: _t(v) for k, v in data.items()}, _t(pos), _t(ds),
                    _t(valid), now)
    fused = np.asarray(want["timestamp"]) != data["timestamp"]
    assert 0.2 < fused.mean() < 0.9
    np.testing.assert_array_equal(got["timestamp"].numpy(),
                                  np.asarray(want["timestamp"]))
    # 1e-6 relative, and 1e-6 absolute where the sum cancels toward 0: a
    # log-odds term is at most log2(0.97 / 0.03) = 5.0, whose last bit is
    # 4.8e-7
    np.testing.assert_allclose(got["occupancy"].numpy(),
                               np.asarray(want["occupancy"]), rtol=1e-6,
                               atol=1e-6)


def test_h_occupancy_matches_jax():
    """The sensor model on a grid across every piece of the bspline."""
    t = np.linspace(-9, 9, 40001, dtype=np.float32)
    want = np.asarray(jof.h_occupancy(jnp.asarray(t)))
    got = ofusion.h_occupancy(_t(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0.5).any() and (want == 0.0).any()


@pytest.mark.parametrize("travelled", [0.1, 0.3, 0.4, 0.9])
def test_march_schedule_matches_jax(travelled):
    band = 6 * MU
    want = float(jof.compute_stepsize(travelled, band, VS))
    got = ofusion.compute_stepsize(travelled, band, VS)
    assert got == want
    assert ofusion.step_to_depth(got, 7, VS) == \
        int(jof.step_to_depth(want, 7, VS))


@pytest.mark.parametrize("coarse", [True, False])
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_ofusion_wanted_masks_match_jax(scene, coarse, phase):
    args = (scene["depth"], scene["pose"], scene["K"])
    want = jint.ofusion_wanted_masks(scene["jmap"],
                                     *(jnp.asarray(a) for a in args),
                                     6 * MU, coarse_stride=coarse,
                                     phase=phase)
    got = integration.ofusion_wanted_masks(scene["tmap"],
                                           *(_t(a) for a in args), 6 * MU,
                                           coarse_stride=coarse, phase=phase)
    assert len(got) == len(want) == 5
    for level, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"level {level}")
    # zones 1-3 request blocks and 16- and 32-voxel octants
    assert all(np.asarray(want[level]).sum() > 10 for level in (2, 3, 4))


def test_phase_rotates_the_coarse_grid(scene):
    """At 80x60 the coarse zones stride, so the four phases request
    different octants, and their union more than most of them."""
    args = tuple(_t(scene[k]) for k in ("depth", "pose", "K"))
    lvl3 = [integration.ofusion_wanted_masks(scene["tmap"], *args, 6 * MU,
                                             phase=p)[3] for p in range(4)]
    union = lvl3[0] | lvl3[1] | lvl3[2] | lvl3[3]
    assert len({m.numpy().tobytes() for m in lvl3}) == 4
    assert sum(int(union.sum()) > int(m.sum()) for m in lvl3) >= 3


def test_allocate_ofusion_matches_jax(scene):
    """From a moved camera, so that the march requests new blocks and
    octants too."""
    pose = scene["pose"].copy()
    pose[:3, 3] += (0.3, 0.0, 0.4)
    args = (scene["depth"], pose, scene["K"])
    jm = jint.allocate_ofusion(scene["jmap"], *(jnp.asarray(a) for a in args),
                               6 * MU, phase=2)
    tm = integration.allocate_ofusion(scene["tmap"], *(_t(a) for a in args),
                                      6 * MU, phase=2)
    assert int(jm.n_blocks) > int(scene["jmap"].n_blocks)
    np.testing.assert_array_equal(tm.block_index.numpy(),
                                  np.asarray(jm.block_index))
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    np.testing.assert_array_equal(tm.active.numpy(), np.asarray(jm.active))
    assert int(tm.n_blocks) == int(jm.n_blocks)
    assert int(tm.overflow) == int(jm.overflow)
    grew = False
    for level in range(tm.block_level + 1):
        np.testing.assert_array_equal(tm.node_alloc[level].numpy(),
                                      np.asarray(jm.node_alloc[level]))
        grew |= bool((np.asarray(jm.node_alloc[level])
                      != np.asarray(scene["jmap"].node_alloc[level])).any())
    assert grew


def test_allocate_octant_masks_matches_jax():
    """Random requests at every level of an empty 64^3 map (8^3 blocks)."""
    rng = np.random.default_rng(3)
    masks = [rng.random((1 << l,) * 3) < 0.3 for l in range(4)]
    jm = joct.init(64, 2.4, jof.OFusionField().channels, capacity=64)
    tm = octree.init(64, 2.4, ofusion.OFusionField().channels, "cpu",
                     capacity=64)
    jm = joct.allocate_octant_masks(jm, [jnp.asarray(m) for m in masks])
    tm = octree.allocate_octant_masks(tm, [torch.from_numpy(m) for m in masks])
    np.testing.assert_array_equal(tm.block_index.numpy(),
                                  np.asarray(jm.block_index))
    assert int(tm.overflow) == int(jm.overflow) > 0
    for level in range(4):
        np.testing.assert_array_equal(tm.node_alloc[level].numpy(),
                                      np.asarray(jm.node_alloc[level]))


@pytest.mark.parametrize("channel", ["occupancy", "timestamp"])
def test_node_fill_and_tiled_rows_match_jax(scene, channel):
    want = np.asarray(joct.node_fill(scene["jmap"], channel))
    got = octree.node_fill(scene["tmap"], channel).numpy()
    np.testing.assert_array_equal(got, want)
    # several pyramid levels show through, and some cells read empty
    assert len(np.unique(want)) > 3 and (want == 0).any()
    np.testing.assert_array_equal(
        octree.pack_tiled_multiscale(scene["tmap"], channel).numpy(),
        np.asarray(joct.pack_tiled_multiscale(scene["jmap"], channel)))


def test_pack_view_multiscale_matches_jax(scene):
    """The view encoded on the [capacity, 512] table equals JAX's and the
    earlier form (both channels tiled to [B^3, 512] in float32, encoded
    there) bit for bit."""
    want = np.asarray(jrc.pack_view(scene["jmap"], scene["field"])["F"]
                      .astype(jnp.float32))
    field = make_field("ofusion", mu=MU, voxel_size=VS)
    got = raycast.pack_view(scene["tmap"], field)["F"]
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    tiled = {c.name: octree.pack_tiled_multiscale(scene["tmap"], c.name)
             for c in scene["tmap"].channels}
    earlier = torch.where(field.sample_valid(tiled), tiled["occupancy"],
                          float("nan")).to(torch.bfloat16).float().numpy()
    for other in (want, earlier):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(other))
        ok = ~np.isnan(other)
        np.testing.assert_array_equal(got[ok], other[ok])
    # fused voxels, free space (< 0) and node fill all appear
    assert np.isnan(want).any() and (want[ok] < 0).any() \
        and (want[ok] > 0).any()
