"""The headline preset at full size (SDF, 256^3 over 4.8 m, capacity 6144,
320x240, the 96 cached frames), the port stepped from each JAX state.

ICP amplifies rounding, so each port frame starts from the JAX system's
state before it (``convert.state_from_numpy``); per frame the port must
give the JAX frame's tracked flag, allocation and raycast patterns, block
count and overflow, and its pose within 1e-3 m.  This holds full-size
parity of the main path on the CPU, one thread."""

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch import convert
from supereight_tpu_torch.pipeline import DenseSLAMSystem

from torch_port_util import K_FULL, load_frames, state_to_numpy

torch.set_num_threads(1)

POSE_ATOL = 1e-3


def _record(st):
    return dict(pose=np.array(st.pose), raycast_pose=np.array(st.raycast_pose),
                tracked=bool(st.tracked), integrated=bool(st.integrated),
                alloc_count=int(st.alloc_count),
                n_blocks=int(st.map.n_blocks), overflow=int(st.map.overflow))


@pytest.fixture(scope="module")
def frames():
    depths, poses = load_frames()
    cfg = apply_preset("headline", Configuration(
        volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
        block_capacity=6144))
    jax_slam = JaxSLAM((240, 320), cfg)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    jax_slam.setPose(poses[0])
    out = []
    for f in range(len(depths)):
        port.state = convert.state_from_numpy(state_to_numpy(jax_slam.state),
                                              "cpu")
        want = _record(jax_slam.step(depths[f], K_FULL, f))
        got = _record(port.step(depths[f], K_FULL, f))
        out.append((want, got))
    return out


def test_headline_full_size_matches_jax(frames):
    assert len(frames) == 96
    for f, (want, got) in enumerate(frames):
        for key in ("tracked", "integrated", "alloc_count", "n_blocks",
                    "overflow"):
            assert got[key] == want[key], (f, key)
        fired = np.array_equal(want["raycast_pose"], want["pose"])
        assert np.array_equal(got["raycast_pose"], got["pose"]) == fired, f
        np.testing.assert_allclose(got["pose"][:3, 3], want["pose"][:3, 3],
                                   rtol=0, atol=POSE_ATOL,
                                   err_msg=f"frame {f}")


def test_headline_full_size_covers_the_path(frames):
    """The run tracks, allocates on its schedule, gates the raycast both
    ways and ends without overflow."""
    want = [w for w, _ in frames]
    assert sum(w["tracked"] for w in want) == 92
    assert all(w["integrated"] for w in want)
    counts = [w["alloc_count"] for w in want]
    assert 30 < counts[-1] < 96
    fired = [np.array_equal(w["raycast_pose"], w["pose"]) for w in want]
    assert 10 < sum(fired[6:]) < 90
    assert want[-1]["overflow"] == 0 and want[-1]["n_blocks"] > 2500
