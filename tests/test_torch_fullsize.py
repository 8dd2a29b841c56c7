"""The headline preset at full size (SDF, 256^3 over 4.8 m, capacity 6144,
320x240, the 96 cached frames), the port stepped from each JAX state.

ICP amplifies rounding, so each port frame starts from the JAX system's
state before it (``torch_port_util.step_split``): the port's tracked flag
equals the JAX frame's and its ICP translation is within 1e-3 m.  XLA's
own sums round differently on CPUs of different vector widths, and a pose
that moves by a fraction of a millimetre can flip the allocation of a block
on its edge, so the mapping half then runs from the JAX frame's pose: its
allocation and raycast patterns, block count, overflow and the
``block_index`` / ``keys`` / ``active`` tables equal the JAX frame's bit for
bit.  This holds full-size parity of the main path on the CPU, one
thread."""

import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch.pipeline import DenseSLAMSystem

from torch_port_util import (K_FULL, assert_split, load_frames, split_want,
                             state_to_numpy, step_split)

torch.set_num_threads(1)

POSE_ATOL = 1e-3


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
    before = state_to_numpy(jax_slam.state)
    for f in range(len(depths)):
        jax_slam.step(depths[f], K_FULL, f)
        after = state_to_numpy(jax_slam.state)
        got = step_split(port, before, after, depths[f], K_FULL, f)
        out.append((split_want(after), got))
        before = after
    return out


def test_headline_full_size_matches_jax(frames):
    assert len(frames) == 96
    for f, (want, got) in enumerate(frames):
        assert_split(got, want, f, POSE_ATOL)


def test_headline_full_size_covers_the_path(frames):
    """The run tracks, allocates on its schedule, gates the raycast both
    ways and ends without overflow."""
    want = [w for w, _ in frames]
    assert sum(w["tracked"] for w in want) == 92
    assert all(w["integrated"] for w in want)
    counts = [w["alloc_count"] for w in want]
    assert 30 < counts[-1] < 96
    fired = [w["fired"] for w in want]
    assert 10 < sum(fired[6:]) < 90
    assert want[-1]["overflow"] == 0 and want[-1]["n_blocks"] > 2500
