"""The knobs of the presets beyond ``headline`` and ``ofusion``, each group
through the PyTorch port's ``DenseSLAMSystem`` against the JAX package's,
over 8 frames at 160x120 (``compute_size_ratio=2``), 128^3 over 4.8 m,
capacity 4096:

- ``noise``: the bilateral filter, with ``fuse_filtered`` on (fusion of
  the filtered depth), on the Kinect-noise sequence;
- ``demo512-sdf``'s knobs: the held SDF read view, the full-res scan and
  symmetric ICP, with the budget equal to the capacity (the all-rows
  fusion path);
- ``demo512-ofusion``'s on-demand allocation gate (threshold 0.002, every
  second cached frame, integration every frame, so that the gate decides
  after the bootstrap);
- ``1024-quality``'s motion allocation gate (1.6 degrees or 0.03 m,
  integration every frame).

As in `tests/test_torch_system.py`, each port frame starts from the JAX
state of the frame before, because ICP amplifies rounding
(``torch_port_util.step_split``).  Per frame, tracked is equal and the ICP
translations agree within 1e-3 m; then, from the JAX frame's pose (a pose
that parts by a fraction of a millimetre can allocate a block on its edge,
and XLA's own ICP sums change with the CPU's vector width), integrated, the
allocation-fired pattern (``alloc_count``), the raycast-fired pattern,
``n_blocks``, ``overflow`` and the ``block_index`` / ``keys`` / ``active``
tables are equal bit for bit.  The held SDF view equals ``pack_view`` of
its map bit for bit after every frame, and ``step_staged`` equals ``step``
bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch.pipeline import DenseSLAMSystem, raycast

from torch_port_util import (K_FULL, assert_split, load_frames, split_want,
                             state_to_numpy, step_split)

torch.set_num_threads(1)

N_FRAMES = 8
K = K_FULL / 2
SMALL = dict(volume_resolution=(128,) * 3, block_capacity=4096)

#: {group: (preset, cached sequence, frame stride, knobs over the preset)}
GROUPS = {
    "noise": ("noise", "synthetic_256_frames_noisy", 1,
              dict(fuse_filtered=True)),
    "demo512-sdf": ("demo512-sdf", "synthetic_256_frames", 1,
                    dict(SMALL, integrate_budget=4096)),
    "demo512-ofusion": ("demo512-ofusion", "synthetic_256_frames", 2,
                        dict(SMALL, integrate_budget=1024, integration_rate=1,
                             alloc_on_demand=0.002)),
    "1024-quality": ("1024-quality", "synthetic_256_frames", 1,
                     dict(SMALL, integrate_budget=1024, integration_rate=1,
                          alloc_adaptive_deg=1.6, alloc_adaptive_dist=0.03)),
}


def _config(group):
    preset, _, _, knobs = GROUPS[group]
    cfg = apply_preset(preset, Configuration(
        volume_size=(4.8,) * 3, compute_size_ratio=2, **SMALL))
    return dataclasses.replace(cfg, **knobs)


def _record(st):
    a = lambda x: np.array(x)
    return dict(pose=a(st.pose), raycast_pose=a(st.raycast_pose),
                tracked=bool(st.tracked), integrated=bool(st.integrated),
                alloc_count=int(st.alloc_count),
                n_blocks=int(st.map.n_blocks), overflow=int(st.map.overflow))


def _assert_view_is_pack_view(st, field, msg):
    rebuilt = raycast.pack_view(st.map, field)["F"]
    assert st.view.dtype == rebuilt.dtype == torch.bfloat16, msg
    assert torch.equal(torch.isnan(st.view), torch.isnan(rebuilt)), msg
    assert torch.equal(torch.nan_to_num(st.view),
                       torch.nan_to_num(rebuilt)), msg


@pytest.fixture(scope="module", params=sorted(GROUPS))
def run(request):
    """The JAX system over N_FRAMES and the port stepped from each of its
    states; the held view is checked right after each step (an SDF view is
    updated in place by the next)."""
    group = request.param
    _, sequence, stride, _ = GROUPS[group]
    depths, poses = load_frames(sequence)
    depths = depths[::stride]
    cfg = _config(group)
    jax_slam = JaxSLAM((240, 320), cfg)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (jax_slam, port):
        s.setPose(poses[0])
    out = dict(group=group, jax=[], port=[], field=port.field)
    before = state_to_numpy(jax_slam.state)
    for f in range(N_FRAMES):
        jst = jax_slam.step(depths[f], K, f)
        out["jax"].append(_record(jst))
        after = state_to_numpy(jst)
        out["port"].append((split_want(after), step_split(
            port, before, after, depths[f], K, f)))
        if port.state.view is not None:
            _assert_view_is_pack_view(port.state, port.field, f"frame {f}")
        before = after
    return out


def test_frames_match_jax(run):
    for f, (want, got) in enumerate(run["port"]):
        assert_split(got, want, f)
    # the run tracks past the bootstrap
    assert all(j["tracked"] for j in run["jax"][5:])


def test_gates_fire_and_skip(run):
    """The allocation gates decide after frame 5 both ways; without a gate
    the march fires on every integration frame."""
    counts = [j["alloc_count"] for j in run["jax"]]
    fired = [b > a for a, b in zip([0] + counts, counts)]
    integrated = [j["integrated"] for j in run["jax"]]
    if run["group"] in ("demo512-ofusion", "1024-quality"):
        assert fired[:6] == [True] * 6 and all(integrated)
        assert any(fired[6:]) and not all(fired[6:])
    else:
        assert fired == integrated


def test_held_sdf_view_and_staged_run():
    """``demo512-sdf``'s knobs free-running: the held SDF view equals
    ``pack_view`` after every frame, and ``step_staged`` equals ``step``
    bit for bit (view included)."""
    depths, poses = load_frames()
    cfg = _config("demo512-sdf")
    fused = DenseSLAMSystem((240, 320), cfg, "cpu")
    staged = DenseSLAMSystem((240, 320), cfg, "cpu")
    for s in (fused, staged):
        s.setPose(poses[0])
    for f in range(N_FRAMES):
        a = fused.step(depths[f], K, f)
        b, _ = staged.step_staged(depths[f], K, f)
        _assert_view_is_pack_view(a, fused.field, f"frame {f}")
        assert torch.equal(torch.nan_to_num(a.view),
                           torch.nan_to_num(b.view)), f
        assert torch.equal(a.pose, b.pose) and a.tracked == b.tracked, f
        assert a.alloc_count == b.alloc_count, f
        for name in a.map.voxels:
            assert torch.equal(a.map.voxels[name], b.map.voxels[name]), f
    assert a.tracked and int(a.map.n_blocks) < a.map.capacity
