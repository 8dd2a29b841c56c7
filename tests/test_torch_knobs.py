"""The knob groups of ``chip_smoke.py``'s phase F (each over the
``headline`` preset) and Tukey's IRLS weights, through the PyTorch port's
stages against the JAX package's ``DenseSLAMSystem`` over 8 frames at
160x120 (``compute_size_ratio=2``), 128^3 over 4.8 m, capacity 4096:

- F1 stored normals, F2 stored normals with the plane refine, F3 the
  midsolve, F4 Huber weights (delta 0.01 m) with bilinear association and
  symmetric ICP, F5 the per-frame symmetric gate (``"auto"``), F6 the
  frame-to-frame bootstrap and fallback; Tukey (c 0.02 m).

Each frame goes through ``torch_port_util.step_split`` from the JAX state
before it: tracked equal and the ICP translation within 1e-3 m; from the
JAX frame's pose, the counts, the fired pattern, ``model_ref`` (the f2f
publication) and the block tables bit for bit, and with stored normals
the gradient table equal to JAX's bit for bit (NaN pattern included).

The ``"auto"`` gate is held against JAX's on the rotation of consecutive
and strided steps of the 96 cached poses: the same decisions, angles
within 1e-3 degrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import system as jsystem
from supereight_tpu_torch.pipeline import DenseSLAMSystem, system

from torch_port_util import (K_FULL, assert_split, load_frames, split_want,
                             state_to_numpy, step_split)

torch.set_num_threads(1)

N_FRAMES = 8
K = K_FULL / 2
GROUPS = dict({name: knobs for name, (knobs, _) in
               chip_smoke.F_RUNS.items()},
              tukey=dict(icp_robust="tukey", icp_robust_delta=0.02))


def _config(group):
    cfg = apply_preset("headline", Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    return dataclasses.replace(cfg, **GROUPS[group])


def _f32(bf16):
    return np.asarray(jnp.asarray(bf16).astype(jnp.float32))


@pytest.fixture(scope="module", params=sorted(GROUPS))
def run(request):
    group = request.param
    depths, poses = load_frames()
    cfg = _config(group)
    jax_slam = JaxSLAM((240, 320), cfg)
    port = DenseSLAMSystem((240, 320), cfg, "cpu")
    jax_slam.setPose(poses[0])
    out = dict(group=group, frames=[], grads=[])
    before = state_to_numpy(jax_slam.state)
    for f in range(N_FRAMES):
        jax_slam.step(depths[f], K, f)
        after = state_to_numpy(jax_slam.state)
        out["frames"].append((split_want(after), step_split(
            port, before, after, depths[f], K, f)))
        if after["grad"] is not None:
            out["grads"].append((_f32(after["grad"]),
                                 port.state.grad.to(torch.float32).numpy()))
        before = after
    return out


def test_knobs_match_jax(run):
    for f, (want, got) in enumerate(run["frames"]):
        assert_split(got, want, f)
    want = [w for w, _ in run["frames"]]
    # the run tracks after the bootstrap (f2f: from frame 1)
    first = 1 if run["group"] == "F6" else 4
    assert all(w["tracked"] for w in want[first:]), run["group"]
    if run["group"] == "F6":
        # frames 0-2 publish their own maps (and fuse as bootstrap
        # frames), frame 3 raycasts the model
        assert [w["model_ref"] for w in want[:4]] == [False, False, False,
                                                      True]


def test_stored_gradients_match_jax(run):
    """With stored normals the table rebuilt on every integration frame
    equals JAX's bit for bit."""
    if run["group"] not in ("F1", "F2"):
        assert not run["grads"]
        return
    assert len(run["grads"]) == N_FRAMES
    for f, (want, got) in enumerate(run["grads"]):
        np.testing.assert_array_equal(got, want, err_msg=f"frame {f}")
    assert np.abs(run["grads"][-1][0][..., :3]).max() > 0


def test_sym_auto_gate_matches_jax():
    _, poses = load_frames()
    gate = jax.jit(jsystem._sym_auto_gate, static_argnums=(1, 2))
    angle = jax.jit(lambda p, q: jnp.degrees(jnp.arccos(jnp.clip(
        0.5 * (jnp.trace(p[:3, :3] @ q[:3, :3].T) - 1.0), -1.0, 1.0))))
    fired = []
    for step in (1, 2, 3, 5):
        for f in range(step, len(poses)):
            p, q = poses[f].astype(np.float32), poses[f - step] \
                .astype(np.float32)
            jst = jsystem.FrameState(
                map=None, pose=jnp.asarray(p), raycast_pose=None,
                float_depth=None, scaled_depth=None, ref_vertex=None,
                ref_normal=None, track_result=None, tracked=None,
                integrated=None, prev_pose=jnp.asarray(q))
            tst = system.FrameState(
                map=None, pose=torch.from_numpy(p), raycast_pose=None,
                float_depth=None, scaled_depth=None, ref_vertex=None,
                ref_normal=None, track_result=None, tracked=False,
                integrated=False, alloc_pose=None, alloc_count=0,
                prev_pose=torch.from_numpy(q), model_ref=True)
            want = bool(gate(jst, 0.5, 4.5))
            assert bool(system._sym_auto_gate(tst, 0.5, 4.5)) == want, \
                (step, f)
            np.testing.assert_allclose(
                float(system.sym_auto_angle(tst)),
                float(angle(jnp.asarray(p), jnp.asarray(q))), rtol=0,
                atol=1e-3)
            fired.append(want)
    assert 0 < sum(fired) < len(fired)
