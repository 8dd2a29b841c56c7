"""Helpers shared by the ``test_torch_*`` parity tests: JAX pytrees to the
numpy dicts that ``supereight_tpu_torch.convert`` takes, the cached bench
frames, and :func:`step_split`, which runs one port frame from a JAX state
with the tracking half and the mapping half held apart."""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DATA = os.path.join(HERE, "..", "bench_data")
#: intrinsics of the cached 320x240 frames
K_FULL = np.array([240.6, 240.0, 160.0, 120.0], np.float32)


def load_frames(sequence: str = "synthetic_256_frames"):
    """(depths uint16 [96, 240, 320], poses [96, 4, 4]) of a cached
    sequence in ``bench_data/``."""
    z = np.load(os.path.join(BENCH_DATA, sequence + ".npz"))
    return z["depths"], z["poses"]


def map_to_numpy(m) -> dict:
    """A JAX ``VoxelMap`` as the dict ``convert.map_from_numpy`` takes."""
    a = np.asarray
    return dict(
        size=m.size, dim=m.dim, capacity=m.capacity,
        partitions=m.partitions, block_index=a(m.block_index),
        keys=a(m.keys), n_blocks=a(m.n_blocks), active=a(m.active),
        overflow=a(m.overflow),
        voxels={k: a(v) for k, v in m.voxels.items()},
        node_values=[{k: a(v) for k, v in lv.items()}
                     for lv in m.node_values],
        node_alloc=[a(x) for x in m.node_alloc],
        part_counts=a(m.part_counts),
        channels=[(c.name, np.dtype(c.dtype).name, c.init, c.empty)
                  for c in m.channels])


def state_to_numpy(st) -> dict:
    """A JAX ``FrameState`` as the dict ``convert.state_from_numpy``
    takes."""
    d = {name: np.asarray(getattr(st, name))
         for name in ("pose", "raycast_pose", "float_depth", "scaled_depth",
                      "ref_vertex", "ref_normal", "track_result", "tracked",
                      "integrated", "alloc_pose", "alloc_count", "prev_pose",
                      "model_ref")}
    d["map"] = map_to_numpy(st.map)
    d["view"] = None if st.view is None else np.asarray(st.view)
    d["grad"] = None if st.grad is None else np.asarray(st.grad)
    return d


def step_split(port, jax_before: dict, jax_after: dict, depth, k,
               frame: int) -> dict:
    """One frame of the port's ``DenseSLAMSystem`` ``port`` from the JAX
    state before it, in two halves (``jax_before`` / ``jax_after``: the
    JAX states before and after the frame, as :func:`state_to_numpy`
    gives them).

    The port's preprocessing and tracking stages run from ``jax_before``
    and give ``pose``, ``tracked`` and ``track_result``.  ICP amplifies
    the last bit of its sums into the pose, and XLA's own sums change with
    the CPU's vector width, so the pose is compared within a tolerance.
    Then the state takes the JAX frame's ``pose``, ``tracked``,
    ``prev_pose`` and ``track_result``, and the port's integration and
    raycasting stages run: from there everything is defined bit for bit
    (``alloc_count``, ``n_blocks``, ``overflow``, ``integrated``, the
    raycast-fired flag and the ``block_index`` / ``keys`` / ``active``
    tables).  Leaves ``port.state`` at the frame's end."""
    import torch
    from supereight_tpu_torch import convert
    from supereight_tpu_torch.pipeline import system

    cfg, field = port.config, port.field
    st = convert.state_from_numpy(jax_before, port.device)
    kd, neg_y = port._k(k)
    st = system.preprocessing_stage(st, port._depth(depth), cfg)
    st = system.tracking_stage(st, kd, frame, cfg, neg_y)
    out = dict(pose=st.pose.cpu().numpy(), tracked=bool(st.tracked),
               track_result=st.track_result.cpu().numpy())
    t = lambda name, dtype: torch.as_tensor(np.array(jax_after[name]),
                                            dtype=dtype, device=port.device)
    st = st.replace(pose=t("pose", torch.float32),
                    prev_pose=t("prev_pose", torch.float32),
                    track_result=t("track_result", torch.int32),
                    tracked=bool(jax_after["tracked"]))
    st = system.integration_stage(st, kd, frame, cfg, field)
    st = system.raycasting_stage(st, kd, frame, cfg, field, neg_y)
    port.state = st
    m = st.map
    out.update(integrated=bool(st.integrated), alloc_count=int(st.alloc_count),
               n_blocks=int(m.n_blocks), overflow=int(m.overflow),
               fired=bool(torch.equal(st.raycast_pose, st.pose)),
               model_ref=bool(st.model_ref),
               block_index=m.block_index.cpu().numpy(),
               keys=m.keys.cpu().numpy(), active=m.active.cpu().numpy())
    return out


def split_want(jax_after: dict) -> dict:
    """The record :func:`step_split` returns, from the JAX state after the
    frame."""
    m = jax_after["map"]
    return dict(pose=np.asarray(jax_after["pose"]),
                tracked=bool(jax_after["tracked"]),
                track_result=np.asarray(jax_after["track_result"]),
                integrated=bool(jax_after["integrated"]),
                alloc_count=int(jax_after["alloc_count"]),
                n_blocks=int(m["n_blocks"]), overflow=int(m["overflow"]),
                fired=bool(np.array_equal(jax_after["raycast_pose"],
                                          jax_after["pose"])),
                model_ref=bool(jax_after["model_ref"]),
                block_index=np.asarray(m["block_index"]),
                keys=np.asarray(m["keys"]).astype(np.int64),
                active=np.asarray(m["active"]))


#: what :func:`assert_split` holds bit for bit after tracking
SPLIT_EXACT = ("integrated", "alloc_count", "n_blocks", "overflow", "fired",
               "model_ref")
SPLIT_TABLES = ("block_index", "keys", "active")


def assert_split(got: dict, want: dict, frame: int,
                 pose_atol: float = 1e-3) -> None:
    """Per frame: ``tracked`` equal and the ICP translation within
    ``pose_atol`` m; given the JAX pose, the counts, the fired flag and
    the three tables equal bit for bit."""
    assert got["tracked"] == want["tracked"], (frame, "tracked")
    np.testing.assert_allclose(got["pose"][:3, 3], want["pose"][:3, 3],
                               rtol=0, atol=pose_atol,
                               err_msg=f"frame {frame}")
    for key in SPLIT_EXACT:
        assert got[key] == want[key], (frame, key)
    for key in SPLIT_TABLES:
        np.testing.assert_array_equal(got[key], want[key],
                                      err_msg=f"frame {frame}: {key}")
