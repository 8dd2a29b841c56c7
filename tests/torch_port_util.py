"""Helpers shared by the ``test_torch_*`` parity tests: JAX pytrees to the
numpy dicts that ``supereight_tpu_torch.convert`` takes, and the cached
bench frames."""

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
    return d
