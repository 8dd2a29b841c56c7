"""State carried across from the JAX package, as numpy arrays.

``map_from_numpy`` takes a ``supereight_tpu`` ``VoxelMap`` and
``state_from_numpy`` a ``FrameState``, each as a dict of numpy arrays (the
arrays of the JAX pytree under their field names, plus the map's static
fields), and return the port's map and state on ``device``.  They let a
port stage start from a JAX mid-sequence state, of either field (SDF or
OFusion, told apart by the voxel channels) or of any channel set whose
ChannelSpecs the caller or the dict gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from supereight_tpu_torch.core.octree import (ChannelSpec, VoxelMap,
                                               channel_specs)
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.pipeline.system import FrameState


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


_CHANNELS = {frozenset(c.name for c in f.channels): f.channels
                   for f in (SDFField(), OFusionField())}


def map_from_numpy(d, device,
                   channels: Optional[Tuple[ChannelSpec, ...]] = None
                   ) -> VoxelMap:
    """``d``: ``size``, ``dim``, ``capacity``, ``partitions`` (default 1),
    ``block_index``, ``keys``, ``n_blocks``, ``active``, ``overflow``,
    ``voxels`` {name: array}, ``node_values`` [{name: array}] and
    ``node_alloc`` [array], and ``part_counts`` (one count a partition,
    summing to ``n_blocks``; optional for one partition).  The channels
    are ``channels``, else ``d["channels"]`` (tuples for
    :func:`channel_specs`), else the field's whose channel names the
    voxels carry."""
    partitions = int(d.get("partitions", 1))
    if channels is None and d.get("channels") is not None:
        channels = channel_specs(d["channels"])
    if channels is None:
        channels = _CHANNELS.get(frozenset(d["voxels"]))
    if channels is None:
        raise NotImplementedError(
            f"channels {sorted(d['voxels'])}: no ported field has them; "
            "pass their ChannelSpecs")
    counts = np.asarray(d["part_counts"] if "part_counts" in d
                        else np.reshape(d["n_blocks"], 1), np.int32)
    if counts.shape != (partitions,) or \
            int(counts.sum()) != int(d["n_blocks"]):
        raise ValueError("part_counts disagrees with n_blocks")
    i32 = torch.int32
    return VoxelMap(
        size=int(d["size"]), dim=float(d["dim"]), capacity=int(d["capacity"]),
        channels=tuple(channels),
        block_index=_t(d["block_index"], i32, device),
        keys=_t(np.asarray(d["keys"]).astype(np.int64), torch.int64, device),
        n_blocks=_t(d["n_blocks"], i32, device),
        active=_t(d["active"], torch.bool, device),
        overflow=_t(d["overflow"], i32, device),
        voxels={c.name: _t(d["voxels"][c.name], c.dtype, device)
                for c in channels},
        node_values=[{c.name: _t(lv[c.name], c.dtype, device)
                      for c in channels} for lv in d["node_values"]],
        node_alloc=[_t(a, torch.bool, device) for a in d["node_alloc"]],
        partitions=partitions, part_counts=_t(counts, i32, device))


def state_from_numpy(d, device) -> FrameState:
    """``d``: ``map`` (a dict for :func:`map_from_numpy`) and the
    FrameState arrays ``pose``, ``raycast_pose``, ``float_depth``,
    ``scaled_depth``, ``ref_vertex``, ``ref_normal``, ``track_result``,
    ``tracked``, ``integrated``, ``alloc_pose``, ``alloc_count``,
    ``prev_pose`` and ``model_ref``, ``view`` (the held read view, or
    None; it may be bf16) and ``grad`` (the stored gradient table, bf16,
    or None)."""
    f32 = torch.float32
    view, grad = d.get("view"), d.get("grad")
    if view is not None:      # bf16 -> f32 -> bf16 is exact
        view = _t(np.asarray(view, np.float32), f32, device) \
            .to(torch.bfloat16)
    if grad is not None:
        grad = _t(np.asarray(grad, np.float32), f32, device) \
            .to(torch.bfloat16)
    return FrameState(
        map=map_from_numpy(d["map"], device),
        **{name: _t(d[name], f32, device)
           for name in ("pose", "raycast_pose", "float_depth",
                        "scaled_depth", "ref_vertex", "ref_normal",
                        "alloc_pose", "prev_pose")},
        track_result=_t(d["track_result"], torch.int32, device),
        tracked=bool(d["tracked"]), integrated=bool(d["integrated"]),
        alloc_count=int(d["alloc_count"]), model_ref=bool(d["model_ref"]),
        view=view, grad=grad)
