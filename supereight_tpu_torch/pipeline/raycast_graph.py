"""The raycasting stage's raycast as one CUDA graph replay a frame.

Once its gate has fired, ``system.raycasting_stage`` reads nothing back to
the host until its reference maps: the view matrix, the scan plan, the read
view's pack where no view is held, R1, the merged scan, R4 and their
wrappers are some 85 host calls for a few hundredths of a millisecond of
device work.  On the card :func:`raycast` captures that call of
``raycast.raycast`` once into a ``torch.cuda.CUDAGraph`` and then replays
it: the same kernels and PyTorch ops in the same order on the same data,
so a replay gives the eager call's bits.

- **Inputs.** Before each replay the small tensors the raycast reads and a
  frame replaces are copied into the graph's own buffers: the pose, the
  intrinsics and the map's ``keys``, ``n_blocks``, ``active``,
  ``block_index`` and ``part_counts`` (an allocation makes them anew).
  The large tables are read in place: the voxel channels (the fusion
  updates them in place) and a held SDF view (likewise).  Their addresses
  are part of the graph's key (:func:`graph_key`), so a table that moves
  is captured again.
- **Outputs.** The maps are copied out of the graph's buffers, so a
  result a caller holds never changes under a later replay.
- **Capture.** The frame that captures runs the raycast eagerly on the
  capture stream first (its result is the frame's): the scratches of R1
  and the look-back, keyed by (device, stream), and cuBLAS's workspace are
  then made outside the graph's pool.  A synchronise (the host read
  ``raycast_capture``), then the same call is captured; the kernels leave
  their scratches zero, so each replay finds them clean.  The graph keeps
  the scratches it captured alive.
- **Counts.** The capture launches nothing, so the wrappers' ``LAUNCHES``
  are set back after it, and each replay adds what the capture counted:
  a replay counts as an eager call.  :data:`COUNTS` holds the captures and
  replays, the spans ``se.raycasting.graph.capture`` and
  ``se.raycasting.graph.replay`` the same under tracing.

Which calls are captured is decided from the call itself
(:func:`eager_reason`); every other call runs ``raycast.raycast`` eagerly,
as it did before.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from supereight_tpu_torch.utils.perfstats import Stats
from . import camera
from . import raycast as _raycast

#: graphs kept, the least recently replayed dropped first
MAX_GRAPHS = 4
#: captures and replays so far
COUNTS = {"captures": 0, "replays": 0}
#: the map's small tensors copied in before each replay
MAP_INPUTS = ("keys", "n_blocks", "active", "block_index", "part_counts")

_GRAPHS: "OrderedDict[tuple, RaycastGraph]" = OrderedDict()
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def eager_reason(device, partitions: int, field, normals: str,
                 row_range=None) -> Optional[str]:
    """Why a raycast of the map on ``device`` runs eagerly, or None where
    it is captured: a CUDA map of one partition, the whole image, an SDF
    field, and normals the kernels make.  The CPU runs the twins; a
    partitioned or sharded map and a strip take the multi-device path;
    a multiscale field's held view is packed anew at each fusion and the
    stored and exact normals' tables rebuilt, which would capture again on
    every fusing frame."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if partitions != 1:
        return "partitions"
    if row_range is not None:
        return "row_range"
    if field.multiscale_alloc:
        return "multiscale"
    if normals not in ("volume", "hybrid"):
        return normals
    return None


def _inputs(m, pose, k) -> tuple:
    return (pose, k) + tuple(getattr(m, n) for n in MAP_INPUTS)


def _layout(t) -> object:
    return None if t is None else (tuple(t.shape), t.dtype)


def graph_key(m, field, pose, k, H: int, W: int, near: float, far: float,
              view, knobs: dict) -> tuple:
    """What a graph of :func:`raycast`'s call holds fixed: the image, the
    planes, every knob, the field, the map's geometry and channels, the
    shapes of the copied inputs, and the addresses of the tables read in
    place (the voxel channels and a held view).  Not the values of the
    pose, the intrinsics or the map's small tensors: they are copied in."""
    tables = tuple((n, t.data_ptr(), _layout(t))
                   for n, t in sorted(m.voxels.items()))
    held = None if view is None else (view.data_ptr(), _layout(view))
    return (m.device, H, W, near, far, tuple(sorted(knobs.items())), field,
            m.size, m.dim, m.capacity, m.partitions, m.channels, tables,
            held, tuple(_layout(t) for t in _inputs(m, pose, k)))


def _call(m, field, pose, k, H, W, near, far, view, grad_table, knobs):
    """The stage's raycast: ``raycast.raycast`` from ``pose`` @ inv(K)."""
    return _raycast.raycast(
        m, field, pose @ camera.inverse_camera_matrix(k), H, W, near, far,
        dense=None if view is None else {"F": view}, grad_table=grad_table,
        **knobs)


def raycast(m, field, pose, k, H: int, W: int, near: float, far: float,
            view=None, grad_table=None, **knobs) -> _raycast.RaycastResult:
    """``raycast.raycast`` of the view ``pose`` @ inv(K(``k``)) with the
    read view ``view`` (None: packed from the map) and ``knobs``: a replay
    of its graph where :func:`eager_reason` allows, captured at the first
    call of its :func:`graph_key`; else the eager call."""
    if eager_reason(m.device, m.partitions, field,
                    knobs.get("normals", "volume"),
                    knobs.get("row_range")) is not None:
        return _call(m, field, pose, k, H, W, near, far, view, grad_table,
                     knobs)
    key = graph_key(m, field, pose, k, H, W, near, far, view, knobs)
    g = _GRAPHS.get(key)
    if g is not None:
        _GRAPHS.move_to_end(key)
        return g.replay(m, pose, k)
    g, result = RaycastGraph.capture(m, field, pose, k, H, W, near, far,
                                     view, knobs)
    _GRAPHS[key] = g
    while len(_GRAPHS) > MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    return result


def _stream(dev: torch.device) -> torch.cuda.Stream:
    """The capture stream of ``dev``, one a device (its scratches with
    it)."""
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(dev)
    return _STREAMS[dev]


class RaycastGraph:
    """One captured raycast: its graph, its input and output buffers, the
    scratches its kernels use, and the launches it counts a replay."""

    def __init__(self, graph, inputs, outputs, scratches, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.scratches, self.launches = scratches, launches

    @classmethod
    def capture(cls, m, field, pose, k, H, W, near, far, view, knobs):
        """The graph of the call, and the call's result (from the eager
        run on the capture stream that precedes the capture)."""
        from supereight_tpu_torch.ops import look_back
        from supereight_tpu_torch.ops import raycast_kernel as rk
        dev = m.device
        main, side = torch.cuda.current_stream(dev), _stream(dev)
        with Stats.span("se.raycasting.graph.capture"):
            inputs = [None if t is None else t.clone()
                      for t in _inputs(m, pose, k)]
            sm = m.replace(**dict(zip(MAP_INPUTS, inputs[2:])))
            args = (sm, field, inputs[0], inputs[1], H, W, near, far, view,
                    None, knobs)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                result = _call(*args)
                with Stats.host_read("raycast_capture"):
                    torch.cuda.synchronize(dev)
                counted = dict(rk.LAUNCHES)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin()
                try:
                    outputs = _call(*args)
                finally:
                    graph.capture_end()
                launches = {n: rk.LAUNCHES[n] - c for n, c in counted.items()}
                rk.LAUNCHES.update(counted)
                lb = look_back.scratch(dev)
                scratches = (rk.scratch(dev).enc, lb.status, lb.ctl)
            main.wait_stream(side)
            for t in result:
                t.record_stream(main)
            COUNTS["captures"] += 1
        return cls(graph, inputs, outputs, scratches, launches), result

    def replay(self, m, pose, k) -> _raycast.RaycastResult:
        """The call on this frame's pose, intrinsics and map: its inputs
        copied in, the graph replayed, its maps copied out."""
        from supereight_tpu_torch.ops import raycast_kernel as rk
        with Stats.span("se.raycasting.graph.replay"):
            for dst, src in zip(self.inputs, _inputs(m, pose, k)):
                if dst is not None:
                    dst.copy_(src)
            self.graph.replay()
            for n, c in self.launches.items():
                rk.LAUNCHES[n] += c
            COUNTS["replays"] += 1
            return _raycast.RaycastResult(*(t.clone() for t in self.outputs))
