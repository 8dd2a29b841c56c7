"""The multi-device map's process group and placement (counterpart of
`supereight_tpu/parallel/sharding.py`).

JAX runs one program over a device ``Mesh``; here D processes, one a rank,
each run the same frame body with their ``rank`` where JAX reads
``axis_index``.  :func:`init_group` starts the group with an explicit
backend (``nccl`` with one rank a card, ``gloo`` on CPU tensors or on CUDA
tensors of ranks that share a card), and :class:`Comm` issues the
collectives the map needs: ``all_reduce_sum`` (JAX's ``psum``) and
``all_gather_cat`` (``all_gather(..., tiled=True)``), each timed on the
host clock, the device synchronised, when ``timed``.

Placement (:func:`shard_state`): a rank holds only its slot range
``[rank * capacity / D, (rank + 1) * capacity / D)`` of the brick table
``map.voxels``; every other field of the state (the block index, keys,
counters, ``active``, the node pyramid, images and poses) is replicated:
each rank computes it identically from identical inputs.
"""

from __future__ import annotations

import datetime
import time

import torch
import torch.distributed as dist

from supereight_tpu_torch.core.octree import VoxelMap

#: dtypes a collective carries as raw bytes (gloo lacks some of them)
_AS_BYTES = (torch.bfloat16, torch.bool)


class Comm:
    """The collectives of one rank of a process group of ``size`` ranks,
    timed (host clock around each call, the device synchronised before and
    after) when ``timed``: ``seconds`` and ``calls`` accumulate per kind."""

    def __init__(self, rank: int, size: int, backend: str,
                 timed: bool = False):
        self.rank, self.size, self.backend = rank, size, backend
        self.timed = timed
        self.seconds = {"all_reduce": 0.0, "all_gather": 0.0}
        self.calls = {"all_reduce": 0, "all_gather": 0}
        self.bytes = {"all_reduce": 0, "all_gather": 0}

    def _timed(self, kind: str, t: torch.Tensor, fn):
        if not self.timed:
            return fn()
        sync = t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize(t.device)
        self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The element-wise sum of ``t`` over the ranks (a new tensor)."""
        out = t.contiguous().clone()

        def run():
            dist.all_reduce(out, op=dist.ReduceOp.SUM)
            return out
        return self._timed("all_reduce", out, run)

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order."""
        src = t.contiguous()
        wire = src.view(torch.uint8) if src.dtype in _AS_BYTES else src

        def run():
            parts = [torch.empty_like(wire) for _ in range(self.size)]
            dist.all_gather(parts, wire)
            return torch.cat(parts)
        out = self._timed("all_gather", wire, run)
        return out.view(src.dtype) if src.dtype in _AS_BYTES else out


def init_group(rank: int, world_size: int, init_method: str,
               backend: str, timeout_s: float = 120.0) -> Comm:
    """Join the process group (`dist.init_process_group` with every
    argument explicit: ``init_method`` e.g. ``tcp://127.0.0.1:<port>``)
    and return this rank's :class:`Comm` (the default group).  A CUDA
    rank calls ``torch.cuda.set_device`` first."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Comm(rank, world_size, backend)


def check_divisible(capacity: int, n: int) -> None:
    if capacity % n:
        raise ValueError(
            f"block capacity {capacity} not divisible by {n} ranks")


def map_sharding(m: VoxelMap, rank: int, n: int) -> VoxelMap:
    """Rank ``rank``'s map: its slot range of ``voxels`` (its own copy),
    the metadata as given."""
    check_divisible(m.capacity, n)
    cap_d = m.capacity // n
    return m.replace(voxels={
        k: v[rank * cap_d:(rank + 1) * cap_d].clone()
        for k, v in m.voxels.items()})


def shard_state(state, rank: int, n: int):
    """Rank ``rank``'s FrameState: its rows of the brick table, everything
    else replicated.  The held view and stored gradient table are dropped:
    the sharded raycast builds its view by the brick exchange."""
    return state.replace(map=map_sharding(state.map, rank, n), view=None,
                         grad=None)
