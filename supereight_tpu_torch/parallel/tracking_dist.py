"""Distributed ICP: image-strip residuals + one all_reduce of the normal
equations (counterpart of `supereight_tpu/parallel/tracking_dist.py`).

The reference reduces per-pixel ICP residuals through an 8-stripe OpenMP
buffer (`tracking.cpp:66-224`); across ranks each computes the sums of its
row strip and one all_reduce gives every rank the global 6x6 system, so
the pose update is the same on every rank.  The whole-frame tracker does
this level by level (``tracking.track(shard=)``), every trip of its device
loop between the two ICP kernels; the helpers here are one plain
iteration of it (the JAX module's API).
"""

from __future__ import annotations

from supereight_tpu_torch.pipeline import camera, tracking
from .sharding import Comm


def sharded_reduce(comm: Comm):
    """``reduce(td) -> (error2, JTe, JTJ, count)`` (JAX `:26-55`): the sums
    over this rank's rows of the per-pixel track data (rows divisible by
    D), all-reduced."""
    def reduce(td: tracking.TrackData):
        rows = td.result.shape[0] // comm.size
        if td.result.shape[0] % comm.size:
            raise ValueError(f"{td.result.shape[0]} rows not divisible by "
                             f"{comm.size}")
        r0 = comm.rank * rows
        strip = tracking.TrackData(*(a[r0:r0 + rows] for a in td))
        return tracking.all_reduce_sums(comm,
                                        *tracking.reduce_kernel(strip))
    return reduce


def track_step_sharded(comm: Comm, pose, in_vertex, in_normal, ref_vertex,
                       ref_normal, view):
    """One ICP iteration with the reduction over the ranks (JAX `:58-67`):
    returns (pose update applied to ``pose``, error2, count), the same on
    every rank."""
    td = tracking.track_kernel(in_vertex, in_normal, ref_vertex, ref_normal,
                               pose, view)
    e2, JTe, JTJ, count = sharded_reduce(comm)(td)
    x = tracking.solve_normal_equations(JTe, JTJ)
    return camera.se3_exp(x) @ pose, e2, count
