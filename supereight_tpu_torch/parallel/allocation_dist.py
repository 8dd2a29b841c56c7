"""Distributed allocation: image-strip band march + one all_reduce of the
request mask + the allocator on replicated metadata (counterpart of
`supereight_tpu/parallel/allocation_dist.py`).

1. each rank marches the allocation rays of its strip of the depth image;
2. the partial block-request masks merge with one ``all_reduce`` (int32
   sum, JAX's ``psum`` of the mask): every rank then knows every requested
   block, the reference's shared allocation list;
3. every rank runs the same deterministic allocator
   (``octree.allocate_block_mask`` with ``partitions == D``) on the
   replicated metadata, so each new block's slot lies in its owner's slot
   range and no two ranks contend for a slot.
"""

from __future__ import annotations

from supereight_tpu_torch.pipeline import integration
from .sharding import Comm


def sharded_sdf_wanted_mask(comm: Comm, H: int, W: int, *, size: int,
                            dim: float, band: float):
    """``mask_fn(depth, pose, K) -> bool[B,B,B]`` (JAX `:37-63`): the band
    march over this rank's ``H / D`` image rows at full ray resolution, so
    the OR of the strips' masks equals the full frame's bit for bit."""
    n = comm.size
    if H % n:
        raise ValueError(f"image height {H} not divisible by {n}")
    rows = H // n

    def mask_fn(depth, pose, K):
        r0 = comm.rank * rows
        partial = integration.sdf_wanted_mask(
            depth[r0:r0 + rows], pose, K, size=size, dim=dim, band=band,
            decim=1, row0=r0)
        return comm.all_reduce_sum(partial.int()) > 0

    return mask_fn
