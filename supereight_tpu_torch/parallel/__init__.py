"""The multi-device map over ``torch.distributed`` (counterpart of
`supereight_tpu/parallel`, `docs/DISTRIBUTED.md`): the brick table split
by slot range over D ranks, one process each, everything else replicated;
strip ICP, all-reduced allocation requests, owner-local fusion and the
frustum brick exchange.  JAX's mesh is a process group here
(:func:`init_group`), its ``shard_map`` body the same frame run by every
rank, ``psum`` an ``all_reduce`` and a tiled ``all_gather`` a list
``all_gather`` and a concatenation (:class:`Comm`).
"""

from .sharding import (Comm, check_divisible, init_group,  # noqa: F401
                       map_sharding, shard_state)
from .tracking_dist import sharded_reduce, track_step_sharded  # noqa: F401
from .allocation_dist import sharded_sdf_wanted_mask  # noqa: F401
from .frame_dist import frame_sharding, make_process_frame_sharded  # noqa: F401
