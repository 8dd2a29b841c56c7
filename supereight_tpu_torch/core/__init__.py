from supereight_tpu_torch.core import morton, octree  # noqa: F401
from supereight_tpu_torch.core.octree import (  # noqa: F401
    BLOCK_SIDE,
    BLOCK_VOXELS,
    ChannelSpec,
    VoxelMap,
)
