from supereight_tpu_torch.core import (  # noqa: F401
    algorithms,
    collision,
    meshing,
    morton,
    octree,
)
from supereight_tpu_torch.core.octree import (  # noqa: F401
    BLOCK_SIDE,
    BLOCK_VOXELS,
    ChannelSpec,
    VoxelMap,
)
