"""SLAM pipeline: preprocessing, ICP tracking, fusion, raycasting
(counterpart of `supereight_tpu/pipeline`)."""

from .system import (DenseSLAMSystem, FrameState, SlamConfig,  # noqa: F401
                     init_state, process_frame)
