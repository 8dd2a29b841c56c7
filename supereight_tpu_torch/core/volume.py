"""Continuous metric-space view over the voxel map (counterpart of
`supereight_tpu/core/volume.py`).

Reference: `se_denseslam/include/se/continuous/volume_template.hpp:49-115`
(``VolumeTemplate``): pos<->voxel scaling for get / interp / grad.
"""

from __future__ import annotations

import torch

from . import octree
from .numerics import trunc_i32
from .octree import VoxelMap


class Volume:
    """Metric-space adapter: positions [..., 3] in metres (float32 tensors
    on the map's device), data from the map."""

    def __init__(self, m: VoxelMap, select_channel: str):
        self.map = m
        self.channel = select_channel

    @property
    def dim(self) -> float:
        return self.map.dim

    @property
    def size(self) -> int:
        return self.map.size

    def _scale(self, pos) -> torch.Tensor:
        pos = torch.as_tensor(pos, dtype=torch.float32,
                              device=self.map.device)
        return pos * self.map.inverse_voxel_size

    def _voxel(self, pos):
        v = trunc_i32(self._scale(pos))
        return v[..., 0], v[..., 1], v[..., 2]

    def get(self, pos, channel=None) -> torch.Tensor:
        """Nearest-voxel value (``VolumeTemplate::get``)."""
        return octree.get(self.map, channel or self.channel,
                          *self._voxel(pos))

    def get_multiscale(self, pos, channel=None) -> torch.Tensor:
        """Deepest-allocated-octant value (``Octree::get``)."""
        return octree.get_multiscale(self.map, channel or self.channel,
                                     *self._voxel(pos))

    def interp(self, pos, channel=None) -> torch.Tensor:
        """Trilinear interpolation (`volume_template.hpp:88-93`)."""
        return octree.interp(self.map, channel or self.channel,
                             self._scale(pos))

    def interp_multiscale(self, pos, channel=None) -> torch.Tensor:
        """Trilinear interpolation whose corners fall back to the deepest
        allocated node value where leaf blocks are missing (the right
        interpolation for occupancy maps)."""
        return octree.interp_multiscale(self.map, channel or self.channel,
                                        self._scale(pos))

    def grad(self, pos, channel=None) -> torch.Tensor:
        """Field gradient (`volume_template.hpp:95-101`)."""
        return octree.grad(self.map, channel or self.channel,
                           self._scale(pos))
