"""KinectFusion-style truncated signed distance field (counterpart of
`supereight_tpu/fields/sdf.py`).  Channels: tsdf (empty 1, init 1) and
weight (empty -1, init 0)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from supereight_tpu_torch.core.numerics import fma, sqrt
from supereight_tpu_torch.core.octree import ChannelSpec


@dataclasses.dataclass(frozen=True)
class SDFField:
    name: str = "sdf"
    mu: float = 0.1                 # truncation band (m)
    max_weight: float = 100.0       # weight cap

    #: channel marched / interpolated by the raycaster
    select_channel: str = "tsdf"
    #: SDF surfaces need the gradient negated
    invert_normals: bool = True
    #: allocation is single-scale (blocks only)
    multiscale_alloc: bool = False
    #: surface is the + -> - zero crossing of tsdf
    surf_boundary: float = 0.0

    @property
    def channels(self):
        return (ChannelSpec("tsdf", torch.float32, init=1.0, empty=1.0),
                ChannelSpec("weight", torch.float32, init=0.0, empty=-1.0))

    def alloc_band(self) -> float:
        """Allocate a +/- mu band around the surface."""
        return 2.0 * self.mu

    def update(self, data: Dict[str, torch.Tensor], pos_cam: torch.Tensor,
               depth_sample: torch.Tensor, valid: torch.Tensor,
               timestamp: float = 0.0) -> Dict[str, torch.Tensor]:
        """Per-voxel projective TSDF update (`sdf.py:SDFField.update`):
        ``pos_cam`` [..., 3] camera-space voxel centres, ``depth_sample`` the
        depth at the projected pixel, ``valid`` the in-frame gate.  The
        frame ``timestamp`` is unused (the SDF keeps no time).

        Rounded as the jitted JAX update rounds: the sum of squares and
        ``w * tsdf + sdf`` are multiply-adds, the root is correctly
        rounded, and the division by ``mu`` is a product with its float32
        reciprocal."""
        z = pos_cam[..., 2]
        zsafe = torch.where(z == 0, 1.0, z)
        nx = pos_cam[..., 0] / zsafe
        ny = pos_cam[..., 1] / zsafe
        norm = sqrt(fma(ny, ny, fma(nx, nx, torch.ones_like(nx))))
        diff = (depth_sample - z) * norm
        do = valid & (depth_sample > 0) & (diff > -self.mu)
        inv_mu = float(np.float32(1.0) / np.float32(self.mu))
        sdf = torch.clamp(diff * inv_mu, max=1.0)
        w = data["weight"]
        tsdf = data["tsdf"]
        new_tsdf = torch.clamp(fma(w, tsdf, sdf) / (w + 1.0), -1.0, 1.0)
        new_w = torch.clamp(w + 1.0, max=self.max_weight)
        return {"tsdf": torch.where(do, new_tsdf, tsdf),
                "weight": torch.where(do, new_w, w)}

    def is_inside(self, f):
        return f < self.surf_boundary

    def sample_valid(self, data):
        """weight == 0 marks allocated-but-never-fused voxels."""
        return data["weight"] != 0
