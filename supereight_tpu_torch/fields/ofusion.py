"""Bayesian occupancy fusion (OFusion): a log-odds field with time decay
(counterpart of `supereight_tpu/fields/ofusion.py`).  Channels: occupancy
(log-odds; empty 0, init 0) and timestamp (f32 frame time; empty 0, init 0).

The arithmetic keeps the JAX package's order of operations: ``x ** 3`` is
``lax.integer_pow``, which multiplies ``x * (x * x)``; ``jnp.log2`` is
``log(x) / log(2)``; divisions by a constant go through ``numerics.div`` so
that CUDA rounds them as the CPU does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from supereight_tpu_torch.core.numerics import div, sqrt
from supereight_tpu_torch.core.octree import ChannelSpec

CAPITAL_T = 4.0
SURF_BOUNDARY = 0.0
TOP_CLAMP = 1000.0
BOTTOM_CLAMP = -1000.0
LN2 = float(np.float32(np.log(2.0)))     # float32(log(2)), as jnp.log2 uses


def _cube(x: torch.Tensor) -> torch.Tensor:
    return x * (x * x)


def bspline_cdf(t: torch.Tensor) -> torch.Tensor:
    """Integral of the cubic bspline sensor kernel: 0 below -3, 1 above 3,
    piecewise cubic between."""
    v1 = div(_cube(3.0 + t), 48.0)                         # [-3, -1]
    v2 = 0.5 + div(t * (3.0 + t) * (3.0 - t), 24.0)        # (-1, 1]
    v3 = 1.0 - div(_cube(3.0 - t), 48.0)                   # (1, 3]
    return torch.where(t <= -3.0, 0.0,
           torch.where(t <= -1.0, v1,
           torch.where(t <= 1.0, v2,
           torch.where(t <= 3.0, v3, 1.0))))


def h_occupancy(val: torch.Tensor) -> torch.Tensor:
    """Inverse sensor model: P(occupied | distance behind the surface
    ``val``, in sigmas)."""
    return bspline_cdf(val) - 0.5 * bspline_cdf(val - 3.0)


def log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2``: ``log(x) / log(2)`` in float32."""
    return div(torch.log(x), LN2)


@dataclasses.dataclass(frozen=True)
class OFusionField:
    name: str = "ofusion"
    mu: float = 0.008                # sensor noise factor
    voxel_size: float = 0.01875      # set by the pipeline at construction
    #: lower bound on the sensor-model sigma besides 2 * voxel_size
    #: (0.0 = the reference's floor)
    sigma_floor: float = 0.0

    select_channel: str = "occupancy"
    invert_normals: bool = False
    #: allocation requests coarse octants as well as blocks
    multiscale_alloc: bool = True
    #: surface is the - -> + crossing of the log-odds
    surf_boundary: float = SURF_BOUNDARY

    @property
    def channels(self):
        return (ChannelSpec("occupancy", torch.float32, init=0.0, empty=0.0),
                ChannelSpec("timestamp", torch.float32, init=0.0, empty=0.0))

    @property
    def sigma_lo(self) -> float:
        """The sensor-model sigma's lower bound."""
        return max(2.0 * self.voxel_size, self.sigma_floor)

    def alloc_band(self) -> float:
        """band = 6 mu."""
        return 6.0 * self.mu

    def update(self, data: Dict[str, torch.Tensor], pos_cam: torch.Tensor,
               depth_sample: torch.Tensor, valid: torch.Tensor,
               timestamp: float) -> Dict[str, torch.Tensor]:
        """Per-voxel log-odds update (`ofusion.py:OFusionField.update`):
        ``pos_cam`` [..., 3] camera-space voxel centres, ``depth_sample`` the
        depth at the projected pixel, ``valid`` the in-frame gate,
        ``timestamp`` the frame time (a float32 value)."""
        z = pos_cam[..., 2]
        zsafe = torch.where(z == 0, 1.0, z)
        nx = pos_cam[..., 0] / zsafe
        ny = pos_cam[..., 1] / zsafe
        norm = sqrt(1.0 + nx * nx + ny * ny)
        diff = (z - depth_sample) * norm
        # max(lo, min(v, hi)): the lower bound wins when lo > hi
        sigma = torch.clamp(torch.clamp(self.mu * z * z, max=0.05),
                            min=self.sigma_lo)
        sample = h_occupancy(diff / sigma)
        do = valid & (depth_sample > 0) & (sample != 0.5)
        sample = torch.clamp(sample, 0.03, 0.97)

        occ = data["occupancy"]
        ts = data["timestamp"]
        ts_now = float(np.float32(timestamp))
        delta_t = ts_now - ts
        frac = torch.clamp(1.0 / (1.0 + div(delta_t, CAPITAL_T)), min=0.5)
        decayed = occ * frac
        new_occ = torch.clamp(decayed + log2(sample / (1.0 - sample)),
                              BOTTOM_CLAMP, TOP_CLAMP)
        return {"occupancy": torch.where(do, new_occ, occ),
                "timestamp": torch.where(do, ts_now, ts)}

    def is_inside(self, f):
        return f > self.surf_boundary

    def sample_valid(self, data):
        """Only voxels fused (timestamp > 0) and not free-locked count."""
        return (data["occupancy"] > -100.0) & (data["timestamp"] > 0.0)


def compute_stepsize(dist_travelled: float, hf_band: float,
                     voxel_size: float) -> float:
    """Distance-adaptive allocation step, rounded to float32 as the JAX
    function's result is: 1 voxel inside the band, 10 just outside, 30 far
    out."""
    if dist_travelled < hf_band:
        step = voxel_size
    elif dist_travelled < hf_band * 1.5:
        step = 10.0 * voxel_size
    else:
        step = 30.0 * voxel_size
    return float(np.float32(step))


def step_to_depth(step: float, max_depth: int, voxel_size: float) -> int:
    """Octree level for an allocation step (float32 log2, as in JAX)."""
    return int(np.floor(np.log2(np.float32(voxel_size / step)))) + max_depth
