"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(`integrate_kernel`: SDF and OFusion fusion, the frustum selection before
it and the node-pyramid update after it; `icp_kernel`: ICP's trips;
`pyramid_kernel`: the tracking pyramid, one launch for every level;
`numerics_kernel`: the 4x4 inverse; `raycast_kernel`: the raycast's splat
bounds, ray scans and full-resolution re-solve with its normals;
`gather_probe`: the gather-rate probe).  Sources live in ``csrc/`` and
build at first launch (`_build`)."""

from . import (gather_probe, icp_kernel, integrate_kernel,  # noqa: F401
               numerics_kernel, pyramid_kernel, raycast_kernel)
