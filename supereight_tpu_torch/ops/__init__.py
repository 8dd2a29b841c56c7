"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(`integrate_kernel`: SDF and OFusion fusion; `icp_kernel`: one ICP trip,
association and sums, then the solve and the pose update; `gather_probe`:
the gather-rate probe).  Sources live in ``csrc/`` and build at first
launch (`_build`)."""

from . import gather_probe, icp_kernel, integrate_kernel  # noqa: F401
