"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin
(`integrate_kernel`: SDF fusion).  Sources live in ``csrc/`` and build at
first launch (`_build`)."""

from . import integrate_kernel  # noqa: F401
