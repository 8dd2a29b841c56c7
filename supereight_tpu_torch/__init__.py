"""supereight_tpu_torch: the PyTorch + CUDA port of supereight_tpu.

The layout mirrors the JAX package (``core/``, ``fields/``, ``ops/``,
``pipeline/``), so each module here has one counterpart there to be checked
against.  Data are dataclasses of tensors and the functions are plain
functions on tensors; every function runs on the device of its inputs.  The
hand-written kernels (``ops/integrate_kernel.py``: SDF and OFusion fusion;
``ops/gather_probe.py``: the gather-rate probe of ``probes/``) launch on
CUDA tensors and use their plain PyTorch twins on CPU tensors.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
