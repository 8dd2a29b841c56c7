"""supereight_tpu_torch: the PyTorch + CUDA port of supereight_tpu.

The layout mirrors the JAX package (``core/``, ``fields/``, ``ops/``,
``pipeline/``, ``io/``, ``apps/``, ``tools/``, ``utils/``), so each module
here has one counterpart there to be checked against.  Users drive it as
they drive the JAX package, from the command line
(``python -m supereight_tpu_torch.apps.benchmark``, ``...apps.runner``),
on the card unless ``--device`` names another device.  Data are
dataclasses of tensors and the functions are plain functions on tensors;
every function runs on the device of its inputs.  The hand-written
kernels (``ops/integrate_kernel.py``: SDF and OFusion fusion;
``ops/gather_probe.py``: the gather-rate probe of ``probes/``) launch on
CUDA tensors and use their plain PyTorch twins on CPU tensors.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
