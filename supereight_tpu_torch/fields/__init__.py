"""Voxel field types (counterpart of `supereight_tpu/fields/__init__.py`)."""

from .ofusion import OFusionField  # noqa: F401
from .sdf import SDFField  # noqa: F401


def make_field(name: str, **kw):
    if name == "sdf":
        return SDFField(**kw)
    if name == "ofusion":
        return OFusionField(**kw)
    raise ValueError(f"unknown field {name!r}")
