"""Voxel field types (counterpart of `supereight_tpu/fields/__init__.py`)."""

from .sdf import SDFField  # noqa: F401


def make_field(name: str, **kw):
    if name == "sdf":
        return SDFField(**kw)
    if name == "ofusion":
        raise NotImplementedError(
            "the OFusion field is not ported yet (ROADMAP queue 1, item 10)")
    raise ValueError(f"unknown field {name!r}")
