"""Runtime configuration (counterpart of `supereight_tpu/config.py`):
:class:`SlamConfig`, the knobs the port runs, and the named presets.

``PRESETS``, ``apply_preset``, ``NOISE_REGIME`` and ``apply_noise_regime``
are copied from the JAX package, not imported (the card has no JAX), and act
on a :class:`SlamConfig`.  A test holds the copies equal to the originals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """The knobs the port runs, with the defaults of
    ``supereight_tpu.config.Configuration``."""
    compute_size_ratio: int = 1
    tracking_rate: int = 1
    integration_rate: int = 2
    volume_resolution: Tuple[int, int, int] = (256, 256, 256)
    volume_size: Tuple[float, float, float] = (2.0, 2.0, 2.0)
    initial_pos_factor: Tuple[float, float, float] = (0.5, 0.5, 0.0)
    pyramid: Tuple[int, ...] = (10, 5, 4)
    mu: float = 0.1
    icp_threshold: float = 1e-5
    bilateral_filter: bool = False
    block_capacity: Optional[int] = None
    raycast_normals: str = "volume"
    raycast_second_window: bool = True
    icp_finest_decimate: int = 1
    raycast_span_factor: float = 1.6
    raycast_near_rescue: bool = True
    raycast_scan_stride: float = 0.5
    incremental_view: bool = False
    raycast_full_res_scan: bool = False
    raycast_grad_decim: int = 1
    alloc_rate: int = 1
    alloc_adaptive_deg: float = 0.0
    alloc_adaptive_dist: float = 0.24
    alloc_on_demand: float = 0.0
    alloc_on_demand_border: float = 0.0
    raycast_w2_budget: int = 8192
    raycast_refine: str = "secant"
    raycast_rate: int = 1
    raycast_adaptive_deg: float = 0.0
    raycast_adaptive_dist: float = 0.12
    alloc_stride: float = 1.0
    integrate_budget: int = 0
    integrate_patch: int = 16
    field_type: str = "sdf"
    bootstrap_frames: int = 3
    raycast_from_frame: int = 3
    fuse_filtered: bool = False
    ofusion_sigma_floor: float = 0.0
    raycast_midsolve: bool = False
    icp_robust: str = "none"              # "none" | "huber" | "tukey"
    icp_robust_delta: float = 0.01        # Huber delta / Tukey c (m)
    icp_assoc: str = "nearest"            # "nearest" | "bilinear"
    #: False | True | "auto" (symmetric only while the last pose step
    #: rotated between icp_sym_min_deg and icp_sym_max_deg)
    icp_symmetric: object = False
    icp_sym_min_deg: float = 0.5
    icp_sym_max_deg: float = 4.5
    bootstrap_f2f: bool = False
    f2f_fallback: bool = False
    #: owner partitions of the map's slot space (one per rank of the
    #: multi-device map, `parallel/`; any count that divides the block
    #: grid edge and the capacity also runs on one device)
    map_partitions: int = 1

    @classmethod
    def of(cls, config) -> "SlamConfig":
        """The knobs of ``config``: a SlamConfig or any object with the
        same attribute names (``supereight_tpu.config.Configuration``)."""
        return cls(**{f.name: getattr(config, f.name)
                      for f in dataclasses.fields(cls)
                      if hasattr(config, f.name)})


#: Named configuration presets: the validated knob stacks of the JAX
#: package (`supereight_tpu/config.py:PRESETS`, where each carries its
#: record), as SlamConfig field overrides; apply with :func:`apply_preset`.
PRESETS = {
    # 256^3 SDF throughput headline
    "headline": dict(
        field_type="sdf",
        raycast_normals="hybrid",
        raycast_adaptive_deg=3.8, raycast_adaptive_dist=0.07,
        icp_finest_decimate=2, integrate_budget=3072,
        raycast_scan_stride=1.0, alloc_rate=3, raycast_grad_decim=2,
        integration_rate=1,
    ),
    # 256^3 SDF quality point: symmetric point-to-plane, full ICP, volume
    # normals
    "quality": dict(
        field_type="sdf",
        raycast_normals="volume", raycast_near_rescue=False,
        integration_rate=1, icp_symmetric=True,
    ),
    # 256^3 OFusion throughput
    "ofusion": dict(
        field_type="ofusion", mu=0.05,
        raycast_normals="hybrid", icp_finest_decimate=2,
        integrate_budget=3072, raycast_scan_stride=1.0,
        incremental_view=True, raycast_near_rescue=False,
        integration_rate=4,
    ),
    # 256^3 OFusion precision point: exact blended gradients, full ICP,
    # the reference demo mu 0.008, trilinear re-solve
    "ofusion-fidelity": dict(
        field_type="ofusion", mu=0.008,
        raycast_normals="exact", raycast_refine="interp",
        raycast_near_rescue=False, integration_rate=4,
    ),
    # translation-dominant regime (dolly or corridor motion)
    "trans": dict(
        field_type="ofusion", mu=0.05,
        raycast_normals="volume", raycast_near_rescue=False,
        integration_rate=4,
    ),
    # Kinect-noise regime: the OFusion quality stack on filtered depth
    "noise": dict(
        field_type="ofusion", mu=0.05,
        raycast_normals="volume", raycast_near_rescue=False,
        integration_rate=4, bilateral_filter=True,
    ),
    # 512^3 SDF: full-res scan, full integrate budget, every frame fused
    "demo512-sdf": dict(
        field_type="sdf",
        volume_resolution=(512, 512, 512),
        block_capacity=24576, integrate_budget=24576,
        raycast_normals="hybrid", icp_finest_decimate=2,
        raycast_scan_stride=1.0, raycast_grad_decim=2,
        incremental_view=True, raycast_full_res_scan=True,
        integration_rate=1, icp_symmetric=True,
    ),
    # 512^3 OFusion: the on-demand (data) allocation gate
    "demo512-ofusion": dict(
        field_type="ofusion", mu=0.05,
        volume_resolution=(512, 512, 512),
        block_capacity=24576, integrate_budget=6144,
        raycast_normals="hybrid", icp_finest_decimate=2,
        raycast_scan_stride=1.0, incremental_view=True,
        alloc_on_demand=0.01, raycast_near_rescue=False,
        integration_rate=4,
    ),
    # 1024^3 OFusion: the motion allocation gate
    "1024-quality": dict(
        field_type="ofusion", mu=0.05,
        volume_resolution=(1024, 1024, 1024),
        block_capacity=196608, integrate_budget=98304,
        raycast_normals="volume", raycast_near_rescue=False,
        icp_finest_decimate=2, raycast_scan_stride=1.0,
        incremental_view=True,
        alloc_adaptive_deg=16.0, alloc_adaptive_dist=0.3,
        integration_rate=4,
    ),
}


def apply_preset(name: str, cfg: Optional[SlamConfig] = None,
                 pinned=()) -> SlamConfig:
    """``cfg`` (default-constructed if None) with the named preset's
    overrides applied; ``pinned`` field names keep their current value."""
    if name not in PRESETS:
        raise ValueError(
            f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = cfg if cfg is not None else SlamConfig()
    upd = {k: v for k, v in PRESETS[name].items() if k not in pinned}
    return dataclasses.replace(cfg, **upd)


#: the noise-validated stack, selected when the bilateral filter is on
NOISE_REGIME = dict(
    field_type="ofusion",
    raycast_normals="volume",
    integration_rate=4,
    raycast_near_rescue=False,
    mu=0.05,
)


def apply_noise_regime(cfg: SlamConfig, pinned=()) -> SlamConfig:
    """The noise stack when the bilateral filter is on, except for the
    ``pinned`` fields (``field_type`` pins the whole stack); ``cfg``
    unchanged when it is off."""
    if not cfg.bilateral_filter or "field_type" in pinned:
        return cfg
    upd = {k: v for k, v in NOISE_REGIME.items() if k not in pinned}
    return dataclasses.replace(cfg, **upd)
