"""DenseSLAMSystem: the pipeline facade (counterpart of
`supereight_tpu/pipeline/system.py`: the SDF and OFusion fields, the knobs
of the ``headline`` and ``ofusion`` presets and the defaults they sit on).

All per-frame state lives in one :class:`FrameState`.  A frame runs four
stages, preprocess -> track -> integrate -> raycast; each stage is one
function that both :meth:`DenseSLAMSystem.step` and
:meth:`DenseSLAMSystem.step_staged` call.  The JAX package's in-graph gates
(``lax.cond``) are Python branches here, decided on the host.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from supereight_tpu_torch.core import octree
from supereight_tpu_torch.fields import make_field
from . import camera, integration, preprocessing, raycast, tracking
from .constants import FAR_PLANE, INVALID, NEAR_PLANE
from .preprocessing import norm


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
    block_capacity: Optional[int] = None
    raycast_normals: str = "volume"
    raycast_second_window: bool = True
    icp_finest_decimate: int = 1
    raycast_span_factor: float = 1.6
    raycast_near_rescue: bool = True
    raycast_scan_stride: float = 0.5
    raycast_grad_decim: int = 1
    alloc_rate: int = 1
    raycast_w2_budget: int = 8192
    raycast_rate: int = 1
    raycast_adaptive_deg: float = 0.0
    raycast_adaptive_dist: float = 0.12
    alloc_stride: float = 1.0
    integrate_budget: int = 0
    integrate_patch: int = 16
    bootstrap_frames: int = 3
    raycast_from_frame: int = 3
    icp_symmetric: bool = False
    field_type: str = "sdf"
    incremental_view: bool = False
    ofusion_sigma_floor: float = 0.0

    @classmethod
    def of(cls, config) -> "SlamConfig":
        """The ported knobs of ``config``: a SlamConfig or any object with
        the same attribute names (``supereight_tpu.config.Configuration``).
        Raises NotImplementedError where ``config`` sets a knob whose code
        is not ported."""
        for name, (default, why) in _UNPORTED.items():
            value = getattr(config, name, default)
            if value != default:
                raise NotImplementedError(f"{name}={value!r}: {why}")
        if getattr(config, "raycast_normals", "volume") not in ("volume",
                                                                "hybrid"):
            raise NotImplementedError(
                f"raycast_normals={config.raycast_normals!r}: {_LATER}")
        if getattr(config, "icp_symmetric", False) not in (False, True):
            raise NotImplementedError(
                f"icp_symmetric={config.icp_symmetric!r}: {_NEGATIVE}")
        if getattr(config, "incremental_view", False) and \
                getattr(config, "field_type", "sdf") == "sdf":
            raise NotImplementedError(
                "incremental_view=True on an SDF field (view_alloc_fill, "
                "integrate(view=)): not ported yet (ROADMAP queue 1, "
                "item 10)")
        return cls(**{f.name: getattr(config, f.name)
                      for f in dataclasses.fields(cls)
                      if hasattr(config, f.name)})


_LATER = "not ported yet (ROADMAP queue 1, item 10)"
_NEGATIVE = "measured negative in the JAX package; not ported"
_UNPORTED = {
    "bilateral_filter": (False, _LATER),
    "fuse_filtered": (False, _LATER),
    "raycast_full_res_scan": (False, _LATER),
    "raycast_refine": ("secant", _LATER),
    "alloc_adaptive_deg": (0.0, _LATER),
    "alloc_on_demand": (0.0, _LATER),
    "map_partitions": (1, "not ported yet (ROADMAP queue 1, item 12)"),
    "raycast_midsolve": (False, _NEGATIVE),
    "icp_robust": ("none", _NEGATIVE),
    "icp_assoc": ("nearest", _NEGATIVE),
    "bootstrap_f2f": (False, _NEGATIVE),
    "f2f_fallback": (False, _NEGATIVE),
}


@dataclasses.dataclass(frozen=True)
class FrameState:
    map: octree.VoxelMap
    pose: torch.Tensor           # camera-to-world [4,4]
    raycast_pose: torch.Tensor   # pose of the last reference raycast
    float_depth: torch.Tensor    # metric depth [H,W] (integration)
    scaled_depth: torch.Tensor   # depth for the tracking pyramid [H,W]
    ref_vertex: torch.Tensor     # [H,W,3] model vertices from last raycast
    ref_normal: torch.Tensor     # [H,W,3]
    track_result: torch.Tensor   # int32[H,W] ICP status image
    tracked: bool
    integrated: bool
    alloc_pose: torch.Tensor     # pose at the last allocation march
    alloc_count: int             # allocation marches so far
    prev_pose: torch.Tensor      # pose before the last tracked frame
    model_ref: bool              # reference maps come from a model raycast
    #: the raycaster's read view [B^3, 512] held across frames and rebuilt
    #: on integration frames (multiscale fields with incremental_view), or
    #: None to build it in every raycast
    view: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)


def init_state(size: int, dim: float, field, H: int, W: int, init_pose,
               device, capacity: Optional[int] = None,
               incremental_view: bool = False) -> FrameState:
    """Empty map at ``init_pose``; every pose field is its own buffer.
    With ``incremental_view`` the state holds the map's read view."""
    m = octree.init(size, dim, field.channels, device, capacity=capacity)
    pose = torch.as_tensor(init_pose, dtype=torch.float32, device=device)
    ref_normal = torch.zeros((H, W, 3), dtype=torch.float32, device=device)
    ref_normal[..., 0] = INVALID
    zeros = dict(dtype=torch.float32, device=device)
    return FrameState(
        map=m, pose=pose.clone(), raycast_pose=pose.clone(),
        float_depth=torch.zeros((H, W), **zeros),
        scaled_depth=torch.zeros((H, W), **zeros),
        ref_vertex=torch.zeros((H, W, 3), **zeros), ref_normal=ref_normal,
        track_result=torch.zeros((H, W), dtype=torch.int32, device=device),
        tracked=False, integrated=False, alloc_pose=pose.clone(),
        alloc_count=0, prev_pose=pose.clone(), model_ref=True,
        view=raycast.pack_view(m, field)["F"] if incremental_view else None)


def preprocessing_stage(state: FrameState, depth_mm) -> FrameState:
    """Integer depth is millimetres, float depth is metres; both are
    decimated to the state's resolution."""
    H, W = state.float_depth.shape
    if depth_mm.dtype.is_floating_point:
        ratio = depth_mm.shape[1] // W
        float_depth = depth_mm[::ratio, ::ratio].to(torch.float32)
    else:
        float_depth = preprocessing.mm_to_meters(depth_mm, (H, W))
    return state.replace(float_depth=float_depth, scaled_depth=float_depth)


def tracking_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                   neg_y: bool) -> FrameState:
    """Coarse-to-fine ICP against the last raycast's reference maps."""
    if frame % cfg.tracking_rate != 0:
        return state.replace(tracked=False)
    depths, vertices, normals = preprocessing.build_pyramid(
        state.scaled_depth, k, len(cfg.pyramid), neg_y=neg_y)
    new_pose, ok, result = tracking.track(
        state.pose, depths, vertices, normals, state.ref_vertex,
        state.ref_normal, state.raycast_pose, k, cfg.pyramid,
        cfg.icp_threshold, finest_decimate=cfg.icp_finest_decimate,
        symmetric=cfg.icp_symmetric)
    return state.replace(pose=new_pose, tracked=bool(ok),
                         track_result=result, prev_pose=state.pose)


def integration_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                      field) -> FrameState:
    """Fuse when tracked against a model map or during the bootstrap
    frames; the allocation march fires every ``alloc_rate``-th frame and
    on the first six.  OFusion's march rotates its coarse ray grid with the
    allocation count.  A held read view is rebuilt here, the only stage
    that changes the map."""
    boot = frame <= cfg.bootstrap_frames
    do_integrate = ((state.tracked and state.model_ref) or boot) and \
        (frame % cfg.integration_rate == 0 or boot)
    if not do_integrate:
        return state.replace(integrated=False)
    K = camera.camera_matrix(k)
    depth, pose = state.float_depth, state.pose
    # the float32 product the JAX stage computes
    timestamp = float(np.float32(1.0 / 30.0) * np.float32(frame))
    m = state.map
    a_pose, a_count = state.alloc_pose, state.alloc_count
    if cfg.alloc_rate <= 1 or frame % cfg.alloc_rate == 0 or frame <= 5:
        if field.multiscale_alloc:
            m = integration.allocate_ofusion(m, depth, pose, K,
                                             field.alloc_band(),
                                             phase=a_count)
        else:
            m = integration.allocate_sdf(m, depth, pose, K,
                                         field.alloc_band(),
                                         stride=cfg.alloc_stride)
        a_pose, a_count = pose.clone(), a_count + 1
    m = integration.integrate(m, field, depth, pose, K, timestamp=timestamp,
                              budget=cfg.integrate_budget,
                              patch=cfg.integrate_patch)
    view = None if state.view is None else raycast.pack_view(m, field)["F"]
    return state.replace(map=m, alloc_pose=a_pose, alloc_count=a_count,
                         integrated=True, view=view)


def raycasting_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                     field) -> FrameState:
    """Refresh the reference maps from the current pose, from frame
    ``raycast_from_frame`` on; with ``raycast_adaptive_deg`` > 0 only once
    the pose has rotated or moved past the thresholds since the last
    refresh (always up to frame 5)."""
    do_raycast = frame >= cfg.raycast_from_frame
    if do_raycast and frame > 5:
        if cfg.raycast_adaptive_deg > 0.0:
            dR = state.pose[:3, :3] @ state.raycast_pose[:3, :3].T
            cos_ang = 0.5 * (torch.trace(dR) - 1.0)
            dist = norm(state.pose[:3, 3] - state.raycast_pose[:3, 3])
            do_raycast = bool(
                (cos_ang < math.cos(math.radians(cfg.raycast_adaptive_deg)))
                | (dist > cfg.raycast_adaptive_dist))
        elif cfg.raycast_rate > 1:
            do_raycast = frame % cfg.raycast_rate == 0
    if not do_raycast:
        return state
    H, W = state.float_depth.shape
    rc = raycast.raycast(
        state.map, field, state.pose @ camera.inverse_camera_matrix(k), H, W,
        NEAR_PLANE, FAR_PLANE,
        dense=None if state.view is None else {"F": state.view},
        normals=cfg.raycast_normals,
        second_window=cfg.raycast_second_window,
        span_factor=cfg.raycast_span_factor, w2_budget=cfg.raycast_w2_budget,
        scan_stride=cfg.raycast_scan_stride,
        near_rescue=cfg.raycast_near_rescue,
        grad_decim=cfg.raycast_grad_decim)
    return state.replace(ref_vertex=rc.vertex, ref_normal=rc.normal,
                         raycast_pose=state.pose.clone(), model_ref=True)


def process_frame(state: FrameState, depth_mm, k, frame: int, *,
                  cfg: SlamConfig, field, neg_y: bool = False) -> FrameState:
    """One full SLAM frame."""
    state = preprocessing_stage(state, depth_mm)
    state = tracking_stage(state, k, frame, cfg, neg_y)
    state = integration_stage(state, k, frame, cfg, field)
    return raycasting_stage(state, k, frame, cfg, field)


class DenseSLAMSystem:
    """Stateful facade over the functional pipeline on an explicit
    ``device``.  ``step()`` runs one frame; ``step_staged()`` runs the same
    stages and times each."""

    def __init__(self, input_size: Tuple[int, int], config, device):
        self.config = cfg = SlamConfig.of(config)
        self.device = torch.device(device)
        # full float32 products on the card, as the JAX reference sets
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ratio = cfg.compute_size_ratio
        self.input_size = input_size                      # (H, W)
        self.H = input_size[0] // ratio
        self.W = input_size[1] // ratio
        if cfg.field_type == "sdf":
            self.field = make_field("sdf", mu=cfg.mu)
        else:
            vs = float(cfg.volume_size[0]) / cfg.volume_resolution[0]
            self.field = make_field(cfg.field_type, mu=cfg.mu, voxel_size=vs,
                                    sigma_floor=cfg.ofusion_sigma_floor)
        self.init_pose = camera.pose_from_translation(
            [f * s for f, s in zip(cfg.initial_pos_factor, cfg.volume_size)],
            self.device)
        self.state = init_state(cfg.volume_resolution[0],
                                float(cfg.volume_size[0]), self.field,
                                self.H, self.W, self.init_pose, self.device,
                                capacity=cfg.block_capacity,
                                incremental_view=cfg.incremental_view)

    def getPose(self) -> torch.Tensor:
        return self.state.pose

    def setPose(self, pose) -> None:
        p = torch.as_tensor(np.asarray(pose), dtype=torch.float32,
                            device=self.device)
        self.state = self.state.replace(pose=p.clone(), prev_pose=p.clone())

    def getMap(self) -> octree.VoxelMap:
        return self.state.map

    def _inputs(self, depth_mm, k):
        if not isinstance(depth_mm, torch.Tensor):
            depth_mm = np.asarray(depth_mm)
            if depth_mm.dtype == np.uint16:
                depth_mm = depth_mm.astype(np.int32)
            depth_mm = torch.from_numpy(depth_mm)
        k_host = np.asarray(k, np.float32)
        return (depth_mm.to(self.device),
                torch.from_numpy(k_host).to(self.device),
                bool(k_host[1] < 0))      # NegY normals for a flipped y

    def step(self, depth_mm, k, frame: int) -> FrameState:
        """Process one frame: ``depth_mm`` [H_in, W_in] integer millimetres,
        ``k`` (fx, fy, cx, cy) at computation resolution."""
        depth, kd, neg_y = self._inputs(depth_mm, k)
        self.state = process_frame(self.state, depth, kd, frame,
                                   cfg=self.config, field=self.field,
                                   neg_y=neg_y)
        return self.state

    def step_staged(self, depth_mm, k, frame: int
                    ) -> Tuple[FrameState, Dict[str, float]]:
        """Like :meth:`step`, returning ``(state, {stage: seconds})``; the
        host clock is read after the device finished each stage."""
        depth, kd, neg_y = self._inputs(depth_mm, k)
        stages = (
            ("preprocessing", lambda s: preprocessing_stage(s, depth)),
            ("tracking", lambda s: tracking_stage(s, kd, frame, self.config,
                                                  neg_y)),
            ("integration", lambda s: integration_stage(
                s, kd, frame, self.config, self.field)),
            ("raycasting", lambda s: raycasting_stage(
                s, kd, frame, self.config, self.field)),
        )
        st = self.state
        times = {}
        for name, fn in stages:
            t0 = time.perf_counter()
            st = fn(st)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[name] = time.perf_counter() - t0
        self.state = st
        return st, times
