"""DenseSLAMSystem: the pipeline facade (counterpart of
`supereight_tpu/pipeline/system.py`: the SDF and OFusion fields and the
knobs of every preset in `supereight_tpu_torch/config.py`).

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

from supereight_tpu_torch.config import SlamConfig
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.volume import Volume
from supereight_tpu_torch.fields import make_field
from supereight_tpu_torch.utils.perfstats import Stats
from . import (camera, gradmap, integration, preprocessing, raycast,
               raycast_graph, rendering, tracking)
from .constants import FAR_PLANE, INVALID, NEAR_PLANE
from .preprocessing import norm


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
    #: the raycaster's read view [B^3, 512] held across frames
    #: (incremental_view), or None to build it in every raycast.  A
    #: multiscale field's view is rebuilt on integration frames; an SDF
    #: view is updated in place there (allocated and fused rows only), so
    #: an earlier FrameState's view is the same tensor
    view: Optional[torch.Tensor] = None
    #: the stored gradient table bf16 [capacity, 512, 4]
    #: (``gradmap.build_table``), rebuilt on integration frames, or None
    #: unless ``raycast_normals == "stored"``
    grad: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "FrameState":
        return dataclasses.replace(self, **kw)


def init_state(size: int, dim: float, field, H: int, W: int, init_pose,
               device, capacity: Optional[int] = None,
               incremental_view: bool = False,
               grad_normals: bool = False,
               partitions: int = 1) -> FrameState:
    """Empty map of ``partitions`` owner partitions at ``init_pose``; every
    pose field is its own buffer.  With ``incremental_view`` the state
    holds the map's read view, with ``grad_normals`` an empty stored
    gradient table."""
    m = octree.init(size, dim, field.channels, device, capacity=capacity,
                    partitions=partitions)
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
        view=raycast.pack_view(m, field)["F"] if incremental_view else None,
        grad=gradmap.empty_table(m.capacity, device) if grad_normals
        else None)


@Stats.spanned("se.preprocessing.stage")
def preprocessing_stage(state: FrameState, depth_mm,
                        cfg: SlamConfig) -> FrameState:
    """Integer depth is millimetres, float depth is metres; both are
    decimated to the state's resolution.  With ``bilateral_filter`` the
    tracking pyramid's depth is filtered."""
    H, W = state.float_depth.shape
    if depth_mm.dtype.is_floating_point:
        ratio = depth_mm.shape[1] // W
        float_depth = depth_mm[::ratio, ::ratio].to(torch.float32)
    else:
        float_depth = preprocessing.mm_to_meters(depth_mm, (H, W))
    scaled_depth = preprocessing.bilateral_filter(float_depth) \
        if cfg.bilateral_filter else float_depth
    return state.replace(float_depth=float_depth, scaled_depth=scaled_depth)


@Stats.spanned("se.tracking.stage")
def tracking_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                   neg_y: bool, gt_pose=None, shard=None) -> FrameState:
    """Coarse-to-fine ICP against the last raycast's reference maps.  A
    ``gt_pose`` (float32 [4,4] on the state's device) bypasses ICP, as the
    reference's ground-truth mode does: it becomes the pose, the frame
    counts as tracked and the ICP status image is kept.  ``shard``: as
    ``tracking.track``'s (the status image is then the rank's strip).
    The level loops read nothing back (the ICP kernels' carry); the stage's
    host reads are the raycast pose's inverse (``numerics.inv``) and the
    ``tracked`` flag the integration gate takes."""
    if gt_pose is not None:
        return state.replace(pose=gt_pose.clone(), tracked=True,
                             prev_pose=state.pose.clone())
    if frame % cfg.tracking_rate != 0:
        return state.replace(tracked=False)
    with Stats.span("se.tracking.pyramid"):
        depths, vertices, normals = preprocessing.build_pyramid(
            state.scaled_depth, k, len(cfg.pyramid), neg_y=neg_y)
    sym = cfg.icp_symmetric
    if sym == "auto":
        sym = _sym_auto_gate(state, cfg.icp_sym_min_deg, cfg.icp_sym_max_deg)
    with Stats.span("se.tracking.icp"):
        new_pose, ok, result = tracking.track(
            state.pose, depths, vertices, normals, state.ref_vertex,
            state.ref_normal, state.raycast_pose, k, cfg.pyramid,
            cfg.icp_threshold, finest_decimate=cfg.icp_finest_decimate,
            symmetric=sym, robust=cfg.icp_robust,
            robust_delta=cfg.icp_robust_delta, assoc=cfg.icp_assoc,
            shard=shard)
    with Stats.host_read("tracked"):
        tracked = bool(ok)
    return state.replace(pose=new_pose, tracked=tracked,
                         track_result=result, prev_pose=state.pose)


def sym_auto_angle(state: FrameState) -> torch.Tensor:
    """The rotation (degrees, float32 on the device) of the last pose step,
    ``prev_pose`` -> ``pose``: what ``icp_symmetric="auto"`` gates on."""
    dR = state.pose[:3, :3] @ state.prev_pose[:3, :3].T
    cos_ang = torch.clamp(0.5 * (torch.trace(dR) - 1.0), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_ang))


def _sym_auto_gate(state: FrameState, min_deg: float,
                   max_deg: float) -> torch.Tensor:
    """``icp_symmetric="auto"``: symmetric point-to-plane only while the
    last pose step rotated between ``min_deg`` and ``max_deg`` degrees (a
    bool tensor on the device: no host sync)."""
    ang = sym_auto_angle(state)
    return (ang >= min_deg) & (ang <= max_deg)


def _moved(pose, ref_pose, deg: float, dist: float, site: str) -> bool:
    """Whether ``pose`` rotated more than ``deg`` degrees or moved more
    than ``dist`` metres since ``ref_pose`` (the motion gates; ``site``
    names the gate's host read)."""
    dR = pose[:3, :3] @ ref_pose[:3, :3].T
    cos_ang = 0.5 * (torch.trace(dR) - 1.0)
    d = norm(pose[:3, 3] - ref_pose[:3, 3])
    moved = (cos_ang < math.cos(math.radians(deg))) | (d > dist)
    with Stats.host_read(site):
        return bool(moved)


def _alloc_fires(state: FrameState, depth, K, frame: int,
                 cfg: SlamConfig) -> bool:
    """The allocation gate, always open up to frame 5: the unallocated
    fraction of the depth above ``alloc_on_demand``, else motion past
    ``alloc_adaptive_deg`` / ``alloc_adaptive_dist`` since the last march,
    else every ``alloc_rate``-th frame."""
    if frame <= 5:
        return True
    if cfg.alloc_on_demand > 0.0:
        frac = integration.unallocated_fraction(
            state.map, depth, state.pose, K,
            border=cfg.alloc_on_demand_border)
        with Stats.host_read("alloc_demand"):
            return bool(frac > cfg.alloc_on_demand)
    if cfg.alloc_adaptive_deg > 0.0:
        return _moved(state.pose, state.alloc_pose, cfg.alloc_adaptive_deg,
                      cfg.alloc_adaptive_dist, "alloc_motion")
    return cfg.alloc_rate <= 1 or frame % cfg.alloc_rate == 0


@Stats.spanned("se.integration.stage")
def integration_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                      field) -> FrameState:
    """Fuse when tracked against a model map or during the bootstrap
    frames (the filtered depth with ``fuse_filtered``); the allocation
    march runs when its gate opens (`_alloc_fires`).  OFusion's march
    rotates its coarse ray grid with the allocation count.  A held read
    view changes here, the only stage that changes the map: an SDF view
    takes the allocated and fused rows, a multiscale view is rebuilt."""
    boot = frame <= cfg.bootstrap_frames
    do_integrate = ((state.tracked and state.model_ref) or boot) and \
        (frame % cfg.integration_rate == 0 or boot)
    if not do_integrate:
        return state.replace(integrated=False)
    K = camera.camera_matrix(k)
    depth = state.scaled_depth if cfg.fuse_filtered else state.float_depth
    pose = state.pose
    # the float32 product the JAX stage computes
    timestamp = float(np.float32(1.0 / 30.0) * np.float32(frame))
    m, view = state.map, state.view
    live_before = octree.slot_mask(m)
    a_pose, a_count = state.alloc_pose, state.alloc_count
    if _alloc_fires(state, depth, K, frame, cfg):
        with Stats.span("se.integration.march"):
            if field.multiscale_alloc:
                m = integration.allocate_ofusion(m, depth, pose, K,
                                                 field.alloc_band(),
                                                 phase=a_count)
            else:
                m = integration.allocate_sdf(m, depth, pose, K,
                                             field.alloc_band(),
                                             stride=cfg.alloc_stride)
        a_pose, a_count = pose.clone(), a_count + 1
    args = dict(timestamp=timestamp, budget=cfg.integrate_budget,
                patch=cfg.integrate_patch)
    if view is not None and not field.multiscale_alloc:
        with Stats.span("se.integration.view_fill"):
            view = raycast.view_alloc_fill(view, m, live_before, field)
        with Stats.span("se.integration.fuse"):
            m, view = integration.integrate(m, field, depth, pose, K,
                                            view=view, **args)
    else:
        with Stats.span("se.integration.fuse"):
            m = integration.integrate(m, field, depth, pose, K, **args)
        if view is not None:
            with Stats.span("se.integration.view_fill"):
                view = raycast.pack_view(m, field)["F"]
    grad = None if state.grad is None else gradmap.build_table(m, field)
    return state.replace(map=m, alloc_pose=a_pose, alloc_count=a_count,
                         integrated=True, view=view, grad=grad)


@Stats.spanned("se.raycasting.stage")
def raycasting_stage(state: FrameState, k, frame: int, cfg: SlamConfig,
                     field, neg_y: bool = False) -> FrameState:
    """Refresh the reference maps from the current pose, from frame
    ``raycast_from_frame`` on; with ``raycast_adaptive_deg`` > 0 only once
    the pose has rotated or moved past the thresholds since the last
    refresh (always up to frame 5).

    Frame-to-frame publication: with ``bootstrap_f2f`` before the first
    model raycast, and with ``f2f_fallback`` whenever this frame's tracking
    failed, this frame's own vertex and normal maps (world space; ``neg_y``
    as in tracking) become the reference, so the next frame tracks against
    it; ``model_ref`` then turns False and suppresses fusion until the
    next model raycast.  On the card the raycast is one CUDA graph replay
    where ``raycast_graph.eager_reason`` allows it."""
    do_raycast = raycast_fires(state, frame, cfg)
    if do_raycast:
        H, W = state.float_depth.shape
        rc = raycast_graph.raycast(
            state.map, field, state.pose, k, H, W, NEAR_PLANE, FAR_PLANE,
            view=state.view, grad_table=state.grad,
            normals=cfg.raycast_normals,
            second_window=cfg.raycast_second_window,
            span_factor=cfg.raycast_span_factor,
            w2_budget=cfg.raycast_w2_budget,
            scan_stride=cfg.raycast_scan_stride,
            near_rescue=cfg.raycast_near_rescue,
            grad_decim=cfg.raycast_grad_decim, refine=cfg.raycast_refine,
            full_res_scan=cfg.raycast_full_res_scan,
            midsolve=cfg.raycast_midsolve)
        state = state.replace(ref_vertex=rc.vertex, ref_normal=rc.normal,
                              raycast_pose=state.pose.clone(),
                              model_ref=True)
    return f2f_publish(state, k, frame, cfg, do_raycast, neg_y)


def raycast_fires(state: FrameState, frame: int, cfg: SlamConfig) -> bool:
    """The reference maps' refresh gate (see :func:`raycasting_stage`)."""
    do_raycast = frame >= cfg.raycast_from_frame
    if do_raycast and frame > 5:
        if cfg.raycast_adaptive_deg > 0.0:
            do_raycast = _moved(state.pose, state.raycast_pose,
                                cfg.raycast_adaptive_deg,
                                cfg.raycast_adaptive_dist, "raycast_motion")
        elif cfg.raycast_rate > 1:
            do_raycast = frame % cfg.raycast_rate == 0
    return do_raycast


def f2f_publish(state: FrameState, k, frame: int, cfg: SlamConfig,
                do_raycast: bool, neg_y: bool) -> FrameState:
    """The frame-to-frame publication of :func:`raycasting_stage`."""
    publish = (cfg.bootstrap_f2f and not do_raycast
               and frame < cfg.raycast_from_frame) or \
        (cfg.f2f_fallback and not state.tracked
         and frame >= cfg.raycast_from_frame)
    if not publish:
        return state
    with Stats.span("se.raycasting.f2f"):
        _, v0, n0 = preprocessing.build_pyramid(state.scaled_depth, k, 1,
                                                neg_y=neg_y)
        invalid = n0[0][..., 0] == INVALID
        w_n = torch.where(invalid[..., None], n0[0],
                          camera.rotate_vectors(state.pose, n0[0]))
        return state.replace(
            ref_vertex=camera.transform_points(state.pose, v0[0]),
            ref_normal=w_n, raycast_pose=state.pose.clone(),
            model_ref=False)


def process_frame(state: FrameState, depth_mm, k, frame: int, *,
                  cfg: SlamConfig, field, neg_y: bool = False,
                  gt_pose=None) -> FrameState:
    """One full SLAM frame (``gt_pose``: see :func:`tracking_stage`)."""
    state = preprocessing_stage(state, depth_mm, cfg)
    state = tracking_stage(state, k, frame, cfg, neg_y, gt_pose)
    state = integration_stage(state, k, frame, cfg, field)
    return raycasting_stage(state, k, frame, cfg, field, neg_y)


def config_field(cfg: SlamConfig):
    """The field a configuration's system runs (SDF or OFusion)."""
    if cfg.field_type == "sdf":
        return make_field("sdf", mu=cfg.mu)
    vs = float(cfg.volume_size[0]) / cfg.volume_resolution[0]
    return make_field(cfg.field_type, mu=cfg.mu, voxel_size=vs,
                      sigma_floor=cfg.ofusion_sigma_floor)


class DenseSLAMSystem:
    """Stateful facade over the functional pipeline (the reference's
    ``DenseSLAMSystem`` API) on ``device``, the card unless the caller asks
    for another, configured by a :class:`SlamConfig` (e.g.
    ``config.apply_preset(name, SlamConfig(...))``) or any object with its
    attribute names.  ``step()`` runs one frame; ``step_staged()`` runs the
    same stages and times each; ``preprocessing`` .. ``raycasting`` run one
    stage each."""

    def __init__(self, input_size: Tuple[int, int], config,
                 device="cuda"):
        self.config = cfg = SlamConfig.of(config)
        self.device = torch.device(device)
        # full float32 products on the card, as the JAX reference sets
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ratio = cfg.compute_size_ratio
        self.input_size = input_size                      # (H, W)
        self.H = input_size[0] // ratio
        self.W = input_size[1] // ratio
        self.field = config_field(cfg)
        self.init_pose = camera.pose_from_translation(
            [f * s for f, s in zip(cfg.initial_pos_factor, cfg.volume_size)],
            self.device)
        self.state = init_state(cfg.volume_resolution[0],
                                float(cfg.volume_size[0]), self.field,
                                self.H, self.W, self.init_pose, self.device,
                                capacity=cfg.block_capacity,
                                incremental_view=cfg.incremental_view,
                                grad_normals=cfg.raycast_normals == "stored",
                                partitions=cfg.map_partitions)
        self._view_pose = None

    # ---- the reference's accessors ----

    def getPosition(self) -> torch.Tensor:
        return self.state.pose[:3, 3]

    def getPose(self) -> torch.Tensor:
        return self.state.pose

    def setPose(self, pose) -> None:
        p = self._pose(pose)
        self.state = self.state.replace(pose=p.clone(), prev_pose=p.clone())

    def setViewPose(self, pose=None) -> None:
        self._view_pose = pose

    def getMap(self) -> octree.VoxelMap:
        return self.state.map

    def getVolume(self) -> Volume:
        """Metric-space continuous view of the map."""
        return Volume(self.state.map, self.field.select_channel)

    def getInitPos(self) -> torch.Tensor:
        return self.init_pose[:3, 3]

    # the host's uploads: a copy from pageable host memory waits for the
    # device's stream, so each is a host read

    def _pose(self, pose) -> torch.Tensor:
        with Stats.span("se.entry.upload"), Stats.host_read("pose"):
            return torch.as_tensor(np.asarray(pose, np.float32),
                                   device=self.device)

    def _depth(self, depth_mm) -> torch.Tensor:
        with Stats.span("se.entry.upload"):
            if not isinstance(depth_mm, torch.Tensor):
                depth_mm = np.asarray(depth_mm)
                if depth_mm.dtype == np.uint16:
                    depth_mm = depth_mm.astype(np.int32)
                depth_mm = torch.from_numpy(depth_mm)
            with Stats.host_read("depth"):
                return depth_mm.to(self.device)

    def _k(self, k) -> Tuple[torch.Tensor, bool]:
        """``k`` on the device, and whether fy < 0 (NegY normals for a
        flipped y)."""
        with Stats.span("se.entry.upload"):
            k_host = np.asarray(k, np.float32)
            with Stats.host_read("intrinsics"):
                kd = torch.from_numpy(k_host).to(self.device)
            return kd, bool(k_host[1] < 0)

    # ---- one stage each (the reference's preprocessing / tracking /
    # integration / raycasting) ----

    def preprocessing(self, depth_mm) -> bool:
        self.state = preprocessing_stage(self.state, self._depth(depth_mm),
                                         self.config)
        return True

    def tracking(self, k, frame: int, gt_pose=None) -> bool:
        kd, neg_y = self._k(k)
        gt = None if gt_pose is None else self._pose(gt_pose)
        self.state = tracking_stage(self.state, kd, frame, self.config,
                                    neg_y, gt)
        return self.state.tracked

    def integration(self, k, frame: int) -> bool:
        kd, _ = self._k(k)
        self.state = integration_stage(self.state, kd, frame, self.config,
                                       self.field)
        return self.state.integrated

    def raycasting(self, k, frame: int) -> bool:
        kd, neg_y = self._k(k)
        self.state = raycasting_stage(self.state, kd, frame, self.config,
                                      self.field, neg_y)
        return frame > 2

    # ---- a whole frame ----

    def step(self, depth_mm, k, frame: int, gt_pose=None) -> FrameState:
        """Process one frame: ``depth_mm`` [H_in, W_in] integer millimetres,
        ``k`` (fx, fy, cx, cy) at computation resolution; ``gt_pose``
        [4,4] bypasses ICP (the reference's ground-truth mode)."""
        depth, (kd, neg_y) = self._depth(depth_mm), self._k(k)
        gt = None if gt_pose is None else self._pose(gt_pose)
        self.state = process_frame(self.state, depth, kd, frame,
                                   cfg=self.config, field=self.field,
                                   neg_y=neg_y, gt_pose=gt)
        return self.state

    def step_staged(self, depth_mm, k, frame: int, gt_pose=None
                    ) -> Tuple[FrameState, Dict[str, float]]:
        """Like :meth:`step`, returning ``(state, {stage: seconds})``; the
        host clock is read after the device finished each stage."""
        depth, (kd, neg_y) = self._depth(depth_mm), self._k(k)
        gt = None if gt_pose is None else self._pose(gt_pose)
        stages = (
            ("preprocessing", lambda s: preprocessing_stage(s, depth,
                                                            self.config)),
            ("tracking", lambda s: tracking_stage(s, kd, frame, self.config,
                                                  neg_y, gt)),
            ("integration", lambda s: integration_stage(
                s, kd, frame, self.config, self.field)),
            ("raycasting", lambda s: raycasting_stage(
                s, kd, frame, self.config, self.field, neg_y)),
        )
        st = self.state
        times = {}
        for name, fn in stages:
            t0 = time.perf_counter()
            st = fn(st)
            self.synchronize()
            times[name] = time.perf_counter() - t0
        self.state = st
        return st, times

    def synchronize(self) -> None:
        """Wait for the device to finish the work queued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- renderers (uint8 [H, W, 4] images) ----

    @Stats.spanned("se.rendering.depth")
    def renderDepth(self) -> torch.Tensor:
        return rendering.render_depth(self.state.scaled_depth)

    @Stats.spanned("se.rendering.track")
    def renderTrack(self) -> torch.Tensor:
        return rendering.render_track(self.state.track_result)

    @Stats.spanned("se.rendering.volume")
    def renderVolume(self, view_pose=None, k=None) -> torch.Tensor:
        """The shaded surface of the last raycast's reference maps, or,
        given ``view_pose`` and ``k``, of a raycast from that view."""
        st = self.state
        if view_pose is None:
            return rendering.render_volume(
                st.map, self.field, None, self.H, self.W,
                vertex=st.ref_vertex, normal=st.ref_normal)
        kd, _ = self._k(k)
        view = self._pose(view_pose) @ camera.inverse_camera_matrix(kd)
        return rendering.render_volume(st.map, self.field, view,
                                       self.H, self.W)

    # ---- map outputs ----

    def dump_mesh(self, filename: str) -> torch.Tensor:
        """Mesh the map in place on its device (``marching_cubes`` on the
        field's select channel and inside test), write the triangles as a
        legacy VTK file and return them (float32 [n, 3, 3], metres)."""
        from supereight_tpu_torch.core import meshing
        from supereight_tpu_torch.io import vtk
        tris = meshing.marching_cubes(self.state.map,
                                      self.field.select_channel,
                                      inside=self.field.is_inside)
        vtk.write_vtk_mesh(filename, tris)
        return tris
