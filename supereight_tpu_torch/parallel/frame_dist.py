"""One SLAM frame over D ranks, every stage with its collectives
(counterpart of `supereight_tpu/parallel/frame_dist.py`).

The same semantics as ``pipeline.system.process_frame`` with the same
knobs, except ``integrate_budget`` (each rank streams its own
``capacity / D`` rows, which is the compaction):

* **placement**: only the brick table ``map.voxels`` is split, by slot
  range; with ``map.partitions == D`` rank r's slot range is owner
  partition r (x-slab r of the block grid), so every per-slot update lands
  on its owner.  Metadata and image-space state are replicated.
* **tracking**: per-level image-row strips and one ``all_reduce`` of the
  normal equations' sums every trip (``tracking.track(shard=)``), between
  the two ICP kernels, with no host read: every rank runs all ``n_iters``
  trips of every level (those after the exit change nothing) and takes
  the exit from its carry, which the identical all-reduced sums keep
  identical on every rank; the finest level's status strips
  ``all_gather`` back.
* **allocation**: each rank marches a round-robin share of the ray rows;
  the request masks merge with one ``all_reduce`` (bit for bit the
  whole-frame mask) and every rank runs the same allocator on the
  replicated metadata.
* **fusion**: each rank fuses only its own rows with the field's kernel
  (``fuse_sdf`` / ``fuse_ofusion`` on a rank-local view of the table: its
  rows and its slices of ``keys`` and ``active``, its partition's count
  as ``n_blocks``); one ``all_gather`` refreshes the replicated
  ``active``.  The node pyramid updates are replicated.
* **raycast**: the frustum-limited brick exchange and the strip scan of
  `raycast_dist.py`; the reference maps ``all_gather`` back to every rank.
  Visible blocks past the exchange budget add to ``overflow``.

Gates.  JAX gates with masks and one ``lax.cond`` whose predicates are
replicated; here each gate (``do_integrate``, the allocation gates, the
raycast gate) is a Python branch on replicated values, and the
``icp_symmetric="auto"`` gate a device mask.  Every rank takes every
branch alike, so every rank issues the same collectives in the same
order.  A rank that did not would wait in its next collective until the
group's timeout.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from supereight_tpu_torch.config import SlamConfig
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.numerics import inv
from supereight_tpu_torch.pipeline import camera, integration, raycast, system
from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
from .raycast_dist import exchange_view, scan_far_extension
from .sharding import Comm, check_divisible, shard_state

#: SlamConfig field -> the sharded frame's keyword (the knobs JAX's
#: DenseSLAMSystem passes to ``process_frame``, `pipeline/system.py`)
KNOBS = {
    "pyramid": "iterations", "tracking_rate": "tracking_rate",
    "integration_rate": "integration_rate", "bilateral_filter": "bilateral",
    "icp_threshold": "icp_threshold", "raycast_normals": "normals",
    "raycast_second_window": "second_window",
    "raycast_span_factor": "span_factor", "raycast_refine": "refine",
    "raycast_rate": "raycast_rate", "icp_finest_decimate": "finest_decimate",
    "raycast_w2_budget": "w2_budget", "raycast_scan_stride": "scan_stride",
    "raycast_grad_decim": "grad_decim",
    "raycast_full_res_scan": "full_res_scan",
    "raycast_near_rescue": "near_rescue", "raycast_midsolve": "midsolve",
    "raycast_adaptive_deg": "adaptive_deg",
    "raycast_adaptive_dist": "adaptive_dist",
    "integrate_budget": "integrate_budget", "alloc_stride": "alloc_stride",
    "alloc_rate": "alloc_rate", "alloc_adaptive_deg": "alloc_adaptive_deg",
    "alloc_adaptive_dist": "alloc_adaptive_dist",
    "alloc_on_demand": "alloc_on_demand",
    "alloc_on_demand_border": "alloc_on_demand_border",
    "integrate_patch": "integrate_patch", "icp_robust": "icp_robust",
    "icp_robust_delta": "icp_robust_delta", "icp_assoc": "icp_assoc",
    "icp_symmetric": "icp_symmetric", "icp_sym_min_deg": "icp_sym_min_deg",
    "icp_sym_max_deg": "icp_sym_max_deg",
    "bootstrap_frames": "bootstrap_frames", "fuse_filtered": "fuse_filtered",
    "raycast_from_frame": "raycast_from_frame",
    "bootstrap_f2f": "bootstrap_f2f", "f2f_fallback": "f2f_fallback",
}
#: single-device knobs the sharded frame does not take, as in JAX
#: (`tests/test_sharding.py:700-714`): per-rank streaming replaces the
#: fusion budget; the depth-patch size, the fixed raycast rate (the motion
#: gate is plumbed), the OFusion coarse-zone decimation and the per-pixel
#: scan stay at their defaults (``coarse_alloc`` is a JAX frame keyword
#: only)
EXCLUDED = {"integrate_budget": 0, "integrate_patch": 16, "raycast_rate": 1,
            "coarse_alloc": True, "full_res_scan": False}


def frame_knobs(cfg) -> dict:
    """The keywords of :func:`make_process_frame_sharded` for a
    SlamConfig.  ``integrate_budget`` is dropped (the per-rank rows are the
    compaction); another excluded knob away from its default raises."""
    cfg = SlamConfig.of(cfg)
    out = {}
    for field, kw in KNOBS.items():
        v = getattr(cfg, field)
        if kw == "integrate_budget":
            continue
        if kw in EXCLUDED:
            if v != EXCLUDED[kw]:
                raise ValueError(f"{field}={v!r}: the sharded frame runs "
                                 f"only {EXCLUDED[kw]!r}")
            continue
        out[kw] = tuple(v) if kw == "iterations" else v
    return out


def _config(**knobs) -> SlamConfig:
    """The SlamConfig whose stage functions the sharded frame reuses."""
    inv_knobs = {kw: f for f, kw in KNOBS.items()}
    return SlamConfig(**{inv_knobs[k]: v for k, v in knobs.items()})


def frame_sharding(rank: int, n: int):
    """``place(state)``: the rank's state for the sharded frame (JAX
    `:79-97`): ``map.partitions`` must equal D and the capacity divide by
    it."""
    def place(state):
        check_divisible(state.map.capacity, n)
        if state.map.partitions != n:
            raise ValueError(
                f"map.partitions ({state.map.partitions}) must equal the "
                f"rank count ({n}) so slot ranges match ownership")
        return shard_state(state, rank, n)
    return place


def local_map(m: octree.VoxelMap, rank: int, n: int) -> octree.VoxelMap:
    """Rank ``rank``'s slot range as a one-partition map for the fusion
    kernel: its rows of ``voxels`` (``m.voxels``, already local), views of
    its ``keys`` and ``active`` (which the kernel updates in place) and
    its partition's count as ``n_blocks``."""
    cap_d = m.capacity // n
    s0 = rank * cap_d
    return m.replace(capacity=cap_d, keys=m.keys[s0:s0 + cap_d],
                     active=m.active[s0:s0 + cap_d],
                     n_blocks=m.part_counts[rank], partitions=1,
                     part_counts=None)


class ShardedFrame:
    """The frame of :func:`make_process_frame_sharded`: ``frame(state,
    depth_mm, k, frame_index, gt_pose=None, neg_y=False, times=None)``
    runs one frame on this rank's state; ``track_half`` and ``map_half``
    run its two halves (preprocessing and tracking; integration and
    raycast).  ``times`` (a dict) accumulates each stage's host seconds,
    the device synchronised after each."""

    def __init__(self, comm: Comm, field, H: int, W: int, knobs: dict,
                 max_visible: int):
        self.comm, self.field, self.H, self.W = comm, field, H, W
        self.cfg = _config(**knobs)
        self.max_visible = max_visible
        #: a dict for ``exchange_view``'s statistics, or None
        self.stats = None

    def _tick(self, times, name, t0, device):
        if times is None:
            return t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        times[name] = times.get(name, 0.0) + (t1 - t0)
        return t1

    def _check(self, state):
        m, n = state.map, self.comm.size
        check_divisible(m.capacity, n)
        if m.partitions != n:
            raise ValueError(f"map.partitions ({m.partitions}) != {n} ranks")

    def track_half(self, state, depth_mm, k, frame: int, gt_pose=None, *,
                   neg_y: bool = False, times=None):
        """Preprocessing (replicated) and strip-sharded tracking."""
        self._check(state)
        t0 = time.perf_counter()
        st = system.preprocessing_stage(state, depth_mm, self.cfg)
        t0 = self._tick(times, "preprocessing", t0, st.pose.device)
        comm, n = self.comm, self.comm.size
        st = system.tracking_stage(st, k, frame, self.cfg, neg_y, gt_pose,
                                   shard=(comm, comm.rank, n))
        d = self.cfg.icp_finest_decimate
        finest_rows = -(-self.H // d)
        if gt_pose is None and frame % self.cfg.tracking_rate == 0 and \
                finest_rows % n == 0:
            # the finest level ran as strips: gather the status image
            st = st.replace(track_result=comm.all_gather_cat(
                st.track_result))
        self._tick(times, "tracking", t0, st.pose.device)
        return st

    def map_half(self, state, k, frame: int, *, neg_y: bool = False,
                 times=None):
        """Gated allocation, owner-local fusion, the exchange raycast and
        the frame-to-frame publication."""
        t0 = time.perf_counter()
        st = self._integrate(state, k, frame)
        t0 = self._tick(times, "integration", t0, st.pose.device)
        st = self._raycast(st, k, frame, neg_y)
        self._tick(times, "raycasting", t0, st.pose.device)
        return st

    def __call__(self, state, depth_mm, k, frame: int, gt_pose=None, *,
                 neg_y: bool = False, times=None):
        st = self.track_half(state, depth_mm, k, frame, gt_pose,
                             neg_y=neg_y, times=times)
        return self.map_half(st, k, frame, neg_y=neg_y, times=times)

    def _integrate(self, st, k, frame: int):
        cfg, field, comm = self.cfg, self.field, self.comm
        rank, n = comm.rank, comm.size
        boot = frame <= cfg.bootstrap_frames
        if not (((st.tracked and st.model_ref) or boot)
                and (frame % cfg.integration_rate == 0 or boot)):
            return st.replace(integrated=False)
        K = camera.camera_matrix(k)
        depth = st.scaled_depth if cfg.fuse_filtered else st.float_depth
        pose = st.pose
        timestamp = float(np.float32(1.0 / 30.0) * np.float32(frame))
        m = st.map
        a_pose, a_count = st.alloc_pose, st.alloc_count
        if system._alloc_fires(st, depth, K, frame, cfg):
            band = field.alloc_band()
            if field.multiscale_alloc:
                masks = integration.ofusion_wanted_masks(
                    m, depth, pose, K, band, phase=a_count,
                    row_share=(rank, n))
                # every level's mask in one all_reduce
                merged = comm.all_reduce_sum(
                    torch.cat([mk.reshape(-1) for mk in masks]).int()) > 0
                masks = [a.reshape(mk.shape) for a, mk in zip(
                    merged.split([mk.numel() for mk in masks]), masks)]
                m = octree.allocate_octant_masks(m, masks)
            else:
                wanted = integration.sdf_wanted_mask(
                    depth, pose, K, size=m.size, dim=m.dim, band=band,
                    decim=integration._alloc_decimation(m, depth.shape),
                    stride=cfg.alloc_stride, row_share=(rank, n))
                m = octree.allocate_block_mask(
                    m, comm.all_reduce_sum(wanted.int()) > 0)
            a_pose, a_count = pose.clone(), a_count + 1
        # owner-local fusion: the kernel on this rank's rows, then the
        # replicated active flags from every rank's
        T_cw = inv(pose)
        K, depth = K.contiguous(), depth.contiguous()
        loc = local_map(m, rank, n)
        integration.fuse(field, loc, None, depth, T_cw, K, timestamp)
        m = m.replace(active=comm.all_gather_cat(loc.active))
        m = integration._update_nodes(m, field, depth, T_cw, K, timestamp)
        return st.replace(map=m, alloc_pose=a_pose, alloc_count=a_count,
                          integrated=True)

    def _raycast(self, st, k, frame: int, neg_y: bool):
        cfg, field, comm = self.cfg, self.field, self.comm
        H, W, n = self.H, self.W, comm.size
        do_raycast = system.raycast_fires(st, frame, cfg)
        if do_raycast:
            m = st.map
            view = st.pose @ camera.inverse_camera_matrix(k)
            far_ext = scan_far_extension(
                field, m.voxel_size, FAR_PLANE,
                span_factor=cfg.raycast_span_factor,
                scan_stride=cfg.raycast_scan_stride)
            dense, inside_any, n_dropped = exchange_view(
                m.voxels, m, field, view, H, W, NEAR_PLANE, far_ext,
                comm=comm, budget=self.max_visible, stats=self.stats)
            rows = H // n
            rc = raycast.raycast(
                m, field, view, H, W, NEAR_PLANE, FAR_PLANE, dense=dense,
                inside_any=inside_any, row_range=(comm.rank * rows, rows),
                normals=cfg.raycast_normals,
                second_window=cfg.raycast_second_window,
                span_factor=cfg.raycast_span_factor,
                w2_budget=cfg.raycast_w2_budget,
                scan_stride=cfg.raycast_scan_stride,
                near_rescue=cfg.raycast_near_rescue,
                grad_decim=cfg.raycast_grad_decim, refine=cfg.raycast_refine,
                midsolve=cfg.raycast_midsolve)
            vn = comm.all_gather_cat(torch.cat([rc.vertex, rc.normal], -1))
            st = st.replace(
                ref_vertex=vn[..., :3].contiguous(),
                ref_normal=vn[..., 3:].contiguous(),
                raycast_pose=st.pose.clone(), model_ref=True,
                map=m.replace(overflow=m.overflow
                              + n_dropped.sum().to(torch.int32)))
        return system.f2f_publish(st, k, frame, cfg, do_raycast, neg_y)


def make_process_frame_sharded(
        comm: Comm, field, H: int, W: int, *,
        iterations, tracking_rate: int = 1, integration_rate: int = 1,
        bootstrap_frames: int = 3, fuse_filtered: bool = False,
        raycast_from_frame: int = 3, bootstrap_f2f: bool = False,
        f2f_fallback: bool = False,
        bilateral: bool = False, icp_threshold: float = 1e-5,
        normals: str = "hybrid", second_window: bool = True,
        span_factor: float = 1.6, refine: str = "secant",
        finest_decimate: int = 1, w2_budget: int = 8192,
        scan_stride: float = 0.5, midsolve: bool = False,
        alloc_stride: float = 1.0, alloc_rate: int = 1,
        alloc_adaptive_deg: float = 0.0, alloc_adaptive_dist: float = 0.0,
        alloc_on_demand: float = 0.0,
        alloc_on_demand_border: float = 0.0,
        grad_decim: int = 1, near_rescue: bool = True,
        adaptive_deg: float = 0.0, adaptive_dist: float = 0.12,
        icp_robust: str = "none", icp_robust_delta: float = 0.01,
        icp_assoc: str = "nearest", icp_symmetric=False,
        icp_sym_min_deg: float = 0.5, icp_sym_max_deg: float = 4.5,
        max_visible_per_device: int = 1024) -> ShardedFrame:
    """The sharded frame of this rank of ``comm`` (JAX `:103-406`, the
    same keywords; :func:`frame_knobs` gives them from a SlamConfig).
    Its states come from :func:`frame_sharding`.  Raises the JAX
    package's errors where the image does not split into D strips: H % D,
    or an odd number of half-res rows a strip."""
    if normals not in ("volume", "hybrid"):
        raise ValueError(f"sharded frame supports volume/hybrid normals, "
                         f"not {normals!r}")
    n = comm.size
    if H % n:
        raise ValueError(f"image height {H} not divisible by {n}")
    rows = H // n
    half_res = H % 2 == 0 and W % 2 == 0 and W >= 160   # raycast's rule
    if half_res and (rows % 2 or (H // 2) % n):
        raise ValueError("half-res raycast strips need even per-device "
                         "rows")
    knobs = {k: v for k, v in locals().items()
             if k in set(KNOBS.values())}
    knobs["iterations"] = tuple(iterations)
    return ShardedFrame(comm, field, H, W, knobs, max_visible_per_device)
