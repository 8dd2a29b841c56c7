"""The comparison that decides a run's ``correct``.

At the frames a run samples, the harness keeps the port's state before the
frame and its outputs after it (:func:`snapshot`).  Once the window has
closed, :func:`reference_frame` works the frame out again with the plain
reference from the same depth and the port's state before it, one stage at
a time: each stage starts from the port's own output of the stage before,
so that a gap shows in the stage that made it.  :func:`compare` reduces
the two sides to the numbers that the configuration's ``check`` limits
hold; the control (``prec="bf16"``) stands in the port's place the same
way.  The configuration's ``field_type`` picks the reference's stages:
the SDF's (``reference/slam.py``) or OFusion's (``reference/ofusion.py``),
whose map also holds the coarse node pyramid.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from slambench.reference import ofusion, slam

#: the numbers compared, each held to ``limits[name]`` (a gap may not
#: exceed it)
NUMBERS = ("depth_m", "pose_mm", "blocks", "voxels_pct", "raycast_pct",
           "images_pct")
#: a voxel differs where its tsdf moved by more than this (tsdf units of
#: mu) or its weight differs; a pixel where a vertex coordinate moved by
#: more than VERTEX_TOL metres or a normal component by NORMAL_TOL
TSDF_TOL, VERTEX_TOL, NORMAL_TOL = 1e-4, 1e-4, 1e-3
#: an OFusion voxel or node cell differs where its occupancy moved by more
#: than this (log-odds) or its timestamp differs: a 500th of one full-
#: confidence update (log2(0.97 / 0.03) = 5.01), 160 float32 ulps at the
#: +-1000 clamp, so that rounding passes and a skipped or altered update
#: does not
OCC_TOL = 1e-2


def _map(state, size: int, dim: float):
    m = state.map
    if "occupancy" in m.voxels:
        return ofusion.Map(
            size=size, dim=dim, block_index=m.block_index.clone(),
            n_blocks=int(m.n_blocks), active=m.active.clone(),
            occupancy=m.voxels["occupancy"].clone(),
            timestamp=m.voxels["timestamp"].clone(),
            node_alloc=[a.clone() for a in m.node_alloc],
            node_occ=[v["occupancy"].clone() for v in m.node_values],
            node_ts=[v["timestamp"].clone() for v in m.node_values])
    return slam.Map(size=size, dim=dim, block_index=m.block_index.clone(),
                    n_blocks=int(m.n_blocks), active=m.active.clone(),
                    tsdf=m.voxels["tsdf"].clone(),
                    weight=m.voxels["weight"].clone())


def snapshot(state, size: int, dim: float, images=None) -> dict:
    """Clones of what a frame starts from or produced (the port's
    ``FrameState``; its map tables are updated in place, so they are
    copied on the device)."""
    return dict(pose=state.pose.clone(), raycast_pose=state.raycast_pose
                .clone(), ref_vertex=state.ref_vertex.clone(),
                ref_normal=state.ref_normal.clone(),
                scaled_depth=state.scaled_depth.clone(),
                track_result=state.track_result.clone(),
                tracked=bool(state.tracked), integrated=bool(state.integrated),
                alloc_count=int(state.alloc_count),
                model_ref=bool(state.model_ref), map=_map(state, size, dim),
                images=None if images is None
                else [im.clone() for im in images])


def reference_frame(before: dict, after: dict, depth_mm: np.ndarray,
                    frame: int, cell, prec: str = "f32") -> dict:
    """The frame's outputs by the plain reference at ``prec``, each stage
    from the port's ``before`` state and the port's own output of the
    stage before (``after``)."""
    cfg, dev = cell.system, before["pose"].device
    ofu = cfg.field_type == "ofusion"
    k = torch.tensor(cell.k, dtype=torch.float32, device=dev)
    q = slam.rounder(prec)
    depth = torch.from_numpy(depth_mm.astype(np.int32)).to(dev)
    float_d, scaled = slam.preprocess(depth, cfg.bilateral_filter, prec)
    out = dict(scaled_depth=scaled, pose=before["pose"], map=before["map"],
               ref_vertex=before["ref_vertex"],
               ref_normal=before["ref_normal"], images=None, work={})
    out["matched"] = None
    if frame % cfg.tracking_rate == 0:
        _, verts, norms = slam.pyramid(scaled, k, len(cfg.pyramid), prec)
        tr = slam.icp(q(before["pose"]), verts, norms, before["ref_vertex"],
                      before["ref_normal"], before["raycast_pose"], k,
                      cfg.pyramid, cfg.icp_threshold, prec)
        out["pose"] = tr.pose
        view = slam.camera_matrix(k) @ slam.inv4(before["raycast_pose"])
        status, _, J = slam.track_pixels(
            verts[0], norms[0], q(before["ref_vertex"]),
            q(before["ref_normal"]), tr.pose, view)
        ok = status == 1
        out["matched"] = (verts[0][ok], J[ok][:, :3])
    boot = frame <= cfg.bootstrap_frames
    if ((after["tracked"] and before["model_ref"]) or boot) and \
            (frame % cfg.integration_rate == 0 or boot):
        K = slam.camera_matrix(k)
        pose = q(after["pose"])
        if ofu:
            m = ofusion.allocate(before["map"], ofusion.wanted_masks(
                float_d, pose, K, cell.size, cell.dim, 6.0 * cfg.mu,
                before["alloc_count"], prec))
        else:
            m = slam.allocate(before["map"], slam.wanted_blocks(
                float_d, pose, K, cell.size, cell.dim, 2.0 * cfg.mu, prec))
        out["work"]["fused_blocks"] = int(
            m.active[slam.live_coords(m)[0]].sum())
        if ofu:
            out["map"], out["work"]["nodes"] = ofusion.fuse(
                m, float_d, pose, K, cfg.mu,
                max(2.0 * m.vs, cfg.ofusion_sigma_floor),
                ofusion.frame_time(frame), prec)
        else:
            out["map"] = slam.fuse(m, float_d, pose, K, cfg.mu, 100.0, prec)
    if frame >= cfg.raycast_from_frame:
        am = after["map"]
        knobs = (cfg.raycast_span_factor, cfg.raycast_scan_stride,
                 cfg.raycast_w2_budget, prec, cfg.raycast_near_rescue,
                 cfg.raycast_normals)
        if ofu:
            v, n = ofusion.raycast(am._replace(
                occupancy=q(am.occupancy), node_occ=[q(o) for o in
                                                     am.node_occ]),
                q(after["pose"]), k, *scaled.shape, *knobs)
        else:
            v, n = slam.raycast(am._replace(tsdf=q(am.tsdf)),
                                q(after["pose"]), k, *scaled.shape, cfg.mu,
                                *knobs)
        out["ref_vertex"], out["ref_normal"] = v, n
        hit = v[..., 2] != 0
        vox = torch.floor(v[hit] * (cell.size / cell.dim)).long() >> 3
        out["work"]["hit_blocks"] = int(torch.unique(
            (vox[:, 0] * 4096 + vox[:, 1]) * 4096 + vox[:, 2]).numel())
    if after["images"] is not None:
        out["images"] = [
            slam.render_depth(q(after["scaled_depth"])),
            slam.render_track(after["track_result"]),
            slam.render_volume(q(after["ref_vertex"]),
                               q(after["ref_normal"]))]
    return out


def _pose_distance_mm(a, b) -> float:
    """The translation gap plus the rotation gap at a 1 m lever, in mm.
    The angle is ||Ra - Rb||_F / sqrt(2) (the angle to first order): a
    float32 rotation is not orthonormal to its last bit, and the arccos of
    Ra Rb^T's trace would read 0.1 mm where the two are equal."""
    a, b = a.double().cpu(), b.double().cpu()
    rot = float(torch.linalg.norm(a[:3, :3] - b[:3, :3])) / math.sqrt(2.0)
    return 1000.0 * (float(torch.linalg.norm(a[:3, 3] - b[:3, 3])) + rot)


def _pose_gap_mm(a, b, matched) -> float:
    """The gap of the tracked pose ``a`` from the reference's ``b`` as
    the frame sees it, in mm: ICP's own point-to-plane measure.
    ``matched`` holds the finest level's points that ICP associates with
    the model at ``b`` (camera frame) and the model's normals there
    (world frame, ``track_pixels``' Jacobian rows); the gap is the root
    mean square, over them, of the distance between the point placed by
    ``a`` and by ``b``, taken along its normal.  Where a frame's surfaces
    leave a direction nearly free and its ICP ends its trips before it
    has converged, rounding alone moves the end millimetres along that
    direction (a float32 ulp of the start pose moves the reference's own
    end by up to 2.6 mm at the handheld loop's phase 359, frame 8) and
    no matched point off its surface; a pose moved off the frame's
    surfaces reads its full distance.  With no matched point (a frame
    that does not track, or before there is a model), the distance of
    the two poses."""
    if matched is None or matched[0].shape[0] == 0:
        return _pose_distance_mm(a, b)
    p, n = matched[0].double(), matched[1].double()
    a, b = a.double().to(p.device), b.double().to(p.device)
    moved = p @ (a[:3, :3] - b[:3, :3]).T + (a[:3, 3] - b[:3, 3])
    along = (moved * n).sum(-1)
    return 1000.0 * float(torch.sqrt((along * along).mean()))


def _cells_differ(occ_a, occ_b, ts_a, ts_b):
    return (torch.abs(occ_a - occ_b) > OCC_TOL) | (ts_a != ts_b)


def _map_gap(a, b):
    """(blocks allocated on one side only, plus common blocks whose active
    flag differs; the share in % of the common blocks' voxels that
    differ).  An OFusion map's coarse octants count with its blocks, and
    its common node cells with its voxels."""
    ia, ib = a.block_index.reshape(-1), b.block_index.reshape(-1)
    only = int(((ia >= 0) != (ib >= 0)).sum())
    common = (ia >= 0) & (ib >= 0)
    sa, sb = ia[common].long(), ib[common].long()
    only += int((a.active[sa] != b.active[sb]).sum())
    if isinstance(a, ofusion.Map):
        bad = int(_cells_differ(a.occupancy[sa], b.occupancy[sb],
                                a.timestamp[sa], b.timestamp[sb]).sum())
        cells = sa.numel() * a.occupancy.shape[1]
        for level in range(1, a.levels + 1):
            na, nb = a.node_alloc[level], b.node_alloc[level]
            only += int((na != nb).sum())
            c = na & nb
            cells += int(c.sum())
            bad += int(_cells_differ(
                a.node_occ[level][c], b.node_occ[level][c],
                a.node_ts[level][c], b.node_ts[level][c]).sum())
        return only, 100.0 * bad / cells if cells else 0.0
    if sa.numel() == 0:
        return only, 0.0
    bad = (torch.abs(a.tsdf[sa] - b.tsdf[sb]) > TSDF_TOL) \
        | (a.weight[sa] != b.weight[sb])
    return only, 100.0 * float(bad.float().mean())


def compare(cand: dict, ref: dict) -> Dict[str, float]:
    """The numbers of one frame: ``cand`` (the port's outputs, or the
    control's) against ``ref``."""
    out = {"depth_m": float(torch.abs(cand["scaled_depth"]
                                      - ref["scaled_depth"]).max()),
           "pose_mm": _pose_gap_mm(cand["pose"], ref["pose"],
                                   ref["matched"])}
    out["blocks"], out["voxels_pct"] = _map_gap(cand["map"], ref["map"])
    dv = torch.abs(cand["ref_vertex"] - ref["ref_vertex"]).amax(-1)
    dn = torch.abs(cand["ref_normal"] - ref["ref_normal"]).amax(-1)
    out["raycast_pct"] = 100.0 * float(((dv > VERTEX_TOL)
                                        | (dn > NORMAL_TOL)).float().mean())
    out["images_pct"] = 0.0
    if ref["images"] is not None:
        if cand["images"] is None:
            out["images_pct"] = 100.0
        else:
            bad = torch.zeros(ref["images"][0].shape[:2], dtype=torch.bool,
                              device=ref["images"][0].device)
            for x, y in zip(cand["images"], ref["images"]):
                bad |= (x != y).any(-1)
            out["images_pct"] = 100.0 * float(bad.float().mean())
    return out


def worst(rows) -> Dict[str, float]:
    """Each number's worst (largest) reading over the sampled frames."""
    return {n: max(r[n] for r in rows) for n in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(numbers[n]) and numbers[n] <= limits[n]
               for n in NUMBERS)


def check_samples(samples, cell, prec: str = "f32",
                  control: Optional[str] = None):
    """(worst numbers of the port against the reference, per-frame rows,
    the reference's work counts; with ``control`` also the worst numbers
    of the control against the reference)."""
    rows, ctl_rows, work = [], [], []
    for s in samples:
        ref = reference_frame(s["before"], s["after"], s["depth"], s["frame"],
                              cell, prec)
        rows.append(compare(s["after"], ref))
        work.append(ref["work"])
        if control is not None:
            ctl = reference_frame(s["before"], s["after"], s["depth"],
                                  s["frame"], cell, control)
            ctl_rows.append(compare(ctl, ref))
    return (worst(rows), rows, work,
            worst(ctl_rows) if control is not None else None)
