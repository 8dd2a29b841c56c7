"""Synthetic depth-sequence generator (counterpart of
`supereight_tpu/io/synthetic.py`: the analytic scene and its sphere trace
in PyTorch, on the card unless the caller asks for another device; the
pose, noise and file functions are numpy copies).

The reference validates end-to-end against ICL-NUIM sequences converted by
`se_tools/scene2raw.cpp`.  This module renders an analytic room scene
(known SDF -> exact depth + exact trajectory) into the same .raw + TUM
ground-truth files, with no download.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from supereight_tpu_torch.core.numerics import fma, matvec
from supereight_tpu_torch.pipeline.preprocessing import norm
from . import groundtruth, raw


MARGIN = 0.45   # walls sit inside the volume so the TSDF band fits


@functools.lru_cache(maxsize=None)
def _scene(room_dim: float, variant: int, device: str):
    """The scene's constant vectors, float32 on ``device``: the centre, then
    (centre, half extents) of each box, (centre, radius) of each sphere and
    the pillar's (centre, radius)."""
    c = room_dim / 2.0
    v = lambda *x: torch.tensor(x, dtype=torch.float32, device=device)
    center = v(c, c, c)
    if variant == 0:
        return dict(center=center,
                    spheres=[(center + v(0.0, 0.3, 0.0), 0.5)],
                    boxes=[(center + v(-0.9, 0.6, 0.7), v(0.3, 0.4, 0.25))])
    return dict(
        center=center,
        pillar=(center + v(0.8, 0.0, -0.6), 0.28),
        spheres=[(center + v(-0.7, 0.55, -0.9), 0.35)],
        boxes=[(center + v(0.4, 0.75, 1.0), v(0.55, 0.25, 0.35)),
               (center + v(-1.2, 0.2, 0.2), v(0.25, 0.8, 0.25))],
        alcove=(v(room_dim - MARGIN, c, c), v(0.35, 0.7, 0.9)))


def _box(p: torch.Tensor, bc, half) -> torch.Tensor:
    """Signed distance to the axis-aligned box of centre ``bc`` and half
    extents ``half``."""
    bq = torch.abs(p - bc) - half
    return (norm(torch.clamp(bq, min=0.0))
            + torch.clamp(bq.amax(-1), max=0.0))


def scene_sdf(p: torch.Tensor, room_dim: float,
              variant: int = 0) -> torch.Tensor:
    """Analytic scene: room interior + obstacles; units metres.  ``p``
    [..., 3] float32 world coordinates; the room occupies
    [MARGIN, room_dim-MARGIN]^3 so wall surfaces stay inside the map volume
    (like ICL-NUIM's ~4 m room in supereight's 4.8 m canonical volume).

    ``variant`` selects the room geometry: 0 = the bench scene (sphere +
    box), 1 = a held-out room (pillar, two boxes, offset sphere, a wall
    alcove)."""
    c = room_dim / 2.0
    sc = _scene(room_dim, variant, str(p.device))
    # room: inside of the box [MARGIN, room_dim-MARGIN]^3 (negative in walls)
    room = -(torch.abs(p - sc["center"]) - (c - MARGIN)).amax(-1)
    (sph_c, sph_r), = sc["spheres"]
    sphere = norm(p - sph_c) - sph_r
    if variant == 0:
        box = _box(p, *sc["boxes"][0])
        return torch.minimum(room, torch.minimum(sphere, box))
    # variant 1: held-out room; a vertical pillar (2D circle + slab)
    pil_c, pil_r = sc["pillar"]
    r2d = norm((p - pil_c)[..., ::2]) - pil_r
    slab = torch.abs(p[..., 1] - c) - (c - MARGIN)
    pillar = torch.maximum(r2d, slab)
    box1, box2 = (_box(p, *b) for b in sc["boxes"])
    # alcove: carve a recess out of one wall (max with negated box)
    room = torch.maximum(room, -_box(p, *sc["alcove"]))
    return torch.minimum(room, torch.minimum(
        pillar, torch.minimum(sphere, torch.minimum(box1, box2))))


#: sphere-trace steps between compactions of the rays still marching
COMPACT_EVERY = 8


def render_depth(pose: torch.Tensor, k: torch.Tensor, room_dim: float,
                 H: int, W: int, steps: int = 160,
                 variant: int = 0) -> torch.Tensor:
    """Exact depth (camera z, metres) [H, W] by sphere tracing the analytic
    SDF ``steps`` times from 0.05 m, on the device of ``pose`` (float32
    [4,4]) and ``k`` (fx, fy, cx, cy); a ray that has not hit gives 0.

    Every COMPACT_EVERY steps the rays that hit are set aside (most hit
    within 40 steps; grazing ones march on): a ray's steps are the same
    element-wise operations either way, so the depth does not change."""
    x = torch.arange(W, dtype=torch.float32, device=pose.device)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=pose.device)[:, None]
    # camera-space ray with unit z so that t == depth
    dx = ((x - k[2]) / k[0]).expand(H, W)
    dy = ((y - k[3]) / k[1]).expand(H, W)
    dirs = matvec(pose[:3, :3], torch.stack([dx, dy, torch.ones_like(dx)],
                                            -1)).reshape(-1, 3)
    origin = pose[:3, 3]
    # conservative step: the SDF scaled by the ray's norm (not unit)
    dn = norm(dirs)
    t_out = torch.full((H * W,), 0.05, dtype=torch.float32,
                       device=pose.device)
    done_out = torch.zeros((H * W,), dtype=torch.bool, device=pose.device)
    idx = torch.arange(H * W, device=pose.device)
    t, done = t_out, done_out
    for step in range(steps):
        if step and step % COMPACT_EVERY == 0:
            t_out[idx], done_out[idx] = t, done
            keep = torch.nonzero(~done)[:, 0]
            idx, t, done, dirs, dn = (a[keep] for a in
                                      (idx, t, done, dirs, dn))
        f = scene_sdf(fma(dirs, t[..., None], origin), room_dim, variant)
        hit = f < 1e-4
        t = torch.where(done | hit, t, t + torch.clamp(f / dn, min=1e-4))
        done = done | hit
    t_out[idx], done_out[idx] = t, done
    depth = torch.where(done_out & (t_out < 2.0 * room_dim), t_out, 0.0)
    return depth.reshape(H, W)


def orbit_poses(n: int, room_dim: float, radius: float = 1.1,
                height_amp: float = 0.12, sweep: float | None = None):
    """Smooth orbit inside the room looking at the centre; returns [n, 4, 4].
    Default sweep keeps angular velocity ~1 deg/frame (ICP-trackable, like
    a 30 fps hand-held sweep)."""
    if sweep is None:
        sweep = min(1.5 * np.pi, 0.0175 * n)
    c = room_dim / 2.0
    center = np.array([c, c, c], np.float32)
    poses = []
    for i in range(n):
        a = sweep * i / max(n - 1, 1)
        eye = center + np.array([radius * np.cos(a),
                                 height_amp * np.sin(2.5 * a),
                                 radius * np.sin(a)], np.float32)
        look = center - eye
        z = look / np.linalg.norm(look)
        up = np.array([0.0, -1.0, 0.0], np.float32)   # camera y down
        xaxis = np.cross(up, z)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(z, xaxis)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = xaxis, yaxis, z, eye
        poses.append(T)
    return np.stack(poses)


def translation_poses(n: int, room_dim: float, span: float = 2.4,
                      look_angle: float = 0.35):
    """Translation-dominant path: dolly along x past the scene at a fixed
    small look-in angle (≈25 mm/frame at n=96, near-zero rotation) —
    the opposite regime from :func:`orbit_poses`' rotation-dominant
    sweep.  Returns [n, 4, 4]."""
    c = room_dim / 2.0
    poses = []
    for i in range(n):
        s = i / max(n - 1, 1)
        eye = np.array([c - span / 2 + span * s, c - 0.1, c - 1.4],
                       np.float32)
        # constant gaze: slightly into the room, tilted by look_angle
        z = np.array([np.sin(look_angle), 0.0, np.cos(look_angle)],
                     np.float32)
        z /= np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        xaxis = np.cross(up, z)
        xaxis /= np.linalg.norm(xaxis)
        yaxis = np.cross(z, xaxis)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = xaxis, yaxis, z, eye
        poses.append(T)
    return np.stack(poses)


def jitter_poses(poses: np.ndarray, rot_sigma_deg: float = 0.35,
                 trans_sigma_m: float = 0.003, seed: int = 7):
    """Hand-shake / rolling-shutter-style pose jitter: compose each pose
    with a small random rotation + translation (deterministic seed).
    The jittered poses ARE the ground truth (frames are rendered from
    them) — this probes frame-to-frame motion roughness, not gt error."""
    rng = np.random.default_rng(seed)
    out = []
    for T in poses:
        w = rng.standard_normal(3) * np.radians(rot_sigma_deg)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]], np.float64) / max(th, 1e-12)
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        J = np.eye(4, dtype=np.float32)
        J[:3, :3] = (T[:3, :3] @ R).astype(np.float32)
        J[:3, 3] = T[:3, 3] + rng.standard_normal(3) * trans_sigma_m
        out.append(J)
    return np.stack(out)


DEFAULT_K = (120.0, 120.0, 160.0, 120.0)   # for 320x240


def apply_sensor_noise(depth_mm: np.ndarray, seed: int = 0) -> np.ndarray:
    """Kinect-style depth noise (the TUM sensors): axial sigma grows
    quadratically with range (~1.2 mm at 0.5 m to ~25 mm at 4 m, Khoshelham
    & Elberink 2012), plus the disparity quantisation staircase.  Applied
    deterministically so noisy datasets are reproducible."""
    rng = np.random.default_rng(seed)
    z = depth_mm.astype(np.float32) / 1000.0
    sigma_mm = 1.2 + 19.0 * (z - 0.4) ** 2 * (z > 0.4)
    noisy = depth_mm.astype(np.float32) \
        + rng.standard_normal(depth_mm.shape).astype(np.float32) * sigma_mm
    # disparity quantisation: step also grows ~quadratically with range
    step_mm = np.maximum(1.0, 2.85 * z * z)
    noisy = np.round(noisy / step_mm) * step_mm
    noisy = np.where(depth_mm == 0, 0.0, noisy)
    return np.clip(noisy, 0, 65535).astype(np.uint16)


def generate_sequence(n_frames: int, H: int = 240, W: int = 320,
                      room_dim: float = 4.8, k=None, noise: bool = False,
                      device="cuda"):
    """Render an orbit sequence on ``device``; returns (depths_mm uint16
    [n,H,W], poses [n,4,4], k).  ``noise`` applies the TUM sensor noise
    model."""
    if k is None:
        k = (DEFAULT_K[0] * W / 320.0, DEFAULT_K[1] * H / 240.0,
             W / 2.0, H / 2.0)
    k_dev = torch.tensor(np.asarray(k, np.float32), device=device)
    poses = orbit_poses(n_frames, room_dim)
    frames = []
    for i in range(n_frames):
        d = render_depth(torch.from_numpy(poses[i]).to(device), k_dev,
                         room_dim, H, W)
        mm = np.clip(d.cpu().numpy() * 1000.0, 0, 65535).astype(np.uint16)
        if noise:
            mm = apply_sensor_noise(mm, seed=i)
        frames.append(mm)
    return np.stack(frames), poses, np.asarray(k, np.float32)


def write_dataset(prefix: str, n_frames: int, H: int = 240, W: int = 320,
                  room_dim: float = 4.8, k=None, noise: bool = False,
                  device="cuda"):
    """Write ``<prefix>.raw`` + ``<prefix>.gt`` (scene2raw equivalent)."""
    depths, poses, k = generate_sequence(n_frames, H, W, room_dim, k,
                                         noise=noise, device=device)
    w = raw.RawWriter(prefix + ".raw", W, H)
    for d in depths:
        w.write(d)
    w.close()
    groundtruth.write_poses(prefix + ".gt", poses)
    return prefix + ".raw", prefix + ".gt", k
