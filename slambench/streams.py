"""The one generator of depth streams: reads a traffic mix's parameters
(``slambench/traffic/<mix>.json``) and makes its closed loop of frames.

The scene is the analytic room of the port's synthetic sequences (a copy of
``supereight_tpu_torch/io/synthetic.py``'s ``scene_sdf`` and sphere trace in
plain PyTorch), sphere-traced along an orbit that is closed: frame
``lap_frames`` would be frame 0 again, so a window may lap the loop with no
jump.  The clean lap depends on the mix and the camera only; it is made on
the device once and kept in a fixed cache directory inside the checkout.
The seed picks the loop's start phase and, where the mix has a noise model,
the noise (drawn on the device from a ``torch.Generator``): it never changes
the scene, the speed or the frame size.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: clean laps, one file a (mix, camera): a fixed path inside the checkout
CACHE_DIR = os.path.join(HERE, "_cache")
#: sphere-trace steps between compactions of the rays still marching
COMPACT_EVERY = 8


def load_mix(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "traffic", name + ".json")) as f:
        return json.load(f)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(-1))


def _box(p, bc, half):
    bq = torch.abs(p - bc) - half
    return _norm(torch.clamp(bq, min=0.0)) + torch.clamp(bq.amax(-1), max=0.0)


def scene_sdf(p: torch.Tensor, scene: dict) -> torch.Tensor:
    """The room's signed distance (metres) at world points ``p`` [..., 3]:
    the inside of the box [margin, room_dim - margin]^3, a sphere and a box
    (the port's scene variant 0)."""
    dim, margin = scene["room_dim"], scene["margin"]
    c = dim / 2.0
    v = lambda x: torch.tensor(x, dtype=torch.float32, device=p.device)
    center = v([c, c, c])
    room = -(torch.abs(p - center) - (c - margin)).amax(-1)
    sphere = _norm(p - (center + v(scene["sphere"][:3]))) - scene["sphere"][3]
    box = _box(p, center + v(scene["box"][:3]), v(scene["box"][3:]))
    return torch.minimum(room, torch.minimum(sphere, box))


def loop_poses(mix: dict) -> np.ndarray:
    """The closed orbit [lap_frames, 4, 4] (camera to world): a circle of
    ``radius`` round the room's centre, the height a whole number of sine
    cycles, looking at the centre, camera y down; frame i at angle
    2 pi i / lap_frames."""
    n, o = mix["lap_frames"], mix["orbit"]
    c = mix["scene"]["room_dim"] / 2.0
    center = np.array([c, c, c], np.float64)
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        if o.get("swing_deg"):
            # a pendulum: out by swing_deg and back, on the same circle
            a = np.radians(o["swing_deg"]) * np.sin(a)
        eye = center + np.array([o["radius"] * np.cos(a),
                                 o["height_amp"] * np.sin(o["height_cycles"]
                                                          * a),
                                 o["radius"] * np.sin(a)])
        z = (center - eye) / np.linalg.norm(center - eye)
        x = np.cross(np.array([0.0, -1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, np.cross(z, x), z, eye
        poses.append(T)
    return np.stack(poses).astype(np.float32)


def trace_depth(pose: torch.Tensor, k, H: int, W: int, scene: dict,
                steps: int) -> torch.Tensor:
    """Exact depth (camera z, metres) [H, W] by sphere tracing the scene
    ``steps`` times from 0.05 m; 0 where a ray has not hit."""
    dev = pose.device
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    dx = ((x - k[2]) / k[0]).expand(H, W)
    dy = ((y - k[3]) / k[1]).expand(H, W)
    cam = torch.stack([dx, dy, torch.ones_like(dx)], -1).reshape(-1, 3)
    dirs = cam @ pose[:3, :3].T
    origin = pose[:3, 3]
    dn = _norm(dirs)
    t_out = torch.full((H * W,), 0.05, device=dev)
    done_out = torch.zeros((H * W,), dtype=torch.bool, device=dev)
    idx = torch.arange(H * W, device=dev)
    t, done = t_out, done_out
    for step in range(steps):
        if step and step % COMPACT_EVERY == 0:
            t_out[idx], done_out[idx] = t, done
            keep = torch.nonzero(~done)[:, 0]
            idx, t, done, dirs, dn = (a[keep] for a in
                                      (idx, t, done, dirs, dn))
        f = scene_sdf(origin + dirs * t[:, None], scene)
        hit = f < 1e-4
        t = torch.where(done | hit, t, t + torch.clamp(f / dn, min=1e-4))
        done = done | hit
    t_out[idx], done_out[idx] = t, done
    depth = torch.where(done_out & (t_out < 2.0 * scene["room_dim"]), t_out,
                        0.0)
    return depth.reshape(H, W)


def _cache_key(mix: dict, k, H: int, W: int) -> str:
    spec = json.dumps({"scene": mix["scene"], "orbit": mix["orbit"],
                       "lap_frames": mix["lap_frames"],
                       "trace_steps": mix["trace_steps"],
                       "k": [float(v) for v in k], "hw": [H, W]},
                      sort_keys=True)
    return hashlib.sha256(spec.encode()).hexdigest()[:16]


def clean_lap(mix: dict, k, H: int, W: int, device,
              cache_dir: Optional[str] = CACHE_DIR) -> np.ndarray:
    """uint16 millimetres [lap_frames, H, W] of the clean loop, read from
    the cache or traced on ``device`` (and cached)."""
    path = None
    if cache_dir is not None:
        path = os.path.join(cache_dir, f"lap-{_cache_key(mix, k, H, W)}.npy")
        if os.path.exists(path):
            return np.load(path)
    kd = torch.tensor(np.asarray(k, np.float32), device=device)
    poses = torch.from_numpy(loop_poses(mix)).to(device)
    out = torch.empty((len(poses), H, W), dtype=torch.int32, device=device)
    for i in range(len(poses)):
        d = trace_depth(poses[i], kd, H, W, mix["scene"], mix["trace_steps"])
        out[i] = torch.clamp(d * 1000.0, 0.0, 65535.0).to(torch.int32)
    frames = out.cpu().numpy().astype(np.uint16)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".part"
        np.save(tmp, frames)
        os.replace(tmp + ".npy", path)
    return frames


def add_noise(frames: np.ndarray, noise: dict, seed: int,
              device) -> np.ndarray:
    """The Kinect noise model of the port's ``apply_sensor_noise`` (axial
    sigma growing with the square of the range, then the disparity
    staircase), drawn on ``device`` from ``seed``: uint16 of the frames'
    shape, 0 where the clean depth is 0."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = np.empty_like(frames)
    for i in range(len(frames)):
        mm = torch.from_numpy(frames[i].astype(np.int32)).to(device)
        z = mm.to(torch.float32) / 1000.0
        sigma = noise["axial_mm"] + noise["axial_quad"] * (
            z - noise["axial_near"]) ** 2 * (z > noise["axial_near"])
        noisy = mm.to(torch.float32) + torch.randn(
            mm.shape, generator=g, device=device) * sigma
        step = torch.clamp(noise["step_quad"] * z * z, min=1.0)
        noisy = torch.round(noisy / step) * step
        noisy = torch.where(mm == 0, 0.0, noisy).clamp(0.0, 65535.0)
        out[i] = noisy.to(torch.int32).cpu().numpy().astype(np.uint16)
    return out


class Stream:
    """A mix's closed loop for one run: ``frames`` uint16 [n, H, W] on the
    host (as a reader hands them), ``poses`` the loop's camera poses,
    ``start`` the seed's phase.  The run holds the camera still at the
    start for its first ``hold`` frames, as a user starts a handheld sweep
    (the system fuses its bootstrap frames at the first pose), then moves
    on: frame ``i >= hold`` of the run is loop frame
    ``(start + i - hold) % n``."""

    def __init__(self, mix: dict, k, H: int, W: int, seed: int, device,
                 cache_dir: Optional[str] = CACHE_DIR):
        self.mix = mix
        frames = clean_lap(mix, k, H, W, device, cache_dir)
        if mix.get("noise"):
            frames = add_noise(frames, mix["noise"], seed, device)
        self.frames = frames
        self.poses = loop_poses(mix)
        self.n = len(frames)
        self.hold = int(mix["hold_frames"])
        self.start = int(seed) % self.n

    def _loop(self, i: int) -> int:
        return (self.start + max(i - self.hold, 0)) % self.n

    def frame(self, i: int) -> np.ndarray:
        return self.frames[self._loop(i)]

    def pose(self, i: int) -> np.ndarray:
        return self.poses[self._loop(i)]
