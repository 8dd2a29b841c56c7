"""Headless viewer: the reference GUI's render triptych as image files
(counterpart of `supereight_tpu/apps/viewer.py`).

The reference's GLUT/Qt frontend draws the depth, ICP-status and
shaded-volume views every frame (`se_apps/src/mainQt.cpp`,
`se_apps/include/draw.h`).  This writes the same three images side by
side as a PNG every ``rate`` frames, a top-down trajectory plot and an
offline HTML scrubber over the frames.  The PNGs are written with
``zlib`` and ``struct`` (no plotting library needed).

Usage (on the card unless ``--device`` names another device):
    python -m supereight_tpu_torch.apps.viewer -i seq.raw -g seq.gt \\
        -v 128 --out-dir renders --rate 5
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np

#: black columns between the triptych's panels
GAP = 8


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB (``[H, W, 3]``) or RGBA (``[H, W, 4]``) image as PNG
    bytes: one IDAT chunk of unfiltered rows."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    color = {3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def _rgb(img) -> np.ndarray:
    """A renderer's uint8 ``[H, W, 4]`` image (tensor or array) as RGB."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img, np.uint8)[..., :3]


def triptych(depth_img, track_img, volume_img) -> np.ndarray:
    """The three views side by side, ``GAP`` black columns apart:
    uint8 ``[H, 3 W + 2 GAP, 3]``."""
    panels = [_rgb(a) for a in (depth_img, track_img, volume_img)]
    gap = np.zeros((panels[0].shape[0], GAP, 3), np.uint8)
    return np.concatenate([panels[0], gap, panels[1], gap, panels[2]],
                          axis=1)


def save_triptych(path: str, depth_img, track_img, volume_img) -> np.ndarray:
    """Write the triptych of the three views as a PNG; returns it."""
    img = triptych(depth_img, track_img, volume_img)
    write_png(path, img)
    return img


def trajectory_image(est_poses, gt_poses=None, size: int = 400
                     ) -> np.ndarray:
    """Top-down (x, z) plot of the estimated positions (white) and the
    ground truth (green) on a black ``size`` x ``size`` RGB image, the two
    scaled together to fit with a margin: the stand-in for the reference
    GUI's live pose plot."""
    est = np.stack([np.asarray(T)[:3, 3] for T in est_poses])[:, [0, 2]]
    paths = [(est, (255, 255, 255))]
    if gt_poses is not None:
        gt = np.stack([np.asarray(T)[:3, 3]
                       for T in gt_poses[:len(est)]])[:, [0, 2]]
        paths.insert(0, (gt, (0, 200, 0)))
    pts = np.concatenate([p for p, _ in paths])
    lo, hi = pts.min(0), pts.max(0)
    scale = (size - 21) / max(float((hi - lo).max()), 1e-6)
    img = np.zeros((size, size, 3), np.uint8)
    for p, color in paths:
        # each segment drawn as a dense run of points
        for a, b in zip(p[:-1], p[1:]) if len(p) > 1 else [(p[0], p[0])]:
            t = np.linspace(0.0, 1.0, 32)[:, None]
            q = ((a + (b - a) * t) - lo) * scale + 10
            x, y = q[:, 0].astype(int), size - 1 - q[:, 1].astype(int)
            img[np.clip(y, 0, size - 1), np.clip(x, 0, size - 1)] = color
    return img


def plot_trajectory(path: str, est_poses, gt_poses=None) -> None:
    write_png(path, trajectory_image(est_poses, gt_poses))


def write_scrubber(out_dir: str, frame_files, fps: float = 6.0) -> str:
    """Offline HTML scrubber over the triptych PNGs (slider, play/pause at
    a chosen rate), as the JAX viewer writes it: open ``view.html``
    anywhere."""
    frames_js = ",".join(f'"{os.path.basename(f)}"' for f in frame_files)
    html = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>supereight_tpu_torch viewer</title>
<style>
 body {{ font-family: sans-serif; background:#111; color:#ddd;
        text-align:center }}
 img#frame {{ max-width: 96%; image-rendering: pixelated }}
 .bar {{ margin: 12px }}
 input[type=range] {{ width: 60% }}
</style></head><body>
<h3>supereight_tpu_torch — render triptych scrubber</h3>
<img id="frame" src=""/>
<div class="bar">
 <button id="play">&#9658;</button>
 <input type="range" id="pos" min="0" value="0"/>
 <span id="label"></span>
 <label>fps <input type="number" id="fps" value="{fps:g}" min="1"
  max="60" style="width:4em"/></label>
</div>
<img src="trajectory.png" style="max-width:70%"/>
<script>
 const frames = [{frames_js}];
 const img = document.getElementById("frame");
 const pos = document.getElementById("pos");
 const label = document.getElementById("label");
 const fps = document.getElementById("fps");
 pos.max = frames.length - 1;
 let timer = null;
 function show(i) {{
   i = Math.max(0, Math.min(frames.length - 1, i|0));
   pos.value = i; img.src = frames[i];
   label.textContent = frames[i] + " (" + (i+1) + "/" + frames.length + ")";
 }}
 pos.oninput = () => show(+pos.value);
 document.getElementById("play").onclick = function () {{
   if (timer) {{ clearInterval(timer); timer = null;
                 this.innerHTML = "&#9658;"; return; }}
   this.innerHTML = "&#10074;&#10074;";
   timer = setInterval(() => show((+pos.value + 1) % frames.length),
                       1000 / +fps.value);
 }};
 if (frames.length) show(0);
</script></body></html>
"""
    path = os.path.join(out_dir, "view.html")
    with open(path, "w") as f:
        f.write(html)
    return path


def run(argv=None) -> dict:
    """The viewer's loop; returns ``{"frames": [index], "images":
    [triptych], "est_poses": [...]}`` for the frames it wrote."""
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.io import groundtruth, raw
    from supereight_tpu_torch.pipeline import DenseSLAMSystem

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-i", "--input-file", required=True)
    p.add_argument("-g", "--ground-truth", default="")
    p.add_argument("-k", "--camera", default="")
    p.add_argument("-s", "--volume-size", type=float, default=4.8)
    p.add_argument("-v", "--volume-resolution", type=int, default=256)
    p.add_argument("--out-dir", default="renders")
    p.add_argument("--rate", type=int, default=5)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    reader = raw.RawReader(args.input_file)
    if args.camera:
        k = np.asarray([float(x) for x in args.camera.split(",")],
                       np.float32)
    else:
        k = np.asarray([481.2, -480.0, reader.width / 2.0,
                        reader.height / 2.0], np.float32)
    cfg = SlamConfig(volume_resolution=(args.volume_resolution,) * 3,
                     volume_size=(args.volume_size,) * 3,
                     integration_rate=1)
    slam = DenseSLAMSystem((reader.height, reader.width), cfg, args.device)
    gt = groundtruth.read_poses(args.ground_truth) \
        if args.ground_truth else None

    os.makedirs(args.out_dir, exist_ok=True)
    n = len(reader)
    if args.max_frames:
        n = min(n, args.max_frames)
    out = dict(frames=[], images=[], est_poses=[])
    frame_files = []
    for frame in range(n):
        depth, _ = reader.read(frame)
        st = slam.step(depth, k, frame,
                       gt_pose=gt[frame] if gt is not None else None)
        out["est_poses"].append(st.pose.cpu().numpy())
        if frame % args.rate == 0 and frame > 2:
            fp = os.path.join(args.out_dir, f"frame_{frame:05d}.png")
            out["images"].append(save_triptych(
                fp, slam.renderDepth(), slam.renderTrack(),
                slam.renderVolume()))
            out["frames"].append(frame)
            frame_files.append(fp)
    plot_trajectory(os.path.join(args.out_dir, "trajectory.png"),
                    out["est_poses"], gt)
    write_scrubber(args.out_dir, frame_files)
    print(f"wrote renders + view.html to {args.out_dir}")
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
