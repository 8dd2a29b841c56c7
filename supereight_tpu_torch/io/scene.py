"""SceneDepthReader: direct reader for ICL-NUIM scene .depth directories
(counterpart of `supereight_tpu/io/scene.py`).

Reference: `se_apps/include/interface.h:179-284` — reads per-frame text
files of euclidean ray lengths and converts to planar depth with the Scene
intrinsics.  Prefer converting once with tools/scene2raw for speed; this
reader exists for parity and ad-hoc use.  The conversion is the numpy one
of `supereight_tpu/io/native.py:euclidean_to_depth_mm`, copied here.
"""

from __future__ import annotations

import glob
import os
from typing import Tuple

import numpy as np

SCENE_K = (481.20, -480.0, 319.5, 239.5)   # interface.h:171-176
SCENE_W, SCENE_H = 640, 480


def euclidean_to_depth_mm(euclidean: np.ndarray, k) -> np.ndarray:
    """ICL-NUIM euclidean ray length -> planar z depth in mm
    (scene2raw semantics, `se_tools/scene2raw.cpp`)."""
    h, w = euclidean.shape
    fx, fy, cx, cy = (float(v) for v in k)
    x = (np.arange(w) - cx) / fx
    y = (np.arange(h)[:, None] - cy) / fy
    denom = np.sqrt(x[None, :] ** 2 + y ** 2 + 1.0)
    z = euclidean / denom
    return np.clip(z * 1000.0 + 0.5, 0, 65535).astype(np.uint16)


class SceneDepthReader:
    def __init__(self, scene_dir: str, k=SCENE_K):
        self.files = sorted(glob.glob(os.path.join(scene_dir, "*.depth")))
        if not self.files:
            raise FileNotFoundError(f"no .depth files in {scene_dir}")
        self.k = k
        self.width, self.height = SCENE_W, SCENE_H
        self.num_frames = len(self.files)

    def read(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (depth_mm uint16 [H, W], rgb zeros [H, W, 3])."""
        vals = np.fromfile(self.files[frame], dtype=np.float32, sep=" ")
        eu = vals.reshape(self.height, self.width)
        mm = euclidean_to_depth_mm(eu, self.k)
        return mm, np.zeros((self.height, self.width, 3), np.uint8)

    def __len__(self):
        return self.num_frames
