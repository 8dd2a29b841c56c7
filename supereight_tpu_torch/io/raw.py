"""SLAMBench .raw depth+rgb stream reader/writer (a copy of
`supereight_tpu/io/raw.py`).

Format (reference `se_apps/include/interface.h:364-437`): per frame
``[uint32 w, uint32 h] + uint16 depth[w*h](mm) + [uint32 w, uint32 h] +
uint8 rgb[w*h*3]``, seekable for random access.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class RawReader:
    """Seek-based .raw reader (parity with RawDepthReader)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        hdr = np.fromfile(self._f, dtype=np.uint32, count=2)
        if hdr.size != 2:
            raise IOError(f"invalid raw file {path}")
        self.width, self.height = int(hdr[0]), int(hdr[1])
        n = self.width * self.height
        self._frame_bytes = 16 + n * 2 + n * 3
        self._f.seek(0, os.SEEK_END)
        self.num_frames = self._f.tell() // self._frame_bytes

    def read(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (depth uint16 [H, W] in mm, rgb uint8 [H, W, 3])."""
        if frame < 0 or frame >= self.num_frames:
            raise IndexError(frame)
        n = self.width * self.height
        self._f.seek(frame * self._frame_bytes)
        hdr = np.fromfile(self._f, dtype=np.uint32, count=2)
        depth = np.fromfile(self._f, dtype=np.uint16, count=n)
        np.fromfile(self._f, dtype=np.uint32, count=2)
        rgb = np.fromfile(self._f, dtype=np.uint8, count=n * 3)
        return (depth.reshape(self.height, self.width),
                rgb.reshape(self.height, self.width, 3))

    def __len__(self):
        return self.num_frames

    def __iter__(self):
        for i in range(self.num_frames):
            yield self.read(i)

    def close(self):
        self._f.close()


class RawWriter:
    """Writes the same format (scene2raw equivalent, `se_tools/scene2raw.cpp`)."""

    def __init__(self, path: str, width: int, height: int):
        self.width, self.height = width, height
        self._f = open(path, "wb")

    def write(self, depth_mm: np.ndarray, rgb: Optional[np.ndarray] = None):
        h, w = depth_mm.shape
        assert (w, h) == (self.width, self.height)
        hdr = np.asarray([w, h], np.uint32)
        hdr.tofile(self._f)
        depth_mm.astype(np.uint16).tofile(self._f)
        hdr.tofile(self._f)
        if rgb is None:
            rgb = np.zeros((h, w, 3), np.uint8)
        rgb.astype(np.uint8).tofile(self._f)

    def close(self):
        self._f.close()
