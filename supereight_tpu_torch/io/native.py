"""ctypes bindings to the native IO helpers (counterpart of
`supereight_tpu/io/native.py`): an mmap'd ``.raw`` reader with a background
prefetch thread, and the ICL-NUIM euclidean -> planar depth conversion.

The source is the package's own ``csrc/io_native.cpp``, built with the
host C++ compiler at first use (``ops/_build.py``).  Where it cannot be
built, :func:`available` is False and the callers take the numpy paths
(``io.raw.RawReader``, ``io.scene.euclidean_to_depth_mm``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None
_tried = False


def load_library() -> Optional[ctypes.CDLL]:
    """The built library (compiled on the first call), or None where it
    cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from supereight_tpu_torch.ops import _build
    try:
        lib = _build.load("io_native")
    except (OSError, RuntimeError):
        return None
    lib.se_raw_open.restype = ctypes.c_void_p
    lib.se_raw_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.se_raw_width.argtypes = [ctypes.c_void_p]
    lib.se_raw_height.argtypes = [ctypes.c_void_p]
    lib.se_raw_frames.restype = ctypes.c_long
    lib.se_raw_frames.argtypes = [ctypes.c_void_p]
    lib.se_raw_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                ctypes.POINTER(ctypes.c_float)]
    lib.se_raw_read_depth_mm.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                         ctypes.POINTER(ctypes.c_uint16)]
    lib.se_raw_read_rgb.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                    ctypes.POINTER(ctypes.c_uint8)]
    lib.se_raw_close.argtypes = [ctypes.c_void_p]
    lib.se_scene2raw_frame.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint16)]
    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


class NativeRawReader:
    """Prefetching ``.raw`` reader: ``read_float(frame)`` returns the
    decimated metric-depth frame and stages ``frame + 1`` in a background
    thread."""

    def __init__(self, path: str, ratio: int = 1):
        lib = load_library()
        if lib is None:
            raise RuntimeError("the native io library could not be built")
        self._lib = lib
        self._h = lib.se_raw_open(path.encode(), ratio)
        if not self._h:
            raise IOError(f"cannot open raw file {path}")
        self.width = lib.se_raw_width(self._h)
        self.height = lib.se_raw_height(self._h)
        self.num_frames = lib.se_raw_frames(self._h)

    def read_float(self, frame: int) -> np.ndarray:
        out = np.empty((self.height, self.width), np.float32)
        rc = self._lib.se_raw_read(
            self._h, frame, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError(frame)
        return out

    def read(self, frame: int):
        """The ``RawReader`` interface: (depth uint16 [H, W] in mm, rgb).
        Decoded to metres and rounded back to mm, exact at ratio 1 (the
        stream stores mm); rgb is not decoded (the pipeline never reads it)
        and comes back as zeros."""
        d = self.read_float(frame)
        mm = np.rint(d * 1000.0).astype(np.uint16)
        rgb = np.zeros((self.height, self.width, 3), np.uint8)
        return mm, rgb

    def __len__(self):
        return self.num_frames

    def close(self):
        if self._h:
            self._lib.se_raw_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def euclidean_to_depth_mm(euclidean: np.ndarray, k) -> np.ndarray:
    """ICL-NUIM euclidean ray length -> planar z depth in mm
    (`se_tools/scene2raw.cpp`): the native conversion where the library
    builds, else ``io.scene``'s numpy one."""
    lib = load_library()
    if lib is None:
        from .scene import euclidean_to_depth_mm as numpy_conversion
        return numpy_conversion(euclidean, k)
    h, w = euclidean.shape
    fx, fy, cx, cy = (float(v) for v in k)
    e = np.ascontiguousarray(euclidean, np.float32)
    out = np.empty((h, w), np.uint16)
    lib.se_scene2raw_frame(
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h, fx, fy, cx,
        cy, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return out
