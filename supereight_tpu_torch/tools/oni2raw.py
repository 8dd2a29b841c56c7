"""oni2raw: OpenNI .oni recordings -> SLAMBench .raw (a copy of
`supereight_tpu/tools/oni2raw.py`).

Reference: `se_tools/oni2raw.cpp` (links against a live OpenNI2 runtime).
OpenNI is a camera-driver stack; where there is no camera hardware or
OpenNI SDK, this tool documents the interface and fails gracefully.
Record with any OpenNI tool, export depth as 16-bit PNG/PGM frames, and use
:func:`frames_to_raw` to produce the .raw stream instead.
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from supereight_tpu_torch.io import raw


def frames_to_raw(frame_dir: str, out_path: str, pattern: str = "*.pgm"):
    """Pack a directory of 16-bit depth frames (mm) into a .raw stream."""
    files = sorted(glob.glob(os.path.join(frame_dir, pattern)))
    if not files:
        raise FileNotFoundError(f"no {pattern} frames in {frame_dir}")
    writer = None
    for path in files:
        depth = _read_pgm16(path)
        if writer is None:
            writer = raw.RawWriter(out_path, depth.shape[1], depth.shape[0])
        writer.write(depth)
    writer.close()
    return len(files)


def _read_pgm16(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            raise ValueError(f"{path}: not a binary PGM")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        maxval = int(f.readline())
        dtype = np.dtype(">u2") if maxval > 255 else np.uint8
        data = np.frombuffer(f.read(), dtype=dtype, count=w * h)
    return data.reshape(h, w).astype(np.uint16)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) == 2 and os.path.isdir(argv[0]):
        n = frames_to_raw(argv[0], argv[1])
        print(f"wrote {n} frames to {argv[1]}")
        return 0
    print("Direct .oni decoding requires the OpenNI2 SDK (not "
          "installed).\n" + __doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
