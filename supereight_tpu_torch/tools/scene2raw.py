"""scene2raw: ICL-NUIM scene depth files -> SLAMBench .raw (a copy of
`supereight_tpu/tools/scene2raw.py`).

Reference: `se_tools/scene2raw.cpp` — reads per-frame text files of
euclidean ray lengths (``scene_00_0000.depth``), converts to planar z depth
in mm with the Scene intrinsics (`interface.h:171-176`), writes the .raw
stream.  Uses the native conversion (``io.native``) where it builds.

Usage: python -m supereight_tpu_torch.tools.scene2raw <scene_dir> <out.raw>
"""

from __future__ import annotations

import glob
import os
import sys

import numpy as np

from supereight_tpu_torch.io import native, raw, scene

SCENE_K = scene.SCENE_K
SCENE_W, SCENE_H = scene.SCENE_W, scene.SCENE_H


def convert(scene_dir: str, out_path: str, k=SCENE_K) -> int:
    files = sorted(glob.glob(os.path.join(scene_dir, "*.depth")))
    if not files:
        raise FileNotFoundError(f"no .depth files in {scene_dir}")
    writer = None
    n = 0
    for path in files:
        vals = np.fromfile(path, dtype=np.float32, sep=" ")
        if vals.size != SCENE_W * SCENE_H:
            raise ValueError(f"{path}: expected {SCENE_W*SCENE_H} values, "
                             f"got {vals.size}")
        eu = vals.reshape(SCENE_H, SCENE_W)
        mm = native.euclidean_to_depth_mm(eu, k)
        if writer is None:
            writer = raw.RawWriter(out_path, SCENE_W, SCENE_H)
        writer.write(mm)
        n += 1
    if writer:
        writer.close()
    return n


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        return 1
    n = convert(argv[0], argv[1])
    print(f"wrote {n} frames to {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
