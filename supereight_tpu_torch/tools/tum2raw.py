"""tum2raw: TUM RGB-D dataset directory -> SLAMBench .raw + associated gt
(a copy of `supereight_tpu/tools/tum2raw.py`; PIL is imported only when
:func:`convert` runs).

The reference pipeline consumes TUM sequences through the same .raw format
as ICL-NUIM (the scripts in `se_apps/scripts/datasets.py` list fr1/fr2/fr3
entries and `associate.py` pairs depth frames with ground-truth poses by
timestamp).  This converter does the whole offline step in one go:

* reads ``depth.txt`` (``timestamp filename`` per line) and decodes the
  16-bit depth PNGs (TUM scale: 5000 units per metre) into millimetre
  uint16 frames;
* associates each depth timestamp with the nearest ground-truth pose from
  ``groundtruth.txt`` (greedy nearest-timestamp, `associate.py` semantics);
* writes ``<out>.raw`` (frames with an associated pose only) and
  ``<out>.gt`` (the matching TUM-format trajectory) so ATE is computed on
  exactly the frames that were run.

Usage: python -m supereight_tpu_torch.tools.tum2raw <tum_dir> <out_prefix>
"""

from __future__ import annotations

import os
import sys

import numpy as np

from supereight_tpu_torch.apps import evaluate
from supereight_tpu_torch.io import raw

TUM_DEPTH_SCALE = 5000.0      # png units per metre


def _read_index(path: str):
    """[(timestamp, relative path)] from a TUM depth.txt / rgb.txt."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts, rel = line.split()[:2]
            out.append((float(ts), rel))
    return out


def _read_gt_lines(path: str):
    """[(timestamp, 7 floats)] from groundtruth.txt."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            out.append((float(vals[0]), [float(v) for v in vals[1:8]]))
    return out


def convert(tum_dir: str, out_prefix: str,
            max_difference: float = 0.02) -> int:
    """Returns the number of converted (depth, pose) pairs."""
    from PIL import Image

    depth_index = _read_index(os.path.join(tum_dir, "depth.txt"))
    gt_lines = _read_gt_lines(os.path.join(tum_dir, "groundtruth.txt"))
    pairs = evaluate.associate([t for t, _ in depth_index],
                               [t for t, _ in gt_lines],
                               max_difference=max_difference)
    if not pairs:
        raise ValueError(f"no depth/groundtruth timestamp pairs within "
                         f"{max_difference}s in {tum_dir}")
    pairs.sort()

    writer = None
    n = 0
    with open(out_prefix + ".gt", "w") as gt_out:
        gt_out.write("# timestamp tx ty tz qx qy qz qw\n")
        for di, gi in pairs:
            ts, rel = depth_index[di]
            img = np.asarray(Image.open(os.path.join(tum_dir, rel)))
            if img.ndim != 2:
                raise ValueError(f"{rel}: expected single-channel depth png")
            mm = np.clip(img.astype(np.float32) * (1000.0 / TUM_DEPTH_SCALE),
                         0, 65535).astype(np.uint16)
            if writer is None:
                h, w = mm.shape
                writer = raw.RawWriter(out_prefix + ".raw", w, h)
            writer.write(mm)
            gt_out.write(" ".join([repr(gt_lines[gi][0])]
                                  + [repr(v) for v in gt_lines[gi][1]])
                         + "\n")
            n += 1
    if writer:
        writer.close()
    return n


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    n = convert(argv[0], argv[1])
    print(f"converted {n} associated frames -> {argv[1]}.raw/.gt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
