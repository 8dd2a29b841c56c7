"""TUM-format ground-truth trajectory IO (a copy of
`supereight_tpu/io/groundtruth.py`).

Reference: `se_apps/include/interface.h:118-151` (readNextPose: last 7
columns are tx ty tz qx qy qz qw; '#' comments skipped; an optional 4x4
transform premultiplies every pose).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)


def rot_to_quat(R) -> np.ndarray:
    """Returns (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw], np.float32)


def read_poses(path: str, transform: Optional[np.ndarray] = None
               ) -> List[np.ndarray]:
    """All 4x4 poses from a TUM trajectory file, optionally premultiplied by
    ``transform`` (the -G flag)."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cols = line.split()
            if len(cols) < 7:
                raise ValueError(f"bad gt line: {line!r}")
            tx, ty, tz, qx, qy, qz, qw = (float(c) for c in cols[-7:])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = quat_to_rot(qx, qy, qz, qw)
            T[:3, 3] = (tx, ty, tz)
            if transform is not None:
                T = np.asarray(transform, np.float32) @ T
            poses.append(T)
    return poses


def write_poses(path: str, poses, timestamps=None):
    """TUM format: ``timestamp tx ty tz qx qy qz qw``."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, T in enumerate(poses):
            ts = timestamps[i] if timestamps is not None else float(i)
            q = rot_to_quat(np.asarray(T)[:3, :3])
            t = np.asarray(T)[:3, 3]
            f.write(f"{ts} {t[0]} {t[1]} {t[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
