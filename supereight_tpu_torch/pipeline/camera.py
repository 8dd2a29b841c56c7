"""Pinhole camera matrices and SE(3) utilities (counterpart of
`supereight_tpu/pipeline/camera.py`).  Matrices are float32 [4, 4]; ``pose``
maps camera coordinates to world coordinates."""

from __future__ import annotations

import torch

from supereight_tpu_torch.core.numerics import matvec


def camera_matrix(k: torch.Tensor) -> torch.Tensor:
    """4x4 intrinsics from (fx, fy, cx, cy)."""
    K = torch.zeros((4, 4), dtype=torch.float32, device=k.device)
    K[0, 0], K[0, 2] = k[0], k[2]
    K[1, 1], K[1, 2] = k[1], k[3]
    K[2, 2] = K[3, 3] = 1.0
    return K


def inverse_camera_matrix(k: torch.Tensor) -> torch.Tensor:
    iK = torch.zeros((4, 4), dtype=torch.float32, device=k.device)
    iK[0, 0], iK[0, 2] = 1.0 / k[0], -k[2] / k[0]
    iK[1, 1], iK[1, 2] = 1.0 / k[1], -k[3] / k[1]
    iK[2, 2] = iK[3, 3] = 1.0
    return iK


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def se3_exp(twist: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of ``[v, w]`` (translation first): closed-form
    Rodrigues with the same small-angle Taylor branches as the JAX
    version, both branches evaluated so the host never syncs."""
    v, w = twist[:3], twist[3:]
    theta2 = torch.dot(w, w)
    theta = torch.sqrt(theta2)
    small = theta < 1e-6
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, theta2 * theta))
    W = _hat(w)
    W2 = W @ W
    I = torch.eye(3, dtype=torch.float32, device=twist.device)
    R = I + a * W + b * W2
    V = I + b * W + c * W2
    T = torch.eye(4, dtype=torch.float32, device=twist.device)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 homogeneous transform to points [..., 3]."""
    return matvec(T[:3, :3], p) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return matvec(T[:3, :3], v)


def pose_from_translation(t, device) -> torch.Tensor:
    T = torch.eye(4, dtype=torch.float32, device=device)
    T[:3, 3] = torch.as_tensor(t, dtype=torch.float32, device=device)
    return T
