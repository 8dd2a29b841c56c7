"""Tests of the port's CUDA kernels on the card (marker ``gpu``).  They skip
without a CUDA device.  This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.ops import integrate_kernel as ik

VS = 0.0375
MU = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _rotation(w):
    """Rodrigues rotation of the axis-angle vector ``w``."""
    t = np.linalg.norm(w)
    k = w / t
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(t) * Kx + (1 - np.cos(t)) * Kx @ Kx


def _case(H, W, seed, n=512):
    """Block rows around a camera at the headline's world scale, from behind
    the camera to 4.5 m deep, inside and outside the frustum."""
    rng = np.random.default_rng(seed)
    fx = 240.6 * W / 320
    pose = np.eye(4)
    pose[:3, :3] = _rotation(rng.uniform(-0.3, 0.3, 3))
    pose[:3, 3] = (2.4, 2.4, 0.6)
    z = rng.uniform(-0.6, 4.5, 4 * n)
    lat = rng.uniform(-1.3, 1.3, (4 * n, 2)) * np.array([W / 2, H / 2]) / fx
    pc = np.stack([lat[:, 0] * np.abs(z), lat[:, 1] * np.abs(z), z], -1)
    bc = np.floor((pc @ pose[:3, :3].T + pose[:3, 3]) / (8 * VS))
    bc = bc[(bc >= 0).all(1)][:n].astype(np.int32)
    depth = rng.uniform(0.2, 4.5, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, 240.0 * W / 320, W / 2, H / 2
    return dict(bc=bc, live=rng.random(len(bc)) < 0.8,
                tsdf=rng.uniform(-1, 1, (len(bc), 512)).astype(np.float32),
                weight=rng.integers(0, 12, (len(bc), 512)).astype(np.float32),
                depth=depth, T_cw=np.linalg.inv(pose).astype(np.float32),
                K=K)


def _args(c, dev):
    t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in c.items()}
    return (t["bc"], t["live"], t["tsdf"], t["weight"], t["depth"],
            t["T_cw"], t["K"], MU, 100.0, VS, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,seed", [(60, 80, 0), (120, 160, 1),
                                      (240, 320, 2)])
def test_kernel_matches_twin(cuda, H, W, seed):
    """Built with --fmad=false and the twin's multiply-add chains, the
    kernel and its twin agree bit for bit."""
    args = _args(_case(H, W, seed), cuda)
    before = ik.LAUNCHES
    out = ik.fuse_sdf(*args)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == before + 1
    ref = ik.fuse_sdf_reference(*args)
    assert bool(ref[2].any()) and not bool(ref[2].all())
    assert int((ref[1] != args[3]).sum()) > 0
    for name, a, b in zip(("tsdf", "weight", "visible"), out, ref):
        bad = a != b
        assert not bool(bad.any()), (
            f"{name}: {int(bad.sum())} of {bad.numel()} differ, max "
            f"{float((a.float() - b.float()).abs().max())}")


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    args = list(_args(_case(60, 80, 3, n=8), cuda))
    bad = list(args)
    bad[2] = args[2].double()                     # tsdf not float32
    with pytest.raises(ValueError):
        ik.fuse_sdf(*bad)
    bad = list(args)
    bad[4] = args[4].t()                          # depth not contiguous
    with pytest.raises(ValueError):
        ik.fuse_sdf(*bad)
    bad = list(args)
    bad[0] = args[0].cpu()                        # bc on another device
    with pytest.raises(ValueError):
        ik.fuse_sdf(*bad)
