"""Tests of the port's CUDA kernels on the card (marker ``gpu``): each
kernel against its plain twin.  They skip
without a CUDA device.  This file imports neither JAX nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from supereight_tpu_torch.ops import gather_probe as gp
from supereight_tpu_torch.ops import integrate_kernel as ik
from supereight_tpu_torch.probes import gather_probe as probe

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
    before = ik.LAUNCHES["fuse_sdf"]
    out = ik.fuse_sdf(*args)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["fuse_sdf"] == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,seed", [(60, 80, 4), (240, 320, 5)])
def test_ofusion_kernel_matches_twin(cuda, H, W, seed):
    """visible and timestamp bit for bit; occupancy within 1e-5 relative
    (1e-6 absolute where log-odds cancel toward 0), the last bits of
    logf."""
    c = _case(H, W, seed)
    rng = np.random.default_rng(seed)
    n = len(c["bc"])
    bc, live, _, _, depth, T_cw, K = _args(c, cuda)[:7]
    occ = torch.from_numpy(rng.uniform(-20, 20, (n, 512)).astype(
        np.float32)).to(cuda)
    ts = torch.from_numpy(rng.uniform(0, 1.2, (n, 512)).astype(
        np.float32)).to(cuda)
    now = float(np.float32(1 / 30) * np.float32(40))
    args = (bc, live, occ, ts, depth, T_cw, K, 0.05, 2 * VS, now, VS, 16)
    before = ik.LAUNCHES["fuse_ofusion"]
    out = ik.fuse_ofusion(*args)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["fuse_ofusion"] == before + 1
    ref = ik.fuse_ofusion_reference(*args)
    assert bool(ref[2].any()) and int((ref[1] == now).sum()) > 100
    assert torch.equal(out[2], ref[2])
    assert torch.equal(out[1], ref[1])
    torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-6)


def _ofusion_channels(n, seed, dev):
    rng = np.random.default_rng(seed)
    occ = rng.uniform(-20, 20, (n, 512)).astype(np.float32)
    ts = rng.uniform(0, 1.2, (n, 512)).astype(np.float32)
    return (torch.from_numpy(occ).to(dev), torch.from_numpy(ts).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fuse_sdf", "fuse_ofusion"])
@pytest.mark.parametrize("n", [6144, 24576, 98304])
def test_kernels_on_whole_tables(cuda, kernel, n):
    """The all-rows fusion branch at the table sizes of the presets
    (capacity 6144 and 24576, the 98304-row budget of 1024^3): about a
    fifth of the rows are dead (not live) and come back unchanged bit for
    bit.  ``fuse_sdf``: tsdf and weight within 1e-5, visible exact;
    ``fuse_ofusion``: occupancy within rtol 1e-5 / atol 1e-6, visible and
    timestamp exact."""
    c = _case(240, 320, n % 1000, n=n)
    assert len(c["bc"]) == n
    args = list(_args(c, cuda))
    now = float(np.float32(1 / 30) * np.float32(95))
    if kernel == "fuse_ofusion":
        args[2:4] = _ofusion_channels(n, n, cuda)
        args[7:9] = [0.05, 2 * VS, now]
    fn, plain = getattr(ik, kernel), getattr(ik, kernel + "_reference")
    before = ik.LAUNCHES[kernel]
    out = fn(*args)
    torch.cuda.synchronize()
    assert ik.LAUNCHES[kernel] == before + 1
    ref = plain(*args)
    dead = ~args[1]
    assert int(dead.sum()) > n // 10
    for o, a in zip(out[:2], args[2:4]):
        assert torch.equal(o[dead], a[dead])
    assert torch.equal(out[2], ref[2])
    if kernel == "fuse_ofusion":
        assert int((ref[1] == now).sum()) > 100
        assert torch.equal(out[1], ref[1])
        torch.testing.assert_close(out[0], ref[0], rtol=1e-5, atol=1e-6)
    else:
        assert int((ref[1] != args[3]).sum()) > 100
        for o, r in zip(out[:2], ref[:2]):
            torch.testing.assert_close(o, r, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gather_probe_kernels_match_twins(cuda):
    """K2 and K3 at the probe's shapes, bit for bit."""
    d = probe.make_data()
    src = torch.from_numpy(d["src"]).to(cuda)
    idx = probe.shuffle_inputs(d, 2, cuda)[1]
    table = probe.table16(d, cuda)
    rows = probe.rows_inputs(d, 2, cuda)[1]
    before = dict(gp.LAUNCHES)
    out = gp.lane_shuffle_sum(src, idx, probe.KREP)
    slab = gp.slab_row_sum(rows, table)
    torch.cuda.synchronize()
    assert gp.LAUNCHES == {k: v + 1 for k, v in before.items()}
    assert torch.equal(out, gp.lane_shuffle_sum_reference(src, idx,
                                                           probe.KREP))
    assert torch.equal(slab, gp.slab_row_sum_reference(rows, table))


@pytest.mark.gpu
def test_gather_probe_kernels_reject_what_they_do_not_take(cuda):
    src = torch.zeros((4, 128), device=cuda)
    idx = torch.zeros((4, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gp.lane_shuffle_sum(src, idx.long(), 3)
    with pytest.raises(ValueError):
        gp.lane_shuffle_sum(src[:, :64].contiguous(), idx[:, :64], 3)
    table = torch.zeros((16, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        gp.slab_row_sum(idx[0, :6], table)
    with pytest.raises(ValueError):
        gp.slab_row_sum(idx[0, :4], table.float())
