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

from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.fields import OFusionField, SDFField
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
    the camera to 4.5 m deep, inside and outside the frustum, inside a
    256^3 map."""
    rng = np.random.default_rng(seed)
    fx = 240.6 * W / 320
    pose = np.eye(4)
    pose[:3, :3] = _rotation(rng.uniform(-0.3, 0.3, 3))
    pose[:3, 3] = (2.4, 2.4, 0.6)
    z = rng.uniform(-0.6, 4.5, 4 * n)
    lat = rng.uniform(-1.3, 1.3, (4 * n, 2)) * np.array([W / 2, H / 2]) / fx
    pc = np.stack([lat[:, 0] * np.abs(z), lat[:, 1] * np.abs(z), z], -1)
    bc = np.floor((pc @ pose[:3, :3].T + pose[:3, 3]) / (8 * VS))
    bc = bc[((bc >= 0) & (bc < 32)).all(1)][:n].astype(np.int64)
    depth = rng.uniform(0.2, 4.5, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, 240.0 * W / 320, W / 2, H / 2
    return dict(bc=bc, depth=depth, T_cw=np.linalg.inv(pose).astype(
        np.float32), K=K, rng=rng)


def _map(c, kernel, dev, n_blocks=None):
    """A 256^3 map whose table holds the case's blocks (some of them in
    several slots), about a fifth of them inactive, with random channels;
    slots from ``n_blocks`` on are not live."""
    rng = c["rng"]
    n = len(c["bc"])
    field = SDFField() if kernel == "fuse_sdf" else OFusionField()
    m = octree.init(256, 256 * VS, field.channels, dev, capacity=n)
    bc = torch.from_numpy(c["bc"])
    if kernel == "fuse_sdf":
        a = rng.uniform(-1, 1, (n, 512))
        b = rng.integers(0, 12, (n, 512))
    else:
        a = rng.uniform(-20, 20, (n, 512))
        b = rng.uniform(0, 1.2, (n, 512))
    # a block that repeats in several slots repeats its channels too, so
    # that the view row they all write is the same whatever the order
    _, first, inv = np.unique(c["bc"], axis=0, return_index=True,
                              return_inverse=True)
    a, b = a[first[inv.reshape(-1)]], b[first[inv.reshape(-1)]]
    names = ik.SDF_CHANNELS if kernel == "fuse_sdf" else ik.OFUSION_CHANNELS
    return m.replace(
        keys=morton.block_key(bc[:, 0], bc[:, 1], bc[:, 2]).to(dev),
        active=torch.from_numpy(rng.random(n) < 0.8).to(dev),
        n_blocks=torch.tensor(n if n_blocks is None else n_blocks,
                              dtype=torch.int32, device=dev),
        voxels={k: torch.from_numpy(v.astype(np.float32)).to(dev)
                for k, v in zip(names, (a, b))})


def _frame(c, dev):
    return tuple(torch.from_numpy(c[k]).to(dev)
                 for k in ("depth", "T_cw", "K"))


def _clone(m):
    return m.replace(voxels={k: v.clone() for k, v in m.voxels.items()},
                     active=m.active.clone())


NOW = float(np.float32(1 / 30) * np.float32(95))


def _params(kernel):
    return (MU, 100.0) if kernel == "fuse_sdf" else (0.05, 2 * VS, NOW)


def _view(c, m, dev):
    """A held bf16 view of the 256^3 map ``m``: the encoding of its rows
    (``weight != 0 ? tsdf : NaN``) in its blocks' rows, as a held view
    holds; random values and NaNs elsewhere."""
    v = c["rng"].uniform(-1, 1, (32 ** 3, 512)).astype(np.float32)
    v[c["rng"].random(v.shape) < 0.2] = np.nan
    view = torch.from_numpy(v).to(dev).to(torch.bfloat16)
    enc = torch.where(m.voxels["weight"] != 0, m.voxels["tsdf"],
                      float("nan"))
    return view.index_copy_(0, octree.block_rows(m).long(),
                            enc.to(torch.bfloat16))


def _run_both(kernel, m, c, dev, slots=None, view=None):
    """The kernel and its twin on clones of ``m`` (and of ``view``):
    (kernel map, twin map, kernel view, twin view)."""
    got, want = _clone(m), _clone(m)
    views = [None, None] if view is None else [view.clone(), view.clone()]
    extra = [{} if v is None else {"view": v} for v in views]
    before = ik.LAUNCHES[kernel]
    getattr(ik, kernel)(got, *_frame(c, dev), *_params(kernel), slots=slots,
                        **extra[0])
    torch.cuda.synchronize()
    assert ik.LAUNCHES[kernel] == before + 1
    getattr(ik, kernel + "_twin")(want, *_frame(c, dev), *_params(kernel),
                                  slots=slots, **extra[1])
    return got, want, views[0], views[1]


def _assert_same(kernel, m, got, want, view=None, got_view=None,
                 want_view=None):
    """Whole tables and ``active``: bit for bit (OFusion's occupancy
    within rtol 1e-5 / atol 1e-6, the last bits of logf); the views with
    NaN where NaN and the same bits elsewhere.  The fusion changed
    something."""
    assert torch.equal(got.active, want.active)
    if kernel == "fuse_sdf":
        for k in ik.SDF_CHANNELS:
            bad = got.voxels[k] != want.voxels[k]
            assert not bool(bad.any()), f"{k}: {int(bad.sum())} differ"
        changed = want.voxels["weight"] != m.voxels["weight"]
    else:
        assert torch.equal(got.voxels["timestamp"], want.voxels["timestamp"])
        torch.testing.assert_close(got.voxels["occupancy"],
                                   want.voxels["occupancy"], rtol=1e-5,
                                   atol=1e-6)
        changed = want.voxels["timestamp"] == NOW
    assert int(changed.sum()) > 100
    assert bool(want.active.any()) and not bool(want.active.all())
    if view is not None:
        assert torch.equal(torch.isnan(got_view), torch.isnan(want_view))
        assert torch.equal(torch.nan_to_num(got_view),
                           torch.nan_to_num(want_view))
        assert int((torch.nan_to_num(want_view)
                    != torch.nan_to_num(view)).any(1).sum()) > 10


def _slots(c, n, dev, frac=0.6):
    """An ascending, unique share of the slots, live or not."""
    pick = np.sort(c["rng"].choice(n, int(n * frac), replace=False))
    return torch.from_numpy(pick.astype(np.int32)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,seed", [(60, 80, 0), (120, 160, 1),
                                      (240, 320, 2)])
def test_kernel_matches_twin(cuda, H, W, seed):
    """Built with --fmad=false and the twin's multiply-add chains, the SDF
    kernel and its twin agree bit for bit on listed slots, the held view
    included."""
    c = _case(H, W, seed)
    m = _map(c, "fuse_sdf", cuda)
    view = _view(c, m, cuda)
    slots = _slots(c, len(c["bc"]), cuda)
    got, want, got_view, want_view = _run_both("fuse_sdf", m, c, cuda, slots,
                                               view)
    _assert_same("fuse_sdf", m, got, want, view, got_view, want_view)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    c = _case(60, 80, 3, n=8)
    m = _map(c, "fuse_sdf", cuda)
    frame = list(_frame(c, cuda))
    slots = torch.arange(4, dtype=torch.int32, device=cuda)
    bad = m.replace(voxels={k: v.double() for k, v in m.voxels.items()})
    with pytest.raises(ValueError):                # tsdf not float32
        ik.fuse_sdf(bad, *frame, *_params("fuse_sdf"))
    with pytest.raises(ValueError):                # depth not contiguous
        ik.fuse_sdf(m, frame[0].t(), *frame[1:], *_params("fuse_sdf"))
    with pytest.raises(ValueError):                # keys on another device
        ik.fuse_sdf(m.replace(keys=m.keys.cpu()), *frame,
                    *_params("fuse_sdf"))
    with pytest.raises(ValueError):                # slots not int32
        ik.fuse_sdf(m, *frame, *_params("fuse_sdf"), slots=slots.long())
    with pytest.raises(ValueError):                # view not bf16
        ik.fuse_sdf(m, *frame, *_params("fuse_sdf"),
                    view=torch.zeros((32 ** 3, 512), device=cuda))
    with pytest.raises(ValueError):                # more slots than the table
        ik.fuse_sdf(m, *frame, *_params("fuse_sdf"),
                    slots=torch.arange(9, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fuse_sdf", "fuse_ofusion"])
def test_kernel_skips_slots_outside_the_table(cuda, kernel):
    """A listed slot past the capacity (or negative) is skipped on the
    card: the others fuse as the twin fuses them alone."""
    c = _case(240, 320, 7)
    m = _map(c, kernel, cuda)
    cap = m.capacity
    inside = _slots(c, cap, cuda, 0.5)
    listed = torch.cat([torch.tensor([-1], dtype=torch.int32, device=cuda),
                        inside, torch.tensor([cap, cap + 7],
                                             dtype=torch.int32,
                                             device=cuda)])
    got, want = _clone(m), _clone(m)
    getattr(ik, kernel)(got, *_frame(c, cuda), *_params(kernel),
                        slots=listed)
    getattr(ik, kernel + "_twin")(want, *_frame(c, cuda), *_params(kernel),
                                  slots=inside)
    torch.cuda.synchronize()
    _assert_same(kernel, m, got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,seed", [(60, 80, 4), (120, 160, 6),
                                      (240, 320, 5)])
def test_ofusion_kernel_matches_twin(cuda, H, W, seed):
    """On listed slots: visible (``active``) and timestamp bit for bit;
    occupancy within 1e-5 relative (1e-6 absolute where log-odds cancel
    toward 0), the last bits of logf."""
    c = _case(H, W, seed)
    m = _map(c, "fuse_ofusion", cuda)
    slots = _slots(c, len(c["bc"]), cuda)
    _assert_same("fuse_ofusion", m,
                 *_run_both("fuse_ofusion", m, c, cuda, slots)[:2])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["fuse_sdf", "fuse_ofusion"])
@pytest.mark.parametrize("n", [6144, 24576, 98304])
def test_kernels_on_whole_tables(cuda, kernel, n):
    """The presets' table sizes: the whole-table branch at capacity 6144
    and 24576 (a tenth of the slots past ``n_blocks`` and a fifth of the
    rest inactive: dead rows keep their voxels and ``active`` bit for
    bit), and 98304 listed slots of a larger table (the budget of
    1024^3).  The SDF runs with a held view."""
    budget = n == 98304
    c = _case(240, 320, n % 1000, n=n + 8192 if budget else n)
    assert len(c["bc"]) == (n + 8192 if budget else n)
    m = _map(c, kernel, cuda, n_blocks=None if budget else n - n // 10)
    slots = _slots(c, len(c["bc"]), cuda, n / len(c["bc"])) if budget \
        else None
    view = _view(c, m, cuda) if kernel == "fuse_sdf" else None
    got, want, gv, wv = _run_both(kernel, m, c, cuda, slots, view)
    _assert_same(kernel, m, got, want, view, gv, wv)
    if budget:
        assert slots.shape[0] == n
        return
    dead = ~(octree.slot_mask(m) & m.active)
    assert int(dead.sum()) > n // 10
    for k, v in got.voxels.items():
        assert torch.equal(v[dead], m.voxels[k][dead])
    assert torch.equal(got.active[dead], m.active[dead])


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
