"""Tests of the port on the card (marker ``gpu``): each CUDA kernel against
its plain twin (the ICP kernels at the headline's level shapes and on a
rank's strip, every knob group; the level loops with no host read), and
the slice's entry points (the benchmark app with its
map outputs, the renderers, the sphere trace, the multiply-add, meshing,
collision queries and the checkpoints) against their CPU results.
They skip without a CUDA device.  This file imports neither JAX nor the
JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import dataclasses
import os

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
        np.float32), K=K, rng=rng, pose=pose.astype(np.float32))


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


def _counted(fn, name):
    """``fn()``, checking that it launched kernel ``name`` once."""
    before = dict(gp.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    assert gp.LAUNCHES == {k: v + (k == name) for k, v in before.items()}
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3, 256, 4097])
@pytest.mark.parametrize("krep", [0, 1, 5, 64, 200])
def test_lane_shuffle_sum_shapes(cuda, S, krep):
    """Any row count (fewer rows than the persistent grid, and more), the
    unrolled krep = 64 and the loop for any other (200: windows wrap), lane
    indices near 2^31 (idx + i overflows int32) and negative: bit for bit."""
    rng = np.random.default_rng(S * 1000 + krep)
    src = torch.from_numpy(rng.standard_normal((S, 128)).astype(np.float32))
    idx = rng.integers(-2 ** 31, 2 ** 31, (S, 128))
    idx[:, :8] = 2 ** 31 - 1 - rng.integers(0, 40, (S, 8))
    idx[:, 8:16] = rng.integers(-300, 0, (S, 8))
    idx = torch.from_numpy(idx.astype(np.int32))
    src, idx = src.to(cuda), idx.to(cuda)
    out = _counted(lambda: gp.lane_shuffle_sum(src, idx, krep),
                   "lane_shuffle_sum")
    assert torch.equal(out, gp.lane_shuffle_sum_reference(src, idx, krep))


def _slab_case(dev, n, wide, cap, seed, offset=0):
    """rows int32[n] of random slabs with repeats and the table's last slab,
    and a bf16[cap, wide] table on ``dev`` whose data starts ``offset``
    elements into its storage (an offset that is not a multiple of 8
    misaligns it)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, cap // 8, n) * 8
    rows[: n // 4] = rows[0]                        # one slab repeated
    rows[-1] = cap - 8                              # the last slab
    flat = torch.from_numpy(rng.standard_normal(cap * wide + offset)
                            .astype(np.float32)).to(dev, torch.bfloat16)
    table = flat[offset:].view(cap, wide)
    return torch.from_numpy(rows.astype(np.int32)).to(dev), table


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4, 2048])
@pytest.mark.parametrize("wide,offset", [(64, 0), (32, 0), (520, 0),
                                         (36, 0), (512, 3)])
def test_slab_row_sum_shapes(cuda, n, wide, offset):
    """One step and the probe's 2048 rows; a width of one whole 64-column
    tile, half a tile (32), one whose last tile is 8 columns (520), one
    that is not a multiple of 8 (36) and a misaligned table (both copied
    element by element); repeated slabs and the table's last one: bit for
    bit."""
    rows, table = _slab_case(cuda, n, wide, 256, n + wide, offset)
    assert table.data_ptr() % 16 == (2 * offset) % 16
    out = _counted(lambda: gp.slab_row_sum(rows, table), "slab_row_sum")
    assert out.shape == (8, wide)
    assert torch.equal(out, gp.slab_row_sum_reference(rows, table))


@pytest.mark.gpu
def test_slab_row_sum_stages_indices_in_chunks(cuda):
    """More steps than one chunk of staged indices (n / 4 > 2048)."""
    rows, table = _slab_case(cuda, 4 * 2048 + 44, 64, 128, 11)
    out = _counted(lambda: gp.slab_row_sum(rows, table), "slab_row_sum")
    assert torch.equal(out, gp.slab_row_sum_reference(rows, table))


# ---- the slice's entry points on the card against their CPU results ----

BENCH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "bench_data", "synthetic_256_frames.npz")
APP_FRAMES = 8


def _sequence(tmp_path):
    """The first APP_FRAMES cached frames as a .raw stream and a TUM
    trajectory."""
    from supereight_tpu_torch.io import groundtruth, raw
    z = np.load(BENCH)
    w = raw.RawWriter(str(tmp_path / "seq.raw"), 320, 240)
    for d in z["depths"][:APP_FRAMES]:
        w.write(d)
    w.close()
    groundtruth.write_poses(str(tmp_path / "seq.gt"),
                            z["poses"][:APP_FRAMES])
    return str(tmp_path / "seq.raw"), str(tmp_path / "seq.gt")


@pytest.mark.gpu
def test_app_ground_truth_on_card(cuda, tmp_path):
    """``apps.benchmark`` in ground-truth mode for 8 frames at 64^3: the
    card's run (through the fusion kernel) and the CPU's (its twin) give
    the same TSV flags and poses, the same blocks, slots and tables, the
    same depth and track images, and volume images whose shaded pixels
    part at most at 0.1 % (the raycast's)."""
    from supereight_tpu_torch.apps import benchmark
    rawp, gtp = _sequence(tmp_path)
    from supereight_tpu_torch.io import serialise
    runs = {}
    for dev in ("cuda", "cpu"):
        log = str(tmp_path / f"{dev}.tsv")
        before = ik.LAUNCHES["fuse_sdf"]
        r = benchmark.run(["-i", rawp, "-g", gtp, "-s", "4.8", "-v", "64",
                           "-r", "2", "-k", "240.6,240,160,120", "-z", "1",
                           "-c", "2", "-q", "-o", log, "--device", dev,
                           "-d", str(tmp_path / f"{dev}.npz"),
                           "--dump-mesh", str(tmp_path / f"{dev}.vtk")])
        launched = ik.LAUNCHES["fuse_sdf"] - before
        runs[dev] = (np.loadtxt(log, skiprows=1, ndmin=2), r, launched)
    (tc, rc, nc), (tp, rp, np_) = runs["cuda"], runs["cpu"]
    assert nc == APP_FRAMES and np_ == 0
    np.testing.assert_array_equal(tc[:, 9:], tp[:, 9:])
    assert tc[:, 12].sum() == APP_FRAMES
    np.testing.assert_array_equal(np.stack(rc.est_poses),
                                  np.stack(rp.est_poses))
    mc, mp = rc.system.state.map, rp.system.state.map
    assert int(mc.n_blocks) == int(mp.n_blocks) > 0
    for name in ("keys", "block_index", "active"):
        assert torch.equal(getattr(mc, name).cpu(), getattr(mp, name))
    for k in mc.voxels:
        assert torch.equal(mc.voxels[k].cpu(), mp.voxels[k]), k
    for a, b in zip(rc.images[:2], rp.images[:2]):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    # the shaded reference maps of maps that part by rounding
    shaded = [(x[..., :3].amax(-1) > 0).float() for x in
              (rc.images[2].cpu(), rp.images[2])]
    assert float((shaded[0] != shaded[1]).float().mean()) <= 1e-3
    # -d and --dump-mesh: the same checkpoint and the same mesh file
    a, b = (serialise.load_map(str(tmp_path / f"{d}.npz"), device="cpu")
            for d in ("cuda", "cpu"))
    for k in a.voxels:
        assert torch.equal(a.voxels[k], b.voxels[k]), k
    assert torch.equal(a.block_index, b.block_index)
    assert (tmp_path / "cuda.vtk").read_bytes() == \
        (tmp_path / "cpu.vtk").read_bytes()


def _to(x, dev):
    """A state, map or tensor (nested in dataclasses, lists and dicts) on
    ``dev``."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, dev) for v in x]
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["headline", "ofusion"])
def test_renderers_match_cpu(cuda, preset):
    """``renderDepth``, ``renderTrack`` and ``renderVolume`` (reference maps
    and a free view) of one state, on the card and on the CPU: bit for bit
    but for a free view's raycast, which may part at 0.1 % of the
    pixels."""
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    z = np.load(BENCH)
    cfg = apply_preset(preset, SlamConfig(
        volume_resolution=(64,) * 3, volume_size=(4.8,) * 3,
        compute_size_ratio=2))
    k = np.array([120.3, 120.0, 80.0, 60.0], np.float32)
    cpu = DenseSLAMSystem((240, 320), cfg, "cpu")
    cpu.setPose(z["poses"][0])
    for f in range(6):
        cpu.step(z["depths"][f], k, f)
    card = DenseSLAMSystem((240, 320), cfg, cuda)
    card.state = _to(cpu.state, cuda)
    for name in ("renderDepth", "renderTrack", "renderVolume"):
        a, b = getattr(card, name)(), getattr(cpu, name)()
        assert a.device.type == "cuda" and a.dtype == torch.uint8
        assert torch.equal(a.cpu(), b), name
    a = card.renderVolume(z["poses"][7], k).cpu()
    b = cpu.renderVolume(z["poses"][7], k)
    assert float((a != b).any(-1).float().mean()) <= 1e-3
    assert float((b[..., :3].amax(-1) > 0).float().mean()) > 0.5


@pytest.mark.gpu
def test_sphere_trace_matches_cpu(cuda):
    """The synthetic sequence's sphere trace on the card and on the CPU,
    both scene variants: the same depth bit for bit."""
    from supereight_tpu_torch.io import synthetic
    pose = synthetic.orbit_poses(120, 4.8)[40]
    k = np.array([120.0, 120.0, 160.0, 120.0], np.float32)
    for variant in (0, 1):
        args = (4.8, 240, 320)
        a = synthetic.render_depth(torch.from_numpy(pose).to(cuda),
                                   torch.from_numpy(k).to(cuda), *args,
                                   variant=variant).cpu()
        b = synthetic.render_depth(torch.from_numpy(pose),
                                   torch.from_numpy(k), *args,
                                   variant=variant)
        assert float((b > 0).float().mean()) > 0.9
        assert torch.equal(a, b), variant


@pytest.mark.gpu
def test_fma_on_card_rounds_once(cuda):
    """``numerics.fma`` on the card (``addcmul`` where nvcc contracts it,
    else the float64 fallback) equals the CPU's on products that nearly
    cancel, where rounding twice differs."""
    from supereight_tpu_torch.core import numerics
    rng = np.random.default_rng(0)
    n = 1 << 20
    a, b = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    c = (-(a.double() * b) * (1 + torch.from_numpy(
        rng.standard_normal(n)) * 1e-7)).float()
    want = numerics.fma(a, b, c)
    got = numerics.fma(a.to(cuda), b.to(cuda), c.to(cuda)).cpu()
    assert torch.equal(got, want)
    assert torch.equal(numerics._fma_round_to_odd(
        a.to(cuda), b.to(cuda), c.to(cuda)).cpu(), want)
    print("addcmul fuses on the card:",
          numerics._addcmul_fuses("cuda"))


@pytest.mark.gpu
def test_inv_on_card(cuda):
    """``numerics.inv`` of a pose on the card: on the card, the CPU's bits."""
    from supereight_tpu_torch.core import numerics
    pose = torch.from_numpy(np.load(BENCH)["poses"][17])
    got = numerics.inv(pose.to(cuda))
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), numerics.inv(pose))


@pytest.mark.gpu
def test_exp_on_card_matches_cpu(cuda):
    """``numerics.exp`` (XLA's ``exp``, which the bilateral filter takes)
    gives the same bits on the card as on the CPU."""
    from supereight_tpu_torch.core import numerics
    x = torch.linspace(-120, 120, 1 << 20, dtype=torch.float64).float()
    assert torch.equal(numerics.exp(x.to(cuda)).cpu(), numerics.exp(x))


def _sphere_map(size=64, dim=4.8, radius=1.0):
    """An analytic-sphere SDF map (every block allocated) on the CPU, with
    a few blocks' weights zeroed (unobserved corners)."""
    chans = (octree.ChannelSpec("v", torch.float32, 1.0, 1.0),
             octree.ChannelSpec("w", torch.float32, 0.0, -1.0))
    m = octree.init(size, dim, chans, "cpu", capacity=(size // 8) ** 3)
    r = torch.arange(size // 8)
    coords = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) \
        .reshape(-1, 3)
    m = octree.allocate_blocks(m, coords, torch.ones(len(coords),
                                                     dtype=torch.bool))
    g = torch.arange(size, dtype=torch.float64) * (dim / size) - dim / 2
    gx, gy, gz = torch.meshgrid(g, g, g, indexing="ij")
    sdf = (gx ** 2 + gy ** 2 + gz ** 2).sqrt() - radius
    i = torch.arange(size)
    ix, iy, iz = (a.reshape(-1) for a in torch.meshgrid(i, i, i,
                                                         indexing="ij"))
    m = octree.set_voxels(m, "v", ix, iy, iz, sdf.reshape(-1).float())
    w = torch.ones(size ** 3)
    w[torch.randperm(size ** 3, generator=torch.Generator().manual_seed(0))
      [:size ** 3 // 50]] = 0.0
    return octree.set_voxels(m, "w", ix, iy, iz, w)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [64, 1024])
def test_meshing_on_card_matches_cpu(cuda, chunk):
    """``marching_cubes`` of one map on the card and on the CPU: the same
    triangles in the same order, bit for bit."""
    from supereight_tpu_torch.core import meshing
    m = _sphere_map()
    want = meshing.marching_cubes(m, "v")
    got = meshing.marching_cubes(_to(m, cuda), "v", chunk=chunk)
    assert got.device.type == "cuda" and want.shape[0] > 1000
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_collision_on_card_matches_cpu(cuda):
    from supereight_tpu_torch.core import collision
    m = _sphere_map()
    m = m.replace(voxels={"tsdf": m.voxels["v"], "weight": m.voxels["w"]},
                  channels=SDFField().channels,
                  node_values=[{"tsdf": lv["v"], "weight": lv["w"]}
                               for lv in m.node_values])
    rng = np.random.default_rng(0)
    statuses = set()
    for _ in range(30):
        bbox = tuple(int(v) for v in rng.integers(-4, 64, 3))
        side = tuple(int(v) for v in rng.integers(1, 10, 3))
        want = collision.collides_with(m, bbox, side,
                                       collision.sdf_collision_test)
        got = collision.collides_with(_to(m, cuda), bbox, side,
                                      collision.sdf_collision_test)
        assert int(got) == int(want)
        statuses.add(int(want))
    assert len(statuses) >= 2


@pytest.mark.gpu
def test_serialise_round_trip_on_card(cuda, tmp_path):
    """A map on the card writes the bytes its CPU copy writes (npz tables
    and the reference binary), and reads back onto the card unchanged."""
    from supereight_tpu_torch.io import serialise
    m = _sphere_map(size=32)
    m = m.replace(voxels={"tsdf": m.voxels["v"], "weight": m.voxels["w"]},
                  channels=SDFField().channels,
                  node_values=[{"tsdf": lv["v"], "weight": lv["w"]}
                               for lv in m.node_values])
    mc = _to(m, cuda)
    for name, mm in (("cpu", m), ("cuda", mc)):
        serialise.save_se(str(tmp_path / f"{name}.bin"), mm)
        serialise.save_map(str(tmp_path / f"{name}.npz"), mm)
    assert (tmp_path / "cpu.bin").read_bytes() == \
        (tmp_path / "cuda.bin").read_bytes()
    back = serialise.load_se(str(tmp_path / "cuda.bin"), m.channels,
                             capacity=m.capacity, device="cuda")
    loaded = serialise.load_map(str(tmp_path / "cuda.npz"), device="cuda")
    for x in (back, loaded):
        assert x.block_index.device.type == "cuda"
        assert torch.equal(x.block_index.cpu(), m.block_index)
        for k in m.voxels:
            assert torch.equal(x.voxels[k].cpu(), m.voxels[k])


def _stored_state():
    """A CPU system with stored normals after 6 cached frames (64^3,
    160x120), and the intrinsics."""
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    z = np.load(BENCH)
    cfg = apply_preset("headline", SlamConfig(
        volume_resolution=(64,) * 3, volume_size=(4.8,) * 3,
        compute_size_ratio=2))
    cfg = dataclasses.replace(cfg, raycast_normals="stored")
    k = np.array([120.3, 120.0, 80.0, 60.0], np.float32)
    cpu = DenseSLAMSystem((240, 320), cfg, "cpu")
    cpu.setPose(z["poses"][0])
    for f in range(6):
        cpu.step(z["depths"][f], k, f)
    return cpu, k


@pytest.mark.gpu
def test_gradmap_on_card_matches_cpu(cuda):
    """The stored gradient table of one map, and samples of it, on the
    card and on the CPU: bit for bit, the NaN pattern included."""
    from supereight_tpu_torch.pipeline import gradmap
    cpu, _ = _stored_state()
    m, field = cpu.state.map, cpu.field
    want = gradmap.build_table(m, field)
    got = gradmap.build_table(_to(m, cuda), field)
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    a, b = got.cpu().float(), want.float()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert torch.equal(b.nan_to_num(), cpu.state.grad.float().nan_to_num())
    pos = torch.rand(20000, 3, generator=torch.Generator().manual_seed(1)) \
        * 72 - 4
    for x, y in zip(gradmap.sample(_to(m, cuda), got, pos.to(cuda)),
                    gradmap.sample(m, want, pos)):
        assert torch.equal(x.cpu().nan_to_num(), y.nan_to_num())


@pytest.mark.gpu
def test_bilinear_and_robust_on_card_match_cpu(cuda):
    """The bilinear association of one state's reference maps on the card
    and on the CPU (bit for bit), and the Huber and Tukey weights (bit for
    bit) and sums (within 1e-5 relative: the card's reductions sum in
    another order)."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing, tracking
    cpu, k = _stored_state()
    st = cpu.state
    kt = torch.from_numpy(k)
    _, v, n = preprocessing.build_pyramid(st.scaled_depth, kt, 1, False)
    view = camera.camera_matrix(kt) @ numerics.inv(st.raycast_pose)
    pv, px, py, _ = tracking._project(st.pose, view, v[0], 120, 160)
    want = tracking._gather_ref(st.ref_vertex, st.ref_normal, px, py, 120,
                                160, "bilinear")
    got = tracking._gather_ref(st.ref_vertex.to(cuda),
                               st.ref_normal.to(cuda), px.to(cuda),
                               py.to(cuda), 120, 160, "bilinear")
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    td = tracking.track_kernel(v[0], n[0], st.ref_vertex, st.ref_normal,
                               st.pose, view, assoc="bilinear")
    assert int((td.result == 1).sum()) > 1000
    tdc = tracking.TrackData(*(x.to(cuda) for x in td))
    for robust in ("huber", "tukey"):
        wa = tracking.robust_weights(tdc, robust, 0.01).cpu()
        assert torch.equal(wa, tracking.robust_weights(td, robust, 0.01))
        for a, b in zip(tracking.reduce_kernel(tdc, robust, 0.01),
                        tracking.reduce_kernel(td, robust, 0.01)):
            a, b = a.cpu().double(), b.double()
            assert torch.allclose(a, b, rtol=1e-5,
                                  atol=1e-6 * float(b.abs().max()))


def _collectives_want(D):
    rows = (np.arange(4 * 512).reshape(4, 512) % 61).astype(np.float32)
    return dict(
        sums=np.full(44, sum(r + 0.5 for r in range(D)), np.float32),
        mask=sum(np.arange(8) % (r + 2) for r in range(D)),
        rows=np.concatenate([rows + 64 * r for r in range(D)]),
        flags=np.concatenate([np.arange(6) % 2 == r % 2 for r in range(D)]),
        tgt=np.concatenate([np.arange(5) + 10 * r for r in range(D)]),
        maps=np.concatenate([np.full((3, 4, 6), float(r))
                             for r in range(D)]))


@pytest.mark.gpu
def test_gloo_cuda_collectives(cuda):
    """gloo carries every collective of the multi-device map on CUDA
    tensors (2 ranks sharing the card): the all_reduce of float32 and
    int32, the list all_gather of bfloat16 rows and bool flags (as bytes),
    int64 rows and float32 maps."""
    from supereight_tpu_torch.parallel import multihost
    res = multihost.launch_jobs(2, [dict(kind="collectives")],
                                device="cuda", backend="gloo",
                                timeout=300, group_timeout=120)[0]
    want = _collectives_want(2)
    for got in res:
        for key, w in want.items():
            np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.gpu
def test_two_rank_frame_on_card(cuda):
    """The sharded frame on 2 ranks on the card (the backend
    ``multihost.default_backend`` picks) == the one-device partitioned
    frame on the card (``multihost.compare``: n_blocks and part_counts
    equal, pose 1e-4, ref_vertex 1e-3, live voxels 1e-4), every rank
    launching the fusion kernel on every frame."""
    from supereight_tpu_torch.parallel import multihost
    multi, single = multihost.launch(2, device="cuda", timeout=300)
    assert multi["state"]["n_blocks"] == single["state"]["n_blocks"] > 0
    for counts in multi["launches_per_rank"]:
        assert counts["fuse_sdf"] == sum(multi["integrated"]) > 0


# ----------------------------------------------------------------------
# The ICP kernels (csrc/icp.cu)
# ----------------------------------------------------------------------

def _icp_inputs(dev):
    """The headline's tracking operands from the cached frames: frame 50's
    pyramid (320x240, three levels), frame 48's level-0 vertices and
    normals in world space as the reference maps, the start pose at frame
    49; all on ``dev``."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing
    z = np.load(BENCH)
    k = torch.tensor([240.6, 240.0, 160.0, 120.0])
    pyr = {}
    for f in (48, 50):
        d = preprocessing.mm_to_meters(
            torch.from_numpy(z["depths"][f].astype(np.int32)), (240, 320))
        pyr[f] = preprocessing.build_pyramid(d, k, 3, neg_y=False)
    rp = torch.from_numpy(z["poses"][48].astype(np.float32))
    n0 = pyr[48][2][0]
    invalid = n0[..., :1] == -2.0
    ref_v = torch.where(invalid, 0.0,
                        camera.transform_points(rp, pyr[48][1][0]))
    ref_n = torch.where(invalid, n0, camera.rotate_vectors(rp, n0))
    to = lambda t: t.to(dev)
    return dict(depths=[to(t) for t in pyr[50][0]],
                vertices=[to(t) for t in pyr[50][1]],
                normals=[to(t) for t in pyr[50][2]],
                ref_v=to(ref_v), ref_n=to(ref_n), rpose=to(rp), k=to(k),
                # on the device, as the kernel forms it
                view=camera.camera_matrix(to(k)) @ numerics.inv(to(rp)),
                start=to(torch.from_numpy(z["poses"][49].astype(
                    np.float32))))


#: the level shapes of the headline (levels 2 and 1, level 0 strided by
#: 2) and rank 1's row strip of the strided level 0 of 2 ranks
ICP_SHAPES = {"80x60": (2, 1, None), "160x120": (1, 1, None),
              "160x120-decimated": (0, 2, None), "strip": (0, 2, (1, 2))}


def _icp_level(inp, shape):
    level, d, strip = ICP_SHAPES[shape]
    iv, inm = inp["vertices"][level][::d, ::d], inp["normals"][level][::d, ::d]
    if strip is not None:
        rank, n = strip
        rows = iv.shape[0] // n
        iv, inm = (a[rank * rows:(rank + 1) * rows] for a in (iv, inm))
    return iv, inm


def _icp_carry(pose):
    from supereight_tpu_torch.pipeline import tracking
    dev = pose.device
    return tracking.TrackState(
        pose=pose.clone(), error2=torch.zeros((), device=dev),
        count=torch.zeros((), device=dev),
        converged=torch.zeros((), dtype=torch.bool, device=dev),
        iteration=torch.zeros((), dtype=torch.int32, device=dev))


def _icp_knobs():
    for assoc in ("nearest", "bilinear"):
        for sym in ("off", "on", "gate"):
            for robust in ("none", "huber", "tukey"):
                yield dict(assoc=assoc, robust=robust,
                           robust_delta=0.02 if robust == "tukey" else 0.01,
                           symmetric=sym)


def _sym(name, dev):
    return {"off": False, "on": True,
            "gate": torch.tensor(True, device=dev)}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ICP_SHAPES))
def test_icp_kernels_match_twins(cuda, shape):
    """Kernel A (a level's first trip: nothing pending) against its twin
    in every knob group: the status image bit
    for bit, the sums within rtol 1e-5 + 1e-6 times their terms' absolute
    sum (another summation order); kernel B on those sums against its
    twin: twist and pose within 1e-6, error2, count and the trip count
    equal."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    iv, inm = _icp_level(inp, shape)
    args = (iv, inm, inp["ref_v"], inp["ref_n"], inp["view"])
    for kn in _icp_knobs():
        kn = dict(kn, symmetric=_sym(kn["symmetric"], cuda))
        st = _icp_carry(inp["start"])
        res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=cuda)
        sums = torch.zeros(icp.N_SUMS, device=cuda)
        before = dict(icp.LAUNCHES)
        got = icp.icp_track_reduce(*args, st, 4, res.clone(), sums.clone(),
                                   **kn)
        want = icp.icp_track_reduce_twin(*args, st, 4, res, sums, **kn)
        assert icp.LAUNCHES["icp_track_reduce"] == \
            before["icp_track_reduce"] + 1
        assert torch.equal(got[1], want[1]), kn
        assert int((got[1] == 1).sum()) > 500
        td = tracking.track_kernel(*args[:4], st.pose, args[4],
                                   symmetric=kn["symmetric"],
                                   assoc=kn["assoc"])
        mag = icp.term_magnitudes(td, tracking.robust_weights(
            td, kn["robust"], kn["robust_delta"])).cpu()
        g, w = got[2].cpu().double(), want[2].cpu().double()
        assert not (torch.abs(g - w) > 1e-5 * w.abs() + 1e-6 * mag).any(), \
            (kn, g, w)

        x_k = torch.zeros(6, device=cuda)
        x_t = torch.zeros(6, device=cuda)
        k_st = icp.icp_update(got[2], _icp_carry(inp["start"]), 4, 1e-5,
                              twist=x_k)
        t_st = icp.icp_update_twin(got[2], _icp_carry(inp["start"]), 4,
                                   1e-5, twist=x_t)
        assert icp.LAUNCHES["icp_update"] == before["icp_update"] + 1
        assert float(x_k.abs().max()) > 1e-5
        torch.testing.assert_close(x_k, x_t, rtol=0, atol=1e-6)
        torch.testing.assert_close(k_st.pose, t_st.pose, rtol=0, atol=1e-6)
        for name in ("error2", "count", "converged", "iteration"):
            assert torch.equal(getattr(k_st, name), getattr(t_st, name))


#: the merged trip's exits: the carry it starts from (converged, iteration)
#: and the threshold of its pending update; "none" runs the update and the
#: pass, "converges" and "last trip" end the level with the update (the
#: carry written, no pass), "ended" finds the level over (nothing written)
TRIP_EXITS = {"none": (False, 0, 1e-9), "converges": (False, 0, 1e9),
              "last trip": (False, 3, 1e-9), "ended": (True, 1, 1e-9)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(ICP_SHAPES))
def test_icp_merged_trip_matches_twins(cuda, shape):
    """Kernel A with the previous trip's sums pending, at each exit of
    TRIP_EXITS in two knob groups: the carry kernel B's on the same sums
    bit for bit (and the twins' update's error2, count, converged and
    iteration); where the pass runs, the status image and sums kernel A's
    from that carry with nothing pending bit for bit, the status image the
    twins' bit for bit and the sums within their tolerance; where it does
    not, the status image and the sums as they were."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    iv, inm = _icp_level(inp, shape)
    args = (iv, inm, inp["ref_v"], inp["ref_n"], inp["view"])
    knobs = list(_icp_knobs())
    for kn in (knobs[0], knobs[-1]):
        kn = dict(kn, symmetric=_sym(kn["symmetric"], cuda))
        pending = icp.icp_track_reduce(
            *args, _icp_carry(inp["start"]), 4,
            torch.zeros(iv.shape[:2], dtype=torch.int32, device=cuda),
            torch.zeros(icp.N_SUMS, device=cuda), **kn)[2]
        for exit_at, (conv, it, thr) in TRIP_EXITS.items():
            def carry():
                st = _icp_carry(inp["start"])
                st.converged.fill_(conv)
                st.iteration.fill_(it)
                return st
            st = carry()
            res = torch.full(iv.shape[:2], 7, dtype=torch.int32,
                             device=cuda)
            sums = torch.arange(icp.N_SUMS, dtype=torch.float32,
                                device=cuda)
            before = dict(icp.LAUNCHES)
            icp.icp_track_reduce(*args, st, 4, res, sums,
                                 pending=pending.clone(), icp_threshold=thr,
                                 **kn)
            assert {k: icp.LAUNCHES[k] - n for k, n in before.items()} == \
                dict(icp_track_reduce=1, icp_update=0, icp_track_levels=0)
            b_st = icp.icp_update(pending, carry(), 4, thr)
            t_st = icp.icp_update_twin(pending, carry(), 4, thr)
            for a, b in zip(st, b_st):
                assert torch.equal(a, b), exit_at
            for name in ("error2", "count", "converged", "iteration"):
                assert torch.equal(getattr(st, name), getattr(t_st, name))
            if exit_at != "none":
                assert bool((res == 7).all()), exit_at
                assert torch.equal(sums, torch.arange(
                    icp.N_SUMS, dtype=torch.float32, device=cuda))
                continue
            ref = icp.icp_track_reduce(
                *args, _icp_carry(b_st.pose), 4, torch.zeros_like(res),
                torch.zeros_like(sums), **kn)
            twin = icp.icp_track_reduce_twin(
                *args, _icp_carry(b_st.pose), 4, torch.zeros_like(res),
                torch.zeros_like(sums), **kn)
            assert torch.equal(res, ref[1]) and torch.equal(sums, ref[2])
            assert torch.equal(res, twin[1])
            td = tracking.track_kernel(*args[:4], b_st.pose, args[4],
                                       symmetric=kn["symmetric"],
                                       assoc=kn["assoc"])
            mag = icp.term_magnitudes(td, tracking.robust_weights(
                td, kn["robust"], kn["robust_delta"])).cpu()
            g, w = sums.cpu().double(), twin[2].cpu().double()
            assert not (torch.abs(g - w) > 1e-5 * w.abs()
                        + 1e-6 * mag).any(), (kn, g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["160x120-decimated", "strip"])
def test_icp_level_loop_on_the_card(cuda, shape):
    """``tracking._level_loop`` on the card (the sharded frame's level
    loop): n_iters launches of kernel A and one of kernel B,
    no host read, and the carry and status image bit for bit those of the
    same kernels composed as the pair ran before (kernel A with nothing
    pending, then kernel B, every trip), at a threshold that ends the
    level early and at one that never does."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    iv, inm = _icp_level(inp, shape)
    refs = (inp["ref_v"], inp["ref_n"], inp["view"])
    ran = set()
    for thr in (1e-3, 0.0):
        torch.cuda.synchronize()
        before = dict(icp.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            st, res = tracking._level_loop(_icp_carry(inp["start"]), 8, iv,
                                           inm, *refs, thr)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert {k: icp.LAUNCHES[k] - n for k, n in before.items()} == \
            dict(icp_track_reduce=8, icp_update=1, icp_track_levels=0)
        pair = _icp_carry(inp["start"])
        p_res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=cuda)
        p_sums = torch.zeros(icp.N_SUMS, device=cuda)
        for _ in range(8):
            icp.icp_track_reduce(iv, inm, *refs, pair, 8, p_res, p_sums)
            icp.icp_update(p_sums, pair, 8, thr)
        for a, b in zip((*st, res), (*pair, p_res)):
            assert torch.equal(a, b), thr
        ran.add((int(st.iteration), bool(st.converged)))
    assert (8, False) in ran and any(c and n < 8 for n, c in ran), ran


@pytest.mark.gpu
def test_icp_kernels_stop_after_the_level(cuda):
    """Once the carry says the level has ended (converged, or iteration at
    n_iters), both kernels launch and change nothing, kernel A with or
    without sums pending."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    iv, inm = _icp_level(inp, "80x60")
    for done in ("converged", "iteration"):
        for pending in (None, torch.ones(icp.N_SUMS, device=cuda)):
            st = _icp_carry(inp["start"])
            if done == "converged":
                st.converged.fill_(True)
            else:
                st.iteration.fill_(3)
            res = torch.full(iv.shape[:2], 7, dtype=torch.int32,
                             device=cuda)
            sums = torch.arange(icp.N_SUMS, dtype=torch.float32,
                                device=cuda)
            carry = [t.clone() for t in st]
            icp.icp_track_reduce(iv, inm, inp["ref_v"], inp["ref_n"],
                                 inp["view"], st, 3, res, sums,
                                 pending=pending, icp_threshold=1e-5)
            icp.icp_update(sums, st, 3, 1e-5)
            torch.cuda.synchronize()
            assert bool((res == 7).all())
            assert torch.equal(sums, torch.arange(icp.N_SUMS,
                                                  dtype=torch.float32,
                                                  device=cuda))
            for a, b in zip(st, carry):
                assert torch.equal(a, b)


@pytest.mark.gpu
def test_icp_kernels_reject_what_they_do_not_take(cuda):
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    iv, inm = _icp_level(inp, "80x60")
    st = _icp_carry(inp["start"])
    res = torch.zeros(iv.shape[:2], dtype=torch.int32, device=cuda)
    sums = torch.zeros(icp.N_SUMS, device=cuda)
    run = lambda *a, **kw: icp.icp_track_reduce(*a, st, 3, res, sums, **kw)
    refs = (inp["ref_v"], inp["ref_n"], inp["view"])
    with pytest.raises(ValueError):                # a CPU tensor
        run(iv, inm, inp["ref_v"].cpu(), *refs[1:])
    with pytest.raises(ValueError):                # not float32
        run(iv.double(), inm, *refs)
    wide = torch.zeros(iv.shape[0], iv.shape[1], 6, device=cuda)
    with pytest.raises(ValueError):                # last dim not contiguous
        run(wide[..., ::2], inm, *refs)
    with pytest.raises(ValueError):                # normals' strides differ
        run(iv, wide[..., :3], *refs)
    with pytest.raises(ValueError):                # reference not contiguous
        run(iv, inm, torch.zeros(240, 320, 6, device=cuda)[..., :3],
            *refs[1:])
    with pytest.raises(ValueError):                # gate not a bool
        run(iv, inm, *refs, symmetric=torch.tensor(1.0, device=cuda))
    with pytest.raises(ValueError):                # pending is the output
        run(iv, inm, *refs, pending=sums, icp_threshold=1e-5)
    with pytest.raises(ValueError):                # pending not float32
        run(iv, inm, *refs, pending=sums.double(), icp_threshold=1e-5)
    with pytest.raises(ValueError):                # a CPU carry
        icp.icp_update(sums, st._replace(pose=st.pose.cpu()), 3, 1e-5)
    with pytest.raises(ValueError):                # sums not float32
        icp.icp_update(sums.double(), st, 3, 1e-5)
    with pytest.raises(ValueError):                # iteration not int32
        icp.icp_update(sums, st._replace(iteration=st.iteration.long()), 3,
                       1e-5)


@pytest.mark.gpu
def test_icp_level_loops_read_nothing_back(cuda):
    """``track_levels`` at the headline's pyramid (10, 5, 4) on the
    card under ``torch.cuda.set_sync_debug_mode("error")``: no host read,
    one launch of ``icp_track_levels`` and none of the pair; ``track`` on
    the card against ``track``
    with the twins (on the CPU): pose within 1e-4 (the multi-device frame's
    tolerance for the same ICP summed in another order), the same
    decision, status flips within 0.1 %."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    levels = (inp["vertices"], inp["normals"], inp["ref_v"], inp["ref_n"],
              inp["rpose"], inp["k"])
    gate = torch.tensor(True, device=cuda)
    torch.cuda.synchronize()
    before = dict(icp.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, res, _ = tracking.track_levels(inp["start"], *levels, (10, 5, 4),
                                           1e-5, finest_decimate=2,
                                           symmetric=gate, robust="huber",
                                           assoc="bilinear")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: icp.LAUNCHES[k] - n for k, n in before.items()} == dict(
        icp_track_levels=1, icp_track_reduce=0, icp_update=0)
    assert 0 < int(st.iteration) <= 4 and bool(torch.isfinite(st.pose).all())
    args = (inp["start"], inp["depths"], inp["vertices"], inp["normals"],
            inp["ref_v"], inp["ref_n"], inp["rpose"], inp["k"])
    got = tracking.track(*args, (10, 5, 4), 1e-5, finest_decimate=2)
    want = tracking.track(*_to(list(args), "cpu"), (10, 5, 4), 1e-5,
                          finest_decimate=2)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4)
    assert bool(got[1]) == bool(want[1]) is True
    assert float((got[2].cpu() != want[2]).float().mean()) <= 1e-3


# ----------------------------------------------------------------------
# icp_track_levels: every trip of every level in one launch
# ----------------------------------------------------------------------

#: the level sets icp_track_levels is held at: the headline's (the finest
#: level strided by 2) and the whole 320x240 finest level
LEVEL_SETS = {"headline": 2, "320x240": 1}


def _levels(inp, d):
    levels = list(zip(inp["vertices"], inp["normals"]))
    levels[0] = tuple(a[::d, ::d] for a in levels[0])
    return levels


def _levels_args(inp, d):
    """What icp_track_levels takes after the start pose (the raycast pose
    and the intrinsics: the view is formed inside the launch)."""
    return (_levels(inp, d), inp["ref_v"], inp["ref_n"], inp["rpose"],
            inp["k"])


def _twin_args(inp, d):
    """What its twin takes after the start pose (the view)."""
    return (_levels(inp, d), inp["ref_v"], inp["ref_n"], inp["view"])


@pytest.mark.gpu
@pytest.mark.parametrize("level_set", sorted(LEVEL_SETS))
def test_icp_track_levels_matches_twin(cuda, level_set):
    """In every knob group: one trip at the finest level from the start
    pose, the status image bit for bit and the sums within rtol 1e-5 +
    1e-6 times their terms' absolute sum; the headline's pyramid (10, 5,
    4), the pose within 1e-4 (a whole ``track``'s tolerance: the sums add
    in another order, which ICP amplifies from trip to trip) and status
    flips within 0.1 %."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    d = LEVEL_SETS[level_set]
    levels, rv, rn, view = _twin_args(inp, d)
    cam = (inp["rpose"], inp["k"])
    for kn in _icp_knobs():
        kn = dict(kn, symmetric=_sym(kn["symmetric"], cuda))
        sums = [torch.zeros(icp.N_SUMS, device=cuda) for _ in range(2)]
        got = icp.icp_track_levels(inp["start"], levels, rv, rn, *cam,
                                   (1, 0, 0), 1e-5, sums=sums[0], **kn)
        want = icp.icp_track_levels_twin(inp["start"], levels, rv, rn, view,
                                         (1, 0, 0), 1e-5, sums=sums[1], **kn)
        assert torch.equal(got[1], want[1]), kn
        assert int((got[1] == 1).sum()) > 500
        td = tracking.track_kernel(*levels[0], rv, rn, inp["start"], view,
                                   symmetric=kn["symmetric"],
                                   assoc=kn["assoc"])
        mag = icp.term_magnitudes(td, tracking.robust_weights(
            td, kn["robust"], kn["robust_delta"])).cpu()
        g, w = sums[0].cpu().double(), sums[1].cpu().double()
        assert not (torch.abs(g - w) > 1e-5 * w.abs() + 1e-6 * mag).any(), \
            (kn, g, w)
        assert float(got[0].count) == float(want[0].count)
        got = icp.icp_track_levels(inp["start"], levels, rv, rn, *cam,
                                   (10, 5, 4), 1e-5, **kn)
        want = icp.icp_track_levels_twin(inp["start"], levels, rv, rn, view,
                                         (10, 5, 4), 1e-5, **kn)
        torch.testing.assert_close(got[0].pose, want[0].pose, rtol=0,
                                   atol=1e-4)
        assert float((got[1] != want[1]).float().mean()) <= 1e-3, kn


@pytest.mark.gpu
@pytest.mark.parametrize("level_set", sorted(LEVEL_SETS))
def test_icp_track_levels_exits_at_every_level(cuda, level_set):
    """Every level exits at its first trip where the threshold is met at
    once: the same pose, bit for bit, as one trip a level that never
    converges, ``converged`` set and ``iteration`` 1; a level configured
    with 0 trips runs none (the finest: a zero status image)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    args = _levels_args(inp, LEVEL_SETS[level_set])
    twin = _twin_args(inp, LEVEL_SETS[level_set])
    run = lambda iters, thr: icp.icp_track_levels(inp["start"], *args,
                                                  iters, thr)
    exit_at_once, res = run((10, 5, 4), 1e3)
    one_each, res1 = run((1, 1, 1), 0.0)
    assert torch.equal(exit_at_once.pose, one_each.pose)
    assert torch.equal(res, res1)
    assert bool(exit_at_once.converged) and not bool(one_each.converged)
    assert int(exit_at_once.iteration) == int(one_each.iteration) == 1
    for iters in ((0, 5, 4), (4, 0, 10), (4, 5, 0)):
        got, r = run(iters, 1e-5)
        want, wr = icp.icp_track_levels_twin(inp["start"], *twin, iters,
                                             1e-5)
        torch.testing.assert_close(got.pose, want.pose, rtol=0, atol=1e-4)
        assert int(got.iteration) == int(want.iteration)
        if iters[0] == 0:
            assert not bool(r.any()) and int(got.iteration) == 0
        else:
            assert float((r != wr).float().mean()) <= 1e-3


@pytest.mark.gpu
def test_icp_track_levels_is_deterministic(cuda):
    """Two launches on the same operands give the same bits: the carry, the
    status image and the sums (a fixed grid, fixed pixels a CTA, the
    partials summed in a fixed order)."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    args = _levels_args(inp, 2)
    runs = []
    for _ in range(2):
        sums = torch.zeros(icp.N_SUMS, device=cuda)
        st, res = icp.icp_track_levels(inp["start"], *args, (10, 5, 4), 1e-5,
                                       sums=sums, robust="tukey",
                                       robust_delta=0.02)
        runs.append((*st, res, sums))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the CTAs owning the decimated 160x120 level's pixels, all resident
    assert icp.levels_launch(cuda, args[0], (10, 5, 4)) == 75
    assert icp.levels_grid(cuda) >= torch.cuda.get_device_properties(
        cuda).multi_processor_count


@pytest.mark.gpu
def test_icp_track_levels_rejects_what_it_does_not_take(cuda):
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    levels, rv, rn, rpose, k = _levels_args(inp, 2)
    run = lambda lv=levels, r=rv, it=(10, 5, 4), rp=rpose, kk=k, **kw: \
        icp.icp_track_levels(inp["start"], lv, r, rn, rp, kk, it, 1e-5, **kw)
    swap = lambda l, pair: [pair if i == l else p
                            for i, p in enumerate(levels)]
    with pytest.raises(ValueError):                # a CPU reference map
        run(r=rv.cpu())
    with pytest.raises(ValueError):                # not float32
        run(lv=swap(1, (levels[1][0].double(), levels[1][1].double())))
    with pytest.raises(ValueError):                # normals' shape differs
        run(lv=swap(2, (levels[2][0], levels[2][1][:, :-1])))
    wide = torch.zeros(60, 80, 6, device=cuda)
    with pytest.raises(ValueError):                # last dim not contiguous
        run(lv=swap(2, (wide[..., ::2], wide[..., ::2])))
    with pytest.raises(ValueError):                # gate not a bool
        run(symmetric=torch.tensor(1.0, device=cuda))
    with pytest.raises(ValueError):                # an iteration missing
        run(it=(10, 5))
    with pytest.raises(ValueError):                # more levels than it takes
        run(lv=levels * 3, it=(1,) * 9)
    with pytest.raises(ValueError):                # sums not float32
        run(sums=torch.zeros(icp.N_SUMS, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):                # a raycast pose on the CPU
        run(rp=rpose.cpu())
    with pytest.raises(ValueError):                # not the 4 intrinsics
        run(kk=torch.zeros(3, device=cuda))
    with pytest.raises(ValueError):                # a view of another shape
        run(view=torch.zeros(3, 4, device=cuda))


@pytest.mark.gpu
def test_one_device_track_launches_levels_once(cuda):
    """``track`` on one device: one launch of ``icp_track_levels``, none of
    the pair, whatever the knobs."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    args = (inp["start"], inp["depths"], inp["vertices"], inp["normals"],
            inp["ref_v"], inp["ref_n"], inp["rpose"], inp["k"])
    for kn in (dict(), dict(symmetric=torch.tensor(True, device=cuda),
                            robust="huber", assoc="bilinear")):
        before = dict(icp.LAUNCHES)
        _, ok, res = tracking.track(*args, (10, 5, 4), 1e-5,
                                    finest_decimate=2, **kn)
        assert {k: icp.LAUNCHES[k] - n for k, n in before.items()} == dict(
            icp_track_levels=1, icp_track_reduce=0, icp_update=0)
        assert bool(ok) and tuple(res.shape) == (240, 320)


def _solve_systems(kind, inp, dev):
    """(sums [n, 29], poses [n, 4, 4]) of one kind of system for the warp
    solve: random SPD normal equations (large and small twists), bad
    pivots (singular, zero, negative and tiny diagonals), non-finite
    entries, or the sums of the headline frame's trips."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    rng = np.random.default_rng({"spd": 1, "bad_pivots": 2,
                                 "non_finite": 3, "trips": 4}[kind])
    poses = []
    sums = []

    def pose():
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rotation(rng.normal(size=3))
        T[:3, 3] = rng.normal(size=3)
        return T

    def pack(e2, jte, jtj, count):
        return icp.pack_sums(torch.tensor(e2, dtype=torch.float32),
                             torch.from_numpy(np.float32(jte)),
                             torch.from_numpy(np.float32(jtj)),
                             torch.tensor(count, dtype=torch.float32))

    if kind == "spd":
        for i in range(512):
            J = rng.normal(size=(64, 6)) * rng.uniform(0.01, 10, size=6)
            jtj = J.T @ J
            x = rng.normal(size=6) * 10.0 ** rng.uniform(-9, 0)
            sums.append(pack(rng.uniform(0, 1), jtj @ x, jtj, 64.0))
            poses.append(pose())
    elif kind == "bad_pivots":
        for i in range(256):
            J = rng.normal(size=(64, 6))
            jtj = J.T @ J
            m = i % 4
            if m == 0:                     # singular: a repeated column
                J[:, 5] = J[:, 2]
                jtj = J.T @ J
            elif m == 1:
                jtj = np.zeros((6, 6))
            elif m == 2:                   # a negative diagonal
                jtj[i % 6, i % 6] = -1.0
            else:                          # a tiny pivot
                jtj[i % 6] *= 1e-30
                jtj[:, i % 6] *= 1e-30
            sums.append(pack(1.0, rng.normal(size=6), jtj, 64.0))
            poses.append(pose())
    elif kind == "non_finite":
        bad = (np.nan, np.inf, -np.inf, 3e38)
        for i in range(256):
            J = rng.normal(size=(64, 6))
            jtj, jte = J.T @ J, rng.normal(size=6)
            if i % 2:
                jtj[i % 6, (i // 6) % 6] = bad[i % 4]
            else:
                jte[i % 6] = bad[i % 4]
            sums.append(pack(1.0, jte, jtj, 64.0))
            poses.append(pose())
    else:
        # every trip of the headline frame, at each level alone and the
        # pyramid, each trip's sums as the kernel summed them
        args = _levels_args(inp, 2)
        for iters in ([(n, 0, 0) for n in range(1, 11)]
                      + [(0, n, 0) for n in range(1, 6)]
                      + [(0, 0, n) for n in range(1, 5)]):
            s = torch.zeros(icp.N_SUMS, device=dev)
            st, _ = icp.icp_track_levels(inp["start"], *args, iters, 0.0,
                                         sums=s)
            sums.append(s.cpu())
            poses.append(st.pose.cpu().numpy())
    return (torch.stack(sums).to(dev).contiguous(),
            torch.from_numpy(np.stack(poses).astype(np.float32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["spd", "bad_pivots", "non_finite",
                                  "trips"])
def test_icp_warp_solve_matches_solve_step(cuda, kind):
    """The warp solve of ``icp_track_levels`` (the Cholesky's columns, sinf
    and cosf, E's entries and the pose product on separate lanes) equals
    ``solve_step`` (one thread, ``icp_update``'s) bit for bit: the new
    pose, the twist and the exit test, at a threshold that stops nothing
    and one that stops every finite twist."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    sums, poses = _solve_systems(kind, _icp_inputs(cuda), cuda)
    bits = lambda t: t.contiguous().view(torch.int32)
    for thr in (0.0, 1e-5, 1e3):
        warp, one = icp.solve_check(sums, poses, thr)
        for a, b in zip(warp[:2], one[:2]):
            assert torch.equal(bits(a), bits(b)), (kind, thr)
        assert torch.equal(warp[2], one[2])
    if kind == "bad_pivots":
        # a zero, negative or underflowing pivot: a zero twist, the pose
        # unchanged (a singular system rounds to a positive pivot)
        caught = torch.arange(len(poses), device=cuda) % 4 != 0
        assert torch.equal(bits(one[0][caught]), bits(poses[caught]))
        assert not bool(one[1][caught].any())
    if kind == "spd":
        assert bool(torch.isfinite(one[1]).all())
        assert float(one[1].abs().max()) > 0.1


def _card_views(poses, k, dev):
    """The card's ``camera_matrix(k) @ inv(pose)`` of each pose and the
    view ``icp_track_levels`` forms inside its launch."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.ops import icp_kernel as icp
    from supereight_tpu_torch.pipeline import camera
    z = torch.zeros((1, 1, 3), device=dev)
    want, got = [], []
    for p in poses:
        rp = torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(dev)
        want.append(camera.camera_matrix(k) @ numerics.inv(rp))
        view = torch.empty((4, 4), device=dev)
        icp.icp_track_levels(torch.eye(4, device=dev), [(z, z)], z, z, rp, k,
                             (0,), 0.0, view=view)
        got.append(view)
    return torch.stack(got), torch.stack(want)


@pytest.mark.gpu
def test_icp_track_levels_forms_the_cards_view(cuda):
    """The view formed inside the launch (lu_inverse.cuh's inverse, then
    K's products added in order) equals the card's ``camera_matrix(k) @
    inv(raycast_pose)`` (``pose_inv`` and PyTorch's product) bit for bit:
    every pose of the cached sequences at the smoke's intrinsics and at
    half of them, and a fuzz of rigid poses, axis-aligned rotations (exact
    and signed zeros) and intrinsics."""
    import glob
    rng = np.random.default_rng(7)
    seqs = sorted(glob.glob(os.path.join(os.path.dirname(BENCH),
                                         "synthetic_256_frames*.npz")))
    poses = np.concatenate([np.load(f)["poses"] for f in seqs])
    fuzz = []
    for i in range(600):
        T = np.eye(4)
        if i % 3:
            T[:3, :3] = _rotation(rng.normal(size=3))
        else:
            perm = rng.permutation(3)
            for r in range(3):
                T[r, :3] = 0.0
                T[r, perm[r]] = rng.choice((-1.0, 1.0))
        T[:3, 3] = rng.normal(size=3) * (3 if i % 2 else 0)
        fuzz.append(T)
    ks = [np.array([240.6, 240.0, 160.0, 120.0], np.float32)]
    ks.append(ks[0] / 2)
    ks += [rng.uniform(50, 700, size=4).astype(np.float32) for _ in range(4)]
    for i, k in enumerate(ks):
        kt = torch.from_numpy(k).to(cuda)
        got, want = _card_views(poses if i < 2 else fuzz[i::4], kt, cuda)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k
    got, want = _card_views(fuzz, torch.from_numpy(ks[0]).to(cuda), cuda)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_icp_track_levels_refuses_what_it_cannot_schedule(cuda, monkeypatch):
    """A cooperative grid of more CTAs than the card holds at once (the
    whole 320x240 level's 300 CTAs where the card is said to hold more) is
    refused by the launch: the wrapper raises, counts no launch and gives
    no twin's result; at the card's own limit the same levels run."""
    from supereight_tpu_torch.ops import icp_kernel as icp
    inp = _icp_inputs(cuda)
    args = _levels_args(inp, 1)
    n = icp.levels_grid(cuda)
    assert icp.levels_launch(cuda, args[0], (1, 1, 1)) == min(n, 300)
    monkeypatch.setitem(icp._GRID, torch.cuda.current_device(), 4 * n)
    assert icp.levels_launch(cuda, args[0], (1, 1, 1)) == 300 > n
    before = dict(icp.LAUNCHES)
    with pytest.raises(RuntimeError, match="launch failed"):
        icp.icp_track_levels(inp["start"], *args, (1, 1, 1), 1e-5)
    assert icp.LAUNCHES == before
    monkeypatch.undo()
    st, _ = icp.icp_track_levels(inp["start"], *args, (1, 1, 1), 1e-5)
    assert int(st.iteration) == 1 and icp.LAUNCHES["icp_track_levels"] == \
        before["icp_track_levels"] + 1


@pytest.mark.gpu
def test_icp_track_levels_in_a_cuda_graph(cuda):
    """``track_levels`` captured into a CUDA graph (the cooperative launch
    and its exchange's words): each replay equals an eager launch on the
    same operands bit for bit (the carry and the status image), three
    times in a row, with eager launches on the same stream between them."""
    from supereight_tpu_torch.pipeline import tracking
    inp = _icp_inputs(cuda)
    args = (inp["start"], inp["vertices"], inp["normals"], inp["ref_v"],
            inp["ref_n"], inp["rpose"], inp["k"], (10, 5, 4), 1e-5)
    eager = tracking.track_levels(*args, finest_decimate=2)[:2]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tracking.track_levels(*args, finest_decimate=2)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tracking.track_levels(*args, finest_decimate=2)[:2]
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        for a, b in zip((*out[0], out[1]), (*eager[0], eager[1])):
            assert torch.equal(a, b)
        again = tracking.track_levels(*args, finest_decimate=2)[:2]
        for a, b in zip((*again[0], again[1]), (*eager[0], eager[1])):
            assert torch.equal(a, b)


# ----------------------------------------------------------------------
# the frame's glue on the card: the pyramid (build_pyramid), the 4x4
# inverse (pose_inv), the frustum selection (frustum_select) and the node
# pyramid's update (update_nodes), each bit for bit with its twin
# ----------------------------------------------------------------------

SEQUENCES = ("synthetic_256_frames", "synthetic_256_frames_trans",
             "synthetic_256_frames_noisy")


def _same_bits(a, b):
    """float32 tensors equal bit for bit (NaN where NaN)."""
    a, b = a.contiguous(), b.contiguous()
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    bad = a.view(torch.int32) != b.to(a.device).view(torch.int32)
    bad &= ~(torch.isnan(a) & torch.isnan(b.to(a.device)))
    assert not bool(bad.any()), f"{int(bad.sum())} of {a.numel()} differ"


def _pyramid_case(ratio, odd=False):
    """A cached frame's depth at 320x240 / ratio and its intrinsics, or a
    61x83 random depth with holes."""
    if odd:
        import chip_smoke
        return tuple(map(torch.from_numpy, chip_smoke.random_depth()))
    from supereight_tpu_torch.pipeline import preprocessing
    z = np.load(BENCH)
    d = preprocessing.mm_to_meters(
        torch.from_numpy(z["depths"][40].astype(np.int32)),
        (240 // ratio, 320 // ratio))
    return d, torch.tensor([240.6, 240.0, 160.0, 120.0]) / ratio


@pytest.mark.gpu
@pytest.mark.parametrize("levels", ["1", "3", "largest"])
@pytest.mark.parametrize("neg_y", [False, True])
@pytest.mark.parametrize("case", ["320x240", "160x120", "61x83"])
def test_pyramid_kernel_matches_twin(cuda, neg_y, case, levels):
    """``build_pyramid`` on the card at 1, 3 (the presets') and its
    largest level count: one launch a call, every level's depth, vertices
    and normals bit for bit with the twin on the card and on the CPU."""
    from supereight_tpu_torch.ops import pyramid_kernel
    from supereight_tpu_torch.pipeline import preprocessing
    n = pyramid_kernel.MAX_LEVELS if levels == "largest" else int(levels)
    d, k = _pyramid_case({"320x240": 1, "160x120": 2}.get(case, 1),
                         odd=case == "61x83")
    before = pyramid_kernel.LAUNCHES["build_pyramid"]
    got = preprocessing.build_pyramid(d.to(cuda), k.to(cuda), n, neg_y)
    torch.cuda.synchronize()
    assert pyramid_kernel.LAUNCHES["build_pyramid"] == before + 1
    on_card = preprocessing.build_pyramid_twin(d.to(cuda), k.to(cuda), n,
                                               neg_y)
    on_cpu = preprocessing.build_pyramid(d, k, n, neg_y)
    for g, w, c in zip(got, on_card, on_cpu):
        assert len(g) == n
        for a, b, h in zip(g, w, c):
            _same_bits(a, b)
            _same_bits(a, h)
    assert bool((got[2][0][..., 0] != -2.0).any())


@pytest.mark.gpu
def test_pyramid_kernel_raises_above_its_levels(cuda):
    """Above its largest level count ``build_pyramid`` raises on the card
    and launches nothing (no per-level fallback)."""
    from supereight_tpu_torch.ops import pyramid_kernel
    from supereight_tpu_torch.pipeline import preprocessing
    d, k = _pyramid_case(1)
    before = pyramid_kernel.LAUNCHES["build_pyramid"]
    with pytest.raises(ValueError, match="levels"):
        preprocessing.build_pyramid(d.to(cuda), k.to(cuda),
                                    pyramid_kernel.MAX_LEVELS + 1, False)
    assert pyramid_kernel.LAUNCHES["build_pyramid"] == before


@pytest.mark.gpu
def test_pose_inv_matches_twin(cuda):
    """``numerics.inv`` on the card (``pose_inv``) on every pose of the
    three cached sequences, on K, on random 4x4 matrices and on the
    ``chip_smoke.pivot_matrices`` of 1, 2 and 4 rows (every pivot pattern:
    the 24 row orders of a 4x4; zero, NaN, subnormal, infinite and huge
    pivots; subnormal products and entries; singular matrices):
    the host twin's bits, one launch a call.  At 3, 5 and 8 rows (random
    matrices and every other size of ``pivot_matrices``), where the twin
    is not XLA's inverse, it raises without a launch."""
    import chip_smoke
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.ops import numerics_kernel
    from supereight_tpu_torch.pipeline import camera
    mats = [camera.camera_matrix(torch.tensor([240.6, 240.0, 160.0, 120.0]))]
    for seq in SEQUENCES:
        mats += list(torch.from_numpy(np.load(os.path.join(
            os.path.dirname(BENCH), seq + ".npz"))["poses"]))
    rng = np.random.default_rng(3)
    random = [torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
              for n in (3, 4, 4, 5, 8)]
    pivots = [torch.from_numpy(m)
              for m in chip_smoke.pivot_matrices().values()]
    held = [m for m in random + pivots if m.shape[0] in numerics.INV_SIZES]
    refused = [m for m in random + pivots
               if m.shape[0] not in numerics.INV_SIZES]
    assert {m.shape[0] for m in refused} >= {3, 5, 8}
    mats += held
    before = numerics_kernel.LAUNCHES["pose_inv"]
    got = [numerics.inv(m.to(cuda)) for m in mats]
    torch.cuda.synchronize()
    assert numerics_kernel.LAUNCHES["pose_inv"] == before + len(mats)
    for g, m in zip(got, mats):
        assert g.device.type == "cuda"
        _same_bits(g.cpu(), numerics.inv_twin(m))
    before = numerics_kernel.LAUNCHES["pose_inv"]
    for m in refused:
        with pytest.raises(ValueError, match="rows"):
            numerics.inv(m.to(cuda))
    assert numerics_kernel.LAUNCHES["pose_inv"] == before


@pytest.mark.gpu
def test_pose_inv_in_registers(cuda):
    """``pose_inv``'s n = 4 kernel as built: no stack frame, no spills
    (``-Xptxas -v``) and no local loads or stores in its SASS."""
    import chip_smoke
    p = chip_smoke.inverse_registers()
    assert p["stack"] == p["spill_stores"] == p["spill_loads"] == 0


def _select_map(cuda, partitions=1):
    c = _case(240, 320, 11)
    m = _map(c, "fuse_sdf", cuda)
    if partitions > 1:
        m = m.replace(partitions=2, part_counts=torch.tensor(
            [200, 150], dtype=torch.int32, device=cuda))
    m = m.replace(overflow=torch.tensor(5, dtype=torch.int32, device=cuda))
    return c, m


def _select_holds(m, pose, K, budget, hw=(240, 320)):
    """``frustum_select`` on the card at ``budget``: one launch and no
    ``pose_inv``; slots, overflow and ``T_cw`` equal to the twin's on the
    card and on the CPU, ``T_cw`` to ``pose_inv``'s bit for bit; the
    look-back's status words and tickets zero after the launch.  Returns
    (slots, overflow)."""
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.ops import look_back, numerics_kernel
    before = ik.LAUNCHES["frustum_select"]
    inv_before = numerics_kernel.LAUNCHES["pose_inv"]
    slots, ovf, T_cw = ik.frustum_select(m, pose, K, hw, budget)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["frustum_select"] == before + 1
    assert numerics_kernel.LAUNCHES["pose_inv"] == inv_before
    sc = look_back.scratch(m.device)
    assert not bool(sc.status.any()) and not bool(sc.ctl.any())
    _same_bits(T_cw, numerics.inv(pose))
    mc = _to(m, "cpu")
    for w_slots, w_ovf, w_T in (
            ik.frustum_select_twin(m, pose, K, hw, budget),
            ik.frustum_select(mc, pose.cpu(), K.cpu(), hw, budget)):
        assert torch.equal(slots.cpu(), w_slots.cpu())
        assert int(ovf) == int(w_ovf)
        _same_bits(T_cw, w_T)
    return slots, ovf


@pytest.mark.gpu
@pytest.mark.parametrize("partitions", [1, 2])
def test_frustum_select_matches_twin(cuda, partitions):
    """``frustum_select`` on the card at budgets below, near and above the
    candidates' count: slots (-1 past the count), overflow and ``T_cw``
    equal to the twin's on the card and on the CPU (``T_cw`` also
    ``pose_inv``'s); one launch a call and no ``pose_inv``; its scratch
    zero after each."""
    c, m = _select_map(cuda, partitions)
    _, _, K = _frame(c, cuda)
    pose = torch.from_numpy(c["pose"]).to(cuda)
    T_cw = ik.frustum_select(m, pose, K, (240, 320), 1)[2]
    cand = int(ik.frustum_candidates(m, T_cw, K, (240, 320)).sum())
    assert cand > 10
    for budget in (cand // 3, cand, cand + 7, m.capacity - 1):
        slots, ovf = _select_holds(m, pose, K, budget)
        assert int(ovf) == 5 + max(cand - budget, 0)
        assert int((slots >= 0).sum()) == min(cand, budget)


#: the selection's capacities (1, 6, 24 and 192 tiles): the map size and
#: capacity of a 1024-slot table, the 256^3 presets', demo512-ofusion's
#: and 1024-quality's
SELECT_CAPACITIES = ((256, 1024), (256, 6144), (512, 24576), (1024, 196608))


@pytest.mark.gpu
@pytest.mark.parametrize("size,capacity", SELECT_CAPACITIES)
def test_frustum_select_at_capacities(cuda, size, capacity):
    """The one-launch selection on a map of the headline's frame 30's
    blocks (``chip_smoke.select_map``) at each capacity of
    SELECT_CAPACITIES: at budgets below and above the candidates' count
    and above the capacity (tile 0's share of the fill runs past the
    table), and with no candidates (every slot inactive), as
    :func:`_select_holds` holds it."""
    import chip_smoke
    from supereight_tpu_torch.pipeline import camera, preprocessing
    z = np.load(BENCH)
    depth = preprocessing.mm_to_meters(
        torch.from_numpy(z["depths"][30].astype(np.int32)).to(cuda),
        (240, 320))
    pose = torch.from_numpy(z["poses"][30].astype(np.float32)).to(cuda)
    K = camera.camera_matrix(torch.from_numpy(chip_smoke.K).to(cuda))
    m = chip_smoke.select_map(torch, size, capacity, cuda, depth, pose, K)
    T_cw = ik.frustum_select(m, pose, K, (240, 320), 1)[2]
    cand = int(ik.frustum_candidates(m, T_cw, K, (240, 320)).sum())
    assert cand > 100
    for budget in (cand // 3, cand + 7, capacity + 5):
        _, ovf = _select_holds(m, pose, K, budget)
        assert int(ovf) == int(m.overflow) + max(cand - budget, 0)
    none = m.replace(active=torch.zeros_like(m.active))
    slots, ovf = _select_holds(none, pose, K, 64)
    assert bool((slots == -1).all()) and int(ovf) == int(m.overflow)


@pytest.mark.gpu
def test_select_and_trip_kernels_in_registers(cuda):
    """The one-launch selection and the sharded ICP trip as built: no more stack frame and spill stores than
    ``chip_smoke.LOOK_BACK_AND_TRIP`` names (``-Xptxas -v``,
    ``chip_smoke.select_trip_registers``; none for the selection)."""
    import chip_smoke
    props = chip_smoke.select_trip_registers()
    for names in chip_smoke.LOOK_BACK_AND_TRIP.values():
        for name, (stack, spills) in names.items():
            p = props[name]
            assert p["stack"] <= stack and p["spill_stores"] <= spills
    p = props["frustum_select"]
    assert p["stack"] == p["spill_stores"] == p["spill_loads"] == 0


def _node_map(cuda, size, field, seed):
    """A ``size``^3 map whose node levels hold random values, half of
    their cells allocated."""
    rng = np.random.default_rng(seed)
    m = octree.init(size, 4.8, field.channels, cuda, capacity=64)
    lo, hi = (-1.0, 1.0) if field.name == "sdf" else (-20.0, 20.0)
    values, alloc = list(m.node_values), list(m.node_alloc)
    for level in range(1, m.block_level + 1):
        s = (1 << level,) * 3
        a = rng.uniform(lo, hi, s).astype(np.float32)
        b = (rng.integers(0, 12, s) if field.name == "sdf"
             else rng.uniform(0, 2.5, s)).astype(np.float32)
        values[level] = {n: torch.from_numpy(v).to(cuda) for n, v in
                         zip((ch.name for ch in field.channels), (a, b))}
        alloc[level] = torch.from_numpy(rng.random(s) < 0.5).to(cuda)
    return m.replace(node_values=values, node_alloc=alloc)


def _fusion_operands(launch, m, T_cw, K):
    """The table and slots a merged fusion launch takes: ``budget`` the
    frustum selection's 3072 slots, ``whole`` every live slot, ``sharded``
    rank 0 of 2's slot range as ``frame_dist.local_map`` gives the fusion
    (its rows, keys and active flags, its live count as n_blocks, and the
    whole map's node tables)."""
    if launch == "budget":
        from supereight_tpu_torch.core import numerics
        return m, ik.frustum_select(m, numerics.inv(T_cw), K, (240, 320),
                                    3072)[0]
    if launch == "whole":
        return m, None
    cap = m.capacity // 2
    return m.replace(capacity=cap, keys=m.keys[:cap], active=m.active[:cap],
                     n_blocks=m.n_blocks.clamp(max=cap),
                     voxels={n: v[:cap] for n, v in m.voxels.items()}), None


@pytest.mark.gpu
@pytest.mark.parametrize("launch", ["alone", "budget", "whole", "sharded"])
@pytest.mark.parametrize("size", [256, 1024])
@pytest.mark.parametrize("field_name", ["sdf", "ofusion"])
def test_update_nodes_matches_twin(cuda, size, field_name, launch):
    """The node pyramid's update on the card on random node tables and a
    cached frame, every level's new tables bit for bit with
    ``update_nodes_twin``'s on the card, the map's own node tables
    untouched: ``alone``, ``update_nodes`` (the fusion kernel's launch with
    no rows); else inside the fusion's launch (``nodes=True``) on a map of
    the frame's blocks (``chip_smoke.fusion_map``) on the budget branch,
    the whole-table branch and a rank's slot range of the sharded frame,
    against ``fuse_*_twin`` followed by ``update_nodes_twin`` (the tables
    and ``active`` as the fusion's own tests hold them), one launch
    counted once under each name."""
    import chip_smoke
    from supereight_tpu_torch.core import numerics
    from supereight_tpu_torch.pipeline import camera, preprocessing
    field = SDFField(mu=0.1) if field_name == "sdf" else \
        OFusionField(mu=0.008, voxel_size=4.8 / size)
    z = np.load(BENCH)
    depth = preprocessing.mm_to_meters(torch.from_numpy(
        z["depths"][30].astype(np.int32)), (240, 320)).to(cuda)
    pose = torch.from_numpy(z["poses"][30]).to(cuda)
    T_cw = numerics.inv(pose)
    K = camera.camera_matrix(torch.tensor(
        [240.6, 240.0, 160.0, 120.0], device=cuda)).contiguous()
    kernel = "fuse_sdf" if field_name == "sdf" else "fuse_ofusion"
    params = (field.mu, field.max_weight) if field_name == "sdf" else \
        (field.mu, field.sigma_lo, NOW)
    if launch == "alone":
        m = _node_map(cuda, size, field, size)
    else:
        m, slots = _fusion_operands(launch, chip_smoke.fusion_map(
            torch, size, field, cuda, size, depth, pose, K), T_cw, K)
        km, tm = chip_smoke.clone_tables(m), chip_smoke.clone_tables(m)
    kept = [{n: v.clone() for n, v in d.items()} for d in m.node_values]
    before = dict(ik.LAUNCHES)
    if launch == "alone":
        got = ik.update_nodes(m, field, depth, T_cw, K, NOW)
    else:
        got = getattr(ik, kernel)(km, depth, T_cw, K, *params, slots=slots,
                                  nodes=True)
    torch.cuda.synchronize()
    ran = {n: ik.LAUNCHES[n] - before[n] for n in before}
    want_ran = dict(fuse_sdf=0, fuse_ofusion=0, frustum_select=0,
                    update_nodes=1)
    want_ran[kernel] = int(launch != "alone")
    assert ran == want_ran
    if launch != "alone":
        getattr(ik, kernel + "_twin")(tm, depth, T_cw, K, *params,
                                      slots=slots)
        assert torch.equal(km.active, tm.active)
        assert bool(tm.active.any())
        a, b = (ik.SDF_CHANNELS if field_name == "sdf"
                else ik.OFUSION_CHANNELS)
        if field_name == "sdf":
            _same_bits(km.voxels[a], tm.voxels[a])
        else:
            torch.testing.assert_close(km.voxels[a], tm.voxels[a],
                                       rtol=1e-5, atol=1e-6)
        _same_bits(km.voxels[b], tm.voxels[b])
        assert int((tm.voxels[b] != m.voxels[b]).sum()) > 100
    want = ik.update_nodes_twin(m, field, depth, T_cw, K,
                                NOW if field_name == "ofusion" else 0.0)
    changed = 0
    for level in range(m.block_level + 1):
        for n in want[level]:
            _same_bits(got[level][n], want[level][n])
            assert torch.equal(m.node_values[level][n], kept[level][n])
            changed += int((want[level][n] != kept[level][n]).sum())
    assert changed > 100


def _warm_headline(cuda, frames):
    from supereight_tpu_torch.config import SlamConfig, apply_preset
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    cfg = apply_preset("headline", SlamConfig(
        volume_resolution=(256,) * 3, volume_size=(4.8,) * 3,
        block_capacity=6144))
    z = np.load(BENCH)
    slam = DenseSLAMSystem((240, 320), cfg, cuda)
    slam.setPose(z["poses"][0])
    k = (240.6, 240.0, 160.0, 120.0)
    for f in range(frames):
        slam.step(z["depths"][f], k, f)
    return slam, z["depths"][frames], k


@pytest.mark.gpu
def test_glue_reads_nothing_back(cuda):
    """At ``headline`` frame 7 (no allocation): the tracking stage up to
    the ``tracked`` read (the pyramid, the view, ICP and the divergence
    test) and ``integration.integrate`` run under
    ``torch.cuda.set_sync_debug_mode("error")``, each kernel launched once;
    the fused map equals the same ``integrate`` on CPU copies (the twins)
    bit for bit."""
    from supereight_tpu_torch.ops import icp_kernel, numerics_kernel
    from supereight_tpu_torch.ops import pyramid_kernel
    from supereight_tpu_torch.pipeline import (camera, integration,
                                               preprocessing, system,
                                               tracking)
    slam, depth_mm, k = _warm_headline(cuda, 7)
    cfg, field = slam.config, slam.field
    kd, neg_y = slam._k(k)
    st = system.preprocessing_stage(slam.state, slam._depth(depth_mm), cfg)
    counts = (ik.LAUNCHES, icp_kernel.LAUNCHES, pyramid_kernel.LAUNCHES,
              numerics_kernel.LAUNCHES)
    before = [dict(c) for c in counts]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        depths, vertices, normals = preprocessing.build_pyramid(
            st.scaled_depth, kd, len(cfg.pyramid), neg_y)
        pose, ok, _ = tracking.track(
            st.pose, depths, vertices, normals, st.ref_vertex, st.ref_normal,
            st.raycast_pose, kd, cfg.pyramid, cfg.icp_threshold,
            finest_decimate=cfg.icp_finest_decimate)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(ok)
    K = camera.camera_matrix(kd)
    depth = st.float_depth
    kept = _to(st.map, "cpu")
    timestamp = float(np.float32(1.0 / 30.0) * np.float32(7))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = integration.integrate(st.map, field, depth, pose, K, timestamp,
                                  budget=cfg.integrate_budget)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    delta = {k: n - b.get(k, 0) for c, b in zip(counts, before)
             for k, n in c.items()}
    # no inverse: the tracking view's is inside icp_track_levels' launch,
    # the fusion's inside the selection's
    assert delta == dict(fuse_sdf=1, fuse_ofusion=0, frustum_select=1,
                         update_nodes=1, icp_track_reduce=0, icp_update=0,
                         icp_track_levels=1, build_pyramid=1, pose_inv=0)
    want = integration.integrate(kept, field, depth.cpu(), pose.cpu(),
                                 K.cpu(), timestamp,
                                 budget=cfg.integrate_budget)
    assert int(m.overflow) == int(want.overflow)
    for n in m.voxels:
        _same_bits(m.voxels[n], want.voxels[n])
    assert torch.equal(m.active.cpu(), want.active)
    for a, b in zip(m.node_values, want.node_values):
        for n in a:
            _same_bits(a[n], b[n])


@pytest.mark.gpu
def test_every_sync_is_a_named_read(cuda, monkeypatch):
    """Frames 0-8 of a small SDF configuration (frames that allocate,
    fuse, raycast and render) through ``step`` and the renders, then
    frames 9-10 through the per-stage calls, under
    ``torch.cuda.set_sync_debug_mode("error")``: every synchronisation
    falls inside a named host read (``Stats.host_read``, wrapped here to
    lower the mode to "default" inside it), the reads of each site as
    many as the path makes."""
    from contextlib import contextmanager
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    from supereight_tpu_torch.utils.perfstats import Stats
    named = Stats.host_read
    sites = []

    @contextmanager
    def lowered(site):
        sites.append(site)
        torch.cuda.set_sync_debug_mode("default")
        try:
            with named(site):
                yield
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(Stats, "host_read", lowered)
    z = np.load(BENCH)
    cfg = SlamConfig(volume_size=(4.8,) * 3, volume_resolution=(128,) * 3,
                     block_capacity=2048)
    slam = DenseSLAMSystem((240, 320), cfg, cuda)
    slam.setPose(z["poses"][0])
    k = (240.6, 240.0, 160.0, 120.0)
    torch.cuda.synchronize()
    sites.clear()
    fused = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in range(9):
            fused += slam.step(z["depths"][f], k, f).integrated
            slam.renderDepth(), slam.renderTrack(), slam.renderVolume()
        for f in (9, 10):
            slam.preprocessing(z["depths"][f])
            slam.tracking(k, f)
            fused += slam.integration(k, f)
            slam.raycasting(k, f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert slam.state.tracked and int(slam.state.map.n_blocks) > 0
    # the fused-multiply-add probe reads once a process
    counts = {s: sites.count(s) for s in set(sites) if s != "fma_probe"}
    # a step uploads its depth and intrinsics, each per-stage call its
    # intrinsics; tracking reads its flag; the renders copy their colours;
    # each march (on every fusing frame here) scatters two host scalars
    assert fused >= 6
    assert counts == dict(depth=11, intrinsics=9 + 2 * 3, tracked=11,
                          track_colors=9, light=9, ambient=9,
                          march_mask=fused, alloc_active=fused)


_RAYCAST_MAPS = {}
_RAYCAST_POSES = {}


def _raycast_map(cuda, preset):
    """The ``preset`` map at full size (256^3, capacity 6144, 320x240)
    after chip_smoke.RAYCAST_FRAMES frames, its view (held, or packed) and
    the view matrix of its pose; built once a preset."""
    import chip_smoke
    from supereight_tpu_torch.pipeline import camera, raycast
    if preset not in _RAYCAST_MAPS:
        z = np.load(BENCH)
        slam = chip_smoke.warm_map(chip_smoke.preset_config(preset),
                                   z["depths"], z["poses"], cuda,
                                   chip_smoke.RAYCAST_FRAMES)
        st = slam.state
        view = st.pose @ camera.inverse_camera_matrix(
            torch.from_numpy(chip_smoke.K).to(cuda))
        dense = {"F": st.view} if st.view is not None else \
            raycast.pack_view(st.map, slam.field)
        _RAYCAST_MAPS[preset] = (st.map, slam.field, view, dense)
        _RAYCAST_POSES[preset] = st.pose
    return _RAYCAST_MAPS[preset]


def _raycast_cases():
    import chip_smoke
    return [("headline", m) for m in chip_smoke.RAYCAST_MODES] + \
        [("ofusion", m) for m in chip_smoke.RAYCAST_OF_MODES]


@pytest.mark.gpu
@pytest.mark.parametrize("preset,mode", _raycast_cases())
def test_raycast_kernels_match_twins(cuda, preset, mode):
    """R1-R4 (csrc/raycast.cu) on the full-size headline and ofusion maps
    in every normals and refine mode of the presets and of phase F, the
    second window cut by a budget of 64, and rank 1's row strip of 2:
    each kernel equal to its twin on the card on the same operands, and
    the whole raycast to ``raycast_twin`` on the card and to ``raycast``
    on CPU copies, bit for bit; each kernel launched once a raycast
    (``chip_smoke.hold_raycast``)."""
    import chip_smoke
    m, field, view, dense = _raycast_map(cuda, preset)
    modes = chip_smoke.RAYCAST_MODES if preset == "headline" else \
        chip_smoke.RAYCAST_OF_MODES
    knobs = modes[mode]
    _, need2 = chip_smoke.hold_raycast(torch, f"{preset} {mode}", m, field,
                                       view, dense, knobs, cpu=True)
    if knobs.get("w2_budget") == chip_smoke.RAYCAST_BUDGET:
        assert need2 > chip_smoke.RAYCAST_BUDGET


@pytest.mark.gpu
def test_dot3_adds_alike_on_the_card(cuda):
    """``numerics.dot3`` (the hybrid correction's and the plane refine's
    dot products, added as R4 adds them) gives the CPU's bits on the card
    (``.sum(-1)`` of a ``[..., 3]`` tensor adds in the order of the
    device's reduction): values of mixed magnitude and signs, signed zeros
    among them."""
    from supereight_tpu_torch.core import numerics
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(240, 320, 3))
            * 10.0 ** rng.integers(-6, 7, (240, 320, 3)) for _ in range(2))
    a[::7, :, 1] = -0.0
    b[::5, ::3] = -0.0
    a, b = (torch.from_numpy(x.astype(np.float32)) for x in (a, b))
    want = numerics.dot3(a, b)
    _same_bits(numerics.dot3(a.to(cuda), b.to(cuda)), want)


@pytest.mark.gpu
def test_raycast_kernels_reject_what_they_do_not_take(cuda):
    """The wrappers raise for a CPU view, a view table of another dtype or
    shape, grids of another shape and a negative budget."""
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import raycast
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    m, field, view, dense = _raycast_map(cuda, "headline")
    with pytest.raises(ValueError):
        rk.splat_bounds(m, field, view.cpu(), 240, 320, NEAR_PLANE,
                        FAR_PLANE)
    plan = raycast.scan_plan(m, field, 240, 320, NEAR_PLANE, FAR_PLANE, 1.6,
                             1.0, False)
    tmin, tmax, g = rk.splat_bounds(m, field, view, 240, 320, NEAR_PLANE,
                                    FAR_PLANE)
    for bad in ({"F": dense["F"].to(torch.float16)},
                {"F": dense["F"][:-1]}):
        with pytest.raises(ValueError):
            rk.ray_scan(m, bad, field, view, plan, tmin, tmax, g)
    with pytest.raises(ValueError):
        rk.ray_scan(m, dense, field, view, plan, tmin[:-1], tmax, g)
    with pytest.raises(ValueError):
        rk.ray_scan(m, dense, field, view, plan, tmin, tmax, g, True, -1,
                    False)
    scan = raycast.ray_scan_twin(m, dense, field, view, plan, tmin, tmax, g)
    with pytest.raises(ValueError):
        rk.ray_refine_normals(m, dense, field, view, plan, scan.z, scan.hit,
                              "none", "hybrid")


@pytest.mark.gpu
def test_splat_bounds_one_launch_cleans_its_scratch(cuda):
    """R1 (one launch, its inverse inside it) twice in a row on the same
    operands and then on a 640x480 grid above kPoolSmemCells (the scratch
    pool), with and without near_rescue, each bit for bit with its twin;
    a launch a call and no ``pose_inv``; the encoded grid and its ticket
    are zero after every call."""
    import chip_smoke
    from supereight_tpu_torch.ops import numerics_kernel
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import raycast
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    m, field, view, _ = _raycast_map(cuda, "headline")
    for near_rescue in (True, False):
        # the twin inverts the view by pose_inv on the card: before the count
        want = raycast._splat_bounds_twin(m, field, view, 240, 320,
                                          NEAR_PLANE, FAR_PLANE, near_rescue)
        before = dict(rk.LAUNCHES)
        inv_before = numerics_kernel.LAUNCHES["pose_inv"]
        got = [rk.splat_bounds(m, field, view, 240, 320, NEAR_PLANE,
                               FAR_PLANE, near_rescue) for _ in range(2)]
        assert rk.LAUNCHES["splat_bounds"] == before["splat_bounds"] + 2
        assert numerics_kernel.LAUNCHES["pose_inv"] == inv_before
        for tmin, tmax, _ in got:
            _same_bits(tmin, want[0])
            _same_bits(tmax, want[1])
        assert not bool(rk.scratch(view.device).enc.any())
    assert chip_smoke.hold_splat_scratch(torch, "headline", m, field,
                                         _RAYCAST_POSES["headline"],
                                         cuda) == 0.0
    assert not bool(rk.scratch(view.device).enc.any())


@pytest.mark.gpu
def test_scan_ranks_across_tile_counts(cuda):
    """The merged scan (R2 with R3) against ``ray_scan_second_twin(
    ray_scan_twin(...))`` bit for bit while the tile count changes from
    call to call (75 at half resolution, 300 with ``full_res_scan``, 38 on
    rank 1's strip of 2), at budgets 0, 64, one that cuts a tile, the
    flagged rays' count and 8192, with and without the midsolve, and the
    scan alone against ``ray_scan_twin``: each launch leaves the
    look-back's status words and counters zero for the next."""
    from supereight_tpu_torch.ops import look_back
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import raycast
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    m, field, view, dense = _raycast_map(cuda, "headline")
    tmin, tmax, g = rk.splat_bounds(m, field, view, 240, 320, NEAR_PLANE,
                                    FAR_PLANE)
    plans = [raycast.scan_plan(m, field, 240, 320, NEAR_PLANE, FAR_PLANE,
                               1.6, 1.0, full, rows)
             for full, rows in ((False, None), (True, None),
                                (False, (120, 120)))]
    for _ in range(2):
        for plan in plans:
            grids = (m, dense, field, view, plan, tmin, tmax, g)
            first = raycast.ray_scan_twin(*grids)
            flagged = int(first.need2.sum())
            assert flagged > 0
            for budget in (0, 64, flagged // 2 + 3, flagged, 8192):
                for mid in (False, True):
                    want = raycast.ray_scan_second_twin(
                        m, dense, field, view, plan, first, True, budget,
                        mid)
                    got = rk.ray_scan(*grids, True, budget, mid)
                    assert torch.equal(got.hit, want.hit)
                    _same_bits(got.z, want.z)
                    sc = look_back.scratch(view.device)
                    assert not bool(sc.status.any() or sc.ctl.any())
            alone = rk.ray_scan(*grids)
            assert torch.equal(alone.hit, first.hit)
            _same_bits(alone.z, first.z)


@pytest.mark.gpu
def test_raycast_kernels_in_registers(cuda):
    """R1, the merged scan and R4 as built: no stack frame, no spills
    (``-Xptxas -v``, ``chip_smoke.raycast_registers``)."""
    import chip_smoke
    props = chip_smoke.raycast_registers()
    for name in ("splat_bounds", "ray_scan", "ray_refine_normals"):
        p = props[name]
        assert p["stack"] == p["spill_stores"] == p["spill_loads"] == 0


#: R4's image shapes (H, W) and a strip (r0, rows) of each: both widths off
#: R4's 32 x 4 tile, and 138 rows and the 70- and 66-row strips off its
#: height; grad_decim 2 divides the first's 70 x 98 scan grid (so its
#: height is a multiple of 4), 3 the second's 69 x 99 and its strip's
#: 36 x 99; each strip's r0 / 2 is odd
R4_SHAPES = {"140x196": ((140, 196), (70, 70)),
             "138x198": ((138, 198), (66, 72))}


@pytest.mark.gpu
@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("shape", sorted(R4_SHAPES))
@pytest.mark.parametrize("preset", ["headline", "ofusion"])
def test_refine_normals_kernel_in_every_mode(cuda, preset, shape, strip):
    """R4 (``raycast_kernel.ray_refine_normals``, 2-D tiles) against
    ``ray_refine_normals_twin`` on the same scan on the full-size headline
    and ofusion maps, in every re-solve x normals mode it takes (the
    secant and trilinear re-solves with no, volume and hybrid normals, the
    hybrid ones at grad_decim 1, 2 and 3; at full resolution no re-solve
    with no and volume normals), on an image whose width and height are
    not multiples of the tile and on a strip of it whose r0 / 2 is odd:
    vertex, normal, ray distance and hit bit for bit, one launch a call."""
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import camera
    from supereight_tpu_torch.pipeline import raycast as rc
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    m, field, _, dense = _raycast_map(cuda, preset)
    (H, W), rows = R4_SHAPES[shape]
    k = torch.tensor([150.0, 150.0, W / 2, H / 2], device=cuda)
    view = _RAYCAST_POSES[preset] @ camera.inverse_camera_matrix(k)
    tmin, tmax, g = rc._splat_bounds_twin(m, field, view, H, W, NEAR_PLANE,
                                          FAR_PLANE)
    modes = [(False, r, n, 1) for r in ("secant", "interp")
             for n in ("none", "volume")] \
        + [(False, r, "hybrid", gd) for r in ("secant", "interp")
           for gd in (1, 2, 3)] \
        + [(True, "none", n, 1) for n in ("none", "volume")]
    hits = 0
    for full, resolve, normals, gd in modes:
        plan = rc.scan_plan(m, field, H, W, NEAR_PLANE, FAR_PLANE, 1.0, 1.0,
                            full, rows if strip else None)
        assert plan.half_res != full
        scan = rc.ray_scan_twin(m, dense, field, view, plan, tmin, tmax, g)
        args = (m, dense, field, view, plan, scan.z, scan.hit, resolve,
                normals, gd)
        before = rk.LAUNCHES["ray_refine_normals"]
        got = rk.ray_refine_normals(*args)
        torch.cuda.synchronize()
        assert rk.LAUNCHES["ray_refine_normals"] == before + 1
        want = rc.ray_refine_normals_twin(*args)
        for a, b in zip(got, want):
            if b is None or b.dtype == torch.bool:
                assert a is b is None or torch.equal(a, b)
            else:
                _same_bits(a, b)
        hits += int(want.hit.sum())
    assert hits > 0.2 * len(modes) * W * (rows[1] if strip else H)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["quality", "ofusion"])
def test_raycasting_stage_reads_nothing_back(cuda, preset):
    """``raycasting_stage`` after 12 frames of ``quality`` (no held view:
    ``pack_view`` runs) and of ``ofusion`` (the held bf16 view, hybrid
    normals) under ``torch.cuda.set_sync_debug_mode("error")``: no host
    read; R1, the merged scan (counted as R2 and R3) and R4 launched once
    each, and no ``pose_inv``; the reference maps equal ``raycast_twin``'s
    on the card bit for bit."""
    import chip_smoke
    from supereight_tpu_torch.ops import numerics_kernel
    from supereight_tpu_torch.ops import raycast_kernel as rk
    from supereight_tpu_torch.pipeline import camera, raycast, system
    from supereight_tpu_torch.pipeline.constants import FAR_PLANE, NEAR_PLANE
    z = np.load(BENCH)
    cfg = chip_smoke.preset_config(preset)
    slam = chip_smoke.warm_map(cfg, z["depths"], z["poses"], cuda, 12)
    kd, neg_y = slam._k(chip_smoke.K)
    st = slam.state
    before = dict(rk.LAUNCHES)
    inv_before = numerics_kernel.LAUNCHES["pose_inv"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = system.raycasting_stage(st, kd, 12, cfg, slam.field, neg_y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: rk.LAUNCHES[k] - before[k] for k in before} == dict(
        splat_bounds=1, ray_scan=1, ray_scan_second=1, ray_refine_normals=1)
    assert numerics_kernel.LAUNCHES["pose_inv"] == inv_before
    want = raycast.raycast_twin(
        st.map, slam.field, st.pose @ camera.inverse_camera_matrix(kd), 240,
        320, NEAR_PLANE, FAR_PLANE,
        dense=None if st.view is None else {"F": st.view},
        **chip_smoke.raycast_knobs(cfg))
    _same_bits(out.ref_vertex, want.vertex)
    _same_bits(out.ref_normal, want.normal)
    assert float((want.vertex.abs().sum(-1) > 0).float().mean()) > 0.5
