"""Fusion kernels of the PyTorch port (`ops/integrate_kernel.py`).

(a) The plain twin ``fuse_sdf_reference`` against the JAX pipeline's
    ``integration.fuse_rows`` on the same rows: blocks off-frame, behind the
    camera, at every footprint level 0-3, and close enough that H >> lvl is
    below the patch side (negative patch origin).  ``visible`` must match
    bit for bit, tsdf/weight within 1e-5.
(b) The twin against the Pallas kernel K1 itself, run in interpret mode as
    tests/test_pallas_kernel.py runs it, with ``scal`` built from the
    fuse_rows formulas.  tsdf/weight within 2e-5 (K1's visibility flag is
    depth-gated, unlike the pipeline's, so it is not compared).
(c) The OFusion twin ``fuse_ofusion_reference`` against ``fuse_rows`` with
    the JAX ``OFusionField`` on the same rows: ``visible`` and timestamp bit
    for bit, occupancy within 1e-5 relative (1e-6 absolute where log-odds
    cancel toward 0; the logarithm rounds differently in the last bit).
(d) The in-place twins (``fuse_sdf_twin``, ``fuse_ofusion_twin``) on a
    map's table: listed slots take the row function's rows and visibility,
    every other slot (and, on the whole-table branch, every dead slot)
    keeps its voxels and ``active``; the SDF view rows equal
    ``encode_view_rows`` + ``index_copy_`` bit for bit.
The CUDA kernels themselves are held against the twins on the card by
tests/test_torch_gpu.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import camera as jcam
from supereight_tpu.pipeline import integration as jint
from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.ops import integrate_kernel as ik

from test_pallas_kernel import run_interpret
from torch_port_util import K_FULL

torch.set_num_threads(1)

VS = 0.0375          # voxel size (m): block 0.3 m, diagonal 0.52 m
MU = 0.1
PATCH = 16


def _case(H, W, seed, n=256):
    """Rows of blocks around a camera: camera-space samples from behind the
    camera to 4.5 m, inside and outside the frustum."""
    rng = np.random.default_rng(seed)
    k = K_FULL * (W / 320.0)
    twist = np.concatenate([rng.uniform(-0.1, 0.1, 3),
                            rng.uniform(-0.3, 0.3, 3)]).astype(np.float32)
    pose = np.array(jcam.se3_exp(jnp.asarray(twist)))
    pose[:3, 3] = (2.4, 2.4, 0.6)     # the headline's world scale
    z = rng.uniform(-0.6, 4.5, 4 * n)
    lat = rng.uniform(-1.3, 1.3, (4 * n, 2)) * np.array([W / 2 / k[0],
                                                         H / 2 / k[1]])
    pc = np.stack([lat[:, 0] * np.abs(z), lat[:, 1] * np.abs(z), z], -1)
    pw = pc @ pose[:3, :3].T + pose[:3, 3]
    bc = np.floor(pw / (8 * VS)).astype(np.int32)
    bc = bc[(bc >= 0).all(1)][:n]
    depth = rng.uniform(0.2, 4.5, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.1] = 0.0
    tsdf = rng.uniform(-1, 1, (n, 512)).astype(np.float32)
    weight = rng.integers(0, 12, (n, 512)).astype(np.float32)
    live = rng.random(n) < 0.8
    T_cw = np.linalg.inv(pose).astype(np.float32)
    K = np.asarray(jcam.camera_matrix(jnp.asarray(k)))
    return dict(bc=bc, live=live, tsdf=tsdf, weight=weight, depth=depth,
                T_cw=T_cw, K=K)


def _scal_parts(c):
    """lvl, p0r, p0c by the formulas of fuse_rows (integration.py:417-433),
    on the JAX side."""
    H, W = c["depth"].shape
    base = (jnp.asarray(c["bc"]) * 8).astype(jnp.float32)
    ccam, cpix = jint._project(jnp.asarray(c["T_cw"]), jnp.asarray(c["K"]),
                               (base + 4.0) * VS)
    zc = jnp.maximum(ccam[..., 2], 1e-3)
    foot = jnp.abs(c["K"][0, 0]) * (1.7320508 * 8 * VS) / zc
    lvl = jnp.clip(jnp.ceil(jnp.log2(jnp.maximum(foot / PATCH, 1.0)))
                   .astype(jnp.int32), 0, 3)
    stride = (1 << lvl).astype(jnp.float32)
    p0r = jnp.clip((cpix[..., 1] / stride).astype(jnp.int32) - PATCH // 2,
                   0, H // (1 << lvl) - PATCH)
    p0c = jnp.clip((cpix[..., 0] / stride).astype(jnp.int32) - PATCH // 2,
                   0, W // (1 << lvl) - PATCH)
    return np.asarray(lvl), np.asarray(p0r), np.asarray(p0c)


def _twin(c):
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    return ik.fuse_sdf_reference(t["bc"], t["live"], t["tsdf"], t["weight"],
                                 t["depth"], t["T_cw"], t["K"], MU, 100.0, VS,
                                 PATCH)


CASES = [(60, 80, 0), (60, 80, 1), (120, 160, 2)]


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX fuse_rows run per case, shared by the tests of this file."""
    out = {}
    for H, W, seed in CASES:
        c = _case(H, W, seed)
        rows, vis = jint.fuse_rows(
            JaxSDF(mu=MU), jnp.asarray(c["bc"]), jnp.asarray(c["live"]),
            {"tsdf": jnp.asarray(c["tsdf"]),
             "weight": jnp.asarray(c["weight"])},
            jnp.asarray(c["depth"]), jnp.asarray(c["T_cw"]),
            jnp.asarray(c["K"]), 0.0, VS, patch=PATCH)
        out[(H, W, seed)] = (c, {k: np.asarray(v) for k, v in rows.items()},
                             np.asarray(vis))
    return out


@pytest.mark.parametrize("H,W,seed", CASES)
def test_twin_matches_fuse_rows(jax_runs, H, W, seed):
    c, rows, vis = jax_runs[(H, W, seed)]
    lvl, p0r, _ = _scal_parts(c)
    cam_z = ((c["bc"] * 8 + 4.0) * VS) @ c["T_cw"][:3, :3].T \
        + c["T_cw"][:3, 3]
    # the cases this test exists for are all present
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    assert (p0r < 0).any() and (cam_z[:, 2] < -0.3).any()
    assert vis.any() and not vis.all()

    tsdf, weight, visible = _twin(c)
    np.testing.assert_array_equal(visible.numpy(), vis)
    np.testing.assert_allclose(tsdf.numpy(), rows["tsdf"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(weight.numpy(), rows["weight"], rtol=0,
                               atol=1e-5)
    # rows that are not live come back unchanged
    dead = ~c["live"]
    np.testing.assert_array_equal(tsdf.numpy()[dead], c["tsdf"][dead])
    # and the fusion did change live rows
    assert (weight.numpy()[c["live"]] != c["weight"][c["live"]]).any()


def test_twin_matches_pallas_kernel(jax_runs):
    from supereight_tpu.ops import integrate_kernel as jk
    c, _, _ = jax_runs[(120, 160, 2)]
    H, W = c["depth"].shape
    lvl, p0r, p0c = _scal_parts(c)
    # K1 reads its slab from an aligned start, so it takes patch origins
    # inside the level's extent only (H >> lvl >= patch)
    rows = np.nonzero((p0r >= 0) & (p0c >= 0))[0][:2 * jk.BLK]
    assert len(rows) == 2 * jk.BLK and len(set(lvl[rows].tolist())) >= 3
    sub = {k: (v[rows] if k in ("bc", "live", "tsdf", "weight") else v)
           for k, v in c.items()}
    scal = np.zeros((len(rows), 8), np.int32)
    scal[:, 0:3] = sub["bc"]
    scal[:, 3], scal[:, 4], scal[:, 5] = lvl[rows], p0r[rows], p0c[rows]
    scal[:, 6] = sub["live"]
    atlas = np.zeros((4 * H + jk.SLAB_ROWS, jk.AW), np.float32)
    atlas[:4 * H, :W] = np.asarray(jint._decimated_atlas(
        jnp.asarray(c["depth"]))).reshape(4 * H, W)
    out_t, out_w, _ = run_interpret(
        jnp.asarray(scal), jnp.asarray(atlas), jnp.asarray(sub["tsdf"]),
        jnp.asarray(sub["weight"]), jnp.asarray(c["T_cw"]),
        jnp.asarray(c["K"]), H, W, MU, VS)

    tsdf, weight, _ = _twin(sub)
    assert (weight.numpy() != sub["weight"]).any()
    np.testing.assert_allclose(tsdf.numpy(), np.asarray(out_t), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(weight.numpy(), np.asarray(out_w), rtol=0,
                               atol=2e-5)


def _table_map(c, channels, names, cap=None, n_blocks=None, dead=None):
    """A 256^3 port map whose table holds the case's rows in slots 0..n-1
    (``active`` = live), then ``cap - n`` slots past ``n_blocks`` that hold
    garbage, so that a write to them shows."""
    n = len(c["bc"])
    cap = cap or n
    rng = np.random.default_rng(cap)
    m = octree.init(256, 256 * VS, channels, "cpu", capacity=cap)
    bc = torch.from_numpy(c["bc"]).long()
    keys = torch.zeros(cap, dtype=torch.int64)
    keys[:n] = morton.block_key(bc[:, 0], bc[:, 1], bc[:, 2])
    keys[n:] = torch.from_numpy(rng.integers(0, 1 << 15, cap - n))
    active = torch.from_numpy(rng.random(cap) < 0.5)
    active[:n] = torch.from_numpy(c["live"])
    # a block that repeats in several slots repeats its channels too, so
    # that the view row they all write is the same whatever the order
    _, first, inv = np.unique(c["bc"], axis=0, return_index=True,
                              return_inverse=True)
    voxels = {}
    for name in names:
        v = torch.from_numpy(rng.uniform(-5, 5, (cap, 512)).astype(
            np.float32))
        v[:n] = torch.from_numpy(c[name][first[inv.reshape(-1)]])
        voxels[name] = v
    return m.replace(keys=keys, active=active, voxels=voxels,
                     n_blocks=torch.tensor(n if n_blocks is None
                                           else n_blocks, dtype=torch.int32))


def _clone(m):
    return m.replace(voxels={k: v.clone() for k, v in m.voxels.items()},
                     active=m.active.clone())


def _frame(c):
    return tuple(torch.from_numpy(np.array(c[k]))
                 for k in ("depth", "T_cw", "K"))


SDF_NAMES = ik.SDF_CHANNELS


def test_cpu_tensors_take_the_twin():
    c = _case(60, 80, 0, n=8)
    m = _table_map(c, SDFField().channels, SDF_NAMES)
    before = dict(ik.LAUNCHES)
    out, ref = _clone(m), _clone(m)
    ik.fuse_sdf(out, *_frame(c), MU, 100.0)
    ik.fuse_sdf_twin(ref, *_frame(c), MU, 100.0)
    for name in SDF_NAMES:
        assert torch.equal(out.voxels[name], ref.voxels[name])
    assert torch.equal(out.active, ref.active)
    oc = _ofusion_case(c)
    m = _table_map(oc, OFusionField().channels, ik.OFUSION_CHANNELS)
    out, ref = _clone(m), _clone(m)
    ik.fuse_ofusion(out, *_frame(oc), OF_MU, 2.0 * VS, NOW)
    ik.fuse_ofusion_twin(ref, *_frame(oc), OF_MU, 2.0 * VS, NOW)
    for name in ik.OFUSION_CHANNELS:
        assert torch.equal(out.voxels[name], ref.voxels[name])
    assert torch.equal(out.active, ref.active)
    assert ik.LAUNCHES == before


def test_twin_fuses_listed_slots_in_place():
    """Budget branch: the listed slots (dead ones too) take the row
    function's rows and their visibility as ``active``; every other slot
    keeps its voxels and flag; the tables stay the same tensors."""
    c = _case(120, 160, 2)
    n = len(c["bc"])
    m = _table_map(c, SDFField().channels, SDF_NAMES, cap=n + 40)
    before = _clone(m)
    ptrs = [m.voxels[k].data_ptr() for k in SDF_NAMES]
    rng = np.random.default_rng(5)
    slots = np.sort(rng.choice(n + 40, n // 2, replace=False))
    sel = torch.from_numpy(slots.astype(np.int32))
    ik.fuse_sdf_twin(m, *_frame(c), MU, 100.0, slots=sel)
    assert [m.voxels[k].data_ptr() for k in SDF_NAMES] == ptrs
    idx = torch.from_numpy(slots)
    bc = torch.stack(morton.block_key_decode(before.keys[idx]), -1)
    t, w, vis = ik.fuse_sdf_reference(
        bc, torch.ones(len(slots), dtype=torch.bool),
        before.voxels["tsdf"][idx], before.voxels["weight"][idx],
        *_frame(c), MU, 100.0, VS, PATCH)
    assert torch.equal(m.voxels["tsdf"][idx], t)
    assert torch.equal(m.voxels["weight"][idx], w)
    assert torch.equal(m.active[idx], vis)
    assert int((w != before.voxels["weight"][idx]).sum()) > 100
    rest = torch.ones(n + 40, dtype=torch.bool)
    rest[idx] = False
    for k in SDF_NAMES:
        assert torch.equal(m.voxels[k][rest], before.voxels[k][rest])
    assert torch.equal(m.active[rest], before.active[rest])


@pytest.mark.parametrize("budget", [True, False])
def test_twin_view_epilogue_matches_encode_view_rows(budget):
    """The held view the SDF twin writes equals ``encode_view_rows`` of
    the fused rows scattered with ``index_copy_`` at their blocks' rows,
    bit for bit; rows of other blocks keep their bits."""
    from supereight_tpu_torch.pipeline import raycast
    c = _case(120, 160, 2)
    n = len(c["bc"])
    m = _table_map(c, SDFField().channels, SDF_NAMES, cap=n + 40)
    rng = np.random.default_rng(6)
    B = m.blocks_per_edge
    view0 = torch.from_numpy(rng.uniform(-1, 1, (B ** 3, 512)).astype(
        np.float32)).to(torch.bfloat16)
    sel = torch.from_numpy(np.sort(rng.choice(n, n // 3, replace=False))
                           .astype(np.int32)) if budget else None
    got, want = _clone(m), _clone(m)
    view = view0.clone()
    ik.fuse_sdf_twin(got, *_frame(c), MU, 100.0, slots=sel, view=view)
    ik.fuse_sdf_twin(want, *_frame(c), MU, 100.0, slots=sel)
    slots = sel.long() if budget else \
        torch.nonzero(octree.slot_mask(m) & m.active)[:, 0]
    enc = raycast.encode_view_rows(
        SDFField(), {k: want.voxels[k][slots] for k in SDF_NAMES})
    ref = view0.clone().index_copy_(0, octree.block_rows(want)[slots], enc)
    assert torch.equal(view.view(torch.int16), ref.view(torch.int16))
    assert int((view.view(torch.int16) != view0.view(torch.int16))
               .any(1).sum()) > 10
    assert bool(torch.isnan(view).any())


@pytest.mark.parametrize("kernel", ["fuse_sdf", "fuse_ofusion"])
def test_whole_table_branch_leaves_dead_rows(kernel):
    """Without ``slots`` every live slot (below ``n_blocks`` and active)
    fuses; inactive slots below ``n_blocks`` and every slot past it keep
    their voxels and ``active`` bit for bit."""
    c = _case(120, 160, 2)
    n = len(c["bc"])
    if kernel == "fuse_sdf":
        field, names, params = SDFField(), SDF_NAMES, (MU, 100.0)
    else:
        c = dict(_ofusion_case(c), bc=c["bc"], live=c["live"])
        field, names = OFusionField(), ik.OFUSION_CHANNELS
        params = (OF_MU, 2.0 * VS, NOW)
    m = _table_map(c, field.channels, names, cap=n + 40)
    before = _clone(m)
    getattr(ik, kernel)(m, *_frame(c), *params)
    live = octree.slot_mask(before) & before.active
    dead = ~live
    assert int(dead[:n].sum()) > 10 and bool(dead[n:].all())
    for k in names:
        assert torch.equal(m.voxels[k][dead], before.voxels[k][dead])
        assert bool((m.voxels[k][live] != before.voxels[k][live]).any())
    assert torch.equal(m.active[dead], before.active[dead])
    assert bool((m.active[live] != before.active[live]).any())


OF_MU = 0.05
NOW = float(np.float32(1 / 30) * np.float32(40))


def _ofusion_case(c):
    """An SDF case's rows and frame with occupancy and timestamp channels."""
    rng = np.random.default_rng(len(c["bc"]))
    n = len(c["bc"])
    oc = {k: c[k] for k in ("bc", "live", "depth", "T_cw", "K")}
    oc["occupancy"] = rng.uniform(-20, 20, (n, 512)).astype(np.float32)
    oc["timestamp"] = rng.uniform(0, 1.2, (n, 512)).astype(np.float32)
    return oc


def _ofusion_args(oc):
    t = {k: torch.from_numpy(np.array(v)) for k, v in oc.items()}
    # the sigma floor 2 * voxel_size of the 128^3 map
    return (t["bc"], t["live"], t["occupancy"], t["timestamp"], t["depth"],
            t["T_cw"], t["K"], OF_MU, 2.0 * VS, NOW, VS, PATCH)


@pytest.mark.parametrize("H,W,seed", CASES)
def test_ofusion_twin_matches_fuse_rows(H, W, seed):
    oc = _ofusion_case(_case(H, W, seed))
    rows, vis = jint.fuse_rows(
        JaxOFusion(mu=OF_MU, voxel_size=VS), jnp.asarray(oc["bc"]),
        jnp.asarray(oc["live"]),
        {"occupancy": jnp.asarray(oc["occupancy"]),
         "timestamp": jnp.asarray(oc["timestamp"])},
        jnp.asarray(oc["depth"]), jnp.asarray(oc["T_cw"]),
        jnp.asarray(oc["K"]), jnp.float32(NOW), VS, patch=PATCH)
    occ, ts, visible = ik.fuse_ofusion_reference(*_ofusion_args(oc))
    np.testing.assert_array_equal(visible.numpy(), np.asarray(vis))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rows["timestamp"]))
    np.testing.assert_allclose(occ.numpy(), np.asarray(rows["occupancy"]),
                               rtol=1e-5, atol=1e-6)
    fused = ts.numpy() == np.float32(NOW)
    assert fused.sum() > 1000 and not fused[~oc["live"]].any()
    # rows that are not live come back unchanged
    dead = ~oc["live"]
    np.testing.assert_array_equal(occ.numpy()[dead], oc["occupancy"][dead])
