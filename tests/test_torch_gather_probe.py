"""Gather-rate probe of the PyTorch port (`ops/gather_probe.py`,
`probes/gather_probe.py`) against the Pallas kernels K2 and K3.

``shuffle_kernel`` and ``rows_kernel`` are closures inside
``scripts/pallas_gather_probe.py:main``; they are taken from its source with
``ast`` and run through ``pl.pallas_call(..., interpret=True)`` with the
probe's constants bound to small values.  The port's plain versions must
equal them bit for bit (both sum in the kernels' order).  The CUDA kernels
are held against the plain versions on the card by tests/test_torch_gpu.py.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from supereight_tpu_torch.ops import gather_probe as gp
from supereight_tpu_torch.probes import gather_probe as probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "pallas_gather_probe.py")


def _pallas_bodies(**consts):
    """``shuffle_kernel`` and ``rows_kernel`` from the JAX probe's source,
    with ``consts`` (S, KREP, WIDE, N_ROWS) bound."""
    with open(SCRIPT) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fns = [n for n in main.body if isinstance(n, ast.FunctionDef)
           and n.name in ("shuffle_kernel", "rows_kernel")]
    ns = dict(jax=jax, jnp=jnp, pl=pl, **consts)
    exec(compile(ast.Module(body=fns, type_ignores=[]), SCRIPT, "exec"), ns)
    return ns["shuffle_kernel"], ns["rows_kernel"]


@pytest.mark.parametrize("S,KREP,carry", [(16, 64, 0), (8, 64, 1 << 20),
                                          (16, 5, 2 ** 31 - 40)])
def test_lane_shuffle_sum_matches_pallas(S, KREP, carry):
    """The last case wraps the int32 lane index past 2^31."""
    shuffle_kernel, _ = _pallas_bodies(S=S, KREP=KREP)
    rng = np.random.default_rng(S + KREP)
    src = rng.standard_normal((S, 128)).astype(np.float32)
    idx = (rng.integers(0, 128, (S, 128)) + carry).astype(np.int32)
    want = pl.pallas_call(
        shuffle_kernel, out_shape=jax.ShapeDtypeStruct((S, 128), jnp.float32),
        interpret=True)(jnp.asarray(src), jnp.asarray(idx))
    got = gp.lane_shuffle_sum(torch.from_numpy(src), torch.from_numpy(idx),
                              KREP)
    assert got.dtype == torch.float32 and got.shape == (S, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("CAP,N_ROWS,WIDE", [(256, 64, 512), (64, 32, 128)])
def test_slab_row_sum_matches_pallas(CAP, N_ROWS, WIDE):
    _, rows_kernel = _pallas_bodies(N_ROWS=N_ROWS, WIDE=WIDE)
    rng = np.random.default_rng(CAP)
    table = jnp.asarray(rng.standard_normal((CAP, WIDE)), jnp.bfloat16)
    rows = (rng.integers(0, CAP // 8, (N_ROWS,)) * 8).astype(np.int32)
    want = pl.pallas_call(
        rows_kernel, out_shape=jax.ShapeDtypeStruct((8, WIDE), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        interpret=True)(jnp.asarray(rows), table)
    t16 = torch.from_numpy(np.array(table.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = gp.slab_row_sum(torch.from_numpy(rows), t16)
    assert got.dtype == torch.float32 and got.shape == (8, WIDE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_plain_versions():
    before = dict(gp.LAUNCHES)
    src = torch.ones((4, 128))
    out = gp.lane_shuffle_sum(src, torch.zeros((4, 128), dtype=torch.int32),
                              3)
    assert torch.equal(out, torch.full((4, 128), 3.0))
    rows = torch.tensor([0, 8, 0, 8], dtype=torch.int32)
    out = gp.slab_row_sum(rows, torch.ones((16, 32), dtype=torch.bfloat16))
    assert torch.equal(out, torch.full((8, 32), 4.0))
    assert gp.LAUNCHES == before


def test_probe_inputs():
    """The probe's per-run inputs follow the JAX steps' formulas, and every
    slab lies inside the table."""
    d = probe.make_data()
    assert d["src"].shape == (probe.S, 128) and d["idxt"].max() < 128
    assert d["table16"].shape == (probe.CAP, probe.WIDE)
    idx = probe.shuffle_inputs(d, 3, "cpu").numpy()
    np.testing.assert_array_equal(idx[2] - d["idxt"], d["carry_shuffle"] + 3)
    rows = probe.rows_inputs(d, 9, "cpu").numpy()
    assert rows.shape == (9, probe.N_ROWS)
    assert (rows % 8 == 0).all() and rows.min() >= 0
    assert rows.max() + 8 <= probe.CAP
    c = d["carry_rows"] + 1
    want = ((d["rows0"] + (c & 7) * 8) % (probe.CAP - 8)) // 8 * 8
    np.testing.assert_array_equal(rows[0], want)
    # the same seed gives the same data
    np.testing.assert_array_equal(probe.make_data()["rows0"], d["rows0"])


def test_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        probe.main([])


def test_constants_reads_literal_definitions(tmp_path, monkeypatch):
    """The geometry is read from the kernel's source: top-level constants
    defined by a literal, not those defined by an expression or inside a
    function."""
    from supereight_tpu_torch.ops import _build
    (tmp_path / "k.cu").write_text(
        "constexpr int kA = 64;            // a comment\n"
        "constexpr int kB = kA / 8;\n"
        "constexpr float kC = 0.5;\n"
        "void f() {\n  constexpr int kD = 3;\n}\n"
        "constexpr int kE = 2048;\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.constants("k") == {"kA": 64, "kE": 2048}


@pytest.mark.parametrize("attr,name", [
    ("LANES", "kLanes"), ("SLAB_ROWS", "kSlabRows"),
    ("TILE_COLS", "kTileCols"), ("CHAINS", "kChains"),
    ("SLAB_STAGE", "kStageSlabs"), ("INDEX_CHUNK", "kIndexChunk")])
def test_geometry_is_the_kernel_source(attr, name):
    """Each constant the bounds use is the one the kernel compiles with."""
    from supereight_tpu_torch.ops import _build
    assert getattr(gp, attr) == _build.constants("gather_probe")[name]


@pytest.mark.parametrize("wide,want", [(512, 256), (520, 288), (32, 32),
                                       (36, 32), (1, 32), (64, 32),
                                       (65, 64)])
def test_slab_grid_covers_the_width(wide, want):
    """K3: four chains for each 64-column tile of each of a slab's 8 rows,
    the last tile masked; the probe's width gives 256 CTAs."""
    assert gp.slab_grid(wide) == want


@pytest.mark.parametrize("n,wide,want", [
    (2048, 512, 2 * 256 * 16),        # 512 steps a chain: 16 whole stages
    (8192, 512, 2 * 256 * 64),
    (4, 512, 0),                      # one step: no whole stage
    (4 * 2048 + 44, 64, 2 * 32 * (64 + 0)),   # a second chunk of 11 steps
    (4 * 4096 + 4 * 40, 32, 2 * 32 * (64 + 64 + 1)),
])
def test_slab_warp_trips(n, wide, want):
    assert gp.slab_warp_trips(n, wide) == want


def test_shuffle_warp_trips():
    assert gp.shuffle_warp_trips(65536) == 4 * 65536


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """``_build.library_path`` keys a library by its source and by every
    ``csrc/`` header it includes (and theirs): editing a copied header
    changes the path of each source that includes it, and of no other."""
    from supereight_tpu_torch.ops import _build
    for name in ("raycast.cu", "numerics.cu", "pyramid.cu",
                 "lu_inverse.cuh"):
        (tmp_path / name).write_text((_build.CSRC / name).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [h.name for h in _build.headers(tmp_path / "raycast.cu")] == \
        ["lu_inverse.cuh"]
    names = ("raycast", "numerics", "pyramid")
    before = {n: _build.library_path(n) for n in names}
    hdr = tmp_path / "lu_inverse.cuh"
    hdr.write_text(hdr.read_text() + "\n// an edit\n")
    after = {n: _build.library_path(n) for n in names}
    assert after["raycast"] != before["raycast"]
    assert after["numerics"] != before["numerics"]
    assert after["pyramid"] == before["pyramid"]
    # a header the header includes counts too
    (tmp_path / "inner.cuh").write_text("// inner\n")
    hdr.write_text('#include "inner.cuh"\n' + hdr.read_text())
    nested = _build.library_path("raycast")
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("raycast") != nested
