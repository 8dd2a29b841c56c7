"""The port's benchmark app (``supereight_tpu_torch.apps.benchmark``, on
the CPU with ``--device cpu``) against the JAX package's on the same
fabricated 8-frame 60x80 ``.raw`` stream of the synthetic room:

- ground-truth mode (``-g``) at 64^3: the TSV's tracked and integrated
  columns equal, X/Y/Z within 1e-3 m, the blocks equal, and the files of
  ``-d`` (the checkpoint's tables equal) and ``--dump-mesh`` (byte for
  byte);
- ICP mode (``-p``) at 128^3 (at 64^3, 7.5 cm voxels, ICP's divergence
  gate never passes and nothing would be compared): the same, but the
  blocks;

then the app's own contract: its flags are the JAX app's plus
``--device``, the TSV has one row a frame (``--staged`` fills the stage
columns, ``-f`` pacing drops frames and keeps rows, ``--live`` replays
the sensor), presets and pinned flags, the overflow warning, the -G
transform, ``-d`` / ``--dump-mesh`` write their files, and the knob flags
(``--midsolve``, ``--normals stored``) run."""

import dataclasses

import numpy as np
import pytest
import torch

from supereight_tpu.apps import benchmark as jbench
from supereight_tpu.pipeline import system as jsystem
from supereight_tpu_torch.apps import benchmark
from supereight_tpu_torch.io import serialise, synthetic

torch.set_num_threads(1)

N_FRAMES = 8
H, W = 60, 80
XYZ_ATOL = 1e-3


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    rawp, gtp, k = synthetic.write_dataset(str(d / "room"), N_FRAMES, H=H,
                                           W=W, device="cpu")
    return dict(dir=d, raw=rawp, gt=gtp,
                k=",".join(str(float(x)) for x in k))


def _base(seq, res):
    return ["-i", seq["raw"], "-s", "4.8", "-v", str(res), "-k", seq["k"],
            "-z", "1", "-c", "2", "-q"]


def _rows(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _run_jax(argv, monkeypatch):
    """The JAX app and the system it made."""
    made = []

    class Kept(jsystem.DenseSLAMSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jbench, "DenseSLAMSystem", Kept)
    est = jbench.main(argv)
    return est, made[0]


@pytest.mark.parametrize("mode", ["ground-truth", "icp"])
def test_app_matches_jax(seq, mode, monkeypatch):
    out = {p: {k: str(seq["dir"] / f"{p}-{mode}.{k}")
               for k in ("tsv", "npz", "vtk")} for p in "jt"}
    if mode == "ground-truth":
        argv = _base(seq, 64) + ["-g", seq["gt"]]
        maps = {p: ["-d", out[p]["npz"], "--dump-mesh", out[p]["vtk"]]
                for p in "jt"}
    else:
        argv = _base(seq, 128) + ["-p", "0.5,0.5,0.23"]
        maps = {"j": [], "t": []}
    jlog, tlog = out["j"]["tsv"], out["t"]["tsv"]
    jest, jslam = _run_jax(argv + ["-o", jlog] + maps["j"], monkeypatch)
    run = benchmark.run(argv + ["-o", tlog, "--device", "cpu"] + maps["t"])
    J, T = _rows(jlog), _rows(tlog)
    assert J.shape == T.shape == (N_FRAMES, 14)
    np.testing.assert_array_equal(T[:, 0], np.arange(N_FRAMES))
    np.testing.assert_array_equal(T[:, 12:], J[:, 12:])
    np.testing.assert_allclose(T[:, 9:12], J[:, 9:12], rtol=0,
                               atol=XYZ_ATOL)
    assert len(run.est_poses) == len(jest) == N_FRAMES
    np.testing.assert_allclose(np.stack(run.est_poses)[:, :3, 3],
                               np.stack(jest)[:, :3, 3], rtol=0,
                               atol=XYZ_ATOL)
    if mode == "ground-truth":
        assert T[:, 12].all()
        assert int(run.system.state.map.n_blocks) == \
            int(jslam.state.map.n_blocks)
        # -d and --dump-mesh: the same checkpoint, read by the port from
        # both files, and the same mesh file byte for byte
        a, b = (serialise.load_map(out[p]["npz"], device="cpu")
                for p in "tj")
        for name in ("block_index", "keys", "n_blocks", "active"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        for name in a.voxels:
            assert torch.equal(a.voxels[name], b.voxels[name]), name
        with open(out["t"]["vtk"], "rb") as ft, \
                open(out["j"]["vtk"], "rb") as fj:
            mesh = ft.read()
            assert mesh == fj.read() and b"POLYGONS 0 " not in mesh
    else:
        assert T[:, 12].sum() >= 4             # it tracks past bootstrap
    # the triptych of the last rendered frame, and the final state's
    assert [tuple(x.shape) for x in run.images] == [(H, W, 4)] * 3
    np.testing.assert_array_equal(run.system.renderDepth().numpy(),
                                  np.asarray(jslam.renderDepth()))


def test_flags_are_the_jax_apps():
    jargs = vars(jbench.parse_args(["-i", "x.raw"]))
    targs = vars(benchmark.parse_args(["-i", "x.raw"]))
    assert set(targs) == set(jargs) | {"device"}
    for name, value in jargs.items():
        assert targs[name] == value, name
    assert targs["device"] == "cuda"


@pytest.mark.parametrize("flag", [["-d", "map.npz"],
                                  ["--dump-mesh", "mesh.vtk"]])
def test_map_outputs_raise(seq, flag):
    """-d and --dump-mesh no longer raise: each writes its file at the end
    of the run, from the final map."""
    path = str(seq["dir"] / flag[1])
    run = benchmark.run(_base(seq, 64) + ["-g", seq["gt"], flag[0], path,
                                          "--device", "cpu"])
    if flag[0] == "-d":
        m = serialise.load_map(path, device="cpu")
        assert int(m.n_blocks) == int(run.system.state.map.n_blocks) > 0
    else:
        head = open(path).read(200)
        assert head.startswith("# vtk DataFile") and "POINTS" in head


class _Made(Exception):
    pass


def _jax_config(argv, monkeypatch):
    """The Configuration the JAX app makes from ``argv`` (it stops at its
    DenseSLAMSystem)."""
    made = []

    def stop(size, cfg):
        made.append(cfg)
        raise _Made

    monkeypatch.setattr(jbench, "DenseSLAMSystem", stop)
    with pytest.raises(_Made):
        jbench.main(argv)
    return made[0]


@pytest.mark.parametrize("flags", [["--midsolve"], ["--normals", "stored"]],
                         ids=["midsolve", "normals-stored"])
def test_knob_flags_run(seq, flags, monkeypatch):
    """The flags that raised before their knobs were ported: the app maps
    them to the JAX app's Configuration and runs a frame on the CPU."""
    argv = _base(seq, 64) + ["-g", seq["gt"], "--max-frames", "1"] + flags
    want = _jax_config(argv, monkeypatch)
    run = benchmark.run(argv + ["--device", "cpu"])
    cfg = run.system.config
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(want, f.name), f.name
    assert len(run.est_poses) == 1 and run.system.state.integrated


def _config(argv):
    return benchmark.make_config(benchmark.parse_args(argv), argv)


def test_presets_and_pinned_flags():
    from supereight_tpu_torch.config import PRESETS
    cfg = _config(["-i", "x", "--preset", "headline", "--int-budget=1024"])
    assert cfg.integrate_budget == 1024
    for name, value in PRESETS["headline"].items():
        if name != "integrate_budget":
            assert getattr(cfg, name) == value, name
    # -F selects the noise regime unless --field pins the field
    assert _config(["-i", "x", "-F"]).field_type == "ofusion"
    cfg = _config(["-i", "x", "-F", "--field", "sdf"])
    assert cfg.field_type == "sdf" and cfg.bilateral_filter
    assert _config(["-i", "x"]).field_type == "sdf"


def test_staged_fills_stage_columns(seq):
    argv = _base(seq, 64) + ["-g", seq["gt"], "--device", "cpu"]
    fused = benchmark.run(argv + ["-o", str(seq["dir"] / "f.tsv")])
    staged = benchmark.run(argv + ["--staged", "-o",
                                   str(seq["dir"] / "s.tsv")])
    rows = _rows(seq["dir"] / "s.tsv")
    assert (rows[:, 2:6] > 0).all()
    assert (_rows(seq["dir"] / "f.tsv")[:, 2:6] == 0).all()
    np.testing.assert_array_equal(np.stack(staged.est_poses),
                                  np.stack(fused.est_poses))


def test_fps_pacing_drops_frames(seq):
    """At 100000 fps every frame arrives late (reading it takes longer than
    its 10 us): each gets a row with the initial pose held and nothing
    computed, as in the JAX app."""
    run = benchmark.run(_base(seq, 64) + ["-f", "100000", "-o",
                                           str(seq["dir"] / "p.tsv"),
                                           "--device", "cpu"])
    rows = _rows(seq["dir"] / "p.tsv")
    assert len(rows) == len(run.est_poses) == N_FRAMES
    np.testing.assert_array_equal(rows[:, 0], np.arange(N_FRAMES))
    assert (rows[:, 1] > 0).all() and (rows[:, 2:9] == 0).all()
    assert (rows[:, 12:] == 0).all()
    init = run.system.init_pose.numpy()
    for p in run.est_poses:
        np.testing.assert_array_equal(p, init)


def test_live_replay(seq):
    """A 1 fps sensor behind a faster consumer: every frame is seen once,
    in order, as from the file."""
    argv = _base(seq, 64) + ["-g", seq["gt"], "--device", "cpu"]
    live = benchmark.run(argv + ["--live", "-f", "1", "-o",
                                 str(seq["dir"] / "l.tsv")])
    fromfile = benchmark.run(argv + ["-o", str(seq["dir"] / "n.tsv")])
    rows = _rows(seq["dir"] / "l.tsv")
    np.testing.assert_array_equal(rows[:, 0], np.arange(N_FRAMES))
    np.testing.assert_array_equal(np.stack(live.est_poses),
                                  np.stack(fromfile.est_poses))


def test_overflow_warning(seq, capsys):
    benchmark.run(_base(seq, 64) + ["-g", seq["gt"], "--block-capacity",
                                    "16", "--device", "cpu", "-o",
                                    str(seq["dir"] / "o.tsv")])
    assert "block-allocation requests dropped" in capsys.readouterr().err


def test_gt_transform(seq):
    """-G premultiplies every ground-truth pose."""
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (0.1, -0.2, 0.05)
    argv = _base(seq, 64) + ["-g", seq["gt"], "--device", "cpu", "-c", "0"]
    plain = benchmark.run(argv + ["-o", str(seq["dir"] / "g0.tsv")])
    moved = benchmark.run(argv + ["-G", ",".join(map(str, shift.ravel())),
                                  "-o", str(seq["dir"] / "g1.tsv")])
    for a, b in zip(plain.est_poses, moved.est_poses):
        np.testing.assert_array_equal(b, shift @ a)
    assert moved.images is None
