"""The port's numpy modules against the JAX package's: the ``.raw`` stream
and TUM trajectory files byte for byte, the scene and live readers frame
for frame, the reader factory, the trajectory evaluation to 1e-12 and the
perf-stats summary text."""

import numpy as np
import pytest

from supereight_tpu.apps import evaluate as jev
from supereight_tpu.io import groundtruth as jgt
from supereight_tpu.io import live as jlive
from supereight_tpu.io import native as jnative
from supereight_tpu.io import raw as jraw
from supereight_tpu.io import scene as jscene
from supereight_tpu.utils import perfstats as jps
import supereight_tpu_torch.io as tio
from supereight_tpu_torch.apps import evaluate
from supereight_tpu_torch.io import groundtruth, live, native, raw, scene
from supereight_tpu_torch.utils import perfstats


def _poses(n, seed=0, scale=1.0):
    """``n`` random rigid poses, float32, rotations of every kind (the four
    branches of ``rot_to_quat``)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = rng.normal(size=3)
        w *= (0.2 + 3.0 * (i % 4) / 4) / np.linalg.norm(w)
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        T[:3, 3] = rng.normal(size=3) * scale
        out.append(T)
    return out


def _frames(n, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 65535, (h, w), dtype=np.uint16) for _ in range(n)]


def test_raw_files_byte_identical(tmp_path):
    frames = _frames(3)
    rgb = np.random.default_rng(1).integers(0, 255, (12, 16, 3), np.uint8)
    for mod, name in ((jraw, "j.raw"), (raw, "t.raw")):
        w = mod.RawWriter(str(tmp_path / name), 16, 12)
        w.write(frames[0], rgb)
        for f in frames[1:]:
            w.write(f)
        w.close()
    a, b = (tmp_path / "j.raw").read_bytes(), (tmp_path / "t.raw").read_bytes()
    assert a == b and len(a) == 3 * (16 + 12 * 16 * 5)
    jr, tr = jraw.RawReader(str(tmp_path / "j.raw")), \
        raw.RawReader(str(tmp_path / "j.raw"))
    assert (tr.width, tr.height, len(tr)) == (jr.width, jr.height, len(jr))
    for i in range(3):
        for x, y in zip(tr.read(i), jr.read(i)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(IndexError):
        tr.read(3)


def test_quaternions_match(tmp_path):
    for T in _poses(12):
        R = T[:3, :3]
        q = groundtruth.rot_to_quat(R)
        np.testing.assert_array_equal(q, jgt.rot_to_quat(R))
        np.testing.assert_array_equal(groundtruth.quat_to_rot(*q),
                                      jgt.quat_to_rot(*q))


def test_trajectory_files_match(tmp_path):
    poses = _poses(9, seed=2)
    ts = [1000.0 + 0.033 * i for i in range(9)]
    jgt.write_poses(str(tmp_path / "j.gt"), poses, timestamps=ts)
    groundtruth.write_poses(str(tmp_path / "t.gt"), poses, timestamps=ts)
    assert (tmp_path / "j.gt").read_text() == (tmp_path / "t.gt").read_text()
    with open(tmp_path / "j.gt", "a") as f:
        f.write("# a comment\n\nextra 1 2 3 0 0 0 1\n")
    transform = _poses(1, seed=3)[0]
    for tr in (None, transform):
        got = groundtruth.read_poses(str(tmp_path / "j.gt"), tr)
        want = jgt.read_poses(str(tmp_path / "j.gt"), tr)
        assert len(got) == len(want) == 10
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    with open(tmp_path / "bad.gt", "w") as f:
        f.write("1 2 3\n")
    with pytest.raises(ValueError):
        groundtruth.read_poses(str(tmp_path / "bad.gt"))


def _scene_dir(tmp_path, n=2):
    d = tmp_path / "scene"
    d.mkdir()
    rng = np.random.default_rng(4)
    for i in range(n):
        eu = rng.uniform(0.3, 6.0, (scene.SCENE_H, scene.SCENE_W))
        eu[rng.random(eu.shape) < 0.05] = 0.0
        np.savetxt(d / f"scene_00_{i:04d}.depth",
                   eu.astype(np.float32).reshape(1, -1), fmt="%.5f")
    return d


def _read_scene(d):
    got, want = scene.SceneDepthReader(str(d)), jscene.SceneDepthReader(str(d))
    assert (got.width, got.height, len(got)) == \
        (want.width, want.height, len(want)) == (640, 480, 2)
    for i in range(2):
        a, b = got.read(i), want.read(i)
        assert a[0].dtype == np.uint16 and (a[0] > 0).mean() > 0.9
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_scene_reader_matches(tmp_path, monkeypatch):
    """Frame for frame against the JAX reader, both with their native
    conversions (``io.native``, float32), then both with their numpy ones
    (the native converter differs from numpy by 1 mm on ~0.02 % of
    pixels)."""
    d = _scene_dir(tmp_path)
    assert scene.SCENE_K == jscene.SCENE_K
    assert native.available() and jnative.available()
    _read_scene(d)
    monkeypatch.setattr(jnative, "load_library", lambda: None)
    monkeypatch.setattr(native, "load_library", lambda: None)
    _read_scene(d)
    assert isinstance(tio.create_reader(str(d)), scene.SceneDepthReader)
    with pytest.raises(FileNotFoundError):
        scene.SceneDepthReader(str(tmp_path))


def test_create_reader_raw(tmp_path):
    p = str(tmp_path / "s.raw")
    w = raw.RawWriter(p, 16, 12)
    for f in _frames(2, seed=5):
        w.write(f)
    w.close()
    r = tio.create_reader(p)
    assert isinstance(r, native.NativeRawReader) and len(r) == 2
    np.testing.assert_array_equal(r.read(1)[0], _frames(2, seed=5)[1])


def test_live_reader_drops_as_jax(tmp_path):
    """The same frames and drop count under the same fake clock, a consumer
    that is sometimes slow and sometimes fast."""
    p = str(tmp_path / "seq.raw")
    w = raw.RawWriter(p, 8, 6)
    for i in range(20):
        w.write(np.full((6, 8), i + 1, np.uint16))
    w.close()
    steps = [0.0, 2.5, 0.1, 0.9, 3.2, 0.0, 1.7, 4.4, 0.2, 30.0]
    seen = []
    for mod in (jlive, live):
        t = {"now": 100.0}
        r = mod.LiveReplayReader(p, fps=30.0, clock=lambda: t["now"])
        got = []
        for dt in steps:
            t["now"] += dt / 30.0
            out = r.read_next()
            got.append(None if out is None else int(out[0][0, 0]))
            got.append(r.dropped)
        seen.append(got)
        assert (r.width, r.height) == (8, 6)
    assert seen[0] == seen[1]
    assert seen[1][-2] is None and seen[1][-1] > 0


def _traj(n=30, seed=0):
    rng = np.random.default_rng(seed)
    gt = _poses(n, seed=seed, scale=0.5)
    est = []
    for T in gt:
        E = T.astype(np.float64).copy()
        E[:3, 3] = 1.1 * E[:3, 3] + rng.normal(0, 0.01, 3) + (0.3, -0.2, 1.0)
        est.append(E)
    return est, gt


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_evaluate_matches():
    est, gt = _traj()
    pe = np.stack([T[:3, 3] for T in est])
    pg = np.stack([T[:3, 3] for T in gt])
    for scale in (False, True):
        _close(evaluate.horn_align(pe, pg, scale),
               jev.horn_align(pe, pg, scale))
        _close(evaluate.ate(est, gt, scale), jev.ate(est, gt, scale))
    assert evaluate.ate(est, gt)["rmse"] > 0.01
    _close(evaluate.ate_scale_search(est, gt), jev.ate_scale_search(est, gt))
    for delta in (1, 5):
        _close(evaluate.rpe(est, gt, delta), jev.rpe(est, gt, delta))
    f = lambda x: (x - 1.3) ** 2
    _close(evaluate.golden_section_search(0.0, 4.0, 1e-4, f),
           jev.golden_section_search(0.0, 4.0, 1e-4, f))
    ta = [0.0, 0.033, 0.066, 0.1, 0.5]
    tb = [0.004, 0.07, 0.2, 0.49, 0.0335]
    assert evaluate.associate(ta, tb) == jev.associate(ta, tb)
    assert evaluate.associate(ta, tb, 0.005) == jev.associate(ta, tb, 0.005)


def test_perfstats_summary_matches():
    samples = {"tracking": [0.01, 0.02, 0.03], "integration": [0.5],
               "raycasting": [0.004, 0.0041]}
    a, b = perfstats.PerfStats(), jps.PerfStats()
    for st, mod in ((a, perfstats), (b, jps)):
        for k, vs in samples.items():
            for v in vs:
                st.sample(k, v, mod.SampleType.TIME)
    assert a.summary() == b.summary()
    assert a.print_all_data() == b.print_all_data()
    assert a.print_latest() == b.print_latest() and a.header() == b.header()
    for k in samples:
        assert (a.mean(k), a.min(k), a.max(k), a.get_sample_time(k),
                a.get_last_data(k)) == (b.mean(k), b.min(k), b.max(k),
                                        b.get_sample_time(k),
                                        b.get_last_data(k))
    with a.timer("block"):
        pass
    assert len(a.results["block"]["data"]) == 1
    assert isinstance(perfstats.Stats, perfstats.PerfStats)
