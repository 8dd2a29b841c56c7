"""The port's spans and host-read counters (``utils/perfstats.py``): their
nesting and self time, tracing off (one shared no-op, nothing recorded,
nothing of ``torch`` called), the host reads by site, the spans of a few
frames of a small SDF configuration through ``step`` and ``step_staged``,
and the frames' outputs the same bit for bit with tracing on and off."""

import os
import time

import numpy as np
import pytest
import torch

from supereight_tpu_torch.utils import perfstats
from supereight_tpu_torch.utils.perfstats import PerfStats, Stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("se.preprocessing.stage", "se.tracking.stage",
          "se.integration.stage", "se.raycasting.stage")
RENDERS = ("se.rendering.depth", "se.rendering.track", "se.rendering.volume")
FRAMES = 5


def _busy(ns: int) -> None:
    t0 = time.perf_counter_ns()
    while time.perf_counter_ns() - t0 < ns:
        pass


def test_span_nesting_parent_and_self_time():
    st = PerfStats()
    with st.tracing() as rec:
        with st.span("se.a.outer"):
            _busy(200_000)
            with st.span("se.a.inner"):
                _busy(300_000)
                with st.host_read("x"):
                    _busy(100_000)
            with st.span("se.a.inner"):
                pass
        with st.span("se.b.alone"):
            pass
    assert [r.path for r in rec] == [
        ("se.a.outer", "se.a.inner", "se.read.x"),
        ("se.a.outer", "se.a.inner"), ("se.a.outer", "se.a.inner"),
        ("se.a.outer",), ("se.b.alone",)]
    read, inner, inner2, outer, alone = rec
    assert (read.parent, inner.parent, outer.parent, alone.parent) == (
        "se.a.inner", "se.a.outer", None, None)
    assert read.name == "se.read.x" and read.self_ns == read.ns >= 100_000
    assert inner.self_ns == inner.ns - read.ns and inner.self_ns >= 300_000
    assert outer.self_ns == outer.ns - inner.ns - inner2.ns >= 200_000
    # each span's seconds are samples under its name, counted by run
    assert len(st.results["se.a.inner"]["data"]) == 2
    assert st.results["se.a.outer"]["data"] == [outer.ns * 1e-9]
    assert st.results["se.a.outer"]["type"] == perfstats.SampleType.TIME
    assert "se.a.inner" in st.summary()
    assert st.export() == rec


def test_tracing_off_records_nothing_and_calls_no_torch(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch called with tracing off")
    monkeypatch.setattr(perfstats, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    st = PerfStats()
    with st.span("se.a.b") as a, st.host_read("x") as b:
        pass
    assert a is b is st.span("se.c.d") is perfstats._NO_SPAN
    assert st.export() == []
    assert not st.results
    # tracing() restores what was there, also after an error
    with pytest.raises(KeyError):
        with st.tracing():
            with st.span("se.a.b"):
                raise KeyError
    assert st.span("se.a.b") is perfstats._NO_SPAN
    assert [r.name for r in st.export()] == ["se.a.b"]
    # each block has a record of its own
    with st.tracing() as rec:
        with st.span("se.c.d"):
            pass
    assert [r.name for r in rec] == [r.name for r in st.export()] \
        == ["se.c.d"]


def test_host_read_counts_by_site():
    st = PerfStats()
    with st.tracing():
        for site, n in (("depth", 3), ("tracked", 2), ("light", 1)):
            for _ in range(n):
                with st.host_read(site):
                    pass
    with st.host_read("depth"):          # tracing off: not counted
        pass
    counts = {}
    for r in st.export():
        assert r.name.startswith(perfstats.READ)
        site = r.name[len(perfstats.READ):]
        counts[site] = counts.get(site, 0) + 1
    assert counts == {"depth": 3, "tracked": 2, "light": 1}
    assert [len(st.results["se.read." + s]["data"]) for s in counts] \
        == [3, 2, 1]


def test_spans_under_a_profiler():
    """A recording ``torch.profiler`` turns the spans on and carries them
    as CPU operations of their names (no copy on a device's timeline)."""
    st = PerfStats()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.span("se.x.outer"), st.host_read("y"):
            torch.ones(3).sum()
    assert st.span("se.x.outer") is perfstats._NO_SPAN
    assert [r.path for r in st.export()] == [
        ("se.x.outer", "se.read.y"), ("se.x.outer",)]
    kinds = {e.name(): str(e.device_type())
             for e in prof.profiler.kineto_results.events()}
    assert kinds["se.x.outer"] == kinds["se.read.y"] == "DeviceType.CPU"
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith("se.") and e.is_user_annotation()]
    # the next profiler's first span starts a record of its own; spans
    # asked for between the two record nothing
    with st.span("se.x.between"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with st.span("se.x.next"):
            pass
    assert [r.path for r in st.export()] == [("se.x.next",)]


def _system():
    from supereight_tpu_torch.config import SlamConfig
    from supereight_tpu_torch.pipeline import DenseSLAMSystem
    z = np.load(os.path.join(REPO, "bench_data",
                             "synthetic_256_frames.npz"))
    cfg = SlamConfig(volume_size=(4.8,) * 3, volume_resolution=(64,) * 3,
                     compute_size_ratio=2, block_capacity=1024)
    slam = DenseSLAMSystem((240, 320), cfg, "cpu")
    slam.setPose(z["poses"][0])
    k = np.array([240.6, 240.0, 160.0, 120.0], np.float32) / 2
    return slam, z["depths"][:FRAMES], k


def _run(staged: bool):
    """FRAMES frames (frames 0-3 fuse, every frame allocates, raycasts
    from frame 3 on) and the renders after each: (the system, the
    renders, the per-frame lists of span names)."""
    torch.set_num_threads(1)
    slam, depths, k = _system()
    images, names = [], []
    for f in range(FRAMES):
        n0 = len(Stats.export())
        if staged:
            slam.step_staged(depths[f], k, f)
        else:
            slam.step(depths[f], k, f)
        images.append((slam.renderDepth(), slam.renderTrack(),
                       slam.renderVolume()))
        names.append([r.name for r in Stats.export()[n0:]])
    return slam, images, names


@pytest.fixture(scope="module")
def runs():
    off = _run(False)
    with Stats.tracing():
        on = _run(False)
        staged = _run(True)
    return off, on, staged


def test_every_stage_span_once_a_frame_in_step_and_step_staged(runs):
    _, (_, _, step), (_, _, staged) = runs
    assert all(not n for n in runs[0][2])          # tracing off
    for frames in (step, staged):
        for names in frames:
            for span in STAGES + RENDERS:
                assert names.count(span) == 1, (span, names)
            assert all(n.startswith("se.") and len(n.split(".")) == 3
                       for n in names)
    assert [sorted(set(n)) for n in step] == [sorted(set(n)) for n in staged]
    seen = set().union(*map(set, step))
    # the parts on this path: a CPU map raycasts without a held view
    assert {"se.entry.upload", "se.tracking.pyramid", "se.tracking.icp",
            "se.integration.march", "se.integration.fuse",
            "se.raycasting.plan", "se.raycasting.pack_view",
            "se.raycasting.splat", "se.raycasting.scan",
            "se.raycasting.finish", "se.read.depth", "se.read.intrinsics",
            "se.read.tracked", "se.read.track_colors", "se.read.light",
            "se.read.ambient", "se.read.march_mask",
            "se.read.alloc_active"} <= seen
    # a frame's reads, each site its own: one upload of the depth and one
    # of the intrinsics, the tracked flag
    for names in step + staged:
        for site in ("tracked", "depth", "intrinsics"):
            assert names.count("se.read." + site) == 1


def test_parts_nest_in_their_stages():
    with Stats.tracing() as rec:
        _run(False)
    for r in rec:
        layer, part = r.name.split(".")[1:]
        if layer in ("preprocessing", "tracking", "integration",
                     "raycasting") and part != "stage":
            assert r.path[0] == f"se.{layer}.stage", r.path
        if layer == "read":
            assert len(r.path) > 1, r.path


def test_outputs_same_bits_with_tracing_on_and_off(runs):
    (a, ia, _), (b, ib, _), (c, ic, _) = runs
    for other, imgs in ((b, ib), (c, ic)):
        assert torch.equal(a.state.pose, other.state.pose)
        assert a.state.tracked == other.state.tracked
        for n in a.state.map.voxels:
            assert torch.equal(a.state.map.voxels[n],
                               other.state.map.voxels[n])
        assert torch.equal(a.state.map.keys, other.state.map.keys)
        assert torch.equal(a.state.ref_vertex, other.state.ref_vertex)
        for x, y in zip(ia, imgs):
            for u, v in zip(x, y):
                assert torch.equal(u, v)
