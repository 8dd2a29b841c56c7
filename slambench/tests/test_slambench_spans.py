"""The per-layer metrics that read the port's own spans
(``slambench/spans.py``), and the trace's reading left as it was by the
spans the profiler now carries."""

from slambench import trace


SPAN_METRICS = ("dispatch.enqueue_ms_per_frame",
                "dispatch.read_wait_ms_per_frame", "raycast.enqueue_ms",
                "integration.march_ms")


def test_traced_line_reads_the_spans(traced):
    for n in SPAN_METRICS:
        assert traced["metrics"][n]["value"] > 0, n
        assert traced["metrics"][n]["unit"] == "ms"
    m = {n: traced["metrics"][n]["value"] for n in SPAN_METRICS}
    # the raycast's enqueue is part of the frame's, and the staged host
    # times hold the enqueue and the reads (and the device's drain)
    assert m["raycast.enqueue_ms"] < m["dispatch.enqueue_ms_per_frame"]
    staged = sum(traced["metrics"][n]["value"] for n in (
        "preprocessing.ms", "tracking.ms", "integration.ms", "raycast.ms",
        "rendering.ms"))
    assert m["dispatch.enqueue_ms_per_frame"] \
        + m["dispatch.read_wait_ms_per_frame"] < staged


def test_lap_is_the_profiled_frames_alone(tiny_root, monkeypatch):
    """Frames run with tracing off and no profiler leave the readers
    nothing; frames under a profiler are the record, and frames after it
    leave the record as it was."""
    import os

    import torch
    from supereight_tpu_torch.utils.perfstats import Stats
    from torch.profiler import ProfilerActivity, profile

    from slambench import harness, spans
    from slambench.tests.conftest import TINY
    monkeypatch.setattr(Stats, "_spans", [])
    cell = harness.load_cell(TINY, tiny_root)
    runner = harness.Runner(cell, 2 ** 33 + 7, torch.device("cpu"),
                            os.path.join(tiny_root, "cache"))
    for i in range(2):
        runner.frame(i)
    assert spans.lap() is None
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2, 5):
            runner.frame(i)
    runner.frame(5)
    assert spans.frames(spans.lap()) == 3


def test_readers_find_nothing_without_the_ports_spans(monkeypatch):
    """Run over a port that has no spans (a checkout from before them),
    the readers return None and raise nothing."""
    from supereight_tpu_torch.utils import perfstats

    from slambench import harness
    monkeypatch.delattr(perfstats.PerfStats, "export")
    for n in SPAN_METRICS:
        assert harness.read_metric(n, {"frames": 72}) is None


def _events(with_spans: bool):
    """A synthetic lap of two frames: the harness's spans, kernels, the
    harness's syncs and a program read; with the port's ``se.`` spans on
    the host and their copies on the device."""
    E = trace.Event
    ev = [E("slambench.window", "user_annotation", 0, 1000, False)]
    for f in range(2):
        t = 500 * f
        ev += [E("slambench.tracking", "user_annotation", t + 10, t + 200,
                 False),
               E("icp", "kernel", t + 50, t + 120, True),
               E("cudaStreamSynchronize", "cuda_runtime", t + 130, t + 140,
                 False),
               E("slambench.sync", "user_annotation", t + 150, t + 200,
                 False),
               E("cudaDeviceSynchronize", "cuda_runtime", t + 160, t + 190,
                 False),
               E("slambench.raycasting", "user_annotation", t + 210,
                 t + 480, False),
               E("scan", "kernel", t + 300, t + 310, True)]
        if with_spans:
            ev += [E("se.tracking.stage", "user_annotation", t + 12,
                     t + 145, False),
                   E("se.read.tracked", "user_annotation", t + 125, t + 145,
                     False),
                   E("se.tracking.stage", "gpu_user_annotation", t + 50,
                     t + 120, True),
                   E("se.raycasting.stage", "user_annotation", t + 215,
                     t + 470, False),
                   E("se.raycasting.scan", "user_annotation", t + 290,
                     t + 305, False),
                   E("se.raycasting.scan", "gpu_user_annotation", t + 300,
                     t + 310, True)]
    return sorted(ev, key=lambda e: e.start)


def test_summarize_reads_the_same_with_the_ports_spans():
    plain, spanned = (trace.summarize(_events(w)) for w in (False, True))
    assert plain == spanned
    assert plain["kernels"] == 4 and plain["host_reads"] == 2
    assert {n for n, _ in plain["idle_gaps"]} <= {"tracking", "raycasting",
                                                  "harness"}
