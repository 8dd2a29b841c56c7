"""The per-layer metric ``raycast.graph_replay_pct`` on a hand-made span
record."""


def test_graph_replay_pct_reads_a_hand_made_lap(monkeypatch):
    """``raycast.graph_replay_pct`` on a record of four frames: one
    capture (its warm-up's and its capture's plan spans inside it), two
    replays and one eager raycast; none where the lap raycast nothing."""
    from supereight_tpu_torch.utils.perfstats import Stats

    from slambench import harness
    st, rc = "se.raycasting.stage", "se.raycasting."
    capture = (st, rc + "graph.capture")
    frames = [(("se.preprocessing.stage",), 10, 10) for _ in range(4)]
    lap = frames + [
        (capture + (rc + "plan",), 5, 5), (capture + (rc + "plan",), 5, 5),
        (capture, 100, 90), ((st, rc + "graph.replay"), 20, 20),
        ((st, rc + "graph.replay"), 20, 20), ((st, rc + "plan"), 5, 5)]
    monkeypatch.setattr(Stats, "_spans", lap)
    assert harness.read_metric("raycast.graph_replay_pct",
                               {"frames": 4}) == 50.0
    monkeypatch.setattr(Stats, "_spans", frames)
    assert harness.read_metric("raycast.graph_replay_pct",
                               {"frames": 4}) is None
