"""BENCHMARK.json, the files it names and the result line."""

import json
import os
import re

from slambench import check

from .conftest import ROOT, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["slambench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(ROOT, "slambench", "metrics",
                                           m["name"] + ".py"))
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"slambench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert set(cfg["limits"]) == set(check.NUMBERS)
        assert cfg["reduced"] == c["reduced"]
    pairs = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            ROOT, "slambench", "traffic", w["traffic"] + ".json"))
        assert len(w["why"]) <= 200
    assert len(json.dumps(b)) < 64 * 1024


def _line_schema(res, names):
    assert list(res)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert isinstance(res["correct"], bool)
    assert res["attempted"] > 0 and 0 <= res["failed"] <= res["attempted"]
    units = {m["name"]: m["unit"] for m in bench()["end_to_end"]
             + bench()["per_layer"]}
    units["tiny.frames"] = "frames"
    for n, m in res["metrics"].items():
        assert n in names and m["unit"] == units[n]
        assert isinstance(m["value"], float)
    for n in check.NUMBERS:
        assert set(res["check"][n]) == {"value", "limit"}
    json.dumps(res)


def test_untraced_line(untraced):
    _line_schema(untraced, {"frames_per_s", "frame_ms_p95", "setup_s"})
    assert set(untraced["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                        "setup_s"}


def test_traced_line_adds_the_new_metric(traced):
    """The copy's new configuration, mix and metric ran with no edit to a
    file the benchmark had: the metric's reader found its cell."""
    names = {m["name"] for m in bench()["per_layer"]} | {"tiny.frames"}
    _line_schema(traced, names)
    assert traced["metrics"]["tiny.frames"]["value"] == 72.0
    for n in ("preprocessing.ms", "tracking.ms", "integration.ms",
              "integration.ms_p95", "raycast.ms", "rendering.ms"):
        assert traced["metrics"][n]["value"] > 0
    # no device on the CPU: the trace's readers find nothing to read
    for n in ("dispatch.launches_per_frame", "kernels_roofline",
              "device.idle_pct"):
        assert n not in traced["metrics"]
    assert TINY not in {w["name"] for w in bench()["workloads"]}
