"""A tiny cell in a temporary copy of the benchmark: a configuration, a
traffic mix and a per-layer metric that the copy adds as new files and new
``BENCHMARK.json`` entries, run on the CPU through the harness."""

import json
import os
import shutil
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
TINY = "tiny.tinyloop"


def shrink(config: dict, mix: dict, lap: int = 72):
    """A configuration and mix cut to a CPU test: 160x120 depth, 128^3
    voxels, the loop in ``lap`` frames swinging 30 degrees."""
    config = json.loads(json.dumps(config))
    mix = json.loads(json.dumps(mix))
    config["input_size"] = [120, 160]
    config["k"] = [v / 4.0 for v in config["k"]]
    config["system"]["volume_resolution"] = [128, 128, 128]
    config["system"].pop("block_capacity", None)
    mix["lap_frames"] = lap
    mix["orbit"]["swing_deg"] = 30
    return config, mix


def make_root(dst: str, workload: str = "sdf256-icl.handheld") -> str:
    """A copy of the benchmark under ``dst`` that adds the tiny cell's
    configuration, mix and metric as files and entries."""
    sb = os.path.join(dst, "slambench")
    shutil.copytree(BENCH, sb, ignore=shutil.ignore_patterns(
        "_cache", "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    with open(os.path.join(sb, "configs", entry["config"] + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(sb, "traffic", entry["traffic"] + ".json")) as f:
        mix = json.load(f)
    config["system"]["integration_rate"] = 2
    config, mix = shrink(config, mix)
    with open(os.path.join(sb, "configs", "tiny.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(sb, "traffic", "tinyloop.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(sb, "metrics", "tiny.frames.py"), "w") as f:
        f.write('"""Frames in the traced window."""\n\n\n'
                'def read(run):\n    return float(run["frames"])\n')
    bench["configs"].append({"name": "tiny", "source": "a test",
                             "file": "slambench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": TINY, "config": "tiny",
                               "traffic": "tinyloop", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "tiny.frames", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "tests", "moves": "frames_per_s",
                               "workloads": [TINY]})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def tiny_run(root, traced=False, seed=2 ** 33 + 7, control=None):
    from slambench import harness
    torch.set_num_threads(2)
    cell = harness.load_cell(TINY, root)
    return harness.run(cell, seed, 0.2, traced, torch.device("cpu"),
                       time.perf_counter(), root=root,
                       cache_dir=os.path.join(root, "cache"),
                       control=control)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def untraced(tiny_root):
    return tiny_run(tiny_root, control="bf16")


@pytest.fixture(scope="session")
def traced(tiny_root):
    return tiny_run(tiny_root, traced=True)
