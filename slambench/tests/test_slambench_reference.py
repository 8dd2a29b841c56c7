"""The plain reference against a tiny run of the port on the CPU, the
control, and the faults that must turn ``correct`` false."""

import json
import os

import pytest
import torch

from slambench import check

from .conftest import tiny_run


def test_reference_holds_a_tiny_port_run(untraced, traced):
    for res in (untraced, traced):
        assert res["correct"], res["check"]


def test_control_fails(untraced):
    """The reference in bfloat16 in the port's place fails a number."""
    limits = {n: untraced["check"][n]["limit"] for n in check.NUMBERS}
    assert not check.verdict(untraced["control"], limits)


def _unchanged(system):
    return lambda state, *a, **kw: state


def _half(system):
    orig = system.process_frame

    def f(state, depth_mm, *a, **kw):
        d = depth_mm.clone()
        d[:, d.shape[1] // 2:] = 0
        return orig(state, d, *a, **kw)
    return f


def _altered(system):
    orig = system.process_frame

    def f(state, *a, **kw):
        st = orig(state, *a, **kw)
        pose = st.pose.clone()
        pose[0, 3] += 2e-3
        return st.replace(pose=pose)
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_frame",
                              "pose_altered"])
def test_a_broken_frame_is_not_correct(fault, tiny_root, monkeypatch):
    """The timed path broken underneath the harness: a frame that returns
    its state unchanged, a frame with half its pixels left out, a pose
    altered where it is produced."""
    from supereight_tpu_torch.pipeline import system
    monkeypatch.setattr(system, "process_frame", fault(system))
    assert not tiny_run(tiny_root)["correct"]


@pytest.mark.gpu
def test_control_on_the_card():
    """On the card, the first cell at its own size: the port passes and
    the control fails (a short window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time
    from slambench import harness
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        cell = harness.load_cell(json.load(f)["workloads"][0]["name"])
    res = harness.run(cell, 424242, 1.0, False, torch.device("cuda", 0),
                      time.perf_counter(), control="bf16")
    assert res["correct"], res["check"]
    assert not check.verdict(res["control"], cell.limits)
