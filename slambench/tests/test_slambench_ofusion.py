"""The plain reference and the check over the OFusion field: a tiny
OFusion cell (the kept ``ofusion512-demo`` configuration cut by
``conftest.shrink``) run through the harness on the CPU, its control, the
faults that must turn ``correct`` false, the knobs ``load_cell`` refuses,
and the work counts."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from slambench import check, harness, work

from .conftest import BENCH, ROOT, TINY, make_root, shrink, tiny_run

KEPT = "ofusion512-demo"
#: the tiny cell's raycast limit: at 128^3 a voxel is 4 times the kept
#: configuration's, and the port's bf16 read view moves 7.6-10.2 % of the
#: pixels past the check's tolerance on 12 seeds (its control reads 62.2 %
#: or more on the same seeds); the kept limit holds the 512^3 reading
TINY_RAYCAST_PCT = 20.0


def make_ofusion_root(dst: str, **system) -> str:
    """``conftest.make_root``'s copy with the tiny cell's configuration
    replaced by the kept OFusion one, cut to a CPU run (``system``
    overrides its knobs)."""
    make_root(dst)
    with open(os.path.join(BENCH, "configs", KEPT + ".json")) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", "handheld.json")) as f:
        mix = json.load(f)
    config, _ = shrink(config, mix)
    config["system"].update(system)
    config["limits"]["raycast_pct"] = TINY_RAYCAST_PCT
    with open(os.path.join(dst, "slambench", "configs", "tiny.json"),
              "w") as f:
        json.dump(config, f)
    return dst


@pytest.fixture(scope="module")
def ofu_root(tmp_path_factory):
    return make_ofusion_root(str(tmp_path_factory.mktemp("ofusion")))


@pytest.fixture(scope="module")
def ofu_untraced(ofu_root):
    return tiny_run(ofu_root, control="bf16")


@pytest.fixture(scope="module")
def ofu_traced(ofu_root):
    return tiny_run(ofu_root, traced=True)


def test_load_cell_accepts_the_kept_configuration(tmp_path):
    """A copy that lists the kept configuration's cell loads it whole."""
    root = make_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"][-1]["config"] = KEPT
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = harness.load_cell(TINY, root)
    assert (cell.system.field_type, cell.system.raycast_normals,
            cell.system.raycast_near_rescue) == ("ofusion", "exact", False)
    assert (cell.H, cell.W, cell.size, cell.system.mu) == (480, 640, 512,
                                                           0.008)


def test_the_tiny_cell_runs_ofusion(ofu_root):
    cell = harness.load_cell(TINY, ofu_root)
    assert cell.system.field_type == "ofusion"
    assert cell.system.raycast_normals == "exact"
    assert (cell.H, cell.W, cell.size) == (120, 160, 128)


def test_reference_holds_a_tiny_ofusion_run(ofu_untraced, ofu_traced):
    for res in (ofu_untraced, ofu_traced):
        assert res["correct"], res["check"]
        assert res["failed"] < res["attempted"]


def test_control_fails(ofu_untraced):
    """The reference in bfloat16 in the port's place fails a number."""
    limits = {n: ofu_untraced["check"][n]["limit"] for n in check.NUMBERS}
    assert not check.verdict(ofu_untraced["control"], limits)


def _unchanged(system, monkeypatch):
    monkeypatch.setattr(system, "process_frame",
                        lambda state, *a, **kw: state)


def _half(system, monkeypatch):
    orig = system.process_frame

    def f(state, depth_mm, *a, **kw):
        d = depth_mm.clone()
        d[:, d.shape[1] // 2:] = 0
        return orig(state, d, *a, **kw)
    monkeypatch.setattr(system, "process_frame", f)


def _altered(system, monkeypatch):
    orig = system.process_frame

    def f(state, *a, **kw):
        st = orig(state, *a, **kw)
        pose = st.pose.clone()
        pose[0, 3] += 2e-3
        return st.replace(pose=pose)
    monkeypatch.setattr(system, "process_frame", f)


def _no_decay(system, monkeypatch):
    """The fusion's time decay dropped: 1 / (1 + dt / inf) is 1."""
    from supereight_tpu_torch.fields import ofusion
    monkeypatch.setattr(ofusion, "CAPITAL_T", float("inf"))


def _no_octants(system, monkeypatch):
    """The march's coarse octants left unallocated: only its blocks."""
    from supereight_tpu_torch.core import octree
    blocks = octree.allocate_block_mask
    monkeypatch.setattr(octree, "allocate_octant_masks",
                        lambda m, masks: blocks(m, masks[m.block_level]))


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered, _no_decay,
                                   _no_octants],
                         ids=["state_unchanged", "half_the_frame",
                              "pose_altered", "decay_dropped",
                              "coarse_octants_unallocated"])
def test_a_broken_frame_is_not_correct(fault, ofu_root, monkeypatch):
    """The timed path broken underneath the harness."""
    from supereight_tpu_torch.pipeline import system
    fault(system, monkeypatch)
    assert not tiny_run(ofu_root)["correct"]


@pytest.mark.parametrize("knob", [dict(raycast_normals="hybrid"),
                                  dict(field_type="tsdf_occupancy"),
                                  dict(raycast_normals="stored"),
                                  dict(integrate_budget=3072)],
                         ids=["hybrid_normals", "third_field",
                              "stored_normals", "budget"])
def test_load_cell_refuses_what_the_reference_does_not_follow(knob,
                                                              tmp_path):
    root = make_ofusion_root(str(tmp_path), **knob)
    with pytest.raises(SystemExit):
        harness.load_cell(TINY, root)


def test_reference_loads_no_jax_and_nothing_of_the_port():
    code = ("import sys, json; import slambench.reference.ofusion, "
            "slambench.check; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = {n.split(".", 1)[0]
            for n in json.loads(out.stdout.splitlines()[-1])}
    assert not mods & {"jax", "jaxlib", "flax", "supereight_tpu",
                       "supereight_tpu_torch"}


def test_tiny_ofusion_run_loads_no_jax(tmp_path):
    """The tiny OFusion cell through the harness, traced, in a fresh
    interpreter."""
    code = f"""
import json, sys
sys.path.insert(0, {os.path.join(ROOT, 'slambench', 'tests')!r})
from slambench.tests.test_slambench_ofusion import make_ofusion_root
from slambench.tests.conftest import tiny_run
res = tiny_run(make_ofusion_root({str(tmp_path)!r}), traced=True)
assert res["attempted"] > 0
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    mods = {n.split(".", 1)[0]
            for n in json.loads(out.stdout.splitlines()[-1])}
    assert "supereight_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "supereight_tpu"}


#: ``work.frame_bytes`` of ``sdf256-icl`` before the OFusion count:
#: (frame, integrated, rendered, fused blocks, hit blocks, bilateral) ->
#: bytes
SDF_BYTES = [((0, True, True, 1234.5, 456.25, False), 57146368.0),
             ((3, False, False, 1234.5, 456.25, False), 40332800.0),
             ((4, True, False, 2048.0, 310.75, False), 58302976.0),
             ((5, False, True, 0.0, 512.0, False), 53963776.0),
             ((8, True, True, 1500.25, 0.0, False), 66696192.0),
             ((9, True, True, 100.0, 200.0, True), 58092544.0)]


@pytest.mark.parametrize("args,expected", SDF_BYTES,
                         ids=[str(a[0]) for a, _ in SDF_BYTES])
def test_sdf_frame_bytes_are_unchanged(args, expected):
    cell = harness.load_cell("sdf256-icl.handheld")
    assert work.frame_bytes(cell, *args) == expected
    assert work.frame_bytes(cell, *args, nodes=1e6) == expected


def test_ofusion_frame_bytes_add_the_masks_and_the_nodes(ofu_root):
    """An integrating OFusion frame moves the SDF frame's bytes, the
    octant masks of levels 0..4 at 128^3 read and written, and the node
    cells' two channels read and written; any other frame the SDF's."""
    cell = harness.load_cell(TINY, ofu_root)
    sdf = dataclasses.replace(cell, system=dataclasses.replace(
        cell.system, field_type="sdf"))
    masks = sum((1 << level) ** 3 for level in range(5))
    for frame, integrated in ((4, True), (5, False)):
        args = (cell, frame, integrated, True, 300.0, 200.0, False)
        extra = (2 * masks + 7 * 2 * 4 * 2) if integrated else 0
        assert work.frame_bytes(*args, nodes=7.0) == \
            work.frame_bytes(sdf, *args[1:], nodes=7.0) + extra
