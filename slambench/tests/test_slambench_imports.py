"""No run of a cell and nothing of the reference loads JAX or the JAX
package; the reference loads nothing of the port.  Names are compared by
their whole top-level part: the port's name begins with the JAX
package's."""

import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "supereight_tpu"}


def _top(names):
    return {n.split(".", 1)[0] for n in names}


def _loaded(code: str, cwd: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_jax_and_nothing_of_the_port():
    mods = _top(_loaded(
        "import sys, json; import slambench.reference.slam, "
        "slambench.check; print(json.dumps(sorted(sys.modules)))", ROOT))
    assert not mods & FORBIDDEN
    assert "supereight_tpu_torch" not in mods


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_tiny_run_of_each_cell_loads_no_jax(cell, tmp_path):
    """Each cell, cut to a CPU run (``conftest.shrink``), run through the
    harness in a fresh interpreter."""
    code = f"""
import json, sys, time, torch
sys.path.insert(0, {os.path.join(ROOT, 'slambench', 'tests')!r})
from conftest import make_root, tiny_run
root = make_root({str(tmp_path)!r}, {cell!r})
res = tiny_run(root, traced=True)
assert res["attempted"] > 0
print(json.dumps(sorted(sys.modules)))
"""
    mods = _top(_loaded(code, str(tmp_path)))
    assert "supereight_tpu_torch" in mods
    assert not mods & FORBIDDEN
