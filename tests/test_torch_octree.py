"""Block map of the PyTorch port against the JAX package: Morton block
keys, slot assignment with ``allocate_block_mask`` and ``allocate_blocks``
(including a capacity that overflows), ``allocate_octants``,
``set_voxels``, the counters, ``axis_aligned_map``, the dense packers and
the carried-over map.  Every output is integer or
boolean and must match bit for bit.  Also checks that the port imports no
JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.core import morton as jmorton
from supereight_tpu.core import octree as joct
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import morton, octree
from supereight_tpu_torch.fields import SDFField

from torch_port_util import map_to_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_block_key_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 1024, (3, 4096)).astype(np.int32)
    want = np.asarray(jmorton.block_key(*(jnp.asarray(v, jnp.uint32)
                                          for v in c)))
    got = morton.block_key(*(torch.from_numpy(v) for v in c)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    back = morton.block_key_decode(torch.from_numpy(got))
    for axis in range(3):
        np.testing.assert_array_equal(back[axis].numpy(), c[axis])


def _masks(B, seed, n):
    rng = np.random.default_rng(seed)
    return [rng.random((B, B, B)) < 0.15 for _ in range(n)]


@pytest.mark.parametrize("capacity", [4096, 150])
def test_allocate_block_mask_matches_jax(capacity):
    """Three successive allocations on a 16^3-block grid; at capacity 150
    the first already overflows and the rest only re-activate."""
    size, B = 128, 16
    jm = joct.init(size, 4.8, JaxSDF().channels, capacity=capacity)
    tm = octree.init(size, 4.8, SDFField().channels, "cpu",
                     capacity=capacity)
    for wanted in _masks(B, capacity, 3):
        jm = joct.allocate_block_mask(jm, jnp.asarray(wanted))
        tm = octree.allocate_block_mask(tm, torch.from_numpy(wanted))
        np.testing.assert_array_equal(tm.block_index.numpy(),
                                      np.asarray(jm.block_index))
        np.testing.assert_array_equal(tm.keys.numpy(),
                                      np.asarray(jm.keys).astype(np.int64))
        assert int(tm.n_blocks) == int(jm.n_blocks)
        assert int(tm.overflow) == int(jm.overflow)
        np.testing.assert_array_equal(tm.active.numpy(),
                                      np.asarray(jm.active))
        np.testing.assert_array_equal(octree.slot_mask(tm).numpy(),
                                      np.asarray(joct.slot_mask(jm)))
        np.testing.assert_array_equal(
            octree.block_coords_table(tm).numpy(),
            np.asarray(joct.block_coords_table(jm)))
    if capacity == 150:
        assert int(tm.overflow) > 0 and int(tm.n_blocks) == capacity
    else:
        assert int(tm.overflow) == 0


def test_map_from_numpy_carries_every_field():
    jm = joct.init(64, 2.4, JaxSDF().channels, capacity=64)
    jm = joct.allocate_block_mask(jm, jnp.asarray(_masks(8, 3, 1)[0]))
    tm = convert.map_from_numpy(map_to_numpy(jm), "cpu")
    assert (tm.size, tm.dim, tm.capacity) == (64, 2.4, 64)
    for name in ("block_index", "n_blocks", "active", "overflow"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))
    for name in ("tsdf", "weight"):
        np.testing.assert_array_equal(tm.voxels[name].numpy(),
                                      np.asarray(jm.voxels[name]))
    assert len(tm.node_alloc) == len(jm.node_alloc) == tm.block_level + 1
    # and it keeps allocating where the JAX map would
    wanted = _masks(8, 4, 1)[0]
    jm = joct.allocate_block_mask(jm, jnp.asarray(wanted))
    tm = octree.allocate_block_mask(tm, torch.from_numpy(wanted))
    np.testing.assert_array_equal(tm.block_index.numpy(),
                                  np.asarray(jm.block_index))


def _random_maps(seed):
    """A 64^3 OFusion map with random blocks, coarse octant requests at
    every level and random channels and node values, built alike in both
    packages."""
    from supereight_tpu.fields.ofusion import OFusionField as JaxOF
    from supereight_tpu_torch.fields import OFusionField
    rng = np.random.default_rng(seed)
    coords = rng.integers(-4, 68, (300, 3)).astype(np.int32)
    levels = rng.integers(0, 7, 300).astype(np.int32)
    valid = rng.random(300) < 0.9
    jm = joct.init(64, 4.8, JaxOF().channels, capacity=48)
    tm = octree.init(64, 4.8, OFusionField().channels, "cpu", capacity=48)
    jm = joct.allocate_octants(jm, jnp.asarray(coords), jnp.asarray(levels),
                               jnp.asarray(valid))
    tm = octree.allocate_octants(tm, torch.from_numpy(coords),
                                 torch.from_numpy(levels),
                                 torch.from_numpy(valid))
    vals = {n: rng.uniform(-5, 5, (48, 512)).astype(np.float32)
            for n in ("occupancy", "timestamp")}
    nodes = [{n: rng.uniform(-5, 5, a.shape).astype(np.float32)
              for n in vals} for a in jm.node_alloc]
    jm = jm.replace(voxels={n: jnp.asarray(v) for n, v in vals.items()},
                    node_values=[{n: jnp.asarray(v) for n, v in lv.items()}
                                 for lv in nodes])
    tm = tm.replace(voxels={n: torch.from_numpy(v) for n, v in vals.items()},
                    node_values=[{n: torch.from_numpy(v)
                                  for n, v in lv.items()} for lv in nodes])
    return jm, tm


@pytest.mark.parametrize("seed", [0, 1])
def test_octree_additions_match_jax(seed):
    """allocate_octants (over the capacity: 48 slots), set_voxels (writes
    outside allocated blocks dropped), the counters, axis_aligned_map and
    the dense packers give the JAX package's tables bit for bit."""
    jm, tm = _random_maps(seed)
    eq = lambda t, j: np.testing.assert_array_equal(
        t.numpy(), np.asarray(j).astype(t.numpy().dtype))
    for name in ("block_index", "keys", "n_blocks", "active", "overflow"):
        eq(getattr(tm, name), getattr(jm, name))
    assert int(tm.overflow) > 0
    for a, b in zip(tm.node_alloc, jm.node_alloc):
        eq(a, b)
    eq(octree.leaves_count(tm), joct.leaves_count(jm))
    eq(octree.nodes_count(tm), joct.nodes_count(jm))
    assert int(octree.nodes_count(tm)) > int(tm.n_blocks)

    rng = np.random.default_rng(seed + 10)
    v = rng.integers(-3, 67, (3, 4000)).astype(np.int32)
    x = rng.uniform(-1, 1, 4000).astype(np.float32)
    jm = joct.set_voxels(jm, "occupancy", *(jnp.asarray(a) for a in v),
                         jnp.asarray(x))
    tm = octree.set_voxels(tm, "occupancy", *(torch.from_numpy(a) for a in v),
                           torch.from_numpy(x))
    eq(tm.voxels["occupancy"], jm.voxels["occupancy"])

    jm = joct.axis_aligned_map(jm, lambda d, c: {
        "occupancy": d["occupancy"] + c[..., 0] - 0.5 * c[..., 2],
        "timestamp": (c[..., 1] % 7).astype(jnp.float32)})
    tm = octree.axis_aligned_map(tm, lambda d, c: {
        "occupancy": d["occupancy"] + c[..., 0] - 0.5 * c[..., 2],
        "timestamp": (c[..., 1] % 7).to(torch.float32)})
    for n in ("occupancy", "timestamp"):
        eq(tm.voxels[n], jm.voxels[n])
        eq(octree.pack_tiled(tm, n), joct.pack_tiled(jm, n))
        eq(octree.pack_dense(tm, n), joct.pack_dense(jm, n))
        eq(octree.pack_dense_multiscale(tm, n),
           joct.pack_dense_multiscale(jm, n))
    dense = rng.uniform(-2, 2, (64, 64, 64)).astype(np.float32)
    jm = joct.unpack_dense(jm, "occupancy", jnp.asarray(dense))
    tm = octree.unpack_dense(tm, "occupancy", torch.from_numpy(dense))
    eq(tm.voxels["occupancy"], jm.voxels["occupancy"])
    # pack_dense inverts unpack_dense on the allocated blocks
    back = octree.pack_dense(tm, "occupancy")
    cells = octree._upsample(tm.block_index >= 0, 8)
    assert torch.equal(back[cells], torch.from_numpy(dense)[cells])


@pytest.mark.parametrize("partitions", [1, 2])
def test_tile_rows_keeps_dead_slots_out(partitions):
    """``tile_rows`` scatters every slot, the dead ones (past each
    partition's count, holding stale keys of live blocks and garbage rows)
    into a scratch row that is cut off: the view holds each live slot's
    row at its block's row and the fill everywhere else, as a scatter of
    the live slots alone gives it."""
    rng = np.random.default_rng(7 + partitions)
    cap, B = 64, 8
    m = octree.init(64, 4.8, SDFField().channels, "cpu", capacity=cap,
                    partitions=partitions)
    cells = rng.permutation(B ** 3)[:cap].astype(np.int64)
    keys = morton.block_key(*(torch.from_numpy(c) for c in np.unravel_index(
        cells, (B,) * 3)))
    counts = [20, 9] if partitions == 2 else [37]
    per = cap // partitions
    live = np.zeros(cap, bool)
    for p, n in enumerate(counts):
        live[p * per:p * per + n] = True
    dead = np.flatnonzero(~live)
    keys[dead[:8]] = keys[np.flatnonzero(live)[:8]]    # stale keys
    m = m.replace(keys=keys, n_blocks=torch.tensor(sum(counts),
                                                   dtype=torch.int32),
                  part_counts=torch.tensor(counts, dtype=torch.int32))
    rows = torch.from_numpy(rng.normal(size=(cap, 512)).astype(np.float32))
    fill = torch.from_numpy(rng.normal(size=B ** 3).astype(np.float32))
    got = octree.tile_rows(fill, m, rows)
    want = fill[:, None].expand(-1, 512).clone()
    for slot in np.flatnonzero(live):
        want[octree.block_rows(m)[slot]] = rows[slot]
    assert got.shape == (B ** 3, 512) and got.is_contiguous()
    assert torch.equal(got, want)


def test_allocate_blocks_matches_jax():
    """Out-of-bounds and invalid requests, with duplicates."""
    rng = np.random.default_rng(4)
    c = rng.integers(-2, 18, (500, 3)).astype(np.int32)
    valid = rng.random(500) < 0.7
    jm = joct.init(128, 4.8, JaxSDF().channels, capacity=300)
    tm = octree.init(128, 4.8, SDFField().channels, "cpu", capacity=300)
    jm = joct.allocate_blocks(jm, jnp.asarray(c), jnp.asarray(valid))
    tm = octree.allocate_blocks(tm, torch.from_numpy(c),
                                torch.from_numpy(valid))
    for name in ("block_index", "n_blocks", "active", "overflow"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(tm.keys.numpy(), np.asarray(jm.keys))


def test_port_imports_no_jax():
    """Every module of the port (its io, apps, tools and utils too) and
    ``chip_smoke.py`` import with JAX and flax made unimportable, and none
    of them loads the JAX package."""
    code = r"""
import importlib, pkgutil, sys
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "flax"):
        del sys.modules[name]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import supereight_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for sub in ("io", "apps", "tools", "utils"):
    assert any(n.startswith(f"supereight_tpu_torch.{sub}.") for n in names)
for mod in ("core.algorithms", "core.collision", "core.meshing",
            "core.morton", "io.serialise", "io.vtk", "apps.viewer",
            "utils.power", "parallel.sharding", "parallel.allocation_dist",
            "parallel.tracking_dist", "parallel.raycast_dist",
            "parallel.frame_dist", "parallel.multihost", "ops.icp_kernel",
            "probes.stage_times"):
    assert "supereight_tpu_torch." + mod in names, mod
import chip_smoke
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "flax")
       or n.split(".")[0] == "supereight_tpu"]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
