"""Map checkpoints of the PyTorch port against the JAX package
(`tests/test_io.py`'s serialisation cases): the reference's
``Octree::save`` binary written by both from the same maps (fused by the
JAX system over a few ground-truth frames, both fields) is byte for byte
the same, ``load_se`` gives back the JAX reader's tables, each package's
``load_map`` reads the other's npz checkpoint with every array equal, and
the reference's own parser (``csrc/se_bin_oracle_*``, where built) reads
the port's binary."""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration
from supereight_tpu.core import octree as jo
from supereight_tpu.core.octree import ChannelSpec as JaxSpec
from supereight_tpu.io import serialise as jser
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu_torch import convert
from supereight_tpu_torch.core import octree
from supereight_tpu_torch.core.octree import ChannelSpec
from supereight_tpu_torch.fields import make_field
from supereight_tpu_torch.io import serialise

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=["sdf", "ofusion"])
def fused(request):
    """A 128^3 map of the JAX system after 3 ground-truth frames at
    160x120 (128, not 64: the reference's own loader needs blocks below
    depth 3), and the same map in the port."""
    cfg = Configuration(volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
                        compute_size_ratio=2, integration_rate=1,
                        field_type=request.param, block_capacity=1024)
    depths, poses = load_frames()
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(3):
        slam.step(depths[f], K_FULL / 2, f, gt_pose=poses[f])
    jm = slam.state.map
    return dict(field=request.param, jax=jm, jfield=slam.field,
                port=convert.map_from_numpy(map_to_numpy(jm), "cpu"))


def _assert_maps_equal(tm, jm):
    assert (tm.size, tm.dim, tm.capacity) == (jm.size, jm.dim, jm.capacity)
    assert [(c.name, c.init, c.empty) for c in tm.channels] == \
        [(c.name, c.init, c.empty) for c in jm.channels]
    for name in ("block_index", "keys", "n_blocks", "active", "overflow"):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(),
            np.asarray(getattr(jm, name)).astype(
                getattr(tm, name).numpy().dtype), err_msg=name)
    for c in jm.channels:
        np.testing.assert_array_equal(tm.voxels[c.name].numpy(),
                                      np.asarray(jm.voxels[c.name]))
        for a, b in zip(tm.node_values, jm.node_values):
            np.testing.assert_array_equal(a[c.name].numpy(),
                                          np.asarray(b[c.name]))
    for a, b in zip(tm.node_alloc, jm.node_alloc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_save_se_bytes_match_jax(fused, tmp_path):
    ours, theirs = tmp_path / "port.bin", tmp_path / "jax.bin"
    serialise.save_se(str(ours), fused["port"])
    jser.save_se(str(theirs), fused["jax"])
    assert int(fused["port"].n_blocks) > 50
    assert ours.read_bytes() == theirs.read_bytes()


def test_load_se_matches_jax(fused, tmp_path):
    path = str(tmp_path / "map.bin")
    serialise.save_se(path, fused["port"])
    field = make_field(fused["field"])
    tm = serialise.load_se(path, field.channels,
                           capacity=fused["port"].capacity, device="cpu")
    jm = jser.load_se(path, fused["jfield"].channels,
                      capacity=fused["jax"].capacity)
    _assert_maps_equal(tm, jm)
    # the blocks and voxels of the map it came from, slot for slot
    n = int(fused["port"].n_blocks)
    assert int(tm.n_blocks) == n
    assert torch.equal(tm.keys[:n], fused["port"].keys[:n])
    for c in field.channels:
        assert torch.equal(tm.voxels[c.name][:n],
                           fused["port"].voxels[c.name][:n])


def test_checkpoints_load_both_ways(fused, tmp_path):
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    serialise.save_map(ours, fused["port"])
    jser.save_map(theirs, fused["jax"])
    _assert_maps_equal(serialise.load_map(theirs, device="cpu"),
                       fused["jax"])
    back = jser.load_map(ours)
    _assert_maps_equal(fused["port"], back)
    assert np.asarray(back.keys).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(back.part_counts),
                                  [int(fused["port"].n_blocks)])
    # the port's own round trip keeps its dtypes
    again = serialise.load_map(ours, device="cpu")
    assert again.keys.dtype == torch.int64
    assert again.channels == fused["port"].channels


def test_reference_parser_reads_port_binary(fused, tmp_path):
    """The reference's own ``Octree::load`` / ``save`` on the port's file
    (as `tests/test_io.py` runs it on the JAX package's): its block count,
    and its checksum of each block's first voxel (the only one its load
    restores) plus 511 init values a block."""
    tool = os.path.join(REPO, "csrc", f"se_bin_oracle_{fused['field']}")
    if not os.path.exists(tool):
        pytest.skip("csrc se_bin_oracle not built")
    m = fused["port"]
    ours, resaved = str(tmp_path / "ours.bin"), str(tmp_path / "resaved.bin")
    serialise.save_se(ours, m)
    out = subprocess.run([tool, ours, resaved], capture_output=True,
                         text=True, timeout=300, check=True)
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    n = int(m.n_blocks)
    assert stats["blocks"] == n
    first = m.channels[0]
    x = m.voxels[first.name][:n].numpy()
    expect = float(x[:, 0].sum() + 511 * first.init * n)
    assert abs(stats["sum_x"] - expect) < 1e-3 * max(1, abs(expect))


def test_checkpoint_roundtrip_of_any_channels(tmp_path):
    """`test_io.py`'s checkpoint case: a one-channel map, written by the
    port, read back by both packages."""
    chans = (ChannelSpec("v", torch.float32, 0.0, -1.0),)
    m = octree.init(32, 2.0, chans, "cpu", capacity=128)
    m = octree.allocate_blocks(m, torch.tensor([[0, 0, 0], [2, 3, 1]]),
                               torch.ones(2, dtype=torch.bool))
    m = octree.set_voxels(m, "v", torch.tensor([1]), torch.tensor([2]),
                          torch.tensor([3]), torch.tensor([7.5]))
    path = str(tmp_path / "map.npz")
    serialise.save_map(path, m)
    m2 = serialise.load_map(path, device="cpu")
    assert int(m2.n_blocks) == 2 and m2.channels == chans
    assert float(octree.get(m2, "v", torch.tensor(1), torch.tensor(2),
                            torch.tensor(3))) == 7.5
    assert torch.equal(m2.block_index, m.block_index)
    j = jser.load_map(path)
    assert float(jo.get(j, "v", 1, 2, 3)) == 7.5
    np.testing.assert_array_equal(np.asarray(j.block_index),
                                  m.block_index.numpy())


def test_partitioned_checkpoint_raises(tmp_path):
    """A partitioned JAX checkpoint used to raise (partitions were not
    ported); it now loads with its partitioning, and the port's save of
    it loads back in JAX.  What still raises: part counts that disagree
    with ``n_blocks``."""
    jm = jo.init(64, 4.8, (JaxSpec("v", jnp.float32, 0.0, 0.0),),
                 capacity=64, partitions=4)
    jm = jo.allocate_block_mask(jm, jnp.zeros((8, 8, 8), bool)
                                .at[1, 2, 3].set(True).at[6, 0, 0].set(True))
    path = str(tmp_path / "map.npz")
    jser.save_map(path, jm)
    m = serialise.load_map(path, device="cpu")
    assert m.partitions == 4 and m.part_counts.tolist() == [1, 0, 0, 1]
    np.testing.assert_array_equal(m.block_index.numpy(),
                                  np.asarray(jm.block_index))
    path2 = str(tmp_path / "map2.npz")
    serialise.save_map(path2, m)
    j2 = jser.load_map(path2)
    assert j2.partitions == 4
    np.testing.assert_array_equal(np.asarray(j2.part_counts), [1, 0, 0, 1])
    d = dict(np.load(path))
    d["part_counts"] = np.array([2, 0, 0, 1], np.int32)
    np.savez(path, **d)
    with pytest.raises(ValueError, match="part_counts"):
        serialise.load_map(path, device="cpu")
