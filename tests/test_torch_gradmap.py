"""The stored gradient table of the PyTorch port (``pipeline/gradmap.py``)
against the JAX package's on JAX maps carried over by
``convert.map_from_numpy``: an SDF map of the headline knobs and an OFusion
map of the ``ofusion`` preset (128^3, 160x120 frames).

``build_table`` (bf16 [capacity, 512, 4]) equals the jitted JAX function's
bit for bit in every component, the NaN pattern of F included, for both
fields; ``empty_table`` equals JAX's; ``sample`` gives the same gradient,
value and validity bits at random voxel positions, outside the volume and
unallocated ones included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supereight_tpu.config import Configuration, apply_preset
from supereight_tpu.fields.ofusion import OFusionField as JaxOFusion
from supereight_tpu.fields.sdf import SDFField as JaxSDF
from supereight_tpu.pipeline import DenseSLAMSystem as JaxSLAM
from supereight_tpu.pipeline import gradmap as jgm
from supereight_tpu_torch import convert
from supereight_tpu_torch.fields import OFusionField, SDFField
from supereight_tpu_torch.pipeline import gradmap

from torch_port_util import K_FULL, load_frames, map_to_numpy

torch.set_num_threads(1)

VS = 4.8 / 128
FIELDS = {"sdf": ("headline", 6, JaxSDF(mu=0.1), SDFField(mu=0.1)),
          "ofusion": ("ofusion", 5, JaxOFusion(mu=0.05, voxel_size=VS),
                      OFusionField(mu=0.05, voxel_size=VS))}


@pytest.fixture(scope="module", params=sorted(FIELDS))
def maps(request):
    preset, frames, jfield, tfield = FIELDS[request.param]
    depths, poses = load_frames()
    cfg = apply_preset(preset, Configuration(
        volume_resolution=(128,) * 3, volume_size=(4.8,) * 3,
        block_capacity=4096, compute_size_ratio=2))
    slam = JaxSLAM((240, 320), cfg)
    slam.setPose(poses[0])
    for f in range(frames):
        slam.step(depths[f], K_FULL / 2, f)
    jm = slam.state.map
    return dict(jmap=jm, jfield=jfield, tfield=tfield,
                tmap=convert.map_from_numpy(map_to_numpy(jm), "cpu"))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.to(torch.float32).numpy()


def test_build_table_matches_jax(maps):
    want = jax.jit(jgm.build_table, static_argnums=1)(maps["jmap"],
                                                      maps["jfield"])
    got = gradmap.build_table(maps["tmap"], maps["tfield"])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(want.shape) == (4096, 512, 4)
    w, g = _f32(want), _f32(got)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(g, w)     # NaN == NaN here
    live = int(maps["jmap"].n_blocks)
    # the live rows hold gradients and values, observed and not
    assert np.abs(w[:live, :, :3]).max() > 0
    assert 0 < np.isnan(w[:live, :, 3]).mean() < 1
    assert np.isnan(w[live:, :, 3]).all() and not w[live:, :, :3].any()


def test_empty_table_matches_jax():
    w, g = _f32(jgm.empty_table(64)), _f32(gradmap.empty_table(64, "cpu"))
    np.testing.assert_array_equal(g, w)
    assert gradmap.empty_table(64, "cpu").dtype == torch.bfloat16


def test_sample_matches_jax(maps):
    rng = np.random.default_rng(3)
    jtab = jgm.build_table(maps["jmap"], maps["jfield"])
    ttab = gradmap.build_table(maps["tmap"], maps["tfield"])
    # voxel coordinates over and around the volume, and at the live blocks'
    # voxels
    pos = rng.uniform(-8, 136, (4096, 3)).astype(np.float32)
    keys = np.asarray(maps["jmap"].keys)[:int(maps["jmap"].n_blocks)]
    bc = maps["tmap"].keys.new_tensor(keys.astype(np.int64))
    from supereight_tpu_torch.core import morton
    blocks = torch.stack(morton.block_key_decode(bc), -1).numpy()
    near = (blocks[rng.integers(0, len(blocks), 4096)] * 8
            + rng.uniform(0, 8, (4096, 3))).astype(np.float32)
    pos = np.concatenate([pos, near])
    jg, jF, jok = jgm.sample(maps["jmap"], jtab, jnp.asarray(pos))
    tg, tF, tok = gradmap.sample(maps["tmap"], ttab, torch.from_numpy(pos))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tF.numpy(), np.asarray(jF))
    assert 0.3 < tok.numpy().mean() < 0.9
