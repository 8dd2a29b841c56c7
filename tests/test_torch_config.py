"""The port's configuration against the JAX package's: the presets and the
noise regime are copies, key for key, and every preset of the JAX package
gives a SlamConfig the port runs."""

import dataclasses

import pytest

from supereight_tpu import config as jcfg
from supereight_tpu_torch import config
from supereight_tpu_torch.config import SlamConfig


def test_presets_equal_jax():
    assert config.PRESETS == jcfg.PRESETS
    assert list(config.PRESETS) == list(jcfg.PRESETS)
    assert config.NOISE_REGIME == jcfg.NOISE_REGIME


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_every_preset_is_ported(name):
    """``SlamConfig.of`` takes the JAX preset, and the port's own
    ``apply_preset`` gives the same knobs."""
    base = dict(volume_size=(4.8,) * 3, block_capacity=6144)
    want = SlamConfig.of(jcfg.apply_preset(name,
                                           jcfg.Configuration(**base)))
    got = config.apply_preset(name, SlamConfig(**base))
    assert got == want
    for key, value in config.PRESETS[name].items():
        assert getattr(got, key) == value, key


def test_apply_preset_pins_and_rejects():
    cfg = config.apply_preset("quality", SlamConfig(integration_rate=3),
                              pinned=("integration_rate",))
    assert (cfg.integration_rate, cfg.icp_symmetric) == (3, True)
    with pytest.raises(ValueError):
        config.apply_preset("nope")


@pytest.mark.parametrize("pinned", [(), ("mu",), ("field_type",)])
def test_noise_regime_matches_jax(pinned):
    want = jcfg.apply_noise_regime(
        jcfg.Configuration(bilateral_filter=True), pinned=pinned)
    got = config.apply_noise_regime(SlamConfig(bilateral_filter=True),
                                    pinned=pinned)
    assert got == SlamConfig.of(want)
    assert config.apply_noise_regime(SlamConfig()) == SlamConfig()


def test_fields_are_configuration_fields():
    names = {f.name for f in dataclasses.fields(jcfg.Configuration)}
    assert {f.name for f in dataclasses.fields(SlamConfig)} <= names
