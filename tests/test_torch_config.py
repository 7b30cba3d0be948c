"""The port's config copy serialises exactly as the JAX package's."""

import pytest

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu_torch.models import config as tcfg


def _small(mod):
    return mod.GANformerConfig(
        img_resolution=16, z_dim=8, w_dim=8, k=3, channel_base=1024,
        channel_max=128, end_res=3, mapping=mod.MappingConfig(num_layers=2),
        attention=mod.AttentionConfig())


def _split(mod):
    return mod.GANformerConfig(
        img_resolution=32, z_dim=8, w_dim=8, k=3, channel_base=4096,
        channel_max=256, end_res=3, mapping=mod.MappingConfig(num_layers=2),
        attention=mod.AttentionConfig())


@pytest.mark.parametrize("make", [
    lambda m: m.ffhq1024_config(),
    lambda m: m.ffhq256_config(),
    _small,
    _split,
], ids=["ffhq1024", "ffhq256", "small", "split"])
def test_config_json_matches_jax(make):
    j, t = make(jcfg), make(tcfg)
    assert t.to_json() == j.to_json()
    assert tcfg.GANformerConfig.from_json(j.to_json()) == t
    assert t.num_ws == j.num_ws and t.block_w_slices() == j.block_w_slices()
    assert [t.channels(r) for r in t.block_resolutions] == \
        [j.channels(r) for r in j.block_resolutions]
