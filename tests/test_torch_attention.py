"""The attention maps (`return_att`) and the attention vis of the port,
against the JAX package on the same weights (carried by `load_flax`) and
the same z.

The config has attention at 4^2 and 8^2 (three layers) and a 16^2 block
that runs the fused route (on the CPU the kernels' plain versions)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import init_generator as j_init_generator
from morphganformer_tpu.ops.upfirdn2d import nearest_neighbors_kernel
from morphganformer_tpu.training import visualize as jvz
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.training import visualize as tvz
from morphganformer_tpu_torch.utils.image import read_png, write_png

from .test_torch_checkpoint_io import bumped
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

RES = 16
MAP_TOL = 2e-5
IMG_TOL = 2e-4


@pytest.fixture(scope="module")
def concrete_nearest_kernels():
    """JAX's `nearest_neighbors_kernel` is lru-cached, and made inside a
    jit trace it is that trace's tracer, which the next trace cannot use.
    The cache is filled here, outside any trace."""
    nearest_neighbors_kernel.cache_clear()
    for factor in (2, 4, 8):
        nearest_neighbors_kernel(factor)


def g_cfg(mod, heads=1, end_res=4, **kw):
    return mod.GANformerConfig(img_resolution=RES, z_dim=8, w_dim=8, k=3, channel_base=256,
                               channel_max=32, end_res=end_res,
                               mapping=mod.MappingConfig(num_layers=2),
                               attention=mod.AttentionConfig(num_heads=heads), **kw)


def carry(heads=1, **kw):
    model, variables = j_init_generator(g_cfg(jcfg, heads, **kw), seed=0)
    variables = jax.device_get(bumped(variables))
    G = load_flax(init_generator(g_cfg(tcfg, heads, **kw), seed=1, device="cpu"), variables)
    return model, variables, G


@pytest.fixture(scope="module", params=[1, 2], ids=["heads1", "heads2"])
def carried(request):
    return carry(request.param)


def jax_forward(model, variables, z, return_att=True):
    fn = jax.jit(lambda v, zz: model.apply(v, zz, truncation_psi=0.7, noise_mode="const",
                                           return_att=return_att))
    return fn(variables, jnp.asarray(z))


def test_return_att_matches_jax(carried):
    model, variables, G = carried
    z = np.random.RandomState(3).randn(2, 3, 8).astype(np.float32)
    want_img, want_att = (np.asarray(a) for a in jax_forward(model, variables, z))
    with torch.no_grad():
        img, att = G(z=torch.from_numpy(z), truncation_psi=0.7, return_att=True)
    heads = G.cfg.attention.num_heads
    # [B, k-1, L, heads, H, W]: the stem's conv1, b8's conv0 and conv1.
    assert tuple(att.shape) == want_att.shape == (2, 2, 3, heads, RES, RES)
    assert att.dtype == torch.float32
    np.testing.assert_allclose(att.numpy(), want_att, rtol=0, atol=MAP_TOL)
    np.testing.assert_allclose(img.numpy(), want_img, rtol=IMG_TOL, atol=IMG_TOL)
    # Each layer's maps are a distribution over the components at each pixel.
    np.testing.assert_allclose(att.sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_return_att_keeps_the_image_and_the_route(carried, monkeypatch):
    _, _, G = carried
    calls = []
    for name in ("fused_modconv3x3", "fused_upconv2"):
        real = getattr(tsyn, name)
        monkeypatch.setattr(tsyn, name, lambda *a, _n=name, _f=real, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    z = torch.from_numpy(np.random.RandomState(4).randn(2, 3, 8).astype(np.float32))
    with torch.no_grad():
        plain_img = G(z=z)
        route = list(calls)
        calls.clear()
        img, att, ws = G(z=z, return_att=True, return_ws=True)
    # b16: conv0 on K2, conv1 and conv_last on K1 (the skip's K2 call is layers.py's).
    assert route == calls == ["fused_upconv2", "fused_modconv3x3", "fused_modconv3x3"]
    assert torch.equal(img, plain_img)
    assert tuple(ws.shape) == (2, 3, G.cfg.num_ws, 8) and att.dim() == 6


def test_return_att_without_attention_layers_is_zeros_as_in_jax():
    model, variables, G = carry(end_res=2)
    z = np.random.RandomState(5).randn(1, 3, 8).astype(np.float32)
    want_img, want_att = (np.asarray(a) for a in jax_forward(model, variables, z))
    with torch.no_grad():
        img, att = G(z=torch.from_numpy(z), truncation_psi=0.7, return_att=True)
    assert want_att.shape == tuple(att.shape) == (1,) and not att.any()
    np.testing.assert_allclose(img.numpy(), want_img, rtol=IMG_TOL, atol=IMG_TOL)
    with pytest.raises(ValueError, match="attention layers"):
        tvz.attention_blends(G, G.cfg, num=1)


def test_attention_maps_are_nearest_copies(carried):
    """Each layer's map is a block-constant copy of its own resolution."""
    _, _, G = carried
    z = torch.from_numpy(np.random.RandomState(6).randn(1, 3, 8).astype(np.float32))
    with torch.no_grad():
        _, att = G(z=z, return_att=True)
    for layer, side in enumerate((4, 8, 8)):
        f = RES // side
        a = att[:, :, layer]
        assert torch.equal(a, a[..., ::f, ::f].repeat_interleave(f, -2).repeat_interleave(f, -1))


def test_attention_blends_match_jax(carried, tmp_path):
    model, variables, G = carried
    cfg = g_cfg(jcfg, G.cfg.attention.num_heads)
    num = 4
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (num, cfg.k, cfg.z_dim)))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jvz.attention_blends(model, variables, cfg, num=num, out_dir=str(tmp_path / "jax"))
    got = tvz.attention_blends(G, G.cfg, num=num, out_dir=str(tmp_path / "port"), z=z)
    assert got.shape == want.shape == (num, RES, RES, 3) and got.dtype == np.float32
    # Where the two largest component means are within 1e-5 the argmax
    # may pick either: those pixels are left out, and must be rare.
    _, att = jax_forward(model, variables, z)
    means = np.sort(np.asarray(att).mean(axis=(2, 3)), axis=1)
    clear = (means[:, -1] - means[:, -2]) > 1e-5                  # [B, H, W]
    assert clear.mean() > 0.999
    np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=IMG_TOL)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == sorted(
        [f"sample_{i}.png" for i in range(num)] + [f"attention_{i}.png" for i in range(num)])
    for name in sorted(os.listdir(tmp_path / "jax")):
        mine = read_png(str(tmp_path / "port" / name)).astype(int)
        theirs = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert mine.shape == theirs.shape == (RES, RES, 3)
        keep = clear[int(name.split("_")[1][:-4])]
        assert np.abs(mine - theirs)[keep].max() <= 1, name


def test_train_entry_point_writes_the_attention_vis(tmp_path):
    data = tmp_path / "data" / "16"
    data.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        write_png(str(data / f"{i:04d}.png"), (rng.rand(RES, RES, 3) * 255).astype(np.uint8))
    cli.main(["train", "--data-dir", str(tmp_path / "data"), "--result-dir",
              str(tmp_path / "runs"), "--expname", "att", "--resolution", str(RES),
              "--components-num", "2", "--latent-size", "16", "--channel-base", "256",
              "--channel-max", "32", "--end-res", "4", "--batch", "4", "--device", "cpu",
              "--ganformer-default", "--kimg-per-tick", "0.004", "--max-ticks", "1",
              "--img-snapshot-ticks", "1", "--vis", "grid", "attention"])
    run = tmp_path / "runs" / "att-000"
    vis = sorted(p for p in os.listdir(run) if p.startswith("vis"))
    assert vis, os.listdir(run)
    for d in vis:
        files = sorted(os.listdir(run / d))
        assert files == sorted([f"sample_{i}.png" for i in range(4)]
                               + [f"attention_{i}.png" for i in range(4)]), files
        assert read_png(str(run / d / "attention_0.png")).shape == (RES, RES, 3)
