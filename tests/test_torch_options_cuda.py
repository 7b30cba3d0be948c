"""The GANformer options' generators on a card, at a small size: the fused
blocks' kernels against their plain versions with gating, the iterative
carry and labels on (the sets of chip_smoke.py's phase options). The image
and the gradient w.r.t. ws, each launch of K1 and K2 counted.

This file imports no JAX (tests/conftest.py does), so on the GPU machine
run it with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_options_cuda.py -m cuda -q

Without a card every test skips. Tolerance 1e-4 of the largest entry:
float32 sums of the same terms in another order through a few layers."""

import pytest
import torch

from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.ops import fused_conv as fc

from .test_torch_kernels_cuda import cuda_device  # noqa: F401

SETS = {
    "gated": dict(k=5, mapping=dict(ltnt_gate=True),
                  attention=dict(ltnt_gate=True, img_gate=True, kmeans_iters=2,
                                 pos_type="trainable")),
    "iterative_conditional": dict(k=9, c_dim=4, mapping=dict(resnet=False),
                                  attention=dict(iterative=True, kmeans_iters=2,
                                                 pos_type="linear")),
    "stylegan2": dict(k=1, transformer=False),
    "shared": dict(k=2, mapping=dict(shared=True), attention=dict(pos_type="trainable2d")),
}


def options_cfg(name):
    """32^2 at widths 64 -> 16, attention at 4^2 and 8^2, b16 and b32
    fused (all blocks from 8^2 without the transformer)."""
    kw = dict(SETS[name])
    mapping, attention = kw.pop("mapping", {}), kw.pop("attention", {})
    return tcfg.GANformerConfig(img_resolution=32, z_dim=16, w_dim=16, channel_base=512,
                                channel_max=64, end_res=4,
                                mapping=tcfg.MappingConfig(num_layers=2, **mapping),
                                attention=tcfg.AttentionConfig(**attention), **kw)


def _close(got, want):
    return (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SETS))
def test_options_generator_kernels_match_plain(cuda_device, name):  # noqa: F811
    cfg = options_cfg(name)
    G = init_generator(cfg, seed=0, device=cuda_device)
    with torch.no_grad():
        for n, p in G.named_parameters():
            if n.endswith(("noise_strength", "bias")):
                p.add_(0.1 * torch.randn(p.shape, device=p.device))
    G.requires_grad_(False)
    fused = [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, "const")]
    assert fused
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    z = torch.randn((2, cfg.k, cfg.z_dim), generator=gen, device=cuda_device)
    c = (torch.randn((2, cfg.c_dim), generator=gen, device=cuda_device)
         if cfg.c_dim else None)
    ws = G.run_mapping(z, c, truncation_psi=0.7).detach()
    cot = torch.randn((2, 32, 32, 3), generator=gen, device=cuda_device)
    out = {}
    for plain in (False, True):
        fc.reset_launch_counts()
        w = ws.clone().requires_grad_(True)
        img = G.run_synthesis(w, plain=plain)
        (img * cot).sum().backward()
        out[plain] = img.detach(), w.grad
        launches = dict(fc.launch_counts)
        k1, k2 = len(fused) + (cfg.img_resolution in fused), 2 * len(fused)
        want = {"modconv3x3": k1, "upconv2": k2, "modconv3x3_adj": k1, "upconv2_adj": k2}
        assert {k: launches[k] for k in want} == ({k: 0 for k in want} if plain else want)
    assert torch.isfinite(out[False][0]).all()
    assert _close(out[False][0], out[True][0])
    assert _close(out[False][1], out[True][1])
