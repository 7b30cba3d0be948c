"""GANformer generator (port of morphganformer_tpu/models/generator.py).

z [B, k, z_dim] -> MappingNetwork -> ws [B, k, num_ws, w_dim]
-> SynthesisNetwork -> img [B, H, W, C] in [-1, 1] (NHWC). The training loss
(training/loss.py) calls `run_mapping` / `run_synthesis` with `train=True`:
attention dropout, the w_avg update, random noise and the component-dropout
mask then draw from an explicit `torch.Generator`. A conditional generator
(c_dim > 0) takes its labels c [B, c_dim] through `forward` and
`run_mapping`, as JAX's does (`generator.py:42-73`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import GANformerConfig
from morphganformer_tpu_torch.models.mapping import MappingNetwork
from morphganformer_tpu_torch.models.synthesis import SynthesisNetwork
from morphganformer_tpu_torch.utils.device import resolve_device
from morphganformer_tpu_torch.utils.dtype import compute_dtype


class Generator(nn.Module):
    def __init__(self, cfg: GANformerConfig):
        super().__init__()
        self.cfg = cfg
        self.pos = nn.Parameter(torch.empty(cfg.k - 1, cfg.w_dim))
        self.mapping = MappingNetwork(cfg)
        self.synthesis = SynthesisNetwork(cfg)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.pos.copy_(torch.rand(self.pos.shape, generator=gen))

    def component_mask(self, batch, device, train=False, gen=None):
        """Keep-mask [B, k-1] of the latent components: under `train` each is
        dropped with probability `component_dropout` (JAX `generator.py:37-39`,
        `random_dp_binary`: kept where uniform >= the rate), else all ones."""
        cfg = self.cfg
        if train and cfg.component_dropout > 0:
            u = torch.rand((batch, cfg.k - 1), generator=gen, device=device)
            return (u >= cfg.component_dropout).float()
        return torch.ones(batch, cfg.k - 1, device=device)

    def run_mapping(self, z, c=None, truncation_psi=1.0, train=False, skip_w_avg_update=False,
                    gen=None, mask=None, truncation_cutoff=None, mesh=None):
        """ws [B, k, num_ws, w_dim] from z [B, k, z_dim] and, for a
        conditional generator, the labels c [B, c_dim] (a ValueError that
        names c_dim without them)."""
        if mask is None:
            mask = self.component_mask(z.shape[0], z.device, train, gen)
        return self.mapping(z, c, pos=self.pos, mask=mask, truncation_psi=truncation_psi,
                            truncation_cutoff=truncation_cutoff, train=train,
                            skip_w_avg_update=skip_w_avg_update, gen=gen, mesh=mesh)

    def run_synthesis(self, ws, noise_mode="const", plain=False, train=False, gen=None,
                      mask=None, return_att=False):
        if mask is None:
            mask = self.component_mask(ws.shape[0], ws.device, train, gen)
        return self.synthesis(ws, pos=self.pos, mask=mask, noise_mode=noise_mode, plain=plain,
                              train=train, gen=gen, return_att=return_att)

    def forward(self, z=None, c=None, ws=None, truncation_psi=1.0, noise_mode="const",
                return_ws=False, plain=False, truncation_cutoff=None, gen=None,
                return_att=False):
        """Full forward from z and the labels c of a conditional generator
        (or from ws): img, or a tuple of img, the
        attention maps [B, k-1, L, heads, H, W] under `return_att` and ws
        under `return_ws`, in JAX's order (`generator.py:74-78`).
        `plain=True` runs the fused blocks on the plain versions of their
        kernels; random noise draws from `gen`."""
        if ws is None:
            ws = self.run_mapping(z, c, truncation_psi=truncation_psi,
                                  truncation_cutoff=truncation_cutoff)
        out = self.run_synthesis(ws, noise_mode=noise_mode, plain=plain, gen=gen,
                                 return_att=return_att)
        ret = out if return_att else (out,)
        if return_ws:
            ret += (ws,)
        return ret if len(ret) > 1 else ret[0]


def set_compute_dtype(G: Generator, dtype: str) -> Generator:
    """G with its synthesis computing in `dtype` ("float32" or "bfloat16"),
    as JAX's `get_model` rebuilds its Generator on `dataclasses.replace(cfg,
    dtype=...)`: every module that holds the config gets the replaced one;
    the parameters stay float32. Returns G."""
    cfg = dataclasses.replace(G.cfg, dtype=dtype)
    compute_dtype(cfg)
    for m in G.modules():
        if isinstance(getattr(m, "cfg", None), GANformerConfig):
            m.cfg = cfg
    return G


def init_generator(cfg: GANformerConfig, seed: int = 0, device="cuda") -> Generator:
    """A generator with random weights and const-noise buffers drawn from a
    CPU `torch.Generator` seeded with `seed` (the same on every device), in
    eval mode on `device`. The draws differ from JAX's init; parity with the
    JAX package comes from carried weights (checkpoint/convert.py)."""
    device = resolve_device(device)
    model = Generator(cfg)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model.to(device).eval()
