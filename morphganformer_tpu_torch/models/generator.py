"""GANformer generator (port of morphganformer_tpu/models/generator.py).

z [B, k, z_dim] -> MappingNetwork -> ws [B, k, num_ws, w_dim]
-> SynthesisNetwork -> img [B, H, W, C] in [-1, 1] (NHWC). Inference only:
component dropout and random noise belong to training, which is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import GANformerConfig
from morphganformer_tpu_torch.models.mapping import MappingNetwork
from morphganformer_tpu_torch.models.synthesis import SynthesisNetwork
from morphganformer_tpu_torch.utils.device import resolve_device


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

    def _mask(self, batch, device):
        return torch.ones(batch, self.cfg.k - 1, device=device)

    def run_mapping(self, z, truncation_psi=1.0):
        return self.mapping(z, pos=self.pos, mask=self._mask(z.shape[0], z.device),
                            truncation_psi=truncation_psi)

    def run_synthesis(self, ws, noise_mode="const", plain=False):
        return self.synthesis(ws, pos=self.pos, mask=self._mask(ws.shape[0], ws.device),
                              noise_mode=noise_mode, plain=plain)

    def forward(self, z=None, ws=None, truncation_psi=1.0, noise_mode="const",
                return_ws=False, plain=False):
        """Full forward from z (or from ws). `plain=True` runs the fused
        blocks on the plain versions of their kernels."""
        if ws is None:
            ws = self.run_mapping(z, truncation_psi=truncation_psi)
        img = self.run_synthesis(ws, noise_mode=noise_mode, plain=plain)
        return (img, ws) if return_ws else img


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
