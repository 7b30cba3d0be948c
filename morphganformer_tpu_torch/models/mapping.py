"""Mapping network z_1..z_k -> w_1..w_k (port of morphganformer_tpu/models/mapping.py).

The k-1 local components go through a resnet MLP with latent self-attention
("mlp"), the global component through a separate MLP ("global_mlp"); the
outputs are broadcast to num_ws and truncated against the tracked `w_avg`.
The JAX package's fused mapping runs both chains as one batched computation
over the same parameters; the math is identical, so the port runs the two
chains as they are written. Labels (c_dim > 0) and the shared mapping are not
ported.
"""

from __future__ import annotations

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import GANformerConfig
from morphganformer_tpu_torch.models.layers import FullyConnected, ResnetLayer, normalize_l2
from morphganformer_tpu_torch.models.transformer import TransformerLayer
from morphganformer_tpu_torch.parallel.mesh import mean_over_ranks


class MLP(nn.Module):
    """(Resnet, optionally self-attentive) MLP over the last axis."""

    def __init__(self, channels, act, resnet=False, sa=False, lrmul=1.0,
                 sa_to_len=0, sa_pos=False, num_heads=1, attention_dropout=0.0):
        super().__init__()
        self.resnet, self.sa = resnet, sa
        self.layers_num = len(channels) // 2 if resnet else len(channels) - 1
        for idx in range(self.layers_num):
            if sa:
                d = channels[idx]
                setattr(self, f"sa{idx}", TransformerLayer(
                    dim=d, pos_dim=d, from_len=sa_to_len, to_len=sa_to_len,
                    from_dim=d, to_dim=d, from_pos=sa_pos, to_pos=sa_pos,
                    num_heads=num_heads, attention_dropout=attention_dropout))
            if resnet:
                if channels[idx] != channels[idx + 1]:
                    raise ValueError("resnet MLP layers need equal widths")
                setattr(self, f"l{idx}", ResnetLayer(channels[idx], act=act, lrmul=lrmul))
            else:
                setattr(self, f"l{idx}", FullyConnected(
                    channels[idx], channels[idx + 1], act=act, lrmul=lrmul))
        self.out_layer = FullyConnected(channels[self.layers_num], channels[-1],
                                        act=act, lrmul=lrmul)

    def forward(self, x, pos=None, mask=None, train=False, gen=None):
        for idx in range(self.layers_num):
            skip = x
            if self.sa:
                x, _ = getattr(self, f"sa{idx}")(x, x, from_pos=pos, to_pos=pos, att_mask=mask,
                                                 train=train, gen=gen)
            layer = getattr(self, f"l{idx}")
            x = layer(x, skip) if self.resnet else layer(x)
        return self.out_layer(x)


class MappingNetwork(nn.Module):
    def __init__(self, cfg: GANformerConfig):
        super().__init__()
        m = cfg.mapping
        if cfg.c_dim > 0 or m.shared or not cfg.transformer:
            raise NotImplementedError("the port maps unconditional, non-shared "
                                      "GANformer latents only")
        self.cfg = cfg
        layer_dim = m.layer_dim or cfg.w_dim
        channels = tuple([cfg.z_dim] + [layer_dim] * (m.num_layers - 1) + [cfg.w_dim])
        self.global_mlp = MLP(channels, act=m.act, resnet=m.resnet, lrmul=m.lrmul)
        self.mlp = MLP(channels, act=m.act, resnet=m.resnet, lrmul=m.lrmul,
                       sa=m.ltnt2ltnt, sa_to_len=cfg.k - 1, sa_pos=m.use_pos,
                       num_heads=cfg.attention.num_heads,
                       attention_dropout=cfg.attention.dropout)
        self.register_buffer("w_avg", torch.zeros(cfg.w_dim))

    def forward(self, z, pos=None, mask=None, truncation_psi=1.0, truncation_cutoff=None,
                train=False, skip_w_avg_update=False, gen=None, mesh=None):
        """`train` applies the attention dropout (masks from `gen`) and,
        unless `skip_w_avg_update`, moves the tracked w_avg towards this
        batch's mean (JAX `mapping.py:276-281`), in place; under a data
        `mesh` the mean over every rank's rows, as JAX's is over the global
        batch.
        Truncation pulls the first `truncation_cutoff` of the num_ws layers
        (all of them when None) towards w_avg (JAX `mapping.py:285-298`)."""
        cfg = self.cfg
        m = cfg.mapping
        k = cfg.k
        if tuple(z.shape[1:]) != (k, cfg.z_dim):
            raise ValueError(f"z must be [B,{k},{cfg.z_dim}], got {tuple(z.shape)}")
        z_comp, g = z[:, : k - 1], z[:, k - 1:]
        if m.normalize_global:
            g = normalize_l2(g)
        z_comp = normalize_l2(z_comp)
        x = self.global_mlp(g)
        p = self.mlp(z_comp, pos=pos if m.use_pos else None, mask=mask, train=train, gen=gen)
        x = torch.cat([p, x], dim=1)                                # global last
        if train and m.w_avg_beta is not None and not skip_w_avg_update:
            with torch.no_grad():
                batch_mean = mean_over_ranks(x.mean(dim=(0, 1)), mesh)
                self.w_avg.copy_(batch_mean + m.w_avg_beta * (self.w_avg - batch_mean))
        x = x[:, :, None, :].expand(-1, -1, cfg.num_ws, -1)          # [B,k,num_ws,w]
        if truncation_psi != 1:
            if m.w_avg_beta is None:
                raise ValueError("truncation needs a tracked w_avg")
            if truncation_cutoff is None:
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            else:
                head = self.w_avg + truncation_psi * (x[:, :, :truncation_cutoff] - self.w_avg)
                x = torch.cat([head, x[:, :, truncation_cutoff:]], dim=2)
        return x
