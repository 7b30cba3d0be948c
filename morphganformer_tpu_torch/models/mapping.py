"""Mapping network z_1..z_k -> w_1..w_k (port of morphganformer_tpu/models/mapping.py).

The k-1 local components go through a resnet MLP with latent self-attention
("mlp"), the global component through a separate MLP ("global_mlp"),
conditioned on a label embedding ("embed") when c_dim > 0; the outputs are
broadcast to num_ws and truncated against the tracked `w_avg`. Without the
transformer, all of z goes through the global MLP alone. The shared mapping
pools the components into one vector for "mlp". The JAX package's fused
mapping runs both chains as one batched computation over the same
parameters; the math is identical, so the port runs the two chains as they
are written (JAX `mapping.py:205-299`). Where JAX fails on a configuration
(a resnet chain whose widths differ, the shared mapping at k != 2, labels
beside more than one latent without the transformer), the port raises a
ValueError at construction.
"""

from __future__ import annotations

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import GANformerConfig
from morphganformer_tpu_torch.models.layers import FullyConnected, ResnetLayer, normalize_l2
from morphganformer_tpu_torch.models.transformer import TransformerLayer
from morphganformer_tpu_torch.parallel.mesh import mean_over_ranks


class MLP(nn.Module):
    """(Resnet, optionally self-attentive) MLP over the last axis. `pool`
    (the shared mapping) flattens [B, L, D] to one vector [B, L*D] first
    and reshapes the output back to [B, L, -1]; `sa_gate` gates the
    self-attention's rows and columns. The self-attention's positions are
    G's [k-1, w_dim] table, w_dim the last of `channels`."""

    def __init__(self, channels, act, resnet=False, sa=False, pool=False, lrmul=1.0,
                 sa_to_len=0, sa_pos=False, sa_gate=False, num_heads=1,
                 attention_dropout=0.0):
        super().__init__()
        self.resnet, self.sa, self.pool = resnet, sa, pool
        self.layers_num = len(channels) // 2 if resnet else len(channels) - 1
        for idx in range(self.layers_num):
            if sa:
                d = channels[idx]
                setattr(self, f"sa{idx}", TransformerLayer(
                    dim=d, pos_dim=channels[-1], from_len=sa_to_len, to_len=sa_to_len,
                    from_dim=d, to_dim=d, from_pos=sa_pos, to_pos=sa_pos,
                    from_gate=sa_gate, to_gate=sa_gate,
                    num_heads=num_heads, attention_dropout=attention_dropout))
            if resnet:
                if channels[idx] != channels[idx + 1]:
                    raise ValueError(
                        f"resnet MLP layer {idx} takes {channels[idx]} features and gives "
                        f"{channels[idx + 1]} (widths {tuple(channels)}); a resnet layer "
                        f"adds its input, so both must be equal, as JAX asserts")
                setattr(self, f"l{idx}", ResnetLayer(channels[idx], act=act, lrmul=lrmul))
            else:
                setattr(self, f"l{idx}", FullyConnected(
                    channels[idx], channels[idx + 1], act=act, lrmul=lrmul))
        self.out_layer = FullyConnected(channels[self.layers_num], channels[-1],
                                        act=act, lrmul=lrmul)

    def forward(self, x, pos=None, mask=None, train=False, gen=None):
        shape = x.shape
        if self.pool and x.dim() > 2:
            x = x.reshape(shape[0], -1)
        for idx in range(self.layers_num):
            skip = x
            if self.sa:
                x, _, _ = getattr(self, f"sa{idx}")(x, x, from_pos=pos, to_pos=pos,
                                                    att_mask=mask, train=train, gen=gen)
            layer = getattr(self, f"l{idx}")
            x = layer(x, skip) if self.resnet else layer(x)
        x = self.out_layer(x)
        if self.pool and len(shape) > 2:
            x = x.reshape(shape[0], *shape[1:-1], -1)
        return x


class MappingNetwork(nn.Module):
    def __init__(self, cfg: GANformerConfig):
        super().__init__()
        m = cfg.mapping
        k, z_dim, w_dim = cfg.k, cfg.z_dim, cfg.w_dim
        self.cfg = cfg
        layers = [m.layer_dim or w_dim] * (m.num_layers - 1) + [w_dim]
        embed_dim = (m.embed_dim or z_dim) if cfg.c_dim > 0 else 0
        if cfg.c_dim > 0 and not cfg.transformer and k != 1:
            raise ValueError(
                f"without the transformer the global MLP takes all of z [B, {k}, {z_dim}], "
                f"and JAX concatenates the label embedding [B, 1, {embed_dim}] onto it, "
                f"which needs k = 1 (got k = {k})")
        if cfg.transformer and m.shared and k != 2:
            raise ValueError(
                f"the shared mapping pools the {k - 1} components into one [B, "
                f"{(k - 1) * z_dim}] vector and gives [B, {w_dim}], which JAX reshapes to "
                f"[B, {k - 1}, {w_dim}/{k - 1}] and concatenates with the global [B, 1, "
                f"{w_dim}]: that needs k = 2 (got k = {k})")
        if cfg.c_dim > 0:
            self.embed = FullyConnected(cfg.c_dim, embed_dim)
        self.global_mlp = MLP(tuple([z_dim + embed_dim] + layers), act=m.act,
                              resnet=m.resnet, lrmul=m.lrmul)
        if cfg.transformer:
            self.mlp = MLP(tuple([z_dim] + layers), act=m.act, resnet=m.resnet, lrmul=m.lrmul,
                           sa=m.ltnt2ltnt and not m.shared, pool=m.shared, sa_to_len=k - 1,
                           sa_pos=m.use_pos, sa_gate=m.ltnt_gate,
                           num_heads=cfg.attention.num_heads,
                           attention_dropout=cfg.attention.dropout)
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z, c=None, pos=None, mask=None, truncation_psi=1.0,
                truncation_cutoff=None, train=False, skip_w_avg_update=False, gen=None,
                mesh=None):
        """`c` [B, c_dim]: the labels of a conditional mapping (c_dim > 0).
        `train` applies the attention dropout (masks from `gen`) and,
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
        if cfg.c_dim > 0 and (c is None or tuple(c.shape) != (z.shape[0], cfg.c_dim)):
            raise ValueError(f"a conditional mapping (c_dim {cfg.c_dim}) needs labels c "
                             f"[{z.shape[0]}, {cfg.c_dim}], got "
                             f"{None if c is None else tuple(c.shape)}")
        if cfg.transformer:
            z_comp, x = z[:, : k - 1], z[:, k - 1:]
            if m.normalize_global:
                x = normalize_l2(x)
            z_comp = normalize_l2(z_comp)
        else:
            x = normalize_l2(z)
        if cfg.c_dim > 0:
            y = normalize_l2(self.embed(c.float()))
            x = torch.cat([x, y[:, None, :]], dim=-1)
        x = self.global_mlp(x)
        if cfg.transformer:
            p = self.mlp(z_comp, pos=pos if m.use_pos else None, mask=mask, train=train,
                         gen=gen)
            x = torch.cat([p, x], dim=1)                            # global last
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
