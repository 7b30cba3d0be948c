"""Bipartite (duplex) attention between image positions and latent components
(port of morphganformer_tpu/models/transformer.py).

Information flows to -> from: `to_tensor` (latents) modulates `from_tensor`
(pixels). Tensors stay batched 3D [B, len, dim]; softmax and normalisation
run in float32. The two fixes of the JAX module over the reference are kept:
`dim` is a constructor argument (the reference reads an unassigned
`self.dim`), and integration "both" splits the control in half (the
reference's `torch.split(control, 2)` cuts pieces of size 2).

Ported: k-means duplex attention with parametric centroids (iterative=False)
and plain attention, integration add/mul/both, norm None/instance/layer.
Training's double attention dropout is ported, its masks drawn from an
explicit `torch.Generator`. Not ported yet: gating, the iterative centroid
carry, kmeans_iters > 1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from morphganformer_tpu_torch.models.layers import FullyConnected, _fill_, _normal_, logits_mask
from morphganformer_tpu_torch.utils.dtype import at_least_f32, scalar


def _to_heads(x, num_heads, head_size):
    """[B, L, N*H] -> [B, N, L, H]."""
    b, l, _ = x.shape
    return x.reshape(b, l, num_heads, head_size).permute(0, 2, 1, 3)


def _from_heads(x):
    """[B, N, L, H] -> [B, L, N*H]."""
    b, n, l, h = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, n * h)


def dropout_masks(att_probs, rate, gen):
    """The two keep-masks of `attention_dropout`, each kept with probability
    1 - rate/2 (flax Dropout keeps where uniform < keep probability): one
    elementwise [B,N,F,T], one per 'to' column [B,N,1,T]."""
    b, heads, _, to_len = att_probs.shape
    keep = 1.0 - rate / 2
    dev = att_probs.device
    m1 = torch.rand(att_probs.shape, generator=gen, device=dev) < keep
    m2 = torch.rand((b, heads, 1, to_len), generator=gen, device=dev) < keep
    return m1, m2


def attention_dropout(att_probs, rate, m1, m2):
    """The reference's double dropout (networks.py:505-513; JAX
    `transformer.py:239-247`): elementwise dropout at rate/2, then a
    dropped-out column mask at rate/2, each kept value scaled by
    1 / (1 - rate/2)."""
    keep = 1.0 - rate / 2
    probs = torch.where(m1, att_probs / keep, torch.zeros_like(att_probs))
    return probs * torch.where(m2, 1.0 / keep, 0.0).to(probs.dtype)


def att_norm(x, integration: str, norm: Optional[str]):
    """Normalise without scale/bias; 'instance' over L, 'layer' over C."""
    if norm is None:
        return x
    x = at_least_f32(x)
    dim = 1 if norm == "instance" else 2
    if integration in ("add", "both"):
        x = x - x.mean(dim=dim, keepdim=True)
    if integration in ("mul", "both"):
        x = x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + 1e-8)
    return x


class TransformerLayer(nn.Module):
    """Duplex bipartite attention layer.

    from_tensor [B, F, from_dim], to_tensor [B, T, to_dim]; `from_pos` /
    `to_pos` say whether positional maps are applied (the flax module
    creates those parameters only when the positions are passed)."""

    def __init__(self, dim, pos_dim, from_len, to_len, from_dim, to_dim,
                 from_pos=False, to_pos=False, from_gate=False, to_gate=False,
                 num_heads=1, integration="add", norm=None, kmeans=False,
                 kmeans_iters=1, iterative=False, attention_dropout=0.0):
        super().__init__()
        if from_gate or to_gate:
            raise NotImplementedError("attention gating is not ported")
        if kmeans and iterative:
            raise NotImplementedError("the iterative centroid carry is not ported")
        if kmeans_iters != 1:
            raise NotImplementedError("only kmeans_iters=1 is ported")
        self.dim, self.num_heads = dim, num_heads
        self.size_head = dim // num_heads
        self.integration, self.norm = integration, norm
        self.kmeans = kmeans
        self.attention_dropout = attention_dropout
        self.to_queries = FullyConnected(from_dim, dim)
        self.to_keys = FullyConnected(to_dim, dim)
        self.to_values = FullyConnected(to_dim, dim)
        self.from_pos_map = FullyConnected(pos_dim, dim) if from_pos else None
        self.to_pos_map = FullyConnected(pos_dim, dim) if to_pos else None
        if kmeans:
            cdim = 2 * self.size_head
            self.centroids = nn.Parameter(torch.empty(1, num_heads, to_len, cdim))
            self.att_weight = nn.Parameter(torch.empty(num_heads, 1, cdim))
        control_dim = 2 * dim if integration == "both" else dim
        self.modulation = FullyConnected(dim, control_dim)

    def reset_parameters(self, gen):
        if self.kmeans:
            _normal_(self.centroids, gen)
            _fill_(self.att_weight, 1.0)

    def forward(self, from_tensor, to_tensor, from_pos=None, to_pos=None, att_mask=None,
                train=False, gen=None):
        """`train` applies the attention dropout, its masks drawn from `gen`."""
        b = from_tensor.shape[0]
        queries = self.to_queries(from_tensor)
        values = self.to_values(to_tensor)
        _queries = queries
        if self.from_pos_map is not None:
            queries = queries + self.from_pos_map(from_pos.to(queries.dtype))[None]
        scale = 1.0 / float(self.size_head) ** 0.5
        if self.kmeans:
            # Scores of the 'from' elements against the parametric centroids;
            # the key projection feeds nothing in this mode.
            from_elements = _to_heads(torch.cat([_queries, queries - _queries], dim=-1),
                                      self.num_heads, 2 * self.size_head)
            to_centroids = self.centroids.expand(b, -1, -1, -1)
            # float32 centroids promote bfloat16 elements, as jnp.einsum does.
            dt = torch.promote_types(from_elements.dtype, to_centroids.dtype)
            att_scores = torch.einsum(
                "bnfc,bntc->bnft",
                (from_elements * self.att_weight.to(from_elements.dtype)[None]).to(dt),
                to_centroids.to(dt))
        else:
            keys = self.to_keys(to_tensor)
            if self.to_pos_map is not None:
                keys = keys + self.to_pos_map(to_pos.to(keys.dtype))[None]
            att_scores = torch.einsum("bnfh,bnth->bnft",
                                      _to_heads(queries, self.num_heads, self.size_head),
                                      _to_heads(keys, self.num_heads, self.size_head))
        att_scores = att_scores * scalar(scale, att_scores.dtype)
        if att_mask is not None:
            att_scores = logits_mask(att_scores, att_mask[:, None, None, :])
        att_probs = torch.softmax(at_least_f32(att_scores), dim=-1)
        if train and self.attention_dropout > 0:
            att_probs = attention_dropout(
                att_probs, self.attention_dropout,
                *dropout_masks(att_probs, self.attention_dropout, gen))

        values_h = _to_heads(values, self.num_heads, self.size_head)
        control = _from_heads(torch.einsum("bnft,bnth->bnfh",
                                           att_probs.to(values_h.dtype), values_h))
        out = att_norm(from_tensor, self.integration, self.norm)
        control = self.modulation(control.to(from_tensor.dtype))
        if self.integration == "both":
            gain, bias = control.chunk(2, dim=-1)
        else:
            gain = bias = control
        if self.integration != "add":
            out = out * (gain.to(out.dtype) + 1.0)
        if self.integration != "mul":
            out = out + bias.to(out.dtype)
        return out.to(from_tensor.dtype), att_probs
