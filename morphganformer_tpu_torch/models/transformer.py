"""Bipartite (duplex) attention between image positions and latent components
(port of morphganformer_tpu/models/transformer.py).

Information flows to -> from: `to_tensor` (latents) modulates `from_tensor`
(pixels). Tensors stay batched 3D [B, len, dim]; softmax and normalisation
run in float32. The two fixes of the JAX module over the reference are kept:
`dim` is a constructor argument (the reference reads an unassigned
`self.dim`), and integration "both" splits the control in half (the
reference's `torch.split(control, 2)` cuts pieces of size 2).

All of JAX's modes are ported: k-means duplex attention with parametric
centroids or with the iterative centroid carry (the first layer's centroids
from its queries, later layers' from the assignments the layer before
hands on), `kmeans_iters` passes, plain attention, integration
add/mul/both, norm None/instance/layer, and sigmoid gating of the rows
(`img_gate`) and of the columns (`ltnt_gate`). Training's double attention
dropout is ported, its masks drawn from an explicit `torch.Generator`.
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


def compute_assignments(att_probs):
    """Each 'from' element's share of a 'to' centroid: the probabilities
    normalised over the 'from' axis, [B,N,F,T] -> [B,N,T,F] (JAX
    `transformer.py:51-56`)."""
    a = att_probs / (att_probs.sum(dim=-2, keepdim=True) + 1e-8)
    return a.transpose(-1, -2)


def _repeat2(x, dims):
    """An exact 2x nearest-neighbour repeat along the two `dims`, which is
    what JAX's `upsample2d` with `nearest_neighbors_kernel(2)` computes
    (every output one input times a tap of 1)."""
    for d in dims:
        x = x.repeat_interleave(2, dim=d)
    return x


def upsample_assignments(to_from, num_heads, to_len, from_len):
    """Carried assignments [B,N,T',F'] brought to [B,N,to_len,from_len] by a
    2x repeat over the T grid where T' < to_len and over the F grid where
    F' < from_len (JAX `_upsample_assignments`, `transformer.py:59-79`)."""
    b = to_from.shape[0]
    if to_from.shape[-2] < to_len:
        s = int(round(to_from.shape[-2] ** 0.5))
        x = to_from.reshape(-1, s, s, to_from.shape[-1])
        to_from = _repeat2(x, (1, 2)).reshape(b, num_heads, to_len, to_from.shape[-1])
    if to_from.shape[-1] < from_len:
        s = int(round(to_from.shape[-1] ** 0.5))
        x = to_from.reshape(-1, to_from.shape[-2], s, s)
        to_from = _repeat2(x, (2, 3)).reshape(b, num_heads, to_len, from_len)
    return to_from


class GateAttention(nn.Module):
    """Sigmoid gates on the attention's rows (from_len L, to_len 1) or
    columns (from_len 1, to_len L): one per head from the tensor of those L
    elements through the FC `gate`, plus their positions through
    `gate_pos` where the layer has them (JAX `transformer.py:94-114`)."""

    def __init__(self, dim, pos_dim, num_heads, from_len, to_len, pos=False, gate_bias=0.0):
        super().__init__()
        self.from_len, self.to_len, self.num_heads = from_len, to_len, num_heads
        self.gate_bias = gate_bias
        self.gate = FullyConnected(dim, num_heads)
        self.gate_pos = FullyConnected(pos_dim, num_heads) if pos else None

    def forward(self, att_probs, tensor, pos):
        gate = self.gate(tensor)
        if self.gate_pos is not None:
            gate = gate + self.gate_pos(pos)
        gate = torch.sigmoid(gate + self.gate_bias)
        gate = gate.reshape(-1, self.from_len, self.to_len, self.num_heads).permute(0, 3, 1, 2)
        return att_probs * gate


class TransformerLayer(nn.Module):
    """Duplex bipartite attention layer.

    from_tensor [B, F, from_dim], to_tensor [B, T, to_dim]; `from_pos` /
    `to_pos` say whether positional maps are applied (the flax module
    creates those parameters only when the positions are passed). With
    `kmeans` and `iterative`, `first` says that no assignments reach the
    layer (the first attention layer of the synthesis), so its centroids
    come from its queries through `queries2centroids`, which JAX reshapes
    from [B, F, dim*N] to [B, T, 2*dim]: that needs F*N = 2*T. `pos_dim`
    is the width of from_pos, `to_pos_dim` that of to_pos (pos_dim unless
    given)."""

    def __init__(self, dim, pos_dim, from_len, to_len, from_dim, to_dim,
                 from_pos=False, to_pos=False, from_gate=False, to_gate=False,
                 num_heads=1, integration="add", norm=None, kmeans=False,
                 kmeans_iters=1, iterative=False, attention_dropout=0.0, first=False,
                 to_pos_dim=None):
        super().__init__()
        if kmeans_iters < 1:
            raise ValueError(f"kmeans_iters must be at least 1, got {kmeans_iters}")
        self.dim, self.num_heads = dim, num_heads
        self.size_head = dim // num_heads
        self.from_len, self.to_len = from_len, to_len
        self.integration, self.norm = integration, norm
        self.kmeans, self.kmeans_iters, self.iterative = kmeans, kmeans_iters, iterative
        self.attention_dropout = attention_dropout
        self.to_queries = FullyConnected(from_dim, dim)
        self.to_keys = FullyConnected(to_dim, dim)
        self.to_values = FullyConnected(to_dim, dim)
        self.from_pos_map = FullyConnected(pos_dim, dim) if from_pos else None
        to_pos_dim = pos_dim if to_pos_dim is None else to_pos_dim
        self.to_pos_map = FullyConnected(to_pos_dim, dim) if to_pos else None
        self.queries2centroids = None
        if kmeans:
            cdim = 2 * self.size_head
            if not iterative:
                self.centroids = nn.Parameter(torch.empty(1, num_heads, to_len, cdim))
            elif first:
                if from_len * num_heads != 2 * to_len:
                    raise ValueError(
                        f"the iterative carry's first layer reshapes queries2centroids "
                        f"[B, {from_len}, {dim * num_heads}] (F={from_len} tokens, "
                        f"{num_heads} heads) to [B, {to_len}, {2 * dim}] (T={to_len} "
                        f"components), which needs F*N = 2*T; JAX fails on it too")
                self.queries2centroids = FullyConnected(dim, dim * num_heads)
            self.att_weight = nn.Parameter(torch.empty(num_heads, 1, cdim))
        self.to_gate_attention = GateAttention(
            to_dim, to_pos_dim, num_heads, 1, to_len, pos=to_pos) if to_gate else None
        self.from_gate_attention = GateAttention(
            from_dim, pos_dim, num_heads, from_len, 1, pos=from_pos,
            gate_bias=1.0) if from_gate else None
        control_dim = 2 * dim if integration == "both" else dim
        self.modulation = FullyConnected(dim, control_dim)

    def reset_parameters(self, gen):
        if self.kmeans:
            if not self.iterative:
                _normal_(self.centroids, gen)
            _fill_(self.att_weight, 1.0)

    def _centroids(self, queries, from_elements, to_from):
        """The first pass's centroids [B,N,T,2H] and the assignments they
        came from (JAX `_compute_centroids`, `transformer.py:155-187`):
        the parameter, the carried assignments times the 'from' elements,
        or the first layer's queries2centroids."""
        b = from_elements.shape[0]
        if not self.iterative:
            return self.centroids.expand(b, -1, -1, -1), to_from
        if to_from is not None:
            to_from = upsample_assignments(to_from, self.num_heads, self.to_len, self.from_len)
            return _matmul_promoted(to_from, from_elements), to_from
        if self.queries2centroids is None:
            raise ValueError("no centroid assignments reach this iterative layer, and only "
                             "the first attention layer makes its centroids from its queries")
        q2c = self.queries2centroids(queries)
        return _to_heads(q2c.reshape(b, self.to_len, -1), self.num_heads,
                         2 * self.size_head), to_from

    def forward(self, from_tensor, to_tensor, from_pos=None, to_pos=None, att_vars=None,
                att_mask=None, train=False, gen=None):
        """(out, att_probs, att_vars) as JAX's layer returns them: att_vars
        {"centroid_assignments": [B,N,T,F] or None} hands the assignments
        to the next layer (the iterative carry), None in parametric mode,
        and passes them on unchanged without k-means. `train` applies the
        attention dropout on every pass, its masks drawn from `gen`."""
        to_from = (att_vars or {}).get("centroid_assignments")
        queries = self.to_queries(from_tensor)
        values = self.to_values(to_tensor)
        _queries = queries
        if self.from_pos_map is not None:
            queries = queries + self.from_pos_map(from_pos.to(queries.dtype))[None]
        scale = 1.0 / float(self.size_head) ** 0.5
        if self.kmeans:
            # Scores of the 'from' elements against the centroids; the key
            # projection feeds nothing in this mode.
            from_elements = _to_heads(torch.cat([_queries, queries - _queries], dim=-1),
                                      self.num_heads, 2 * self.size_head)
            to_centroids, to_from = self._centroids(queries, from_elements, to_from)
            att_weight = self.att_weight.to(from_elements.dtype)[None]
        else:
            keys = self.to_keys(to_tensor)
            if self.to_pos_map is not None:
                keys = keys + self.to_pos_map(to_pos.to(keys.dtype))[None]
            att_scores = torch.einsum("bnfh,bnth->bnft",
                                      _to_heads(queries, self.num_heads, self.size_head),
                                      _to_heads(keys, self.num_heads, self.size_head))
        att_probs = None
        for i in range(self.kmeans_iters):
            if self.kmeans:
                if i > 0:
                    to_from = compute_assignments(att_probs)
                    to_centroids = _matmul_promoted(to_from, from_elements)
                # float32 centroids promote bfloat16 elements, as jnp.einsum does.
                dt = torch.promote_types(from_elements.dtype, to_centroids.dtype)
                att_scores = torch.einsum("bnfc,bntc->bnft", (from_elements * att_weight).to(dt),
                                          to_centroids.to(dt))
            # Every pass scales (and masks) the scores, also those of the
            # pass before when there is no k-means, as JAX's loop does.
            att_scores = att_scores * scalar(scale, att_scores.dtype)
            if att_mask is not None:
                att_scores = logits_mask(att_scores, att_mask[:, None, None, :])
            att_probs = torch.softmax(at_least_f32(att_scores), dim=-1)
            if train and self.attention_dropout > 0:
                att_probs = attention_dropout(
                    att_probs, self.attention_dropout,
                    *dropout_masks(att_probs, self.attention_dropout, gen))

        if self.to_gate_attention is not None:
            att_probs = self.to_gate_attention(
                att_probs, to_tensor, to_pos[None] if to_pos is not None else None)
        if self.from_gate_attention is not None:
            att_probs = self.from_gate_attention(
                att_probs, from_tensor, from_pos[None] if from_pos is not None else None)
        if self.kmeans and self.iterative:
            to_from = compute_assignments(att_probs)
        elif not self.iterative:
            to_from = None

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
        return out.to(from_tensor.dtype), att_probs, {"centroid_assignments": to_from}


def _matmul_promoted(a, b):
    """a @ b in the promoted type of the two, as jnp.matmul computes it."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
