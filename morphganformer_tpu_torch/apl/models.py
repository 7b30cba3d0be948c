"""The modules of Adaptive Posterior Learning (port of
morphganformer_tpu/apl/models.py; reference apl/models.py): MHDPA
self-attention over memory slots, NormMLP, ResidualTransform, the
relational self-attention feed-forward decoder RSAFFDecoder and the
strided-conv Encoder.

Each module names its parameters as the flax module does (a Dense holds
`kernel` [in, out] and `bias`, a Conv `kernel` HWIO, a LayerNorm `scale`
and `bias`, a BatchNorm `scale` and `bias` with `mean` and `var` running
statistics), so `from_flax` copies a flax variables tree in by path. The
norms compute as flax's do: the variance as E[x^2] - E[x]^2 clipped at 0,
LayerNorm's epsilon 1e-6, BatchNorm's 1e-5 with momentum 0.99 and the
biased batch variance in its running statistics. Like JAX's:

- MHDPA layer-norms the QKV projection jointly over (slots, features)
  with a per-(slot, feature) affine, torch's nn.LayerNorm([slots,
  features]);
- the decoder softmaxes the negated distances once and uses the weights
  both as an input feature and for the distance-weighted readout;
- the Encoder's final norm covers whatever the flatten yields (the
  reference hard-codes 32), and an optional Dense maps to `embed_dim`.

Activations are NHWC for the Encoder, as in JAX. Every constructor takes
the input widths that flax infers on its first call, an explicit device
and an explicit `torch.Generator` for the initial weights (flax's
initialisers: LeCun-normal kernels truncated at two standard deviations,
zero biases, unit scales, unit-variance embeddings).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def _truncated_normal(shape, fan_in, generator, device):
    """flax's lecun_normal: a normal truncated to [-2, 2], scaled to
    variance 1 / fan_in."""
    x = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0, generator=generator)
    return (x * math.sqrt(1.0 / fan_in) / 0.87962566103423978).to(device)


def _stats(x, dims):
    """flax's fast variance: (mean, max(E[x^2] - mean^2, 0))."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return mean, var


class Dense(nn.Module):
    """flax nn.Dense: x @ kernel + bias."""

    def __init__(self, in_features, out_features, generator, device="cuda"):
        super().__init__()
        self.kernel = nn.Parameter(_truncated_normal((in_features, out_features), in_features,
                                                     generator, device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (epsilon 1e-6)."""

    def __init__(self, features, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        mean, var = _stats(x, (-1,))
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over the last axis of NHWC: batch statistics in
    training (the running ones updated with momentum 0.99 and the biased
    variance), the running ones in evaluation; epsilon 1e-5."""

    def __init__(self, features, device="cuda"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, train):
        if train:
            mean, var = _stats(x, (0, 1, 2))
            with torch.no_grad():
                self.mean.mul_(0.99).add_(0.01 * mean.reshape(-1))
                self.var.mul_(0.99).add_(0.01 * var.reshape(-1))
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + 1e-5) * self.scale) + self.bias


class Conv(nn.Module):
    """flax nn.Conv on NHWC with an HWIO kernel, padding 1 on each side."""

    def __init__(self, in_channels, out_channels, stride, generator, device="cuda"):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(_truncated_normal((3, 3, in_channels, out_channels),
                                                     9 * in_channels, generator, device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1), stride=self.stride,
                     padding=1)
        return y.permute(0, 2, 3, 1) + self.bias


class MHDPA(nn.Module):
    """Multi-head dot-product self-attention over memory slots (reference
    models.py:7-92); `in_features` is the memory's feature width."""

    def __init__(self, memory_slots, key_size, value_size, n_heads, in_features, generator,
                 device="cuda"):
        super().__init__()
        self.key_size, self.value_size, self.n_heads = key_size, value_size, n_heads
        self.qkv_size = 2 * key_size + value_size
        self.qkv_projector = Dense(in_features, n_heads * self.qkv_size, generator, device)
        shape = (memory_slots, n_heads * self.qkv_size)
        self.qkv_layernorm_scale = nn.Parameter(torch.ones(shape, device=device))
        self.qkv_layernorm_bias = nn.Parameter(torch.zeros(shape, device=device))

    def forward(self, memory):
        b, n = memory.shape[:2]
        qkv = self.qkv_projector(memory)
        mean, var = _stats(qkv, (-2, -1))
        qkv = (qkv - mean) * torch.rsqrt(var + 1e-5) * self.qkv_layernorm_scale \
            + self.qkv_layernorm_bias
        qkv = qkv.reshape(b, n, self.n_heads, self.qkv_size)
        q, k, v = torch.split(qkv, [self.key_size, self.key_size, self.value_size], dim=-1)
        q = q * self.key_size ** -0.5
        weights = torch.softmax(torch.einsum("bnhk,bmhk->bhnm", q, k), dim=-1)
        out = torch.einsum("bhnm,bmhv->bnhv", weights, v)
        return out.reshape(b, n, self.n_heads * self.value_size)


class NormMLP(nn.Module):
    """layer_norm(linear(relu(x))) (reference models.py:95-103)."""

    def __init__(self, output_size, in_features, generator, device="cuda"):
        super().__init__()
        self.Dense_0 = Dense(in_features, output_size, generator, device)
        self.LayerNorm_0 = LayerNorm(output_size, device)

    def forward(self, x):
        return self.LayerNorm_0(self.Dense_0(torch.relu(x)))


class ResidualTransform(nn.Module):
    """Residual MHDPA, then residual NormMLP (reference models.py:106-116)."""

    def __init__(self, n_neighbours, key_size, value_size, n_heads, hidden_dim, generator,
                 device="cuda"):
        super().__init__()
        self.attention = MHDPA(n_neighbours, key_size, value_size, n_heads, hidden_dim,
                               generator, device)
        self.norm_mlp = NormMLP(hidden_dim, hidden_dim, generator, device)

    def forward(self, x):
        x = x + self.attention(x)
        return x + self.norm_mlp(x)


class RSAFFDecoder(nn.Module):
    """Classify a query embedding from its retrieved neighbours, their
    labels and the retrieval distances (reference models.py:119-191). The
    neighbours' embeddings are `buffer_embed_dim` wide (default
    query_embed_dim)."""

    def __init__(self, n_classes, query_embed_dim, label_embed_dim, n_neighbours, key_size,
                 value_size, n_heads, num_layers, generator, device="cuda",
                 buffer_embed_dim: Optional[int] = None):
        super().__init__()
        hidden = value_size * n_heads
        width = (buffer_embed_dim or query_embed_dim) + label_embed_dim + query_embed_dim + 1
        self.label_embeddings = nn.Module()
        self.label_embeddings.embedding = nn.Parameter(
            torch.randn((n_classes + 1, label_embed_dim), generator=generator).to(device))
        self.pre_transform = Dense(width, hidden, generator, device)
        for i in range(num_layers):
            setattr(self, f"residual_{i}", ResidualTransform(
                n_neighbours, key_size, value_size, n_heads, hidden, generator, device))
        self.num_layers = num_layers
        self.logits = Dense(hidden, n_classes, generator, device)

    def forward(self, buffer_embeds, buffer_labels, query, distances):
        """buffer_embeds [B, N, E], buffer_labels [B, N] (n_classes is
        "unseen"), query [B, E], distances [B, N] -> logits [B, n_classes]."""
        weights = torch.softmax(-distances, dim=1)
        label_embeds = self.label_embeddings.embedding[buffer_labels.long()]
        query_copies = query[:, None, :].expand(*buffer_embeds.shape[:2], query.shape[-1])
        memory = self.pre_transform(torch.cat(
            [buffer_embeds, label_embeds, query_copies, weights[..., None]], dim=-1))
        for i in range(self.num_layers):
            memory = getattr(self, f"residual_{i}")(memory)
        return self.logits((memory * weights[..., None]).sum(dim=1))


class _BasicBlock(nn.Module):
    """conv(relu(batchnorm(x))) (reference models.py:194-202)."""

    def __init__(self, in_channels, stride, generator, device):
        super().__init__()
        self.batch_norm = BatchNorm(in_channels, device)
        self.conv = Conv(in_channels, 64, stride, generator, device)

    def forward(self, x, train):
        return self.conv(torch.relu(self.batch_norm(x, train)))


class _BlockCombo(nn.Module):
    """A stride-2 block, then two residual stride-1 blocks (reference
    models.py:205-217)."""

    def __init__(self, in_channels, generator, device):
        super().__init__()
        self.block1 = _BasicBlock(in_channels, 2, generator, device)
        self.block2 = _BasicBlock(64, 1, generator, device)
        self.block3 = _BasicBlock(64, 1, generator, device)

    def forward(self, x, train):
        out = self.block1(x, train)
        out = out + self.block2(out, train)
        return out + self.block3(out, train)


class Encoder(nn.Module):
    """Image -> embedding (reference models.py:220-233): a 3x3 conv to 64
    channels, five BlockCombos (each halving the resolution), flatten,
    LayerNorm, and a Dense to `embed_dim` unless it is None or already the
    flattened width. `in_shape` is the NHWC input's (H, W, C)."""

    def __init__(self, in_shape, generator, embed_dim: Optional[int] = None, device="cuda"):
        super().__init__()
        h, w, c = in_shape
        self.conv = Conv(c, 64, 1, generator, device)
        for i in range(5):
            setattr(self, f"combo_{i}", _BlockCombo(64, generator, device))
            h, w = (h + 1) // 2, (w + 1) // 2
        flat = h * w * 64
        self.norm = LayerNorm(flat, device)
        self.proj = (Dense(flat, embed_dim, generator, device)
                     if embed_dim is not None and embed_dim != flat else None)

    def forward(self, x, train=False):
        x = self.conv(x)
        for i in range(5):
            x = getattr(self, f"combo_{i}")(x, train)
        x = self.norm(x.reshape(x.shape[0], -1))
        return x if self.proj is None else self.proj(x)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def from_flax(module: nn.Module, variables) -> nn.Module:
    """Copy a flax variables tree ({"params": ..., "batch_stats": ...}) into
    `module` by path; every parameter and statistic must be matched."""
    state = module.state_dict()
    seen = set()
    for collection in ("params", "batch_stats"):
        for key, value in _flat(variables.get(collection, {})):
            if key not in state:
                raise KeyError(f"{collection}/{key} has no counterpart in {type(module).__name__}")
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if tuple(arr.shape) != tuple(state[key].shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                                 f"{tuple(state[key].shape)}")
            state[key] = arr.to(state[key].device)
            seen.add(key)
    missing = set(state) - seen
    if missing:
        raise KeyError(f"not in the flax tree: {sorted(missing)}")
    module.load_state_dict(state)
    return module
