"""Building-block layers (port of morphganformer_tpu/models/layers.py).

NHWC activations, equalized learning rate. Parameters are stored as the JAX
package stores them ([in, out] and HWIO, scaled down by the runtime
coefficient), under the same names, so a flax variables tree maps onto a
state_dict by joining its path (checkpoint/convert.py). Each module that owns
parameters initialises them in `reset_parameters(gen)` from a
`torch.Generator`.

Under a model axis (parallel/tp.py `shard_params`) a layer whose weight or
bias is sharded holds this rank's slice of its output channels and carries
the axis as `tp`: it computes that slice from its whole input
(`to_model`) and gathers the whole output (`from_model`); without one, `tp`
is None and both are the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from morphganformer_tpu_torch.ops.bias_act import activation_funcs, bias_act
from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample
from morphganformer_tpu_torch.ops.fused_conv import (
    fused_downconv2,
    fused_modconv3x3,
    fused_upconv2,
)
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter
from morphganformer_tpu_torch.parallel.tp import from_model, to_model
from morphganformer_tpu_torch.utils.dtype import at_least_f32


def normalize_l2(x, eps=1e-8):
    """Scale so the mean square over all non-batch dims is 1 (float32)."""
    x = at_least_f32(x)
    dims = tuple(range(1, x.ndim))
    return x * torch.rsqrt(x.square().mean(dim=dims, keepdim=True) + eps)


def get_global(ws):
    """Global latent component = last."""
    return ws[:, -1]


def get_components(ws):
    """Local latent components = all but last."""
    return ws[:, :-1]


def get_gain(arch: str) -> float:
    """Resnet branches are scaled by 1/sqrt(2)."""
    return math.sqrt(0.5) if arch == "resnet" else 1.0


def runtime_coef(fan_in: int, gain: float = 1.0, lrmul: float = 1.0) -> float:
    """He-std runtime multiplier."""
    return gain / math.sqrt(fan_in) * lrmul


def _normal_(p, gen, std=1.0):
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=gen) * std)


def _fill_(p, value):
    with torch.no_grad():
        p.fill_(value)


class FullyConnected(nn.Module):
    """act(x @ (w * coef) + b * lrmul) over the last axis; under a model axis
    this rank's output features, then all of them gathered."""

    tp = None

    def __init__(self, in_features, features, use_bias=True, act="linear",
                 gain=1.0, lrmul=1.0, bias_init=0.0):
        super().__init__()
        self.act, self.lrmul, self.bias_init = act, lrmul, bias_init
        self.coef = runtime_coef(in_features, gain, lrmul)
        self.weight = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, gen):
        _normal_(self.weight, gen, 1.0 / self.lrmul)
        if self.bias is not None:
            _fill_(self.bias, self.bias_init)

    def forward(self, x):
        x = to_model(x, self.tp)
        y = x @ (self.weight * self.coef).to(x.dtype)
        b = None if self.bias is None else self.bias * self.lrmul
        if self.act == "linear":
            y = y if b is None else y + b.to(y.dtype)
        else:
            y = bias_act(y, b, act=self.act)
        return from_model(y, self.tp)


class BiasAct(nn.Module):
    """Bias + activation + gain over the last axis (NHWC). Under a model
    axis the bias is this rank's slice: it applies to the slice of the
    output channels, or gathered (`whole=True`) to the whole activation."""

    tp = None

    def __init__(self, num_channels, use_bias=True, act="linear", lrmul=1.0,
                 bias_init=0.0, gain=1.0):
        super().__init__()
        self.act, self.lrmul, self.bias_init, self.gain = act, lrmul, bias_init, gain
        self.bias = nn.Parameter(torch.empty(num_channels)) if use_bias else None

    def reset_parameters(self, gen):
        if self.bias is not None:
            _fill_(self.bias, self.bias_init)

    def runtime_bias(self):
        """The bias as the fused kernels take it (None when absent)."""
        return None if self.bias is None else self.bias * self.lrmul

    def forward(self, x, whole=False):
        gain = activation_funcs[self.act].def_gain * self.gain
        b = self.runtime_bias()
        return bias_act(x, from_model(b, self.tp) if whole else b, act=self.act, gain=gain)


class ResnetLayer(nn.Module):
    """fc0(act) -> fc1 -> lrelu(x + skip) (the final lrelu has no gain)."""

    def __init__(self, channels, act="linear", lrmul=1.0):
        super().__init__()
        self.fc0 = FullyConnected(channels, channels, act=act, lrmul=lrmul)
        self.fc1 = FullyConnected(channels, channels, lrmul=lrmul)

    def forward(self, x, skip):
        return torch.nn.functional.leaky_relu(self.fc1(self.fc0(x)) + skip, 0.2)


class Conv2dLayer(nn.Module):
    """Conv + resample + bias/act: the synthesis resnet skip branch and the
    discriminator's layers. Under a model axis it computes this rank's
    output channels and gathers them (`gather=False` keeps the slice, for a
    fused layer's resid)."""

    tp = None

    def __init__(self, in_channels, out_channels, kernel_size, use_bias=True,
                 act="linear", up=1, down=1, resample_kernel=(1, 3, 3, 1), gain=1.0):
        super().__init__()
        self.kernel_size, self.up, self.down, self.gain = kernel_size, up, down, gain
        self.coef = runtime_coef(in_channels * kernel_size * kernel_size)
        self.weight = nn.Parameter(
            torch.empty(kernel_size, kernel_size, in_channels, out_channels))
        self.biasAct = BiasAct(out_channels, use_bias=use_bias, act=act, gain=gain)
        self.register_buffer("resample_filter", setup_filter(list(resample_kernel)),
                             persistent=False)

    def reset_parameters(self, gen):
        _normal_(self.weight, gen)

    def _forward_fused(self, x, w, f, resid, plain):
        """The fused branches (JAX `layers.py:170-227`): the unmodulated 1x1
        up-conv skip on K2, the 2x-down conv on K3-forward (bias, lrelu and
        the resnet skip-add in its epilogue), the same-res 3x3 conv on K1
        with no styles (JAX's styles 1) and no demodulation."""
        act = self.biasAct.act
        if act not in ("lrelu", "linear"):
            raise ValueError(f"the fused branches take lrelu or linear, got {act!r}")
        x = x.contiguous()
        resid = None if resid is None else resid.contiguous()
        if self.up == 2:
            if self.kernel_size != 1 or self.down != 1 or self.biasAct.bias is not None \
                    or act != "linear" or resid is not None:
                raise ValueError("the fused up-conv is the linear, bias-free 1x1 skip")
            return fused_upconv2(x, w, None, f, None, None, self.gain, 1.0, False, False,
                                 plain=plain)
        gain = activation_funcs[act].def_gain * self.gain
        alpha = 0.2 if act == "lrelu" else 1.0
        b = self.biasAct.runtime_bias()
        if self.down == 2:
            return fused_downconv2(x, w, f, b, resid, gain, alpha, True, plain=plain)
        if self.kernel_size == 3 and self.down == 1:
            return fused_modconv3x3(x, w, None, None, b, resid, gain, alpha, False, plain=plain)
        raise ValueError("no fused branch for this layer")

    def forward(self, x, fused=None, resid=None, gather=True):
        """`fused` ("kernel" or "plain") runs the layer on the fused kernels
        (or their plain versions); None runs the unfused conv2d_resample path.
        `resid`: a skip branch added after the activation, shaped like the
        output; under a model axis this rank's slice of it on the fused path
        (the kernels add it), the whole of it on the unfused one. `gather`
        False returns this rank's slice of the output channels."""
        tp = self.tp
        x = to_model(x, tp)
        w = self.weight * self.coef
        f = self.resample_filter
        if fused is not None:
            y = self._forward_fused(x, w, f, resid, fused == "plain")
            return from_model(y, tp) if gather else y
        x = conv2d_resample(x, w.to(x.dtype), f=f, up=self.up, down=self.down,
                            padding=self.kernel_size // 2, flip_weight=(self.up == 1))
        x = self.biasAct(x)
        if gather:
            x = from_model(x, tp)
        return x if resid is None else x + resid.to(x.dtype)


def sinusoidal_encoding(size: int, dim: int, num: int = 2) -> np.ndarray:
    """2D sinusoidal grid embedding [size, size, dim]."""
    if num == 2:
        c = np.linspace(-1.0, 1.0, size)[:, None]
        i = np.arange(dim // 4, dtype=np.float64)
        pe_sin = np.sin(c / np.power(10000.0, 4 * i / dim))
        pe_cos = np.cos(c / np.power(10000.0, 4 * i / dim))
        sin_x = np.tile(pe_sin[None, :, :], (size, 1, 1))
        cos_x = np.tile(pe_cos[None, :, :], (size, 1, 1))
        sin_y = np.tile(pe_sin[:, None, :], (1, size, 1))
        cos_y = np.tile(pe_cos[:, None, :], (1, size, 1))
        emb = np.concatenate([sin_x, cos_x, sin_y, cos_y], axis=-1)
    else:
        theta = np.arange(0, math.pi, math.pi / num)
        dirs = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
        c = np.linspace(-1.0, 1.0, size)
        x = np.tile(c[None, :], (size, 1))
        y = np.tile(c[:, None], (1, size))
        xy = np.stack([x, y], axis=-1)
        lens = np.sum(xy[:, :, None, :] * dirs, axis=-1, keepdims=True)
        i = np.arange(dim // (2 * num), dtype=np.float64)
        sins = np.sin(lens / np.power(10000.0, 2 * num * i / dim))
        coss = np.cos(lens / np.power(10000.0, 2 * num * i / dim))
        emb = np.concatenate([sins, coss], axis=-1).reshape(size, size, dim)
    return emb.astype(np.float32)


def linear_encoding_dirs(size: int, num: int) -> np.ndarray:
    """Direction-projected grid lengths [size, size, num, 1] of the linear
    encoding, which multiplies them by a trainable [num, dim/num] table."""
    theta = np.arange(0, math.pi, math.pi / num)
    dirs = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    c = np.linspace(-1.0, 1.0, size)
    x = np.tile(c[None, :], (size, 1))
    y = np.tile(c[:, None], (1, size))
    xy = np.stack([x, y], axis=-1)
    lens = np.sum(xy[:, :, None, :] * dirs, axis=-1, keepdims=True)
    return lens.astype(np.float32)


POS_TYPES = ("sinus", "linear", "trainable", "trainable2d")


class GridPositionalEncoding(nn.Module):
    """Positional encoding of a res x res grid, [res*res, pos_dim] row-major
    (JAX `GridPositionalEncoding`, `layers.py:270-319`). "sinus" is a fixed
    buffer; "linear" multiplies the fixed direction lengths by the parameter
    `pos0` [num, pos_dim/num]; "trainable" tiles `pos0` [res, pos_dim/2]
    along x and `pos1` along y; "trainable2d" is
    the parameter `pos0` [res, res, pos_dim]. The parameters are drawn
    uniform in [0, 1) or normal (`pos_init`), as flax's initialisers."""

    def __init__(self, res, pos_dim, pos_type="sinus", pos_init="uniform",
                 pos_directions_num=2):
        super().__init__()
        if pos_type not in POS_TYPES:
            raise ValueError(f"pos_type must be one of {POS_TYPES}, got {pos_type!r}")
        if pos_init not in ("uniform", "normal"):
            raise ValueError(f"pos_init must be uniform or normal, got {pos_init!r}")
        self.res, self.pos_dim, self.pos_type = res, pos_dim, pos_type
        self.pos_init = pos_init
        s, d, num = res, pos_dim, pos_directions_num
        if pos_type == "sinus":
            emb = sinusoidal_encoding(s, d, num).reshape(s * s, d)
            self.register_buffer("emb", torch.from_numpy(emb), persistent=False)
        elif pos_type == "linear":
            self.register_buffer("lens", torch.from_numpy(linear_encoding_dirs(s, num)),
                                 persistent=False)
            self.pos0 = nn.Parameter(torch.empty(num, d // num))
        elif pos_type == "trainable2d":
            self.pos0 = nn.Parameter(torch.empty(s, s, d))
        else:
            self.pos0 = nn.Parameter(torch.empty(s, d // 2))
            self.pos1 = nn.Parameter(torch.empty(s, d // 2))

    def reset_parameters(self, gen):
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.copy_(torch.rand(p.shape, generator=gen) if self.pos_init == "uniform"
                        else torch.randn(p.shape, generator=gen))

    def forward(self):
        s, d = self.res, self.pos_dim
        if self.pos_type == "sinus":
            return self.emb
        if self.pos_type == "linear":
            return (self.lens * self.pos0).reshape(s * s, d)
        if self.pos_type == "trainable2d":
            return self.pos0.reshape(s * s, d)
        return torch.cat([self.pos0[None, :, :].expand(s, -1, -1),
                          self.pos1[:, None, :].expand(-1, s, -1)], dim=-1).reshape(s * s, d)


def logits_mask(x, mask):
    """-10000 where mask == 0."""
    return x + (1.0 - mask.float()) * -10000.0
