"""Building-block layers (port of morphganformer_tpu/models/layers.py).

NHWC activations, equalized learning rate. Parameters are stored as the JAX
package stores them ([in, out] and HWIO, scaled down by the runtime
coefficient), under the same names, so a flax variables tree maps onto a
state_dict by joining its path (checkpoint/convert.py). Each module that owns
parameters initialises them in `reset_parameters(gen)` from a
`torch.Generator`.
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
    """act(x @ (w * coef) + b * lrmul) over the last axis."""

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
        y = x @ (self.weight * self.coef).to(x.dtype)
        b = None if self.bias is None else self.bias * self.lrmul
        if self.act == "linear":
            return y if b is None else y + b.to(y.dtype)
        return bias_act(y, b, act=self.act)


class BiasAct(nn.Module):
    """Bias + activation + gain over the last axis (NHWC)."""

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

    def forward(self, x):
        gain = activation_funcs[self.act].def_gain * self.gain
        return bias_act(x, self.runtime_bias(), act=self.act, gain=gain)


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
    discriminator's layers."""

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

    def forward(self, x, fused=None, resid=None):
        """`fused` ("kernel" or "plain") runs the layer on the fused kernels
        (or their plain versions); None runs the unfused conv2d_resample path.
        `resid`: a skip branch shaped like the output, added after the
        activation."""
        w = self.weight * self.coef
        f = self.resample_filter
        if fused is not None:
            return self._forward_fused(x, w, f, resid, fused == "plain")
        x = conv2d_resample(x, w.to(x.dtype), f=f, up=self.up, down=self.down,
                            padding=self.kernel_size // 2, flip_weight=(self.up == 1))
        x = self.biasAct(x)
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


def grid_positional_encoding(res, pos_dim, pos_type="sinus", pos_directions_num=2):
    """Fixed positional encoding of a res x res grid, [res*res, pos_dim]
    row-major. The trainable and linear encodings are not ported yet."""
    if pos_type != "sinus":
        raise NotImplementedError(f"pos_type {pos_type!r} is not ported")
    emb = sinusoidal_encoding(res, pos_dim, pos_directions_num)
    return torch.from_numpy(emb.reshape(res * res, pos_dim))


def logits_mask(x, mask):
    """-10000 where mask == 0."""
    return x + (1.0 - mask.float()) * -10000.0
