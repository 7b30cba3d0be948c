"""Synthesis network: intermediate latents -> image (port of
morphganformer_tpu/models/synthesis.py).

NHWC activations, float32. Blocks that pass `packed_structural_ok` (for
FFHQ-1024: b256, b512 and b1024) run every conv on the fused kernels of
ops/fused_conv.py, as the JAX package runs them on its Pallas kernels:

    conv0           K2 (2x-up modulated conv, FIR composed in)
    skip            K2 (unmodulated, undemodulated 1x1)
    conv1           K1, with the skip branch added in-kernel
    conv_last       K1 (no bias, no noise: alpha 1, gain 1)

so one 1024^2 forward makes 4 K1 and 6 K2 launches. The other blocks run the
unfused plain PyTorch path. `plain=True` runs the fused blocks on the plain
versions of the kernels even on a card (used to check the kernels).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import GANformerConfig
from morphganformer_tpu_torch.models.layers import (
    BiasAct,
    Conv2dLayer,
    FullyConnected,
    _fill_,
    _normal_,
    get_components,
    get_gain,
    get_global,
    grid_positional_encoding,
    runtime_coef,
)
from morphganformer_tpu_torch.models.transformer import TransformerLayer
from morphganformer_tpu_torch.ops.bias_act import activation_funcs
from morphganformer_tpu_torch.ops.fused_conv import (
    fused_modconv3x3,
    fused_upconv2,
    modconv3x3_plain,
    upconv2_plain,
)
from morphganformer_tpu_torch.ops.modulated_conv import modulated_conv2d
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d

NOISE_MODES = ("const", "none")


def packed_structural_ok(cfg: GANformerConfig, res: int, noise_mode: str) -> bool:
    """Which blocks run on the fused kernels: the structural part of the JAX
    gate of the same name without its lane-alignment terms, which only the
    TPU's [N, H, G, 128] packing needs. The kernels take batch-shared
    [H, W] noise, hence const or none."""
    return (cfg.architecture == "resnet" and cfg.style and cfg.act == "lrelu"
            and res > 4 and not cfg.use_attention(res) and noise_mode in NOISE_MODES)


class SynthesisLayer(nn.Module):
    """Modulated conv + optional duplex attention + noise + bias/act."""

    def __init__(self, cfg: GANformerConfig, in_channels, out_channels, out_res,
                 kernel_size=3, up=1, use_bias=True, gain=1.0,
                 use_transformer=False, local_noise=True):
        super().__init__()
        self.cfg = cfg
        self.kernel_size, self.up, self.gain = kernel_size, up, gain
        self.out_res, self.local_noise = out_res, local_noise
        self.affine = FullyConnected(cfg.w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, in_channels, out_channels))
        self.w_gain = runtime_coef(in_channels * kernel_size * kernel_size)
        self.register_buffer("resample_filter", setup_filter(list(cfg.resample_kernel)),
                             persistent=False)
        if use_transformer:
            att = cfg.attention
            pos_dim = att.pos_dim or cfg.w_dim
            self.register_buffer(
                "grid_pos", grid_positional_encoding(out_res, pos_dim, att.pos_type,
                                                     att.pos_directions_num),
                persistent=False)
            self.transformer = TransformerLayer(
                dim=out_channels, pos_dim=pos_dim, from_len=out_res * out_res,
                to_len=cfg.k - 1, from_dim=out_channels, to_dim=cfg.w_dim,
                from_pos=True, to_pos=cfg.mapping.use_pos,
                from_gate=att.img_gate, to_gate=att.ltnt_gate,
                num_heads=att.num_heads, integration=att.integration, norm=att.norm,
                kmeans=att.kmeans, kmeans_iters=att.kmeans_iters, iterative=att.iterative)
        else:
            self.transformer = None
        if local_noise:
            self.noise_strength = nn.Parameter(torch.empty(()))
            self.register_buffer("noise_const", torch.empty(out_res, out_res))
        self.biasAct = BiasAct(out_channels, act=cfg.act, gain=gain) if use_bias else None

    def reset_parameters(self, gen):
        _normal_(self.weight, gen)
        if self.local_noise:
            _fill_(self.noise_strength, 0.0)
            _normal_(self.noise_const, gen)

    def forward(self, x, y, pos=None, mask=None, noise_mode="const", resid=None, fused=None):
        """`resid`: the skip branch, added after the activation. `fused`
        ("kernel" / "plain") runs the conv and its epilogue as K1 / K2."""
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, got {noise_mode!r}")
        styles = self.affine(get_global(y).float())
        w = self.weight * self.w_gain
        f = self.resample_filter
        use_noise = self.local_noise and noise_mode == "const"

        if fused is not None:
            noise = self.noise_const * self.noise_strength if use_noise else None
            if self.biasAct is not None:
                b = self.biasAct.runtime_bias()
                alpha = 0.2
                act_gain = activation_funcs[self.cfg.act].def_gain * self.gain
            else:
                b, alpha, act_gain = None, 1.0, 1.0
            x = x.contiguous()
            if self.up == 2:
                op = fused_upconv2 if fused == "kernel" else upconv2_plain
                x = op(x, w, styles, f, noise, b, act_gain, alpha, True, False)
                return x if resid is None else x + resid
            op = fused_modconv3x3 if fused == "kernel" else modconv3x3_plain
            return op(x, w, styles, noise, b, None if resid is None else resid.contiguous(),
                      act_gain, alpha, True)

        x = modulated_conv2d(x, w.to(x.dtype), styles=styles, modulate=self.cfg.style,
                             up=self.up, padding=self.kernel_size // 2,
                             resample_kernel=f, flip_weight=(self.up == 1))
        if self.transformer is not None:
            b_, h, wd, c = x.shape
            tokens, _ = self.transformer(
                x.reshape(b_, h * wd, c), get_components(y).to(x.dtype),
                from_pos=self.grid_pos,
                to_pos=pos if (self.cfg.mapping.use_pos and pos is not None) else None,
                att_mask=mask)
            x = tokens.reshape(b_, h, wd, c)
        if use_noise:
            x = x + (self.noise_const[None, :, :, None] * self.noise_strength).to(x.dtype)
        if self.biasAct is not None:
            x = self.biasAct(x)
        return x if resid is None else x + resid.to(x.dtype)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv without demodulation, with the TF-compat quirk of
    scaling the styles (not the weight) by the runtime gain."""

    def __init__(self, cfg: GANformerConfig, in_channels, out_channels, kernel_size=1):
        super().__init__()
        self.cfg = cfg
        self.affine = FullyConnected(cfg.w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.empty(kernel_size, kernel_size, in_channels, out_channels))
        self.w_gain = runtime_coef(in_channels * kernel_size * kernel_size)
        self.biasAct = BiasAct(out_channels)

    def reset_parameters(self, gen):
        _normal_(self.weight, gen)

    def forward(self, x, y):
        styles = self.affine(get_global(y).float())
        w = self.weight
        if self.cfg.style:
            styles = styles * self.w_gain
        else:
            w = w * self.w_gain
        x = modulated_conv2d(x, w.to(x.dtype), styles=styles, modulate=self.cfg.style,
                             demodulate=False)
        return self.biasAct(x).float()


class SynthesisBlock(nn.Module):
    """Stem/conv0/conv1(/conv_last) + RGB accumulation."""

    def __init__(self, cfg: GANformerConfig, res: int):
        super().__init__()
        self.cfg, self.res = cfg, res
        arch = cfg.architecture
        self.is_last = res == cfg.img_resolution
        self.stem = res == 4
        out_ch = cfg.channels(res)
        in_ch = cfg.channels(res // 2) if not self.stem else 0
        use_tr = cfg.use_attention(res)

        def layer(in_c, up, gain):
            return SynthesisLayer(cfg, in_c, out_ch, res, up=up, gain=gain,
                                  use_transformer=use_tr, local_noise=cfg.local_noise)

        if self.stem:
            if cfg.latent_stem:
                self.conv_stem = FullyConnected(cfg.w_dim, out_ch * res * res, act=cfg.act,
                                                gain=math.sqrt(2) / 4)
            else:
                self.const = nn.Parameter(torch.empty(res, res, out_ch))
            self.conv1 = layer(out_ch, 1, 1.0)
        else:
            if arch == "resnet":
                self.skip = Conv2dLayer(in_ch, out_ch, 1, use_bias=False, up=2,
                                        resample_kernel=cfg.resample_kernel, gain=get_gain(arch))
            self.conv0 = layer(in_ch, 2, 1.0)
            self.conv1 = layer(out_ch, 1, get_gain(arch))
        if self.is_last:
            self.conv_last = SynthesisLayer(cfg, out_ch, out_ch, res, use_bias=False,
                                            local_noise=False)
        if self.is_last or arch == "skip":
            self.torgb = ToRGBLayer(cfg, out_ch, cfg.img_channels)
        self.register_buffer("resample_filter", setup_filter(list(cfg.resample_kernel)),
                             persistent=False)

    def reset_parameters(self, gen):
        if self.stem and not self.cfg.latent_stem:
            _normal_(self.const, gen)

    def forward(self, x, img, ws, pos=None, mask=None, noise_mode="const", fused=None):
        cfg = self.cfg
        w_i = iter(range(ws.shape[2]))
        kw = dict(pos=pos, mask=mask, noise_mode=noise_mode, fused=fused)
        if self.stem:
            if cfg.latent_stem:
                h = self.conv_stem(get_global(ws[:, :, next(w_i)]))
                x = h.reshape(ws.shape[0], self.res, self.res, -1)
            else:
                x = self.const[None].expand(ws.shape[0], -1, -1, -1)
            x = self.conv1(x, ws[:, :, next(w_i)], **kw)
        elif cfg.architecture == "resnet":
            y_skip = self.skip(x, fused=fused)
            x = self.conv0(x, ws[:, :, next(w_i)], **kw)
            x = self.conv1(x, ws[:, :, next(w_i)], resid=y_skip, **kw)
        else:
            x = self.conv0(x, ws[:, :, next(w_i)], **kw)
            x = self.conv1(x, ws[:, :, next(w_i)], **kw)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.is_last:
            x = self.conv_last(x, ws[:, :, next(w_i)], noise_mode=noise_mode, fused=fused)
        if self.is_last or cfg.architecture == "skip":
            y = self.torgb(x, ws[:, :, next(w_i)])
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: GANformerConfig):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(cfg, res))

    def forward(self, ws, pos=None, mask=None, noise_mode="const", plain=False):
        cfg = self.cfg
        if tuple(ws.shape[1:]) != (cfg.k, cfg.num_ws, cfg.w_dim):
            raise ValueError(f"ws must be [B,{cfg.k},{cfg.num_ws},{cfg.w_dim}], "
                             f"got {tuple(ws.shape)}")
        ws = ws.float()
        x = img = None
        for res, (start, count) in zip(cfg.block_resolutions, cfg.block_w_slices()):
            fused = (("plain" if plain else "kernel")
                     if packed_structural_ok(cfg, res, noise_mode) else None)
            x, img = getattr(self, f"b{res}")(x, img, ws[:, :, start:start + count],
                                              pos=pos, mask=mask, noise_mode=noise_mode,
                                              fused=fused)
        return img
