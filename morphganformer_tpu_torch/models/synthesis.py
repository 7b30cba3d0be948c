"""Synthesis network: intermediate latents -> image (port of
morphganformer_tpu/models/synthesis.py).

NHWC activations in `cfg.dtype` (float32, or bfloat16 as JAX's blocks cast
them at entry; the parameters, the affine styles and the RGB image stay
float32, and the fused blocks take float32 weights and cast them as JAX's
Pallas wrappers do). Blocks that pass `packed_structural_ok` (for
FFHQ-1024: b256, b512 and b1024) run every conv on the fused kernels of
ops/fused_conv.py, as the JAX package runs them on its Pallas kernels:

    conv0           K2 (2x-up modulated conv, FIR composed in)
    skip            K2 (unmodulated, undemodulated 1x1)
    conv1           K1, with the skip branch added in-kernel
    conv_last       K1 (no bias, no noise: alpha 1, gain 1)

so one 1024^2 forward makes 4 K1 and 6 K2 launches, and its backward 4
K1-adjoint and 6 K3 launches, plus, when the weights are differentiated
(training), 4 K1-dw and 6 K3-dw launches. Built inside
`second_order_scope()` (ops/second_order.py; the path-length stage) the
fused blocks are differentiable twice. The other blocks run the unfused
plain PyTorch path, as does every block under `force_unpacked()`
(ops/packed_override.py; the path-length stage under
MGT_PACKED_SECOND_ORDER=0), and so do the `skip` and
`orig` layouts, whose SAME 3x3 convs at 512^2 and above (b512 conv1, b1024
conv1 and conv_last at FFHQ-1024 widths) run on K4 when MGT_PALLAS_CONV=1
(ops/conv3x3.py). Training runs `noise_mode="random"`: per-sample noise
[N,H,W] drawn from an explicit `torch.Generator`; `train=True` applies the
attention dropout. `plain=True` runs the fused blocks
on the plain versions of the kernels and of their adjoints even on a card
(used to check the kernels). `return_att=True` also returns each attention
layer's probabilities, stacked and up-sampled to the image as JAX's
`_att_maps_to_tensor` does; asking for them changes neither the image nor
the route of any block.

Under a model axis (parallel/tp.py) each conv computes this rank's slice
of its output channels from its whole input and styles, and the slices
are gathered after it: after the fused call and its epilogue (demodulation,
noise, bias, lrelu * gain and the resid all act per output channel; the
skip hands conv1 its own slice, ungathered), or right after the
modulated conv on the unfused path, where the transformer, the noise and
the bias (gathered) act on the whole activation.
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
    GridPositionalEncoding,
    get_global,
    runtime_coef,
)
from morphganformer_tpu_torch.models.transformer import TransformerLayer
from morphganformer_tpu_torch.ops.bias_act import activation_funcs
from morphganformer_tpu_torch.ops.fused_conv import (
    fused_modconv3x3,
    fused_upconv2,
    lw_fir_ok,
    lw_widths_ok,
)
from morphganformer_tpu_torch.ops.modulated_conv import modulated_conv2d
from morphganformer_tpu_torch.ops.packed_override import packed_paths_disabled
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter, upsample2d
from morphganformer_tpu_torch.parallel.tp import from_model, to_model
from morphganformer_tpu_torch.utils.dtype import at_least_f32, to_compute

NOISE_MODES = ("const", "none", "random")


def packed_structural_ok(cfg: GANformerConfig, res: int, noise_mode: str) -> bool:
    """Which blocks run on the fused kernels: the structural part of the JAX
    gate of the same name without its lane-alignment terms, which only the
    TPU's [N, H, G, 128] packing needs, and what the kernels take: a 4-tap
    FIR (K2, K3) and channel counts in fours (K1, K2, K3). A block they
    would refuse runs unfused, as JAX's gate sends it to XLA off the TPU.
    The kernels take batch-shared [H, W] (const) and per-sample [N, H, W]
    (random) noise."""
    return (cfg.architecture == "resnet" and cfg.style and cfg.act == "lrelu"
            and res > 4 and not cfg.use_attention(res) and noise_mode in NOISE_MODES
            and lw_fir_ok(cfg.resample_kernel)
            and lw_widths_ok(cfg.channels(res // 2), cfg.channels(res)))


class SynthesisLayer(nn.Module):
    """Modulated conv + optional duplex attention + noise + bias/act."""

    tp = None

    def __init__(self, cfg: GANformerConfig, in_channels, out_channels, out_res,
                 kernel_size=3, up=1, use_bias=True, gain=1.0,
                 use_transformer=False, local_noise=True, first_attention=False):
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
            self.grid_pos = GridPositionalEncoding(out_res, pos_dim, att.pos_type, att.pos_init,
                                                   att.pos_directions_num)
            self.transformer = TransformerLayer(
                dim=out_channels, pos_dim=pos_dim, from_len=out_res * out_res,
                to_len=cfg.k - 1, from_dim=out_channels, to_dim=cfg.w_dim,
                from_pos=True, to_pos=cfg.mapping.use_pos,
                from_gate=att.img_gate, to_gate=att.ltnt_gate,
                num_heads=att.num_heads, integration=att.integration, norm=att.norm,
                kmeans=att.kmeans, kmeans_iters=att.kmeans_iters, iterative=att.iterative,
                attention_dropout=att.dropout, first=first_attention, to_pos_dim=cfg.w_dim)
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

    def forward(self, x, y, pos=None, mask=None, noise_mode="const", resid=None, fused=None,
                train=False, gen=None, att_vars=None):
        """(x, att, att_vars): `att` is the transformer's attention
        probabilities [B, heads, H * W, k - 1], or None without one;
        `att_vars` the centroid assignments that the transformer hands on
        (JAX `synthesis.py:277-288`), or those it was given without one, as
        the fused branch does (JAX :206). `resid`: the skip
        branch, added after the activation (under a model axis this rank's
        slice of it on the fused path, the whole on the unfused one).
        `fused` ("kernel" / "plain") runs the conv and its epilogue as K1 /
        K2. Random noise and the attention dropout draw from `gen`."""
        if noise_mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, got {noise_mode!r}")
        styles = self.affine(at_least_f32(get_global(y)))
        w = self.weight * self.w_gain
        f = self.resample_filter
        noise = None
        if self.local_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        elif self.local_noise and noise_mode == "random":
            noise = torch.randn((x.shape[0], self.out_res, self.out_res), generator=gen,
                                device=x.device) * self.noise_strength

        tp = self.tp
        if fused is not None:
            x, styles, noise = to_model(x, tp), to_model(styles, tp), to_model(noise, tp)
            if self.biasAct is not None:
                b = self.biasAct.runtime_bias()
                alpha = 0.2
                act_gain = activation_funcs[self.cfg.act].def_gain * self.gain
            else:
                b, alpha, act_gain = None, 1.0, 1.0
            x, plain = x.contiguous(), fused == "plain"
            if self.up == 2:
                x = fused_upconv2(x, w, styles, f, noise, b, act_gain, alpha, True, False,
                                  plain=plain)
                x = x if resid is None else x + resid
            else:
                x = fused_modconv3x3(x, w, styles, noise, b,
                                     None if resid is None else resid.contiguous(),
                                     act_gain, alpha, True, plain=plain)
            return from_model(x, tp), None, att_vars

        x = modulated_conv2d(to_model(x, tp), w.to(x.dtype), styles=to_model(styles, tp),
                             modulate=self.cfg.style, up=self.up,
                             padding=self.kernel_size // 2, resample_kernel=f,
                             flip_weight=(self.up == 1))
        x = from_model(x, tp)
        att = None
        if self.transformer is not None:
            b_, h, wd, c = x.shape
            tokens, att, att_vars = self.transformer(
                x.reshape(b_, h * wd, c), get_components(y).to(x.dtype),
                from_pos=self.grid_pos(),
                to_pos=pos if (self.cfg.mapping.use_pos and pos is not None) else None,
                att_vars=att_vars, att_mask=mask, train=train, gen=gen)
            x = tokens.reshape(b_, h, wd, c)
        if noise is not None:
            x = x + (noise[..., None] if noise.dim() == 3 else noise[None, :, :, None]).to(x.dtype)
        if self.biasAct is not None:
            x = self.biasAct(x, whole=True)
        return (x if resid is None else x + resid.to(x.dtype)), att, att_vars


class ToRGBLayer(nn.Module):
    """1x1 modulated conv without demodulation, with the TF-compat quirk of
    scaling the styles (not the weight) by the runtime gain. Its 3 output
    channels stay replicated but on a model axis of 3 (JAX's rule)."""

    tp = None

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
        styles = self.affine(at_least_f32(get_global(y)))
        w = self.weight
        if self.cfg.style:
            styles = styles * self.w_gain
        else:
            w = w * self.w_gain
        tp = self.tp
        x = modulated_conv2d(to_model(x, tp), w.to(x.dtype), styles=to_model(styles, tp),
                             modulate=self.cfg.style, demodulate=False)
        return at_least_f32(from_model(self.biasAct(x), tp))


class SynthesisBlock(nn.Module):
    """Stem/conv0/conv1(/conv_last) + RGB accumulation."""

    def __init__(self, cfg: GANformerConfig, res: int, first_attention=False):
        """`first_attention`: the block holds the synthesis's first attention
        layer (its first conv), which the iterative carry starts from."""
        super().__init__()
        self.cfg, self.res = cfg, res
        arch = cfg.architecture
        self.is_last = res == cfg.img_resolution
        self.stem = res == 4
        out_ch = cfg.channels(res)
        in_ch = cfg.channels(res // 2) if not self.stem else 0
        use_tr = cfg.use_attention(res)

        def layer(in_c, up, gain, first=False):
            return SynthesisLayer(cfg, in_c, out_ch, res, up=up, gain=gain,
                                  use_transformer=use_tr, local_noise=cfg.local_noise,
                                  first_attention=first)

        if self.stem:
            if cfg.latent_stem:
                self.conv_stem = FullyConnected(cfg.w_dim, out_ch * res * res, act=cfg.act,
                                                gain=math.sqrt(2) / 4)
            else:
                self.const = nn.Parameter(torch.empty(res, res, out_ch))
            self.conv1 = layer(out_ch, 1, 1.0, first_attention)
        else:
            if arch == "resnet":
                self.skip = Conv2dLayer(in_ch, out_ch, 1, use_bias=False, up=2,
                                        resample_kernel=cfg.resample_kernel, gain=get_gain(arch))
            self.conv0 = layer(in_ch, 2, 1.0, first_attention)
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

    def forward(self, x, img, ws, pos=None, mask=None, noise_mode="const", fused=None,
                train=False, gen=None, att_vars=None):
        """(x, img, maps, att_vars): `maps` lists the attention
        probabilities of the block's layers that have a transformer, and
        `att_vars` carries the centroid assignments from layer to layer (JAX
        `synthesis.py:367-392`)."""
        cfg = self.cfg
        w_i = iter(range(ws.shape[2]))
        kw = dict(pos=pos, mask=mask, noise_mode=noise_mode, fused=fused, train=train, gen=gen)
        if self.stem:
            if cfg.latent_stem:
                h = self.conv_stem(get_global(ws[:, :, next(w_i)]))
                x = h.reshape(ws.shape[0], self.res, self.res, -1)
            else:
                x = self.const[None].expand(ws.shape[0], -1, -1, -1)
        x = to_compute(x, cfg)
        maps = []
        if self.stem:
            x, att, att_vars = self.conv1(x, ws[:, :, next(w_i)], att_vars=att_vars, **kw)
            maps.append(att)
        elif cfg.architecture == "resnet":
            # On the fused path conv1 adds the skip in its kernel: this
            # rank's slice of it under a model axis.
            y_skip = self.skip(x, fused=fused, gather=fused is None)
            x, att, att_vars = self.conv0(x, ws[:, :, next(w_i)], att_vars=att_vars, **kw)
            maps.append(att)
            x, att, att_vars = self.conv1(x, ws[:, :, next(w_i)], resid=y_skip,
                                          att_vars=att_vars, **kw)
            maps.append(att)
        else:
            x, att, att_vars = self.conv0(x, ws[:, :, next(w_i)], att_vars=att_vars, **kw)
            maps.append(att)
            x, att, att_vars = self.conv1(x, ws[:, :, next(w_i)], att_vars=att_vars, **kw)
            maps.append(att)
        if img is not None:
            img = upsample2d(img, self.resample_filter)
        if self.is_last:
            x, _, _ = self.conv_last(x, ws[:, :, next(w_i)], noise_mode=noise_mode,
                                     fused=fused, train=train, gen=gen)
        if self.is_last or cfg.architecture == "skip":
            y = self.torgb(x, ws[:, :, next(w_i)])
            img = img + y if img is not None else y
        return x, img, [a for a in maps if a is not None], att_vars


def att_maps_to_tensor(maps, res, device=None):
    """Attention maps [B, N, H_l * W_l, T] of L layers -> [B, T, L, N, res,
    res] float32 (JAX `_att_maps_to_tensor`, `synthesis.py:423-443`). JAX
    up-samples each map with `upsample2d` and a nearest-neighbour kernel of
    a power-of-two factor: every output sums one non-zero product of weight
    1, an exact copy of the value, which is what the repeat here writes.
    Without attention layers: zeros([1]), as JAX returns."""
    if not maps:
        return torch.zeros(1, device=device)
    b, n, _, t = maps[0].shape
    out = torch.empty((b, t, len(maps), n, res, res), dtype=torch.float32,
                      device=maps[0].device)
    for i, a in enumerate(maps):
        s = int(round(a.shape[2] ** 0.5))
        f = res // s
        src = a.permute(0, 3, 1, 2).reshape(b, t, n, s, 1, s, 1)
        out[:, :, i].unflatten(-1, (s, f)).unflatten(-3, (s, f)).copy_(src)
    return out


class SynthesisNetwork(nn.Module):
    def __init__(self, cfg: GANformerConfig):
        super().__init__()
        self.cfg = cfg
        first = next((r for r in cfg.block_resolutions if cfg.use_attention(r)), None)
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", SynthesisBlock(cfg, res, first_attention=res == first))

    def forward(self, ws, pos=None, mask=None, noise_mode="const", plain=False, train=False,
                gen=None, return_att=False):
        """img, or (img, att) under `return_att`: att [B, k-1, L, heads,
        res, res] (att_maps_to_tensor)."""
        cfg = self.cfg
        if tuple(ws.shape[1:]) != (cfg.k, cfg.num_ws, cfg.w_dim):
            raise ValueError(f"ws must be [B,{cfg.k},{cfg.num_ws},{cfg.w_dim}], "
                             f"got {tuple(ws.shape)}")
        ws = at_least_f32(ws)
        x = img = None
        maps = []
        att_vars = {"centroid_assignments": None}
        for res, (start, count) in zip(cfg.block_resolutions, cfg.block_w_slices()):
            fused = (("plain" if plain else "kernel")
                     if packed_structural_ok(cfg, res, noise_mode)
                     and not packed_paths_disabled() else None)
            x, img, block_maps, att_vars = getattr(self, f"b{res}")(
                x, img, ws[:, :, start:start + count], pos=pos, mask=mask,
                noise_mode=noise_mode, fused=fused, train=train, gen=gen, att_vars=att_vars)
            if return_att:
                maps += block_maps
        if return_att:
            return img, att_maps_to_tensor(maps, cfg.img_resolution, ws.device)
        return img
