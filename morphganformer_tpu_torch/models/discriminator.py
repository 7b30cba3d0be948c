"""StyleGAN2-style discriminator (port of morphganformer_tpu/models/discriminator.py).

Resnet down-sampling blocks, the minibatch-std layer and the epilogue. NHWC,
float32. Blocks that pass `packed_d_block_eligible` (at 1024^2: b1024 and
b512) run every conv on the fused kernels of ops/fused_conv.py, as the JAX
package runs them on its Pallas kernels:

    fromrgb     plain 1x1 conv + bias + lrelu (the stem's entry)
    skip        K3-forward (1x1 down-conv, FIR composed in, linear, no bias)
    conv0       K1 (styles 1, no demodulation, bias, lrelu)
    conv1       K3-forward (3x3 down-conv, bias, lrelu, the skip added in-kernel)

so one 1024^2 forward makes 2 K1 and 4 K3-forward launches; its backward
makes the K1 adjoint and K2 use_dw launches for dx and the dw launches for
the weights that are differentiated. The other blocks run the unfused plain
PyTorch path, as JAX runs XLA there. `plain=True` runs the fused blocks on
the plain versions of the kernels. The conditional projection (c_dim > 0)
and the skip architecture are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import DiscriminatorConfig
from morphganformer_tpu_torch.models.layers import Conv2dLayer, FullyConnected, get_gain
from morphganformer_tpu_torch.utils.device import resolve_device


def packed_d_structural_ok(cfg: DiscriminatorConfig, res: int) -> bool:
    """The structural part of the JAX gate of the same name without its
    lane-alignment terms, which only the TPU's [N, H, G, 128] packing needs:
    a resnet lrelu block that doubles its channels."""
    if cfg.architecture != "resnet" or cfg.act != "lrelu":
        return False
    return cfg.channels(res // 2) == 2 * cfg.channels(res)


def packed_d_block_eligible(cfg: DiscriminatorConfig, res: int) -> bool:
    """Which blocks run on the fused kernels: those of 512^2 and above, as in
    JAX (`discriminator.py:31-49`, without its TPU check)."""
    return res >= 512 and packed_d_structural_ok(cfg, res)


class DiscriminatorBlock(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig, res: int):
        super().__init__()
        self.cfg, self.res = cfg, res
        in_ch, out_ch = cfg.channels(res), cfg.channels(res // 2)
        self.stem = res == cfg.img_resolution
        if self.stem:
            self.fromrgb = Conv2dLayer(cfg.img_channels, in_ch, 1, act=cfg.act)
        if cfg.architecture == "resnet":
            self.skip = Conv2dLayer(in_ch, out_ch, 1, use_bias=False, down=2,
                                    resample_kernel=cfg.resample_kernel,
                                    gain=get_gain(cfg.architecture))
        self.conv0 = Conv2dLayer(in_ch, in_ch, 3, act=cfg.act)
        self.conv1 = Conv2dLayer(in_ch, out_ch, 3, down=2, resample_kernel=cfg.resample_kernel,
                                 act=cfg.act, gain=get_gain(cfg.architecture))

    def forward(self, x, img, fused=None):
        if self.stem:
            y = self.fromrgb(img)
            x = y if x is None else x + y
        if self.cfg.architecture == "resnet":
            y = self.skip(x, fused=fused)
            x = self.conv0(x, fused=fused)
            return self.conv1(x, fused=fused, resid=y)
        return self.conv1(self.conv0(x, fused=fused), fused=fused)


def minibatch_std(x, group_size, num_channels):
    """Minibatch standard-deviation features (reference MinibatchStdLayer,
    networks.py:1399-1420). x: NHWC."""
    n, h, w, c = x.shape
    g = min(group_size, n) if group_size is not None else n
    if n % g:
        raise ValueError(f"batch {n} not divisible by mbstd group {g}")
    f = num_channels
    y = x.float().reshape(g, n // g, h, w, f, c // f)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)      # [n/g, h, w, f, cc]
    y = y.mean(dim=(1, 2, 4))                            # [n/g, f]
    y = y[:, None, None, :].repeat(g, h, w, 1)           # replicate over group and pixels
    return torch.cat([x, y.to(x.dtype)], dim=-1)


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        in_ch = cfg.channels(4)
        self.conv = Conv2dLayer(in_ch + cfg.mbstd_num_channels, in_ch, 3, act=cfg.act)
        self.fc = FullyConnected(in_ch * 16, in_ch, act=cfg.act)
        self.out = FullyConnected(in_ch, max(cfg.c_dim, 1))

    def forward(self, x):
        cfg = self.cfg
        x = x.float()
        if cfg.mbstd_num_channels > 0:
            x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels)
        x = self.conv(x)
        return self.out(self.fc(x.reshape(x.shape[0], -1)))


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        if cfg.c_dim > 0 or cfg.architecture not in ("resnet", "orig"):
            raise NotImplementedError("the port's discriminator is unconditional, "
                                      "resnet or orig")
        self.cfg = cfg
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(cfg, res))
        self.b4 = DiscriminatorEpilogue(cfg)

    def forward(self, img, plain=False):
        """Logits [N, 1] of images [N, R, R, C] in [-1, 1]."""
        cfg = self.cfg
        if tuple(img.shape[1:]) != (cfg.img_resolution, cfg.img_resolution, cfg.img_channels):
            raise ValueError(f"img must be [N,{cfg.img_resolution},{cfg.img_resolution},"
                             f"{cfg.img_channels}], got {tuple(img.shape)}")
        x = None
        for res in cfg.block_resolutions:
            fused = (("plain" if plain else "kernel")
                     if packed_d_block_eligible(cfg, res) else None)
            x = getattr(self, f"b{res}")(x, img, fused=fused)
        return self.b4(x)


def init_discriminator(cfg: DiscriminatorConfig, seed: int = 0, device="cuda") -> Discriminator:
    """A discriminator with random weights drawn from a CPU `torch.Generator`
    seeded with `seed`, on `device`. The draws differ from JAX's init; parity
    with the JAX package comes from carried weights (checkpoint/convert.py)."""
    device = resolve_device(device)
    model = Discriminator(cfg)
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    return model.to(device)
