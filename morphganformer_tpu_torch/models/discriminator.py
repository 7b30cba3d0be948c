"""StyleGAN2-style discriminator (port of morphganformer_tpu/models/discriminator.py).

Resnet down-sampling blocks, the minibatch-std layer and the epilogue. NHWC;
the blocks compute in `cfg.dtype` (float32, or bfloat16 as JAX's blocks
cast x and fromrgb's input, `discriminator.py:64-98`), the minibatch-std
layer and the epilogue in float32, so the logits are float32; the
parameters stay float32. Blocks that pass `packed_d_block_eligible` (at 1024^2: b1024 and
b512) run every conv on the fused kernels of ops/fused_conv.py, as the JAX
package runs them on its Pallas kernels:

    fromrgb     plain 1x1 conv + bias + lrelu (the stem's entry)
    skip        K3-forward (1x1 down-conv, FIR composed in, linear, no bias)
    conv0       K1 (no styles, no demodulation, bias, lrelu)
    conv1       K3-forward (3x3 down-conv, bias, lrelu, the skip added in-kernel)

so one 1024^2 forward makes 2 K1 and 4 K3-forward launches; its backward
makes the K1 adjoint and K2 use_dw launches for dx and the dw launches for
the weights that are differentiated. Built inside `second_order_scope()`
(ops/second_order.py; the R1 stage) the fused blocks are differentiable
twice. The other blocks run the unfused plain PyTorch path, as JAX runs XLA
there, and so does every block under `force_unpacked()`
(ops/packed_override.py; the R1 stage under MGT_PACKED_SECOND_ORDER=0).
`plain=True` runs
the fused blocks on the plain versions of the kernels.

The `orig` and `skip` layouts (JAX `discriminator.py:94-117`) run unfused;
`skip` adds a `fromrgb` of the image, down-sampled by the FIR once per
block, at every block and in the epilogue. Their conv0 at 512^2 and above
(b1024 and b512 at 1024^2) runs on K4 when MGT_PALLAS_CONV=1
(ops/conv3x3.py). A conditional D (c_dim > 0) gives c_dim outputs and
projects them onto the labels c [N, c_dim]: sum(out * c) per row (JAX
`discriminator.py:158-160`); its blocks are those of the unconditional D.
"""

from __future__ import annotations

import torch
from torch import nn

from morphganformer_tpu_torch.models.config import DiscriminatorConfig
from morphganformer_tpu_torch.models.layers import Conv2dLayer, FullyConnected, get_gain
from morphganformer_tpu_torch.ops.fused_conv import lw_fir_ok, lw_widths_ok
from morphganformer_tpu_torch.ops.packed_override import packed_paths_disabled
from morphganformer_tpu_torch.ops.upfirdn2d import downsample2d, setup_filter
from morphganformer_tpu_torch.parallel.mesh import gather_rows
from morphganformer_tpu_torch.utils.device import resolve_device
from morphganformer_tpu_torch.utils.dtype import at_least_f32, to_compute


def packed_d_structural_ok(cfg: DiscriminatorConfig, res: int) -> bool:
    """The structural part of the JAX gate of the same name without its
    lane-alignment terms, which only the TPU's [N, H, G, 128] packing needs:
    a resnet lrelu block that doubles its channels."""
    if cfg.architecture != "resnet" or cfg.act != "lrelu":
        return False
    return cfg.channels(res // 2) == 2 * cfg.channels(res)


def packed_d_block_eligible(cfg: DiscriminatorConfig, res: int) -> bool:
    """Which blocks run on the fused kernels: those of 512^2 and above, as in
    JAX (`discriminator.py:31-49`, without its TPU check), that the kernels
    take: a 4-tap FIR (K2, K3) and channel counts in fours (K1, K2, K3).
    Other blocks run unfused, as JAX sends them to XLA off the TPU."""
    return (res >= 512 and packed_d_structural_ok(cfg, res)
            and lw_fir_ok(cfg.resample_kernel)
            and lw_widths_ok(cfg.channels(res), cfg.channels(res // 2)))


class DiscriminatorBlock(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig, res: int):
        super().__init__()
        self.cfg, self.res = cfg, res
        in_ch, out_ch = cfg.channels(res), cfg.channels(res // 2)
        self.stem = res == cfg.img_resolution
        if self.stem or cfg.architecture == "skip":
            self.fromrgb = Conv2dLayer(cfg.img_channels, in_ch, 1, act=cfg.act)
        if cfg.architecture == "resnet":
            self.skip = Conv2dLayer(in_ch, out_ch, 1, use_bias=False, down=2,
                                    resample_kernel=cfg.resample_kernel,
                                    gain=get_gain(cfg.architecture))
        self.conv0 = Conv2dLayer(in_ch, in_ch, 3, act=cfg.act)
        self.conv1 = Conv2dLayer(in_ch, out_ch, 3, down=2, resample_kernel=cfg.resample_kernel,
                                 act=cfg.act, gain=get_gain(cfg.architecture))
        self.register_buffer("resample_filter", setup_filter(list(cfg.resample_kernel)),
                             persistent=False)

    def forward(self, x, img, fused=None):
        """(x, img) -> (x at half the resolution, img): `skip` hands the next
        block the image down-sampled, the other layouts hand `img` on."""
        skip = self.cfg.architecture == "skip"
        if x is not None:
            x = to_compute(x, self.cfg)
        if self.stem or skip:
            y = self.fromrgb(to_compute(img, self.cfg))
            x = y if x is None else x + y
            if skip:
                img = downsample2d(img, self.resample_filter)
        if self.cfg.architecture == "resnet":
            y = self.skip(x, fused=fused)
            x = self.conv0(x, fused=fused)
            return self.conv1(x, fused=fused, resid=y), img
        return self.conv1(self.conv0(x, fused=fused), fused=fused), img


def minibatch_std(x, group_size, num_channels, mesh=None):
    """Minibatch standard-deviation features (reference MinibatchStdLayer,
    networks.py:1399-1420). x: NHWC.

    Under a data mesh of more than one rank, x is this rank's block of the
    global batch: the blocks are gathered (differentiably, so each rank's
    gradient reaches the others' rows), the groups formed over the global
    batch as JAX forms them under its mesh (group j holds rows j, j + n/g,
    ..., which span the ranks), and this rank's rows of the result kept."""
    if mesh is not None and mesh.world > 1:
        rows = x.shape[0]
        full = minibatch_std(gather_rows(x, mesh), group_size, num_channels)
        return full[mesh.rank * rows:(mesh.rank + 1) * rows]
    n, h, w, c = x.shape
    g = min(group_size, n) if group_size is not None else n
    if n % g:
        raise ValueError(f"batch {n} not divisible by mbstd group {g}")
    f = num_channels
    y = at_least_f32(x).reshape(g, n // g, h, w, f, c // f)
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
        if cfg.architecture == "skip":
            self.fromrgb = Conv2dLayer(cfg.img_channels, in_ch, 1, act=cfg.act)
        self.conv = Conv2dLayer(in_ch + cfg.mbstd_num_channels, in_ch, 3, act=cfg.act)
        self.fc = FullyConnected(in_ch * 16, in_ch, act=cfg.act)
        self.out = FullyConnected(in_ch, max(cfg.c_dim, 1))

    def forward(self, x, img, c=None, mesh=None):
        cfg = self.cfg
        x = at_least_f32(x)
        if cfg.architecture == "skip":
            x = x + self.fromrgb(at_least_f32(img))
        if cfg.mbstd_num_channels > 0:
            x = minibatch_std(x, cfg.mbstd_group_size, cfg.mbstd_num_channels, mesh)
        x = self.conv(x)
        x = self.out(self.fc(x.reshape(x.shape[0], -1)))
        if cfg.c_dim > 0:
            x = (x * c).sum(dim=1, keepdim=True)
        return x


class Discriminator(nn.Module):
    def __init__(self, cfg: DiscriminatorConfig):
        super().__init__()
        self.cfg = cfg
        for res in cfg.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(cfg, res))
        self.b4 = DiscriminatorEpilogue(cfg)

    def forward(self, img, c=None, plain=False, mesh=None):
        """Logits [N, 1] of images [N, R, R, C] in [-1, 1] (with their labels
        c [N, c_dim] for a conditional D); under a data `mesh`, of this
        rank's rows, with the minibatch-std over every rank's."""
        cfg = self.cfg
        if tuple(img.shape[1:]) != (cfg.img_resolution, cfg.img_resolution, cfg.img_channels):
            raise ValueError(f"img must be [N,{cfg.img_resolution},{cfg.img_resolution},"
                             f"{cfg.img_channels}], got {tuple(img.shape)}")
        if cfg.c_dim > 0 and (c is None or tuple(c.shape) != (img.shape[0], cfg.c_dim)):
            raise ValueError(f"a conditional D (c_dim {cfg.c_dim}) needs labels c "
                             f"[{img.shape[0]}, {cfg.c_dim}], got "
                             f"{None if c is None else tuple(c.shape)}")
        x = None
        for res in cfg.block_resolutions:
            fused = (("plain" if plain else "kernel")
                     if packed_d_block_eligible(cfg, res) and not packed_paths_disabled()
                     else None)
            x, img = getattr(self, f"b{res}")(x, img, fused=fused)
        return self.b4(x, img, c, mesh)


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
