"""FIR up/down resampling of NHWC feature maps (port of
morphganformer_tpu/ops/upfirdn2d.py).

For each channel: zero-insert upsample by `up` (up-1 zeros after each
pixel), pad (negative = crop) w.r.t. the upsampled image, correlate with the
FIR filter (flipped first unless `flip_filter`), keep every `down`-th pixel.
Runs as a depthwise `F.conv2d` in NCHW between two permutes, through a pair
of autograd Functions, the FIR and its transpose, each the other's
backward: the same function with the same first and second derivatives as
autograd's convolution, but no derivative in the (constant) filter, which
autograd's double backward of a grouped convolution forms per group
(`aten::_convolution_double_backward`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding):
    """int / [x, y] / [x0, x1, y0, y1] -> (px0, px1, py0, py1)."""
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        padding = [px, px, py, py]
    px0, px1, py0, py1 = padding
    return int(px0), int(px1), int(py0), int(py1)


def _get_filter_size(f):
    """Filter -> (fw, fh). None counts as a 1x1 impulse."""
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None):
    """Prepare a FIR filter for `upfirdn2d`: float32 [fh, fw] (or [taps] when
    separable), normalised to sum 1 and scaled by gain."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float64)
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.tensor(np.ascontiguousarray(f), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def nearest_neighbors_kernel(factor=2):
    """Nearest-neighbour upsampling kernel. Cached: callers must not modify it."""
    return setup_filter([1] * factor)


def _pad_nchw(x, px0, px1, py0, py1):
    """Pad (or crop, where negative) the two spatial dims of NCHW x."""
    return F.pad(x, [px0, px1, py0, py1])


def _zero_insert_nchw(x, upx, upy):
    """[N,C,H,W] -> [N,C,H*upy,W*upx] with up-1 zeros after each pixel."""
    if upx == 1 and upy == 1:
        return x
    n, c, h, w = x.shape
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    return x.reshape(n, c, h * upy, w * upx)


class _DepthwiseFIR(torch.autograd.Function):
    """y = the valid depthwise correlation of x [N,C,H,W] with f [C,1,fh,fw];
    its backward is `_DepthwiseFIRT` (the filter takes no cotangent)."""

    @staticmethod
    def forward(ctx, x, f):
        ctx.save_for_backward(f)
        return F.conv2d(x, f, groups=f.shape[0])

    @staticmethod
    def backward(ctx, g):
        f, = ctx.saved_tensors
        return _DepthwiseFIRT.apply(g, f), None


class _DepthwiseFIRT(torch.autograd.Function):
    """The transpose of `_DepthwiseFIR` in x; its backward is `_DepthwiseFIR`."""

    @staticmethod
    def forward(ctx, g, f):
        ctx.save_for_backward(f)
        return F.conv_transpose2d(g, f, groups=f.shape[0])

    @staticmethod
    def backward(ctx, gg):
        f, = ctx.saved_tensors
        return _DepthwiseFIR.apply(gg, f), None


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """Pad, upsample, FIR-filter and downsample a batch of NHWC images.
    `f` is a [fh, fw] / [taps] float32 filter from `setup_filter`, or None
    (identity); `padding` is w.r.t. the upsampled image."""
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects NHWC input, got {tuple(x.shape)}")
    if f is None:
        f = torch.ones(1, 1)
    if f.requires_grad:
        raise ValueError("upfirdn2d takes a constant filter: it forms no cotangent for it")
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    c = x.shape[3]

    y = x.permute(0, 3, 1, 2)
    y = _zero_insert_nchw(y, upx, upy)
    y = _pad_nchw(y, px0, px1, py0, py1)
    f = (f * float(gain) ** (f.ndim / 2)).to(device=x.device, dtype=x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        y = _DepthwiseFIR.apply(y, f[None, None].expand(c, 1, *f.shape))
    else:
        y = _DepthwiseFIR.apply(y, f[None, None, None, :].expand(c, 1, 1, -1))
        y = _DepthwiseFIR.apply(y, f[None, None, :, None].expand(c, 1, -1, 1))
    y = y[:, :, ::downy, ::downx]
    return y.permute(0, 2, 3, 1)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """FIR upsampling with magnitude-preserving gain."""
    upx, upy = _parse_scaling(up)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw + upx - 1) // 2,
        px1 + (fw - upx) // 2,
        py0 + (fh + upy - 1) // 2,
        py1 + (fh - upy) // 2,
    ]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """FIR downsampling (the `skip` discriminator's image path)."""
    downx, downy = _parse_scaling(down)
    px0, px1, py0, py1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [
        px0 + (fw - downx + 1) // 2,
        px1 + (fw - downx) // 2,
        py0 + (fh - downy + 1) // 2,
        py1 + (fh - downy) // 2,
    ]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
