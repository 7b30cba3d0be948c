"""2D convolution with fused FIR up/downsampling (port of
morphganformer_tpu/ops/conv2d_resample.py).

NHWC activations, HWIO weights at the interface; the convolutions run as
`F.conv2d` in NCHW/OIHW between permutes. The branches mirror the JAX op:
1x1 kernels reorder conv and resampling, other kernels fold the FIR into the
conv weights (`_compose_kernel_fir`), and the synthesis up-conv (3x3 kernel,
4-tap FIR, SAME padding) runs as one polyphase conv at input resolution.
With MGT_PALLAS_CONV=1, an eligible plain SAME 3x3 conv runs on K4
(ops/conv3x3.py).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.ops.packed_override import (in_second_order_scope,
                                                          packed_paths_disabled)
from morphganformer_tpu_torch.ops.upfirdn2d import (
    _get_filter_size,
    _pad_nchw,
    _parse_padding,
    _zero_insert_nchw,
    upfirdn2d,
)
from morphganformer_tpu_torch.utils.dtype import at_least_f32


def _to_oihw(w):
    return w.permute(3, 2, 0, 1)


def _compose_kernel_fir(w, f, flip_weight, flip_filter, gain=1.0):
    """Compose conv kernel w [kh,kw,I,O] with FIR f into one correlation
    kernel K [kh+fh-1, kw+fw-1, I, O]: corr(corr(z, w'), f') == corr(z, K)
    with K the full convolution of the two kernels. A bfloat16 w is composed
    in float32 and rounded once, as XLA's bfloat16 convolution that composes
    it in JAX sums in float32."""
    dtype = w.dtype
    w = at_least_f32(w)
    if not flip_weight:
        w = w.flip((0, 1))
    if f.ndim == 1:
        f = torch.outer(f, f)
    f = (f.to(device=w.device, dtype=w.dtype) * gain).to(dtype).to(w.dtype)
    if not flip_filter:
        f = f.flip((0, 1))
    kh, kw, ci, co = w.shape
    fh, fw = f.shape
    k = w.new_zeros(kh + fh - 1, kw + fw - 1, ci, co)
    for i in range(fh):
        for j in range(fw):
            k[i:i + kh, j:j + kw] += f[i, j] * w
    return k.to(dtype)


def _conv(x, w, *, stride=1, padding=(0, 0, 0, 0), groups=1, flip_weight=True):
    """Grouped correlation of NHWC x with HWIO w; `flip_weight=False` is a
    true convolution. padding = (px0, px1, py0, py1), negative crops."""
    if not flip_weight:
        w = w.flip((0, 1))
    y = _pad_nchw(x.permute(0, 3, 1, 2), *padding)
    k = _to_oihw(w).to(x.dtype)
    if (x.dtype == torch.bfloat16 and x.device.type == "cpu"
            and (in_second_order_scope() or packed_paths_disabled())):
        # torch's bfloat16 convolution on the CPU (oneDNN) takes a wrong
        # second derivative at some shapes (an 18 x 18 input of 16 channels:
        # the double backward's relative error 1.0, where float32's is 5e-7;
        # the card's is 1.8e-3). So inside a reg stage (the only place that
        # differentiates twice) the bfloat16 operands are summed in float32
        # on the CPU and y is rounded once; elsewhere the CPU's bfloat16
        # convolution stays, which rounds as XLA's does.
        y = F.conv2d(y.float(), k.float(), stride=stride, groups=groups).to(x.dtype)
    else:
        y = F.conv2d(y, k, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def _conv_up2_polyphase(x, k, py0, px0, groups):
    """2x-up conv with the composed 6x6 kernel as ONE 3x3 conv at input
    resolution: output pixel (2n+ry, 2m+rx) takes the taps of parity
    (p0+r) mod 2, so the four phase kernels stack along the output channels
    and a depth-to-space interleaves them. x: [B,H,W,I]; k: [6,6,I,O]."""
    co = k.shape[-1]
    b, h, wd, _ = x.shape

    def taps(r, p0):
        t0 = (p0 + r) % 2
        return [t0, t0 + 2, t0 + 4]

    phases = [k[taps(ry, py0)][:, taps(rx, px0)]
              for ry in (0, 1) for rx in (0, 1)]
    k4 = torch.cat(phases, dim=-1)                               # [3,3,I,4O]
    y = _conv(x, k4, padding=(1, 1, 1, 1), groups=groups)
    y = y.reshape(b, h, wd, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * wd, co)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """2D convolution with optional FIR up/downsampling.

    x: NHWC [N,H,W,Cin]; w: HWIO [kh,kw,Cin/groups,Cout]; f: FIR filter from
    `setup_filter` or None; padding w.r.t. the upsampled image;
    flip_weight/flip_filter False = convolution, True = correlation."""
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("conv2d_resample expects NHWC x and HWIO w")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1):
        raise ValueError(f"up/down must be integers >= 1, got {up}, {down}")
    kh, kw = int(w.shape[0]), int(w.shape[1])
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # 1x1 + downsampling only: downsample first, then convolve.
    if kw == 1 and kh == 1 and down > 1 and up == 1:
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1], flip_filter=flip_filter)
        return _conv(x, w, groups=groups, flip_weight=flip_weight)

    # 1x1 + upsampling only: convolve first, then upsample.
    if kw == 1 and kh == 1 and up > 1 and down == 1:
        x = _conv(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter)

    # Downsampling only: one strided conv with the FIR composed in.
    if down > 1 and up == 1:
        if f is not None:
            k = _compose_kernel_fir(w, f, flip_weight, flip_filter)
        else:
            k = w if flip_weight else w.flip((0, 1))
        return _conv(x, k, stride=down, padding=(px0, px1, py0, py1), groups=groups)

    # Upsampling: one conv over the zero-inserted input with the FIR composed
    # in (the trailing up-1 zeros of the insertion are the high padding).
    if up > 1:
        if f is not None:
            k = _compose_kernel_fir(w, f, flip_weight, flip_filter, gain=float(up ** 2))
        else:
            k = (w if flip_weight else w.flip((0, 1))) * float(up ** 2)
        if (up == 2 and down == 1 and groups == 1 and k.shape[0] == 6
                and k.shape[1] == 6 and (py0, py1, px0, px1) == (3, 2, 3, 2)):
            return _conv_up2_polyphase(x, k, py0, px0, groups)
        xd = _zero_insert_nchw(x.permute(0, 3, 1, 2), up, up).permute(0, 2, 3, 1)
        x = _conv(xd, k, padding=(px0, px1, py0, py1), groups=groups)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    # Plain conv with symmetric non-negative padding. Opt-in, as in JAX
    # (conv2d_resample.py:236-251): MGT_PALLAS_CONV=1 sends an eligible SAME
    # 3x3 conv to K4 (ops/conv3x3.py).
    if up == 1 and down == 1 and px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        if px0 == 1 and py0 == 1 and os.environ.get("MGT_PALLAS_CONV") == "1":
            from morphganformer_tpu_torch.ops.conv3x3 import conv3x3_eligible, conv3x3_same

            if conv3x3_eligible(x, w, groups):
                return conv3x3_same(x, w if flip_weight else w.flip((0, 1)))
        return _conv(x, w, padding=(px0, px0, py0, py0), groups=groups,
                     flip_weight=flip_weight)

    # Generic fallback.
    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = _conv(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
