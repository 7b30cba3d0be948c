"""Style-modulated convolution (port of morphganformer_tpu/ops/modulated_conv.py).

Uses the activation-scaling form of StyleGAN2 mod/demod:
    conv(x, w * s * d) == d * conv(x * s, w)
with d[b,o] = rsqrt(sum_i s[b,i]^2 * sum_{kh,kw} w[.,.,i,o]^2 + 1e-8),
computed in float32.
"""

from __future__ import annotations

import torch

from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample


def demod_coef(w, styles):
    """d[n,o] = rsqrt(s^2 @ sum_{kh,kw} w^2 + 1e-8), float32."""
    wsq = w.float().square().sum(dim=(0, 1))                    # [I, O]
    return torch.rsqrt(styles.float().square() @ wsq + 1e-8)   # [N, O]


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_kernel=None, demodulate=True, flip_weight=True,
                     modulate=True):
    """x: NHWC [N,H,W,Cin]; weight: HWIO; styles: [N,Cin]; noise: broadcastable
    to the output or None; resample_kernel: FIR filter from setup_filter."""
    if not modulate:
        x = conv2d_resample(x, weight, f=resample_kernel, up=up, down=down,
                            padding=padding, flip_weight=flip_weight)
        return x if noise is None else x + noise.to(x.dtype)
    if styles.shape != (x.shape[0], x.shape[3]):
        raise ValueError(f"styles {tuple(styles.shape)} do not match x {tuple(x.shape)}")
    x = x * styles.to(x.dtype)[:, None, None, :]
    x = conv2d_resample(x, weight, f=resample_kernel, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * demod_coef(weight, styles).to(x.dtype)[:, None, None, :]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
