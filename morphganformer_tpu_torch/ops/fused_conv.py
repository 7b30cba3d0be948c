"""Fused modulated convolutions of the high-resolution synthesis blocks.

Port of the forward roles of the two Pallas kernels the 1024^2 generator runs
(morphganformer_tpu/ops/pallas_conv.py):

  * K1 `fused_modconv3x3` <- `fused_modconv3x3_lrelu` (`_modconv_epilogue_kernel`):
        y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain [+ resid]
  * K2 `fused_upconv2` <- `fused_packed_upconv2` / `fused_packed_upconv2_c256`
    (`_packed_upconv_kernel`): the 2x-up modulated conv with the 4-tap FIR
    composed into the weights, evaluated per output parity, then the same
    epilogue (no resid).

Activations are NHWC and weights HWIO, as in JAX; the TPU's lane packing is
not carried over. Each wrapper takes its plain PyTorch version for a CPU
tensor and launches the CUDA kernel (csrc/fused_conv.cu) for a CUDA tensor;
there is no fallback between the two. The plain versions `modconv3x3_plain`
and `upconv2_plain` follow `second_order.py::modconv_ref` / `upconv_ref`.
`launch_counts` counts kernel launches (never plain calls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef

launch_counts = {"modconv3x3": 0, "upconv2": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _lrelu(y, gain, alpha):
    return torch.where(y >= 0, y, y * alpha) * gain


def _epilogue(y, d, noise, bias, gain, alpha):
    if d is not None:
        y = y * d[:, None, None, :]
    if noise is not None:
        y = y + noise[None, :, :, None]
    if bias is not None:
        y = y + bias
    return _lrelu(y, gain, alpha)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def modconv3x3_plain(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True):
    """Plain K1. x [N,H,W,C]; w [3,3,C,O]; styles [N,C]; noise [H,W] (already
    scaled by its strength) or None; bias [O] or None; resid [N,H,W,O] or None."""
    xs = (x * styles[:, None, None, :]).permute(0, 3, 1, 2)
    y = F.conv2d(xs, w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    d = demod_coef(w, styles) if demodulate else None
    y = _epilogue(y, d, noise, bias, gain, alpha)
    return y if resid is None else y + resid


def upconv2_phase_kernels(w, f, flip_weight=False):
    """Phase weights of the 2x-up conv: compose w [kh,kw,I,O] with the FIR
    (gain 4, as pallas_conv.py:1699-1700), then split the composed LxL kernel
    by output parity: output 2n+r takes taps t = t0(r), t0(r)+2, ... with
    t0(r) = (p0 + r) mod 2, reading input n + (r + t - p0)/2
    (`_taps_upconv2_polyphase`, p0 = kh//2 + (fw+1)//2).

    Returns (wp [2,2,NT,NT,I,O], (hb0, hb1)): hb[r] is where parity r's
    NT-tap window starts in the input padded by one pixel on each side."""
    kh = int(w.shape[0])
    fw = int(f.shape[-1])
    k = _compose_kernel_fir(w, f, flip_weight, False, gain=4.0)
    L = int(k.shape[0])
    p0 = kh // 2 + (fw + 1) // 2
    t0 = [(p0 + r) % 2 for r in (0, 1)]
    nt = {len(range(t, L, 2)) for t in t0}
    hb = tuple(1 + (r + t0[r] - p0) // 2 for r in (0, 1))
    if len(nt) != 1 or min(hb) < 0 or max(hb) + max(nt) > 3:
        raise ValueError(f"up-conv taps outside a 3x3 neighbourhood (L={L}, p0={p0})")
    wp = torch.stack([torch.stack([k[t0[ry]::2, t0[rx]::2] for rx in (0, 1)])
                      for ry in (0, 1)])
    return wp.contiguous(), hb


def upconv2_plain(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                  demodulate=True, flip_weight=False):
    """Plain K2. x [N,H,W,I]; w [kh,kw,I,O] with kh in (1, 3); styles [N,I]
    or None (unmodulated, no demodulation); f: FIR from setup_filter;
    noise [2H,2W] or None; bias [O] or None. Returns [N,2H,2W,O]."""
    n, h, wd, _ = x.shape
    wp, hb = upconv2_phase_kernels(w, f, flip_weight)
    nt, co = wp.shape[2], wp.shape[-1]
    xs = x if styles is None else x * styles[:, None, None, :]
    xp = F.pad(xs.permute(0, 3, 1, 2), [1, 1, 1, 1])
    phases = []
    for ry in (0, 1):
        for rx in (0, 1):
            win = xp[:, :, hb[ry]:hb[ry] + h + nt - 1, hb[rx]:hb[rx] + wd + nt - 1]
            phases.append(F.conv2d(win, wp[ry, rx].permute(3, 2, 0, 1)))
    y = torch.stack(phases, dim=2).reshape(n, co, 2, 2, h, wd)      # [N,O,ry,rx,H,W]
    y = y.permute(0, 4, 2, 5, 3, 1).reshape(n, 2 * h, 2 * wd, co)
    d = demod_coef(w, styles) if (styles is not None and demodulate) else None
    return _epilogue(y, d, noise, bias, gain, alpha)


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(name, t, shape, device):
    """Validate an optional kernel operand; returns its pointer (None if absent)."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name}: the CUDA kernels are forward only; "
                           "call under torch.no_grad()")
    return t.data_ptr()


def _launch(fn, *args):
    from morphganformer_tpu_torch.ops._build import library

    rc = getattr(library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")


def fused_modconv3x3(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True):
    """K1: y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain
    [+ resid], with d = rsqrt(s^2 . sum w^2 + 1e-8) when `demodulate`.
    Shapes as `modconv3x3_plain`; float32, contiguous."""
    if _on_cpu(x):
        return modconv3x3_plain(x, w, styles, noise, bias, resid, gain, alpha, demodulate)
    n, h, wd, c = x.shape
    o = w.shape[-1]
    dev = x.device
    d = demod_coef(w, styles).contiguous() if demodulate else None
    ptrs = [_check("x", x, (n, h, wd, c), dev), _check("w", w, (3, 3, c, o), dev),
            _check("styles", styles, (n, c), dev), _check("d", d, (n, o), dev),
            _check("noise", noise, (h, wd), dev), _check("bias", bias, (o,), dev),
            _check("resid", resid, (n, h, wd, o), dev)]
    y = torch.empty((n, h, wd, o), device=dev, dtype=torch.float32)
    _launch("mgt_modconv3x3_fwd", *ptrs, y.data_ptr(), n, h, wd, c, o,
            float(gain), float(alpha), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    launch_counts["modconv3x3"] += 1
    return y


def fused_upconv2(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                  demodulate=True, flip_weight=False):
    """K2: 2x-up modulated conv with the FIR composed in, then demod (when
    styles are given and `demodulate`), noise, bias and lrelu * gain.
    Shapes as `upconv2_plain`; float32, contiguous."""
    if _on_cpu(x):
        return upconv2_plain(x, w, styles, f, noise, bias, gain, alpha,
                             demodulate, flip_weight)
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    dev = x.device
    wp, (hb0, hb1) = upconv2_phase_kernels(w, f, flip_weight)
    nt = wp.shape[2]
    d = demod_coef(w, styles).contiguous() if (styles is not None and demodulate) else None
    ptrs = [_check("x", x, (n, h, wd, ci), dev), _check("wp", wp, (2, 2, nt, nt, ci, co), dev),
            _check("styles", styles, (n, ci), dev), _check("d", d, (n, co), dev),
            _check("noise", noise, (2 * h, 2 * wd), dev), _check("bias", bias, (co,), dev)]
    y = torch.empty((n, 2 * h, 2 * wd, co), device=dev, dtype=torch.float32)
    _launch("mgt_upconv2_fwd", *ptrs, y.data_ptr(), n, h, wd, ci, co, nt, hb0, hb1,
            float(gain), float(alpha), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    launch_counts["upconv2"] += 1
    return y
