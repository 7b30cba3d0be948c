"""Fused modulated convolutions of the high-resolution synthesis blocks.

Port of the two Pallas kernels the 1024^2 generator runs and of their
adjoint launches (morphganformer_tpu/ops/pallas_conv.py):

  * K1 `fused_modconv3x3` <- `fused_modconv3x3_lrelu` (`_modconv_epilogue_kernel`):
        y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain [+ resid]
    Its backward launches the same kernel in its adjoint role
    (`_modconv_bwd_impl`): dx = s * conv3x3(gd, flip(w)^T) with the ds dot
    tap and the demod-chain dd taps.
  * K2 `fused_upconv2` <- `fused_packed_upconv2` / `fused_packed_upconv2_c256`
    (`_packed_upconv_kernel`): the 2x-up modulated conv with the 4-tap FIR
    composed into the weights, evaluated per output parity, then the same
    epilogue (no resid). Its backward is K3 `_packed_downconv_kernel` in its
    adjoint role (`_packed_upconv_bwd_impl`): the stride-2 correlation from
    output-resolution gd to input-resolution dx, with the same taps.

`FusedModConv3x3` and `FusedUpConv2` are the autograd Functions; the
backward differentiates x, styles and resid only (latent projection), and
raises for the weight, bias and noise, which belong to training.

Activations are NHWC and weights HWIO, as in JAX; the TPU's lane packing is
not carried over. Each kernel wrapper takes its plain PyTorch version for a
CPU tensor and launches the CUDA kernel (csrc/fused_conv.cu) for a CUDA
tensor; there is no fallback between the two. `plain=True` runs the plain
forward and the plain adjoint on any device. The plain forwards follow
`second_order.py::modconv_ref` / `upconv_ref`. `launch_counts` counts kernel
launches (never plain calls).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef

launch_counts = {"modconv3x3": 0, "upconv2": 0, "modconv3x3_adj": 0, "upconv2_adj": 0}


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


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Plain forwards.
# ---------------------------------------------------------------------------


def modconv3x3_plain(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True):
    """Plain K1. x [N,H,W,C]; w [3,3,C,O]; styles [N,C]; noise [H,W] (already
    scaled by its strength) or None; bias [O] or None; resid [N,H,W,O] or None."""
    xs = _nchw(x * styles[:, None, None, :])
    y = _nhwc(F.conv2d(xs, w.permute(3, 2, 0, 1), padding=1))
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
    xp = F.pad(_nchw(xs), [1, 1, 1, 1])
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
# Plain adjoints. Both split as the TPU backward does: torch forms
# gd = g * lrelu'(.) * d (`_modconv_bwd_impl` :842-847), the adjoint launch
# (plain here, the kernel in the wrappers below) gives du = conv^T(gd), dx =
# du * s, the ds dot tap sum x*du and the dd taps dd1 = sum gd*(y/mask -
# noise), dd2 = sum gd, and torch closes the demod chain (:921-931).
# ---------------------------------------------------------------------------


def _adjoint_gd(g, y, w, styles, gain, alpha, demodulate):
    """(mask, gd, d): the lrelu*gain slope from the sign of y (already peeled
    of resid), gd = g * mask * d, and d (None without demodulation)."""
    mask = torch.where(y >= 0, g.new_tensor(gain), g.new_tensor(gain * alpha))
    gd = g * mask
    d = None
    if styles is not None and demodulate:
        d = demod_coef(w, styles)
        gd = gd * d[:, None, None, :]
    return mask, gd, d


def _dd_taps_plain(gd, y, mask, noise):
    """dd1 = sum_hw gd*(y/mask - noise), dd2 = sum_hw gd, each [N, O]."""
    t = y / mask
    if noise is not None:
        t = t - noise[None, :, :, None]
    return (gd * t).sum(dim=(1, 2)), gd.sum(dim=(1, 2))


def _demod_chain(ds, dd1, dd2, d, w, styles, bias):
    """ds += 2 s (de @ wsq^T) with de = -0.5 (dd1 - b dd2) d: the cotangent
    through d = rsqrt(s^2 @ wsq + 1e-8) (`_modconv_bwd_impl` :921-929)."""
    raw = dd1 if bias is None else dd1 - bias[None] * dd2
    de = -0.5 * raw * d
    wsq = w.to(de.dtype).square().sum(dim=(0, 1))
    return ds + 2.0 * styles * (de @ wsq.T)


def modconv3x3_adjoint_weights(w):
    """flip(w)^T: [3,3,C,O] -> [3,3,O,C], so that du = conv3x3_same(gd, .)."""
    return w.flip((0, 1)).transpose(2, 3).contiguous()


def upconv2_adjoint_kernels(w, f, flip_weight=False):
    """The K2 phase weights read back for the adjoint: input pixel j gathers,
    for each parity r, the NT taps whose output 2n+r lands on it, so
    du[j] = sum_r sum_a gd_r[j + hbt[r] - 1 + a] @ wt[r, a] with
    wt = flip(wp)^T over each parity's taps and hbt[r] = 3 - hb[r] - NT.

    Returns (wt [2,2,NT,NT,O,I], (hbt0, hbt1))."""
    wp, hb = upconv2_phase_kernels(w, f, flip_weight)
    nt = int(wp.shape[2])
    return wp.flip((2, 3)).transpose(4, 5).contiguous(), tuple(3 - b - nt for b in hb)


def _taps_result(du, x, styles, want_dx, want_dot):
    dx = du if styles is None else du * styles[:, None, None, :]
    dot = (x * du).sum(dim=(1, 2)) if want_dot else None
    return (dx if want_dx else None), dot


def modconv3x3_adjoint_plain(g, x, w, styles, y, noise=None, bias=None, resid=None,
                             gain=1.0, alpha=0.2, demodulate=True, need_dx=True,
                             need_ds=True):
    """Plain K1 adjoint: the cotangents of x and styles of `modconv3x3_plain`
    for output cotangent g, from its inputs and its output y. Returns
    (dx, ds, dd1, dd2); dx / ds are None unless asked for, dd1 / dd2 (the
    demod-chain taps, [N,O]) are None without demodulation or ds. The resid
    cotangent is g itself."""
    if resid is not None:
        y = y - resid
    mask, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    wt = modconv3x3_adjoint_weights(w)
    du = _nhwc(F.conv2d(_nchw(gd), wt.permute(3, 2, 0, 1), padding=1))
    dx, ds = _taps_result(du, x, styles, need_dx, need_ds)
    dd1 = dd2 = None
    if need_ds and d is not None:
        dd1, dd2 = _dd_taps_plain(gd, y, mask, noise)
        ds = _demod_chain(ds, dd1, dd2, d, w, styles, bias)
    return dx, ds, dd1, dd2


def upconv2_adjoint_plain(g, x, w, styles, f, y, noise=None, bias=None, gain=1.0,
                          alpha=0.2, demodulate=True, flip_weight=False, need_dx=True,
                          need_ds=True):
    """Plain K3 in its adjoint role: the cotangents of x and styles of
    `upconv2_plain` for output cotangent g [N,2H,2W,O], from its inputs and
    its output y. Returns (dx, ds, dd1, dd2) as `modconv3x3_adjoint_plain`;
    the unmodulated skip (styles None) gives dx only."""
    n, h, wd, _ = x.shape
    need_ds = need_ds and styles is not None
    mask, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    wt, hbt = upconv2_adjoint_kernels(w, f, flip_weight)
    nt = int(wt.shape[2])
    du = 0
    for ry in (0, 1):
        for rx in (0, 1):
            gp = F.pad(_nchw(gd[:, ry::2, rx::2]), [1, 1, 1, 1])
            win = gp[:, :, hbt[ry]:hbt[ry] + h + nt - 1, hbt[rx]:hbt[rx] + wd + nt - 1]
            du = du + F.conv2d(win, wt[ry, rx].permute(3, 2, 0, 1))
    dx, ds = _taps_result(_nhwc(du), x, styles, need_dx, need_ds)
    dd1 = dd2 = None
    if need_ds and d is not None:
        dd1, dd2 = _dd_taps_plain(gd, y, mask, noise)
        ds = _demod_chain(ds, dd1, dd2, d, w, styles, bias)
    return dx, ds, dd1, dd2


# ---------------------------------------------------------------------------
# Kernel wrappers.
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
    return t.data_ptr()


def _library():
    from morphganformer_tpu_torch.ops._build import library

    return library()


def _launch(fn, *args):
    rc = getattr(_library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")


def _stream(dev):
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _modconv3x3_forward(x, w, styles, noise=None, bias=None, resid=None,
                        gain=1.0, alpha=0.2, demodulate=True):
    """K1 forward: the plain version for a CPU tensor, the kernel for a CUDA one."""
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
            float(gain), float(alpha), *_stream(dev))
    launch_counts["modconv3x3"] += 1
    return y


def _upconv2_forward(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                     demodulate=True, flip_weight=False):
    """K2 forward: the plain version for a CPU tensor, the kernel for a CUDA one."""
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
            float(gain), float(alpha), *_stream(dev))
    launch_counts["upconv2"] += 1
    return y


def _adjoint_launch(fn, gd, wt, styles, x, y_dd, noise, mask_args, need_dx, need_ds,
                    shape_args):
    """Allocate dx and the per-block partials, launch one adjoint kernel and
    sum the partials (in a fixed order: the result does not depend on how
    the blocks were scheduled). Returns (dx, dot, dd1, dd2)."""
    n, h, wd, c = x.shape
    o = gd.shape[-1]
    dev = x.device
    nblk = _library().mgt_bwd_tiles(h, wd)
    dx = torch.empty((n, h, wd, c), device=dev, dtype=torch.float32) if need_dx else None
    dot = torch.empty((n, nblk, c), device=dev, dtype=torch.float32) if need_ds else None
    dd = [torch.empty((n, nblk, o), device=dev, dtype=torch.float32)
          if y_dd is not None else None for _ in range(2)]
    ho, wo = gd.shape[1:3]
    ptrs = [_check("gd", gd, (n, ho, wo, o), dev), _check("wt", wt, wt.shape, dev),
            _check("styles", styles, (n, c), dev),
            _check("x", x if need_ds else None, (n, h, wd, c), dev),
            _check("y", y_dd, (n, ho, wo, o), dev), _check("noise", noise, (ho, wo), dev)]
    outs = [None if t is None else t.data_ptr() for t in (dx, dot, *dd)]
    _launch(fn, *ptrs, *outs, n, h, wd, o, c, *shape_args,
            *(float(v) for v in mask_args), *_stream(dev))
    return (dx, None if dot is None else dot.sum(1),
            *(None if t is None else t.sum(1) for t in dd))


def modconv3x3_adjoint(g, x, w, styles, y, noise=None, bias=None, resid=None,
                       gain=1.0, alpha=0.2, demodulate=True, need_dx=True, need_ds=True):
    """K1 adjoint: `modconv3x3_adjoint_plain` for a CPU tensor; for a CUDA
    tensor one launch of `mgt_modconv3x3_bwd` gives dx, the ds dot and the
    dd taps as per-block partials, summed here. Same returns."""
    if _on_cpu(x):
        return modconv3x3_adjoint_plain(g, x, w, styles, y, noise, bias, resid, gain,
                                        alpha, demodulate, need_dx, need_ds)
    if resid is not None:
        y = y - resid
    _, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    need_dd = need_ds and d is not None
    dx, ds, dd1, dd2 = _adjoint_launch(
        "mgt_modconv3x3_bwd", gd.contiguous(), modconv3x3_adjoint_weights(w), styles, x,
        y.contiguous() if need_dd else None, noise if need_dd else None,
        (gain, alpha), need_dx, need_ds, ())
    launch_counts["modconv3x3_adj"] += 1
    if need_dd:
        ds = _demod_chain(ds, dd1, dd2, d, w, styles, bias)
    return dx, ds, dd1, dd2


def upconv2_adjoint(g, x, w, styles, f, y, noise=None, bias=None, gain=1.0, alpha=0.2,
                    demodulate=True, flip_weight=False, need_dx=True, need_ds=True):
    """K3 in its adjoint role: `upconv2_adjoint_plain` for a CPU tensor; for
    a CUDA tensor one launch of `mgt_upconv2_bwd`. Same returns."""
    if _on_cpu(x):
        return upconv2_adjoint_plain(g, x, w, styles, f, y, noise, bias, gain, alpha,
                                     demodulate, flip_weight, need_dx, need_ds)
    need_ds = need_ds and styles is not None
    _, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    need_dd = need_ds and d is not None
    wt, (hb0, hb1) = upconv2_adjoint_kernels(w, f, flip_weight)
    dx, ds, dd1, dd2 = _adjoint_launch(
        "mgt_upconv2_bwd", gd.contiguous(), wt, styles, x,
        y.contiguous() if need_dd else None, noise if need_dd else None,
        (gain, alpha), need_dx, need_ds, (int(wt.shape[2]), hb0, hb1))
    launch_counts["upconv2_adj"] += 1
    if need_dd:
        ds = _demod_chain(ds, dd1, dd2, d, w, styles, bias)
    return dx, ds, dd1, dd2


# ---------------------------------------------------------------------------
# Autograd Functions.
# ---------------------------------------------------------------------------


def _refuse_training_grads(name, needs, which):
    asked = [arg for arg, need in zip(which, needs) if need]
    if asked:
        raise NotImplementedError(
            f"{name}: gradients of {', '.join(asked)} are not ported (training); "
            "freeze the generator's weights (G.requires_grad_(False))")


class FusedModConv3x3(torch.autograd.Function):
    """K1 with its adjoint: gradients of x, styles and resid."""

    @staticmethod
    def forward(ctx, x, w, styles, noise, bias, resid, gain, alpha, demodulate, plain):
        fwd = modconv3x3_plain if plain else _modconv3x3_forward
        y = fwd(x, w, styles, noise, bias, resid, gain, alpha, demodulate)
        ctx.save_for_backward(x, w, styles, noise, bias, resid, y)
        ctx.opts = (gain, alpha, demodulate, plain)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        _refuse_training_grads("FusedModConv3x3", (need[1], need[3], need[4]),
                               ("w", "noise", "bias"))
        x, w, styles, noise, bias, resid, y = ctx.saved_tensors
        gain, alpha, demodulate, plain = ctx.opts
        g = g.contiguous()
        dx = ds = None
        if need[0] or need[2]:
            adjoint = modconv3x3_adjoint_plain if plain else modconv3x3_adjoint
            dx, ds, _, _ = adjoint(g, x, w, styles, y, noise, bias, resid, gain, alpha,
                                   demodulate, need[0], need[2])
        dresid = g if need[5] else None
        return dx, None, ds, None, None, dresid, None, None, None, None


class FusedUpConv2(torch.autograd.Function):
    """K2 with K3 as its adjoint: gradients of x and styles."""

    @staticmethod
    def forward(ctx, x, w, styles, f, noise, bias, gain, alpha, demodulate, flip_weight,
                plain):
        fwd = upconv2_plain if plain else _upconv2_forward
        y = fwd(x, w, styles, f, noise, bias, gain, alpha, demodulate, flip_weight)
        ctx.save_for_backward(x, w, styles, f, noise, bias, y)
        ctx.opts = (gain, alpha, demodulate, flip_weight, plain)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        need = ctx.needs_input_grad
        _refuse_training_grads("FusedUpConv2", (need[1], need[3], need[4], need[5]),
                               ("w", "f", "noise", "bias"))
        x, w, styles, f, noise, bias, y = ctx.saved_tensors
        gain, alpha, demodulate, flip_weight, plain = ctx.opts
        dx = ds = None
        if need[0] or need[2]:
            adjoint = upconv2_adjoint_plain if plain else upconv2_adjoint
            dx, ds, _, _ = adjoint(g.contiguous(), x, w, styles, f, y, noise, bias, gain,
                                   alpha, demodulate, flip_weight, need[0], need[2])
        return dx, None, ds, None, None, None, None, None, None, None, None


def fused_modconv3x3(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True, plain=False):
    """K1: y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain
    [+ resid], with d = rsqrt(s^2 . sum w^2 + 1e-8) when `demodulate`.
    Shapes as `modconv3x3_plain`; float32, contiguous. Differentiable in x,
    styles and resid (`FusedModConv3x3`); `plain=True` runs the plain
    forward and adjoint on any device."""
    return FusedModConv3x3.apply(x, w, styles, noise, bias, resid, gain, alpha,
                                 demodulate, plain)


def fused_upconv2(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                  demodulate=True, flip_weight=False, plain=False):
    """K2: 2x-up modulated conv with the FIR composed in, then demod (when
    styles are given and `demodulate`), noise, bias and lrelu * gain.
    Shapes as `upconv2_plain`; float32, contiguous. Differentiable in x and
    styles (`FusedUpConv2`, whose backward is K3); `plain=True` runs the
    plain forward and adjoint on any device."""
    return FusedUpConv2.apply(x, w, styles, f, noise, bias, gain, alpha, demodulate,
                              flip_weight, plain)
