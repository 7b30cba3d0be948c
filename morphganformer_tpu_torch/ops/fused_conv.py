"""Fused convolutions of the high-resolution blocks, their adjoints and their
weight cotangents.

Port of the Pallas kernels of morphganformer_tpu/ops/pallas_conv.py that the
1024^2 generator and discriminator run, in every role a first-order
training step needs:

  * K1 `fused_modconv3x3` <- `fused_modconv3x3_lrelu` (`_modconv_epilogue_kernel`):
        y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain [+ resid]
    Its backward launches the same kernel in its adjoint role
    (`_modconv_bwd_impl`): the kernel forms gd = g * lrelu'(y - resid) * d
    itself and gives dx = s * conv3x3(gd, flip(w)^T) with the ds dot tap and
    the demod-chain dd taps; and the dw taps.
  * K2 `fused_upconv2` <- `fused_packed_upconv2` / `fused_packed_upconv2_c256`
    (`_packed_upconv_kernel`): the 2x-up modulated conv with the 4-tap FIR,
    then the same epilogue (no resid). Its backward is K3
    `_packed_downconv_kernel` in its adjoint role (`_packed_upconv_bwd_impl`),
    and K3's dw taps.
  * K3 `fused_downconv2` <- `fused_packed_dconv2` (`_packed_downconv_kernel`,
    D-tower forward): lrelu(conv_down2(x, compose(w, f)) + bias) * gain
    [+ resid]. Its backward is K2 in its `use_dw` role (`_dconv_bwd_impl`):
    dx = the down-conv read back, an up-conv of gz; and the block cotangent.

K1's kernel (both roles, and K4's) is one least-work template: the style
folded into the weights in the forward, gd formed in shared memory and
flip(w)^T read by index in the adjoint.
K2's and K3's kernels take, in both roles, least-work operands: the small
weight, the 4x4 FIR and a pad. K3 (`downconv2_leastwork`,
`upconv2_adjoint_leastwork`) runs the FIR at input resolution, then a
stride-2 conv; K2 (`upconv2_leastwork`, `downconv2_adjoint_leastwork`) a
stride-2 transposed conv, then the FIR at output resolution. The plain
versions evaluate the same functions per parity from the composed kernel.

The weight cotangent of every role is one more kernel: on the TPU it rides
the adjoint launch as in-kernel taps, carried across the sequential grid;
Hopper blocks cannot carry a sum, so the port launches it on its own and
sums per-slice partials in a fixed order. K1's (`conv_dw`) takes the 3x3
taps of x against gd. K3's and the D down-conv's (`upconv2_dw`,
`downconv2_dw`; operands from `upconv2_dw_leastwork`,
`downconv2_dw_leastwork`) take least-work operands too: the FIR applied once
to the full-resolution operand, then the small weight's stride-2 taps,
whose cotangent maps onto w with a flip alone. Only the plain route (a CPU
tensor, or `plain=True`) still takes the per-parity taps of the composed
kernel (`conv_dw_plain`) and folds them back onto w through the vjp of the
(linear) map from w to the parity weights (`_fold`, the port's
`jax.linear_transpose(w_to_blk)`). The demodulation adds 2 w (s^2^T de).
dbias and dnoise are plain reductions, as in JAX.

`FusedModConv3x3`, `FusedUpConv2` and `FusedDownConv2` are the autograd
Functions; each computes only the cotangents that `ctx.needs_input_grad`
asks for (JAX's symbolic zeros). Built inside `second_order_scope()`, they
are differentiable twice (ops/second_order.py); elsewhere a second
derivative through them raises. Noise is batch-shared [H,W] or per-sample
[N,H,W] (random noise mode).

Activations are NHWC and weights HWIO, as in JAX; the TPU's lane packing is
not carried over. Each kernel wrapper takes its plain PyTorch version for a
CPU tensor and launches the CUDA kernel (csrc/fused_conv.cu) for a CUDA
tensor; there is no fallback between the two. `plain=True` runs the plain
forward and the plain backward on any device. The plain forwards follow
`second_order.py::modconv_ref` / `upconv_ref` / `dconv_ref`.
`launch_counts` counts kernel launches (never plain calls), one key per role.

The compute type is x's: float32, or bfloat16 in every role (JAX's
`project`, `morph` and `demorph` default, and `train --dtype bfloat16`).
The weights, styles and noise are float32 at the interface and are cast as
JAX's Pallas wrappers cast them (pallas_conv.py:673-700, :1699-1715,
:838-847, :1798-1851, :2054-2068, :2121-2157): in bfloat16 the kernels read
bfloat16 operands (x * s formed and rounded in bfloat16 in the forwards;
K2's and K3's weights composed with the FIR in float32 and then rounded on
the plain route, the small weight rounded in the kernels), sum in float32,
run the epilogue and the ds/dd taps in float32 (d, bias, the adjoints'
scale s) and round the output once; the adjoints form gd = g * mask * d in
bfloat16 inside their kernels (K1's and K3's on the tensor cores,
`conv3x3_adj_tc_kernel` and `downconv2_tc_kernel`, as K2's bfloat16
forward, `upconv2_tc_kernel`, which also runs K2's use_dw role). The D
tower's forward (`downconv2_fwd_tc_kernel`), K1's dw (`conv_dw_tc_kernel`)
and the FIR dw of K3 and of the D down-conv (`fir_dw_tc_kernel`: the FIR in
float32, its B reaching the tensor cores as bfloat16 hi and lo) run on the
tensor cores too. The dw kernels round x * s (base * s) to bfloat16 as
JAX's u_t (pallas_conv.py:270-271, :1399-1401), keep the FIR and their
partials in float32 and return a float32 cotangent (`dw.astype(w.dtype)`).
A bfloat16 tensor on a card launches the `_bf16` entry points or raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef
from morphganformer_tpu_torch.ops.packed_override import scope_reaches
from morphganformer_tpu_torch.utils.dtype import at_least_f32

# One key per role; "conv3x3" and "conv3x3_adj" are K4's (ops/conv3x3.py);
# a `_bf16` key counts the bfloat16 entry point of its role.
_ROLES = ("modconv3x3", "upconv2", "modconv3x3_adj", "upconv2_adj", "downconv2",
          "downconv2_adj", "modconv3x3_dw", "upconv2_dw", "downconv2_dw")
launch_counts = {**dict.fromkeys(_ROLES, 0), "conv3x3": 0, "conv3x3_adj": 0,
                 **dict.fromkeys((f"{r}_bf16" for r in _ROLES), 0),
                 "conv3x3_bf16": 0, "conv3x3_adj_bf16": 0}

# Blocks of one least-work dw launch (`mgt_conv_dw`, `mgt_fir_dw`): one wave
# at 2 per SM of an H100.
_FD_BLOCKS = 2 * 132


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _lrelu(y, gain, alpha):
    return torch.where(y >= 0, y, y * alpha) * gain


def _slope(y, gain, alpha):
    """lrelu'(y) * gain in y's dtype, with no host-to-device copy."""
    return torch.where(y >= 0, y.new_full((), gain), y.new_full((), gain * alpha))


def _noise_nhwc(noise):
    """[H,W] (batch-shared) or [N,H,W] (per-sample) -> broadcastable NHWC."""
    return noise[None, :, :, None] if noise.dim() == 2 else noise[:, :, :, None]


def _widened(t, dtype):
    """t rounded to `dtype` (the kernels' operand type), then widened back
    to float32 for the float32 sums; a float32 t passes unchanged."""
    return None if t is None else at_least_f32(t.to(dtype))


def _epilogue(y, d, noise, bias, gain, alpha):
    if d is not None:
        y = y * d[:, None, None, :]
    if noise is not None:
        y = y + _noise_nhwc(noise)
    if bias is not None:
        y = y + bias
    return _lrelu(y, gain, alpha)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _phase_upconv(x, wp, hb):
    """Output parity (ry, rx) of pixel (2n+ry, 2m+rx) is the correlation of
    x (zero-padded by one) with wp[ry, rx], its window starting at hb[r].
    x [N,H,W,I]; wp [2,2,NT,NT,I,O] -> [N,2H,2W,O]."""
    n, h, wd, _ = x.shape
    nt, co = wp.shape[2], wp.shape[-1]
    xp = F.pad(_nchw(x), [1, 1, 1, 1])
    phases = [F.conv2d(xp[:, :, hb[ry]:hb[ry] + h + nt - 1, hb[rx]:hb[rx] + wd + nt - 1],
                       wp[ry, rx].permute(3, 2, 0, 1))
              for ry in (0, 1) for rx in (0, 1)]
    y = torch.stack(phases, dim=2).reshape(n, co, 2, 2, h, wd)      # [N,O,ry,rx,H,W]
    return y.permute(0, 4, 2, 5, 3, 1).reshape(n, 2 * h, 2 * wd, co)


def _parity_downconv(x, wt, hb):
    """The sum over input parities (ry, rx) of plane x[:, ry::2, rx::2]
    (zero-padded by one) correlated with wt[ry, rx] from hb[r]: the stride-2
    correlation in the parity form. x [N,2H,2W,I]; wt [2,2,NT,NT,I,O] ->
    [N,H,W,O]."""
    h, wd = x.shape[1] // 2, x.shape[2] // 2
    nt = wt.shape[2]
    out = 0
    for ry in (0, 1):
        for rx in (0, 1):
            xp = F.pad(_nchw(x[:, ry::2, rx::2]), [1, 1, 1, 1])
            win = xp[:, :, hb[ry]:hb[ry] + h + nt - 1, hb[rx]:hb[rx] + wd + nt - 1]
            out = out + F.conv2d(win, wt[ry, rx].permute(3, 2, 0, 1))
    return _nhwc(out)


# ---------------------------------------------------------------------------
# Weights of each role: linear functions of w.
# ---------------------------------------------------------------------------


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


def downconv2_parity_kernels(w, f, flip_weight=True):
    """Input-parity weights of the 2x-down conv (conv2d_resample down=2,
    padding kh//2): y[m] = sum_t K[t] x[2m + t - q0] with K = compose(w, f)
    and q0 = kh//2 + (fw-1)//2 (`_dconv_compose`, pallas_conv.py:2040-2051:
    K 6x6, q0 2 for the 3x3 conv1; K 4x4, q0 1 for the 1x1 skip). Input
    pixel 2(m+a)+q is parity plane q at m+a, reached through tap
    t = q0 + q + 2a.

    Returns (wf [2,2,NT,NT,I,O], (hb0, hb1)): parity q's taps read plane
    positions m + hb[q] - 1 + ta (conv1: NT 3, hb 0,0; skip: NT 2, hb 1,0)."""
    kh = int(w.shape[0])
    if f is None:
        k, fw = (w if flip_weight else w.flip((0, 1))), 1
    else:
        k, fw = _compose_kernel_fir(w, f, flip_weight, False), int(f.shape[-1])
    L = int(k.shape[0])
    q0 = kh // 2 + (fw - 1) // 2
    amin = [-((q0 + q) // 2) for q in (0, 1)]
    nt = max((L - 1 - q0 - q) // 2 - amin[q] + 1 for q in (0, 1))
    hb = tuple(1 + amin[q] for q in (0, 1))
    if min(hb) < 0 or max(hb) + nt > 3:
        raise ValueError(f"down-conv taps outside a 3x3 neighbourhood (L={L}, q0={q0})")
    # Parity q's taps are t0, t0 + 2, ... from t0 = (q0 + q) % 2; a parity
    # with fewer taps (odd L, without the FIR) reads zero taps past L.
    k = F.pad(k, (0, 0, 0, 0, 0, 2, 0, 2))
    t0 = [(q0 + q) % 2 for q in (0, 1)]
    wf = torch.stack([torch.stack([k[t0[py]:t0[py] + 2 * nt:2, t0[px]:t0[px] + 2 * nt:2]
                                   for px in (0, 1)]) for py in (0, 1)])
    return wf.contiguous(), hb


def _flipped_taps(wk, hb):
    """Read parity weights back for the adjoint: flip each parity's taps and
    swap I and O; the window of parity r then starts at 3 - hb[r] - NT."""
    nt = int(wk.shape[2])
    return wk.flip((2, 3)).transpose(4, 5).contiguous(), tuple(3 - b - nt for b in hb)


def modconv3x3_adjoint_weights(w):
    """flip(w)^T: [3,3,C,O] -> [3,3,O,C], so that du = conv3x3_same(gd, .)."""
    return w.flip((0, 1)).transpose(2, 3).contiguous()


def upconv2_adjoint_kernels(w, f, flip_weight=False):
    """The K2 phase weights read back for the adjoint: input pixel j gathers,
    for each parity r, the NT taps whose output 2n+r lands on it, so
    du[j] = sum_r sum_a gd_r[j + hbt[r] - 1 + a] @ wt[r, a] with
    wt = flip(wp)^T over each parity's taps and hbt[r] = 3 - hb[r] - NT.

    Returns (wt [2,2,NT,NT,O,I], (hbt0, hbt1))."""
    return _flipped_taps(*upconv2_phase_kernels(w, f, flip_weight))


def downconv2_adjoint_kernels(w, f, flip_weight=True):
    """The K3-forward parity weights read back for the adjoint (K2's use_dw
    role): output parity r of dx gathers the taps of parity r whose output m
    reads it, so dx = `_phase_upconv(gz, wt, hbt)` with wt = flip(wf)^T over
    each parity's taps and hbt[r] = 3 - hb[r] - NT.

    Returns (wt [2,2,NT,NT,O,I], (hbt0, hbt1))."""
    return _flipped_taps(*downconv2_parity_kernels(w, f, flip_weight))


def lw_fir_ok(f):
    """Whether K2 and K3 take the FIR `f` (taps, a 1-d or 2-d filter): 4 taps."""
    return f is not None and tuple(torch.as_tensor(f).shape) in ((4,), (4, 4))


def lw_widths_ok(*widths):
    """Whether the kernels (K1, K2, K3 and K4) take these channel counts: they
    read channels with 16-byte copies, so each is a positive multiple of 4."""
    return all(int(c) >= 4 and int(c) % 4 == 0 for c in widths)


def _fir_4x4(f):
    """The FIR as a [4,4] tensor; the least-work kernels take no other size."""
    if not lw_fir_ok(f):
        raise ValueError(f"the least-work kernels take a 4x4 FIR, got "
                         f"{None if f is None else tuple(f.shape)}")
    f2 = torch.outer(f, f) if f.dim() == 1 else f
    return f2.to(dtype=torch.float32)


def downconv2_leastwork(w, f, flip_weight=True):
    """K3-forward's operands in least-work form: (wk [kh,kh,I,O], fk [4,4],
    pad) with, in each spatial dimension,
        y[m] = sum_a sum_i wk[a] fk[i] x[2m + a + i - pad],
    x zero outside the image: the FIR at input resolution (fk), then a
    stride-2 correlation with the small weight. This is the composed
    correlation of `downconv2_parity_kernels` (K[t] = sum_i fk[i] wk[t - i],
    left pad q0 = kh//2 + (fw-1)//2; conv2d_resample down=2, padding kh//2,
    flip_filter False) factored back into its two parts."""
    kh = int(w.shape[0])
    fk = _fir_4x4(f).flip((0, 1))
    wk = w if flip_weight else w.flip((0, 1))
    return wk.contiguous(), fk.contiguous(), kh // 2 + 1


def upconv2_leastwork(w, f, flip_weight=False):
    """K2-forward's operands in least-work form: (wk [kh,kh,I,O], fk [4,4],
    pad) with, in each spatial dimension,
        Z[q] = sum_a wk[a] xz[q - a],    y[o] = sum_i fk[i] Z[o + i - pad],
    xz the zero-inserted input (xz[2m] = x[m], zero between and outside):
    the stride-2 transposed conv with the small weight, then the FIR at
    output resolution. The up-conv is y[o] = sum_t K[t] xz[o + t - p0] with
    K[t] = sum_i fz[i] wz[t - i] (fz the flipped FIR times the gain 4, wz
    the correlation taps) and p0 = kh//2 + (fw+1)//2 (`upconv2_phase_kernels`,
    conv2d_resample up=2, padding kh//2); with a counted from the other end,
    wk = flip(wz), fk = fz and pad = p0 - (kh - 1): 1 for the 3x3, 2 for
    the 1x1."""
    kh = int(w.shape[0])
    fk = _fir_4x4(f).flip((0, 1)) * 4.0
    wk = w.flip((0, 1)) if flip_weight else w
    return wk.contiguous(), fk.contiguous(), kh // 2 + 2 - (kh - 1)


def downconv2_adjoint_leastwork(w, f, flip_weight=True):
    """K2-use_dw's operands (dx of the D down-conv) in the form of
    `upconv2_leastwork`: (wk [kh,kh,O,I], fk [4,4], pad) with dx[p] =
    sum_i fk[i] Z[p + i - pad], Z[r] = sum_a wk[a] gzz[r - a] and gzz the
    zero-inserted cotangent gz. `downconv2_leastwork`'s y[m] = sum_a sum_i
    wd[a] fd[i] x[2m + a + i - q] read back: the transposed stride-2 conv
    with wd^T (I and O swapped), then the FIR fd from the other end (fk =
    flip(fd) = f, gain 1) and pad = 3 - q."""
    wd, fd, q = downconv2_leastwork(w, f, flip_weight)
    return wd.transpose(2, 3).contiguous(), fd.flip((0, 1)).contiguous(), 3 - q


def upconv2_adjoint_leastwork(w, f, flip_weight=False):
    """K3-adjoint's operands in least-work form: (wk [kh,kh,O,I], fk [4,4],
    pad) with du[m] = sum_a sum_i wk[a] fk[i] gd[2m + a + i - pad] (each
    spatial dimension, gd zero outside the image). The up-conv is y[o] =
    sum_t K[t] xz[o + t - p0] with xz the zero-inserted input, K[t] =
    sum_i fz[i] wz[t - i] (fz the flipped FIR times the gain 4, wz the
    correlation taps) and p0 = kh//2 + (fw+1)//2 (`upconv2_phase_kernels`);
    its adjoint du[m] = sum_t K[t]^T gd[2m + p0 - t] reads, with a and i
    counted from the other end, wk = flip(wz)^T, fk = flip(fz) = 4 f and
    pad = kh + fw - 2 - p0."""
    kh = int(w.shape[0])
    fk = _fir_4x4(f) * 4.0
    wz = w if flip_weight else w.flip((0, 1))
    wk = wz.flip((0, 1)).transpose(2, 3)
    return wk.contiguous(), fk.contiguous(), kh - kh // 2


def upconv2_dw_leastwork(w, f, flip_weight=False):
    """K3-dw's operands (the cotangent of K2's weight) in least-work form:
    (flip, fk [4,4], pad) with, in each spatial dimension,
        dwk[a] = sum_m xs[m]^T B[2m + a],    B[p] = sum_i fk[i] gd[p + i - pad],
    xs = x * s the scaled input, gd the pre-activation cotangent (zero
    outside the image), and dw = flip(dwk) if `flip` else dwk. K2 is Z[q] =
    sum_a wk[a] xz[q - a], y[o] = sum_i fz[i] Z[o + i - pz]
    (`upconv2_leastwork`), so dwk[a] = sum_q xz[q - a] gZ[q] = sum_m xs[m]
    gZ[2m + a] with gZ[q] = sum_o fz[q - o + pz] gd[o]; counted from the
    other end, gZ = B with fk = flip(fz) = 4 f and pad = 3 - pz = kh -
    kh//2: the operand that K3's adjoint filters (`upconv2_adjoint_leastwork`).
    wk = flip(w) when flip_weight, so flip = flip_weight."""
    _, fk, pad = upconv2_adjoint_leastwork(w, f, flip_weight)
    return flip_weight, fk, pad


def downconv2_dw_leastwork(w, f, flip_weight=True):
    """The D down-conv's dw operands in least-work form: (flip, fk [4,4],
    pad) with, in each spatial dimension,
        dwk[a] = sum_m B[2m + a]^T gz[m],    B[p] = sum_i fk[i] x[p + i - pad],
    gz the pre-activation cotangent, x zero outside the image, and dw =
    flip(dwk) if `flip` else dwk: K3-forward's y[m] = sum_a wk[a] B[2m + a]
    (`downconv2_leastwork`, B the FIR at input resolution) differentiated in
    wk, which is w when flip_weight and flip(w) otherwise."""
    _, fk, pad = downconv2_leastwork(w, f, flip_weight)
    return not flip_weight, fk, pad


def _fold(weights_of, w, dk):
    """The cotangent of w through the linear map `weights_of` (w -> parity
    weights) at dk: the vjp, the port's `jax.linear_transpose`."""
    with torch.enable_grad():
        w_ = w.detach().requires_grad_(True)
        return torch.autograd.grad(weights_of(w_), w_, dk)[0]


# ---------------------------------------------------------------------------
# Plain forwards.
# ---------------------------------------------------------------------------


def modconv3x3_plain(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True):
    """Plain K1. x [N,H,W,C]; w [3,3,C,O]; styles [N,C] or None (unscaled, no
    demodulation); noise [H,W] or [N,H,W] (already scaled by its strength)
    or None; bias [O] or None; resid [N,H,W,O] or None. In x's type: in
    bfloat16, x * s, w, the noise and resid are rounded to bfloat16, the
    sums and the epilogue run in float32 and y is rounded once."""
    dt = x.dtype
    xs = x if styles is None else x * styles.to(dt)[:, None, None, :]
    y = _nhwc(F.conv2d(_nchw(at_least_f32(xs)), _widened(w, dt).permute(3, 2, 0, 1),
                       padding=1))
    d = demod_coef(w, styles) if demodulate else None
    y = _epilogue(y, d, _widened(noise, dt), bias, gain, alpha)
    return (y if resid is None else y + _widened(resid, dt)).to(dt)


def upconv2_plain(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                  demodulate=True, flip_weight=False):
    """Plain K2. x [N,H,W,I]; w [kh,kw,I,O] with kh in (1, 3); styles [N,I]
    or None (unmodulated, no demodulation); f: FIR from setup_filter;
    noise [2H,2W] or [N,2H,2W] or None; bias [O] or None. Returns
    [N,2H,2W,O] in x's type; in bfloat16 the FIR-composed weights are
    rounded after their float32 composition, as JAX's."""
    dt = x.dtype
    wp, hb = upconv2_phase_kernels(w, f, flip_weight)
    xs = x if styles is None else x * styles.to(dt)[:, None, None, :]
    y = _phase_upconv(at_least_f32(xs), _widened(wp, dt), hb)
    d = demod_coef(w, styles) if (styles is not None and demodulate) else None
    return _epilogue(y, d, _widened(noise, dt), bias, gain, alpha).to(dt)


def downconv2_plain(x, w, f, bias=None, resid=None, gain=1.0, alpha=0.2, flip_weight=True):
    """Plain K3 forward (the D down-conv). x [N,2H,2W,I]; w [kh,kw,I,O] with
    kh in (1, 3); f: FIR from setup_filter (or None); bias [O] or None;
    resid [N,H,W,O] or None, added after the activation. Returns [N,H,W,O]
    in x's type, equal to conv2d_resample(x, w, f, down=2, padding=kh//2) +
    bias_act. In bfloat16 the composed kernel is rounded after its float32
    composition and resid is rounded, the sums and the epilogue run in
    float32 and y is rounded once (`_dconv_fwd_impl` :2061-2068)."""
    dt = x.dtype
    wf, hb = downconv2_parity_kernels(w, f, flip_weight)
    y = _parity_downconv(at_least_f32(x), _widened(wf, dt), hb)
    y = _lrelu(y + (0 if bias is None else bias), gain, alpha)
    return (y if resid is None else y + _widened(resid, dt)).to(dt)


# ---------------------------------------------------------------------------
# Plain adjoints and dw taps. The split is the TPU backward's: torch forms
# gd = g * lrelu'(.) * d (`_modconv_bwd_impl` :842-847), the adjoint launch
# (plain here, the kernel in the wrappers below) gives du = conv^T(gd), dx =
# du * s, the ds dot tap sum x*du and the dd taps dd1 = sum gd*(y/mask -
# noise), dd2 = sum gd; the dw launch gives the weight cotangent (on the
# plain route per parity, folded back onto w); torch closes the demod chain
# (:921-931).
# ---------------------------------------------------------------------------


def _adjoint_gd(g, y, w, styles, gain, alpha, demodulate):
    """(mask, gd, d): the lrelu*gain slope from the sign of y (already peeled
    of resid), gd = g * mask * d, and d (None without demodulation). mask
    and gd are in g's type, d rounded to it, as JAX forms them (:842-847)."""
    mask = _slope(y, gain, alpha)
    gd = g * mask
    d = None
    if styles is not None and demodulate:
        d = demod_coef(w, styles)
        gd = gd * d.to(gd.dtype)[:, None, None, :]
    return mask, gd, d


def _dd_taps_plain(gd, y, slope, noise):
    """dd1 = sum_hw gd*(y/mask - noise), dd2 = sum_hw gd, each [N, O], in
    float32; mask is the forward's lrelu'*gain from `slope` = (gain, alpha)
    in float32 (JAX's dd taps take the float32 gain), the noise rounded to
    gd's type."""
    gdf, yf = at_least_f32(gd), at_least_f32(y)
    t = yf / _slope(yf, *slope)
    if noise is not None:
        t = t - _widened(_noise_nhwc(noise), gd.dtype)
    return (gdf * t).sum(dim=(1, 2)), gdf.sum(dim=(1, 2))


def _demod_de(dd1, dd2, d, bias):
    """de = -0.5 (dd1 - b dd2) d: the cotangent of e = s^2 @ wsq through
    d = rsqrt(e + 1e-8) (`_modconv_bwd_impl` :921-929)."""
    raw = dd1 if bias is None else dd1 - bias[None] * dd2
    return -0.5 * raw * d


def _demod_chain(ds, de, w, styles):
    """ds += 2 s (de @ wsq^T): the styles' share through the demodulation."""
    return ds + 2.0 * styles * (de @ w.to(de.dtype).square().sum(dim=(0, 1)).T)


def _taps_result(du, x, styles, want_dx, want_dot, dtype):
    """dx = du * s rounded to `dtype` (gd's) and the ds dot sum x * du in
    float32, from du, the float32 sums of the adjoint."""
    dx = du if styles is None else du * styles[:, None, None, :]
    dot = (x * du).sum(dim=(1, 2)) if want_dot else None
    return (dx.to(dtype) if want_dx else None), dot


def _k1_taps_plain(gd, x, w, styles, y, slope, noise, need_dx, need_ds, need_dd):
    """The K1 adjoint launch's function on gd: (dx, ds dot, dd1, dd2).
    `slope` is the forward's (gain, alpha), for the dd taps."""
    du = _nhwc(F.conv2d(_nchw(at_least_f32(gd)),
                        _widened(modconv3x3_adjoint_weights(w), gd.dtype).permute(3, 2, 0, 1),
                        padding=1))
    dx, dot = _taps_result(du, x, styles, need_dx, need_ds, gd.dtype)
    dd1, dd2 = _dd_taps_plain(gd, y, slope, noise) if need_dd else (None, None)
    return dx, dot, dd1, dd2


def _k3_taps_plain(gd, x, w, styles, f, flip_weight, y, slope, noise, need_dx, need_ds,
                   need_dd):
    """The K3 adjoint launch's function on gd, as `_k1_taps_plain`; the
    composed weights rounded to gd's type after their float32 composition."""
    wt, hbt = upconv2_adjoint_kernels(w, f, flip_weight)
    du = _parity_downconv(at_least_f32(gd), _widened(wt, gd.dtype), hbt)
    dx, dot = _taps_result(du, x, styles, need_dx, need_ds, gd.dtype)
    dd1, dd2 = _dd_taps_plain(gd, y, slope, noise) if need_dd else (None, None)
    return dx, dot, dd1, dd2


def modconv3x3_adjoint_plain(g, x, w, styles, y, noise=None, bias=None, resid=None,
                             gain=1.0, alpha=0.2, demodulate=True, need_dx=True,
                             need_ds=True):
    """Plain K1 adjoint: the cotangents of x and styles of `modconv3x3_plain`
    for output cotangent g, from its inputs and its output y. Returns
    (dx, ds, dd1, dd2); dx / ds are None unless asked for (ds never without
    styles), dd1 / dd2 (the demod-chain taps, [N,O]) are None without
    demodulation or ds. The resid cotangent is g itself."""
    need_ds = need_ds and styles is not None
    if resid is not None:
        y = y - resid
    _, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    need_dd = need_ds and d is not None
    dx, ds, dd1, dd2 = _k1_taps_plain(gd, x, w, styles, y, (gain, alpha), noise, need_dx,
                                      need_ds, need_dd)
    if need_dd:
        ds = _demod_chain(ds, _demod_de(dd1, dd2, d, bias), w, styles)
    return dx, ds, dd1, dd2


def upconv2_adjoint_plain(g, x, w, styles, f, y, noise=None, bias=None, gain=1.0,
                          alpha=0.2, demodulate=True, flip_weight=False, need_dx=True,
                          need_ds=True):
    """Plain K3 in its adjoint role: the cotangents of x and styles of
    `upconv2_plain` for output cotangent g [N,2H,2W,O], from its inputs and
    its output y. Returns (dx, ds, dd1, dd2) as `modconv3x3_adjoint_plain`;
    the unmodulated skip (styles None) gives dx only."""
    need_ds = need_ds and styles is not None
    _, gd, d = _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)
    need_dd = need_ds and d is not None
    dx, ds, dd1, dd2 = _k3_taps_plain(gd, x, w, styles, f, flip_weight, y, (gain, alpha),
                                      noise, need_dx, need_ds, need_dd)
    if need_dd:
        ds = _demod_chain(ds, _demod_de(dd1, dd2, d, bias), w, styles)
    return dx, ds, dd1, dd2


def downconv2_adjoint_plain(gz, w, f, flip_weight=True):
    """Plain K2 in its use_dw role: dx of `downconv2_plain` from gz [N,H,W,O],
    the cotangent of the conv output (g * lrelu'), as the up-conv of gz with
    the flipped, transposed parity taps. Returns [N,2H,2W,I] in gz's type:
    in bfloat16 the taps are rounded after their float32 composition, the
    sums run in float32 and dx is rounded once (`_dconv_bwd_impl` :2150)."""
    wt, hbt = downconv2_adjoint_kernels(w, f, flip_weight)
    return _phase_upconv(at_least_f32(gz), _widened(wt, gz.dtype), hbt).to(gz.dtype)


_PARITIES = ((0, 0), (0, 1), (1, 0), (1, 1))


def conv_dw_plain(a, b, s, pa, pb, nt, hb):
    """The dw taps: dW[p, ta, tb] = sum_{n,iy,ix} A_p[n, iy + hb[qy] + ta - 1,
    ix + hb[qx] + tb - 1, :]^T B_p[n, iy, ix, :] over a base grid, A zero
    outside it. A_p is a * s (pa = 1) or parity plane p = (qy, qx) of a
    (pa = 2); B_p is b (pb = 1) or its parity plane p (pb = 2); one p when
    both are 1. a [N,pa*H,pa*W,I]; b [N,pb*H,pb*W,O]; s [N,I] or None.
    Returns [NP,NT,NT,I,O], summed in float32 (JAX's taps take float32); in
    bfloat16 a * s is rounded to bfloat16 first, as JAX's u_t (:270-271)."""
    dt = a.dtype
    a, b = at_least_f32(a), at_least_f32(b)
    if s is not None:
        a = _widened(a * s[:, None, None, :], dt)
    out = []
    for qy, qx in (_PARITIES if max(pa, pb) == 2 else ((0, 0),)):
        ap = a[:, qy::2, qx::2] if pa == 2 else a
        bp = b[:, qy::2, qx::2] if pb == 2 else b
        h, wd = bp.shape[1:3]
        apad = F.pad(ap, (0, 0, 1, 1, 1, 1))
        out.append(torch.stack([torch.stack([
            torch.einsum("nhwc,nhwo->co",
                         apad[:, hb[qy] + ta:hb[qy] + ta + h, hb[qx] + tb:hb[qx] + tb + wd], bp)
            for tb in range(nt)]) for ta in range(nt)]))
    return torch.stack(out)


def fir_dw_plain(src, base, s, fk, pad, kh):
    """The function of the least-work dw kernel (`mgt_fir_dw`) in torch, in
    its order of operations: the FIR once, then the stride-2 taps,
        out[a, b, u, v] = sum_{n,m,l} B[n, 2m + a, 2l + b, u] (base * s)[n, m, l, v],
        B[n, p, r, u]   = sum_{iy,ix} fk[iy, ix] src[n, p + iy - pad, r + ix - pad, u],
    src zero outside the image. src [N,2H,2W,U]; base [N,H,W,V]; s [N,V] or
    None; fk [4,4] -> [kh,kh,U,V], in float32 (bfloat16 operands widened,
    base * s rounded to bfloat16 as the kernel rounds it). The tests hold
    the kernel's operands with it; the main path never calls it."""
    n, h, wd, _ = base.shape
    u = src.shape[-1]
    dt = base.dtype
    src, base = at_least_f32(src), at_least_f32(base)
    if s is not None:
        base = _widened(base * s[:, None, None, :], dt)
    hi = kh + 2 - pad
    b = F.conv2d(F.pad(_nchw(src), (pad, hi, pad, hi)), fk.to(src.dtype).expand(u, 1, 4, 4),
                 groups=u)
    return torch.stack([torch.stack([
        torch.einsum("nuhw,nhwv->uv", b[:, :, ta:ta + 2 * h:2, tb:tb + 2 * wd:2], base)
        for tb in range(kh)]) for ta in range(kh)])


def upconv2_dw_plain(x, gd, styles, w, f, flip_weight=False):
    """The cotangent of K2's weight w from gd [N,2H,2W,O] and x [N,H,W,I]
    scaled by styles [N,I] (or None), the composed way: the per-parity dw
    taps of the FIR-composed kernel (`conv_dw_plain`, pb 2) folded back onto
    w through the vjp of `upconv2_phase_kernels`. The plain route's, and
    the reference that the kernel (`upconv2_dw`) is held against."""
    wp, hb = upconv2_phase_kernels(w, f, flip_weight)
    dwp = conv_dw_plain(x, gd, styles, 1, 2, int(wp.shape[2]), hb)
    return _fold(lambda w_: upconv2_phase_kernels(w_, f, flip_weight)[0], w,
                 dwp.reshape(wp.shape))


def downconv2_dw_plain(x, gz, w, f, flip_weight=True):
    """The cotangent of the D down-conv's weight w from gz [N,H,W,O] and x
    [N,2H,2W,I], the composed way: the per-input-parity dw taps of the
    FIR-composed kernel (`conv_dw_plain`, pa 2) folded back onto w through
    the vjp of `downconv2_parity_kernels`. The plain route's, and the
    reference that the kernel (`downconv2_dw`) is held against."""
    wf, hb = downconv2_parity_kernels(w, f, flip_weight)
    dwf = conv_dw_plain(x, gz, None, 2, 1, int(wf.shape[2]), hb)
    return _fold(lambda w_: downconv2_parity_kernels(w_, f, flip_weight)[0], w,
                 dwf.reshape(wf.shape))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(name, t, shape, device, dtype=torch.float32):
    """Validate an optional kernel operand of type `dtype`; returns its
    pointer (None if absent)."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def _check_noise(name, noise, n, h, wd, device, dtype=torch.float32):
    """(pointer, per-sample stride) of batch-shared [H,W] or per-sample
    [N,H,W] noise."""
    if noise is None:
        return None, 0
    if noise.dim() == 3:
        return _check(name, noise, (n, h, wd), device, dtype), h * wd
    return _check(name, noise, (h, wd), device, dtype), 0


# The kernels' entry points by compute type: the float32 ones and the
# bfloat16 ones.
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def _kernel_dtype(t, name="x"):
    """The compute type of a launch: t's, float32 or bfloat16."""
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernels take float32 or bfloat16, got {t.dtype}")
    return t.dtype


def _as(t, dtype):
    """An operand cast to the kernel's type, contiguous (None stays None)."""
    return None if t is None else t.to(dtype).contiguous()


def _library():
    from morphganformer_tpu_torch.ops._build import library

    return library()


def _launch(fn, *args):
    rc = getattr(_library(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {rc}")


def _stream(dev):
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _aligned(name, ptr):
    if ptr is not None and ptr % 16:
        raise ValueError(f"{name}: the least-work kernels read 16-byte vectors, must be "
                         "16-byte aligned")
    return ptr


def k1_widths(c, o):
    """K1's kernel (and K4's) takes channel counts in fours (16-byte copies)."""
    if not lw_widths_ok(c, o):
        raise ValueError(f"K1 takes channel counts in fours, got {c} -> {o}")


def _modconv3x3_forward(x, w, styles, noise=None, bias=None, resid=None,
                        gain=1.0, alpha=0.2, demodulate=True):
    """K1 forward: the plain version for a CPU tensor; for a CUDA one a launch
    of `mgt_modconv3x3_fwd`, which folds the style into the weights."""
    if _on_cpu(x):
        return modconv3x3_plain(x, w, styles, noise, bias, resid, gain, alpha, demodulate)
    n, h, wd, c = x.shape
    o = w.shape[-1]
    dev, dt = x.device, _kernel_dtype(x)
    k1_widths(c, o)
    d = demod_coef(w, styles).contiguous() if demodulate else None
    wc, sc, nz = _as(w, dt), _as(styles, dt), _as(noise, dt)
    noise_p, noise_ns = _check_noise("noise", nz, n, h, wd, dev, dt)
    ptrs = [_aligned("x", _check("x", x, (n, h, wd, c), dev, dt)),
            _aligned("w", _check("w", wc, (3, 3, c, o), dev, dt)),
            _check("styles", sc, (n, c), dev, dt), _check("d", d, (n, o), dev),
            noise_p, _check("bias", bias, (o,), dev),
            _check("resid", resid, (n, h, wd, o), dev, dt)]
    y = torch.empty((n, h, wd, o), device=dev, dtype=dt)
    _launch("mgt_modconv3x3_fwd" + _SUFFIX[dt], *ptrs, y.data_ptr(), n, h, wd, c, o,
            float(gain), float(alpha), noise_ns, *_stream(dev))
    launch_counts["modconv3x3" + _SUFFIX[dt]] += 1
    return y


def _lw_weights(wk, fk, dev, dtype=torch.float32):
    """Pointers of the least-work kernels' (K2, K3) small weight (of type
    `dtype`) and FIR (float32). They take a 1x1 or 3x3 weight and channel
    counts in fours, and read them with 16-byte copies."""
    kh, ci, co = int(wk.shape[0]), int(wk.shape[2]), int(wk.shape[3])
    if kh not in (1, 3) or wk.shape[1] != kh:
        raise ValueError(f"the least-work kernels take a 1x1 or 3x3 weight, got "
                         f"{tuple(wk.shape[:2])}")
    if not lw_widths_ok(ci, co):
        raise ValueError(f"the least-work kernels take channel counts in fours, got {ci} -> {co}")
    return [_aligned("wk", _check("wk", wk, wk.shape, dev, dtype)),
            _check("fir", fk, (4, 4), dev)]


def _upconv2_launch(x, operands, styles, d, noise, bias, gain, alpha):
    """One launch of K2's least-work kernel (`mgt_upconv2_fwd`, either
    role): x [N,H,W,I] -> [N,2H,2W,O]; `operands` are (wk, fk, pad)."""
    wk, fk, pad = operands
    n, h, wd, ci = x.shape
    kh, co = int(wk.shape[0]), int(wk.shape[-1])
    dev, dt = x.device, _kernel_dtype(x)
    wk, sc, nz = _as(wk, dt), _as(styles, dt), _as(noise, dt)
    noise_p, noise_ns = _check_noise("noise", nz, n, 2 * h, 2 * wd, dev, dt)
    ptrs = [_aligned("x", _check("x", x, (n, h, wd, ci), dev, dt)),
            *_lw_weights(wk, fk, dev, dt), _check("styles", sc, (n, ci), dev, dt),
            _aligned("d", _check("d", d, (n, co), dev)),
            noise_p, _aligned("bias", _check("bias", bias, (co,), dev))]
    y = torch.empty((n, 2 * h, 2 * wd, co), device=dev, dtype=dt)
    _launch("mgt_upconv2_fwd" + _SUFFIX[dt], *ptrs, y.data_ptr(), n, h, wd, ci, co, kh, pad,
            float(gain), float(alpha), noise_ns, *_stream(dev))
    return y


def _upconv2_forward(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                     demodulate=True, flip_weight=False):
    """K2 forward: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _on_cpu(x):
        return upconv2_plain(x, w, styles, f, noise, bias, gain, alpha,
                             demodulate, flip_weight)
    d = demod_coef(w, styles).contiguous() if (styles is not None and demodulate) else None
    y = _upconv2_launch(x, upconv2_leastwork(w, f, flip_weight), styles, d, noise, bias, gain,
                        alpha)
    launch_counts["upconv2" + _SUFFIX[y.dtype]] += 1
    return y


def _downconv2_forward(x, w, f, bias=None, resid=None, gain=1.0, alpha=0.2, flip_weight=True):
    """K3 forward: the plain version for a CPU tensor; for a CUDA one a launch
    of `mgt_downconv2_fwd` (float32, downconv2_lw_kernel) or
    `mgt_downconv2_fwd_bf16` (x, the small weight and resid rounded to
    bfloat16; the FIR, the bias and the sums float32; on the tensor cores,
    downconv2_fwd_tc_kernel)."""
    if _on_cpu(x):
        return downconv2_plain(x, w, f, bias, resid, gain, alpha, flip_weight)
    n, h2, w2, ci = x.shape
    h, wd = h2 // 2, w2 // 2
    dev, dt = x.device, _kernel_dtype(x)
    wk, fk, pad = downconv2_leastwork(w, f, flip_weight)
    kh, co = int(wk.shape[0]), int(wk.shape[-1])
    ptrs = [_aligned("x", _check("x", x, (n, 2 * h, 2 * wd, ci), dev, dt)),
            *_lw_weights(_as(wk, dt), fk, dev, dt), _check("bias", bias, (co,), dev),
            _aligned("resid", _check("resid", resid, (n, h, wd, co), dev, dt))]
    y = torch.empty((n, h, wd, co), device=dev, dtype=dt)
    _launch("mgt_downconv2_fwd" + _SUFFIX[dt], *ptrs, y.data_ptr(), n, h, wd, ci, co, kh, pad,
            float(gain), float(alpha), *_stream(dev))
    launch_counts["downconv2" + _SUFFIX[dt]] += 1
    return y


def _adjoint_outputs(n, h, wd, c, o, nblk, need_dx, need_ds, need_dd, dev, dtype):
    """dx [N,H,W,C] of type `dtype` and the float32 per-block partials of an
    adjoint launch, dot [N,nblk,C] and dd1, dd2 [N,nblk,O]; None where not
    asked."""
    def empty(*shape, dt=torch.float32):
        return torch.empty(shape, device=dev, dtype=dt)
    return (empty(n, h, wd, c, dt=dtype) if need_dx else None,
            empty(n, nblk, c) if need_ds else None,
            *(empty(n, nblk, o) if need_dd else None for _ in range(2)))


def _summed(dx, dot, dd1, dd2):
    """(dx, dot, dd1, dd2) with the partials summed over the blocks in a
    fixed order: the result does not depend on how the blocks were
    scheduled."""
    return (dx, *(None if t is None else t.sum(1) for t in (dot, dd1, dd2)))


def _k1_adjoint_launch(g, w, styles, d, x, y, resid, noise, gain, alpha, need_dx, need_ds,
                       need_dd):
    """One launch of K1's adjoint: the kernel forms gd = g * mask(y - resid)
    * d itself (no scale without d) and reads flip(w)^T from w by index,
    so no elementwise pass over g, y or resid runs here. In float32
    `mgt_modconv3x3_bwd` (conv3x3_lw_kernel), in bfloat16
    `mgt_modconv3x3_bwd_bf16` (conv3x3_adj_tc_kernel, on the tensor cores),
    each with its own count of partials. g [N,H,W,O]; w [3,3,C,O]; x
    [N,H,W,C] for the ds dot (need_ds). Returns (dx, dot, dd1, dd2), the
    per-block partials summed here in a fixed order; None where not asked."""
    n, h, wd, o = g.shape
    c = w.shape[2]
    dev, dt = g.device, _kernel_dtype(g, "g")
    k1_widths(c, o)
    tiles = _library().mgt_bwd_tiles_bf16 if dt == torch.bfloat16 else _library().mgt_bwd_tiles
    outs = _adjoint_outputs(n, h, wd, c, o, tiles(h, wd, c), need_dx, need_ds, need_dd, dev, dt)
    wc, nz = _as(w, dt), _as(noise if need_dd else None, dt)
    noise_p, noise_ns = _check_noise("noise", nz, n, h, wd, dev, dt)
    ptrs = [_aligned("g", _check("g", g, (n, h, wd, o), dev, dt)),
            _aligned("w", _check("w", wc, (3, 3, c, o), dev, dt)),
            _check("styles", styles if need_dx else None, (n, c), dev),
            _aligned("d", _check("d", d, (n, o), dev)),
            _check("x", x if need_ds else None, (n, h, wd, c), dev, dt),
            _aligned("y", _check("y", y, (n, h, wd, o), dev, dt)),
            _aligned("resid", _check("resid", resid, (n, h, wd, o), dev, dt)),
            noise_p]
    _launch("mgt_modconv3x3_bwd" + _SUFFIX[dt], *ptrs,
            *(None if t is None else t.data_ptr() for t in outs),
            n, h, wd, o, c, float(gain), float(alpha), noise_ns, *_stream(dev))
    launch_counts["modconv3x3_adj" + _SUFFIX[dt]] += 1
    return _summed(*outs)


def _k1_taps(g, x, w, styles, d, y, resid, noise, gain, alpha, slope, need_dx, need_ds,
             need_dd):
    """The K1 adjoint launch: (dx, ds dot, dd1, dd2). On a CPU tensor the
    plain version, on gd formed in torch (`slope()`, `_modulated_backward`);
    on a CUDA tensor the kernel, which forms gd itself."""
    if _on_cpu(x):
        y_, _, _, gd = slope()
        return _k1_taps_plain(gd, x, w, styles, y_, (gain, alpha), noise, need_dx, need_ds,
                              need_dd)
    return _k1_adjoint_launch(g, w, styles, None if d is None else d.contiguous(), x, y, resid,
                              noise, gain, alpha, need_dx, need_ds, need_dd)


def _k3_adjoint_launch(t, x, w, styles, f, flip_weight, d, y, noise, gain, alpha, need_dx,
                       need_ds, need_dd):
    """One launch of K3's adjoint: (dx, ds dot, dd1, dd2), the per-block
    partials summed here in a fixed order; None where not asked. In float32
    t is gd, formed in torch (`mgt_upconv2_bwd`). In bfloat16 t is the
    output cotangent g [N,2H,2W,O] and the kernel (`mgt_upconv2_bwd_bf16`,
    downconv2_tc_kernel) forms gd = g * mask(y) * d itself (d None: no
    demodulation), so no elementwise pass over g or y runs here; it reads y
    only for the dd taps or a mask that is not the gain alone (alpha 1).
    x [N,H,W,C] is read for the ds dot only."""
    wk, fk, pad = upconv2_adjoint_leastwork(w, f, flip_weight)
    n, ho, wo, o = t.shape
    h, wd, c = ho // 2, wo // 2, w.shape[2]
    bf = _kernel_dtype(t, "g") == torch.bfloat16
    dev, dt, name = t.device, t.dtype, "g" if bf else "gd"
    outs = _adjoint_outputs(n, h, wd, c, o, _library().mgt_downconv2_tiles(h, wd), need_dx,
                            need_ds, need_dd, dev, dt)
    wk, nz = _as(wk, dt), _as(noise if need_dd else None, dt)
    yc = y.contiguous() if need_dd or (bf and float(alpha) != 1.0) else None
    noise_p, noise_ns = _check_noise("noise", nz, n, ho, wo, dev, dt)
    ptrs = [_aligned(name, _check(name, t, (n, ho, wo, o), dev, dt)),
            *_lw_weights(wk, fk, dev, dt),
            _aligned("styles", _check("styles", styles, (n, c), dev)),
            *([_check("d", d, (n, o), dev)] if bf else []),
            _aligned("x", _check("x", x if need_ds else None, (n, h, wd, c), dev, dt)),
            _aligned("y", _check("y", yc, (n, ho, wo, o), dev, dt)), noise_p]
    _launch("mgt_upconv2_bwd" + _SUFFIX[dt], *ptrs,
            *(None if u is None else u.data_ptr() for u in outs),
            n, h, wd, o, c, int(wk.shape[0]), pad, float(gain), float(alpha), noise_ns,
            *_stream(dev))
    launch_counts["upconv2_adj" + _SUFFIX[dt]] += 1
    return _summed(*outs)


def _k3_taps(g, gd_of, x, w, styles, f, flip_weight, d, y, noise, gain, alpha, need_dx,
             need_ds, need_dd):
    """The K3 adjoint launch: (dx, ds dot, dd1, dd2). `gd_of()` gives gd =
    g * mask(y) * d formed in torch, which the plain version (a CPU tensor)
    and the float32 kernel take; the bfloat16 kernel forms gd from g, y and
    d itself. x [N,H,W,C] is read for the ds dot only."""
    if _on_cpu(g):
        return _k3_taps_plain(gd_of(), x, w, styles, f, flip_weight, y, (gain, alpha), noise,
                              need_dx, need_ds, need_dd)
    t = g.contiguous() if _kernel_dtype(g, "g") == torch.bfloat16 else gd_of().contiguous()
    return _k3_adjoint_launch(t, x, w, styles, f, flip_weight,
                              None if d is None else d.contiguous(), y, noise, gain, alpha,
                              need_dx, need_ds, need_dd)


def modconv3x3_adjoint(g, x, w, styles, y, noise=None, bias=None, resid=None,
                       gain=1.0, alpha=0.2, demodulate=True, need_dx=True, need_ds=True):
    """K1 adjoint: `modconv3x3_adjoint_plain` for a CPU tensor; for a CUDA
    tensor one launch of `mgt_modconv3x3_bwd` forms gd and gives dx, the ds
    dot and the dd taps as per-block partials, summed here. Same returns; x
    is read for ds only."""
    if _on_cpu(g):
        return modconv3x3_adjoint_plain(g, x, w, styles, y, noise, bias, resid, gain,
                                        alpha, demodulate, need_dx, need_ds)
    d = demod_coef(w, styles).contiguous() if demodulate else None
    need_ds = need_ds and styles is not None
    need_dd = need_ds and d is not None
    dx, ds, dd1, dd2 = _k1_adjoint_launch(g.contiguous(), w, styles, d, x, y, resid, noise,
                                          gain, alpha, need_dx, need_ds, need_dd)
    if need_dd:
        ds = _demod_chain(ds, _demod_de(dd1, dd2, d, bias), w, styles)
    return dx, ds, dd1, dd2


def upconv2_adjoint(g, x, w, styles, f, y, noise=None, bias=None, gain=1.0, alpha=0.2,
                    demodulate=True, flip_weight=False, need_dx=True, need_ds=True):
    """K3 in its adjoint role: `upconv2_adjoint_plain` for a CPU tensor; for
    a CUDA tensor one launch of `mgt_upconv2_bwd` on gd formed in torch
    (float32), or of `mgt_upconv2_bwd_bf16`, which forms gd itself
    (bfloat16). Same returns; x is read for ds only."""
    if _on_cpu(g):
        return upconv2_adjoint_plain(g, x, w, styles, f, y, noise, bias, gain, alpha,
                                     demodulate, flip_weight, need_dx, need_ds)
    need_ds = need_ds and styles is not None
    d = demod_coef(w, styles) if (styles is not None and demodulate) else None
    need_dd = need_ds and d is not None
    dx, ds, dd1, dd2 = _k3_taps(
        g, lambda: _adjoint_gd(g, y, w, styles, gain, alpha, demodulate)[1], x, w, styles, f,
        flip_weight, d, y, noise, gain, alpha, need_dx, need_ds, need_dd)
    if need_dd:
        ds = _demod_chain(ds, _demod_de(dd1, dd2, d, bias), w, styles)
    return dx, ds, dd1, dd2


def downconv2_adjoint(gz, w, f, flip_weight=True):
    """K2 in its use_dw role (dx of the D down-conv): `downconv2_adjoint_plain`
    for a CPU tensor; for a CUDA tensor one launch of K2's kernel with the
    down-conv's operands read back, no scale and no epilogue: the
    least-work kernel in float32, the tensor-core one (`upconv2_tc_kernel`)
    in bfloat16."""
    if _on_cpu(gz):
        return downconv2_adjoint_plain(gz, w, f, flip_weight)
    dx = _upconv2_launch(gz.contiguous(), downconv2_adjoint_leastwork(w, f, flip_weight),
                         None, None, None, None, 1.0, 1.0)
    launch_counts["downconv2_adj" + _SUFFIX[dx.dtype]] += 1
    return dx


def k1_dw_ot(co):
    """The gd channels of a block of K1's dw kernel for O = co (a multiple
    of 32): 64 where they divide co, else 32."""
    return 64 if co % 64 == 0 else 32


def dw_slices(ntiles, groups):
    """(slices, tiles per slice) of one least-work dw launch over ntiles
    tiles and `groups` channel tiles: one wave of `_FD_BLOCKS` blocks, no
    slice empty."""
    per = -(-ntiles // max(1, min(ntiles, _FD_BLOCKS // groups)))
    return -(-ntiles // per), per


def conv_dw(x, gd, s):
    """K1's dw taps (`conv_dw_plain` with pa = pb = 1, 3 taps, hb 0): the
    plain version for a CPU tensor; for a CUDA tensor one launch of the
    least-work kernel (`mgt_conv_dw`), or on bfloat16 x and gd of the
    tensor-core one (`mgt_conv_dw_bf16`, x * s rounded to bfloat16 as it
    lands), whose float32 per-slice partials are summed here in a fixed
    order. x [N,H,W,C], gd [N,H,W,O], s [N,C] (float32) or None -> float32
    [3,3,C,O]. Both kernels tile C and O by 32: other widths are padded
    with zero channels, whose cotangent entries are cut off."""
    if _on_cpu(x):
        return conv_dw_plain(x, gd, s, 1, 1, 3, (0, 0))[0]
    n, h, wd, ci = x.shape
    co = gd.shape[-1]
    if ci % 32 or co % 32:
        pad_a, pad_b = (0, -ci % 32), (0, -co % 32)
        s = None if s is None else F.pad(s, pad_a)
        return conv_dw(F.pad(x, pad_a), F.pad(gd, pad_b), s)[..., :ci, :co]
    dev, dt = x.device, _kernel_dtype(x)
    ptrs = [_aligned("x", _check("x", x, (n, h, wd, ci), dev, dt)),
            _aligned("gd", _check("gd", gd, (n, h, wd, co), dev, dt)),
            _aligned("s", _check("s", s, (n, ci), dev))]
    ot = k1_dw_ot(co)
    tiles = getattr(_library(), "mgt_conv_dw_tiles" + _SUFFIX[dt])(n, h, wd, ot)
    slices, per = dw_slices(tiles, (ci // 32) * (co // ot))
    part = torch.empty((slices, 3, 3, ci, co), device=dev, dtype=torch.float32)
    _launch("mgt_conv_dw" + _SUFFIX[dt], *ptrs, part.data_ptr(), n, h, wd, ci, co, ot, slices,
            per, *_stream(dev))
    launch_counts["modconv3x3_dw" + _SUFFIX[dt]] += 1
    return part.sum(0)


def _fir_dw_launch(src, base, s, fk, pad, kh):
    """One launch of the FIR dw kernel (`mgt_fir_dw`, the least-work one, or
    on bfloat16 src and base `mgt_fir_dw_bf16`, the tensor-core one):
    `fir_dw_plain` of src [N,2H,2W,U] (filtered), base [N,H,W,V] and s
    [N,V] (float32) or None, with the float32 partials of its slices summed
    here in a fixed order; [kh,kh,U,V]. Both kernels tile U by 32 and V by
    64: other widths are padded with zero channels, whose entries are cut
    off."""
    n, h, wd, cv = base.shape
    cu = src.shape[-1]
    if cu % 32 or cv % 64:
        pad_u, pad_v = (0, -cu % 32), (0, -cv % 64)
        out = _fir_dw_launch(F.pad(src, pad_u), F.pad(base, pad_v),
                             None if s is None else F.pad(s, pad_v), fk, pad, kh)
        return out[..., :cu, :cv]
    if kh not in (1, 3):
        raise ValueError(f"the least-work dw kernel takes a 1x1 or 3x3 weight, got {kh}x{kh}")
    dev, dt = base.device, _kernel_dtype(base, "base")
    ptrs = [_aligned("src", _check("src", src, (n, 2 * h, 2 * wd, cu), dev, dt)),
            _aligned("base", _check("base", base, (n, h, wd, cv), dev, dt)),
            _aligned("s", _check("s", s, (n, cv), dev)), _check("fir", fk, (4, 4), dev)]
    tiles = getattr(_library(), "mgt_fir_dw_tiles" + _SUFFIX[dt])(n, h, wd)
    slices, per = dw_slices(tiles, (cu // 32) * (cv // 64))
    part = torch.empty((slices, kh, kh, cu, cv), device=dev, dtype=torch.float32)
    _launch("mgt_fir_dw" + _SUFFIX[dt], *ptrs, part.data_ptr(), n, h, wd, cu, cv, kh, pad,
            slices, per, *_stream(dev))
    return part.sum(0)


def upconv2_dw(x, gd, styles, w, f, flip_weight=False):
    """K3's dw role, the cotangent of K2's weight w [kh,kh,I,O] from the
    pre-activation cotangent gd [N,2H,2W,O] and x [N,H,W,I] scaled by
    styles [N,I] (or None): `upconv2_dw_plain` for a CPU tensor; for a CUDA
    tensor one launch of `mgt_fir_dw` on `upconv2_dw_leastwork`'s operands
    (gd filtered once, then the small weight's taps against x * s), whose
    cotangent maps onto w with a flip alone."""
    if _on_cpu(x):
        return upconv2_dw_plain(x, gd, styles, w, f, flip_weight)
    flip, fk, pad = upconv2_dw_leastwork(w, f, flip_weight)
    dwk = _fir_dw_launch(gd.contiguous(), x, styles, fk, pad, int(w.shape[0])).transpose(2, 3)
    launch_counts["upconv2_dw" + _SUFFIX[x.dtype]] += 1
    return dwk.flip((0, 1)) if flip else dwk


def downconv2_dw(x, gz, w, f, flip_weight=True):
    """The D down-conv's dw (the block cotangent of K2's use_dw role), the
    cotangent of its weight w [kh,kh,I,O] from gz [N,H,W,O] and x
    [N,2H,2W,I]: `downconv2_dw_plain` for a CPU tensor; for a CUDA tensor
    one launch of `mgt_fir_dw` on `downconv2_dw_leastwork`'s operands (x
    filtered once, then the small weight's taps against gz), whose
    cotangent maps onto w with a flip alone."""
    if _on_cpu(x):
        return downconv2_dw_plain(x, gz, w, f, flip_weight)
    flip, fk, pad = downconv2_dw_leastwork(w, f, flip_weight)
    dwk = _fir_dw_launch(x, gz.contiguous(), None, fk, pad, int(w.shape[0]))
    launch_counts["downconv2_dw" + _SUFFIX[x.dtype]] += 1
    return dwk.flip((0, 1)) if flip else dwk


# ---------------------------------------------------------------------------
# Backward passes of the Functions: every cotangent asked for, nothing else.
# ---------------------------------------------------------------------------


def _noise_grad(g_pre, noise):
    """dnoise: the pre-activation cotangent summed over channels, and over
    the batch for batch-shared noise."""
    dn = g_pre.sum(dim=3)
    return dn if noise.dim() == 3 else dn.sum(dim=0)


def _modulated_backward(g, y_of, w, styles, noise, bias, gain, alpha, demodulate, needs,
                        taps, dw_taps):
    """Cotangents (dx, dw, ds, dnoise, dbias) of K1 or K2 for output
    cotangent g; `needs` flags them in that order, None where not asked.
    `taps(d, slope, need_dx, need_ds, need_dd)` is the adjoint launch, run
    when dx, ds or the demod taps (for ds or dw) are needed; `dw_taps(gd)`
    the dw launch, the cotangent of w, run when dw is. `slope()` gives (y, mask,
    g * mask, gd = g * mask * d) in torch, formed once on first use from
    `y_of()`, the output peeled of resid: by the launches that take gd, and
    for dw, dnoise and dbias (K1's kernel forms gd itself)."""
    need_dx, need_dw, need_ds, need_dn, need_db = needs
    d = demod_coef(w, styles) if (styles is not None and demodulate) else None
    need_dd = d is not None and (need_ds or need_dw)

    @functools.lru_cache(maxsize=None)
    def slope():
        y = y_of()
        mask = _slope(y, gain, alpha)
        g_pre = g * mask
        return y, mask, g_pre, (g_pre if d is None else g_pre * d.to(g.dtype)[:, None, None, :])

    dx = ds = dd1 = dd2 = dw = None
    if need_dx or need_ds or need_dd:
        dx, ds, dd1, dd2 = taps(d, slope, need_dx, need_ds, need_dd)
    de = _demod_de(dd1, dd2, d, bias) if need_dd else None
    if need_ds and de is not None:
        ds = _demod_chain(ds, de, w, styles)
    if need_dw:
        dw = dw_taps(slope()[3].contiguous())
        if de is not None:
            dw = dw + 2.0 * w * (styles.square().T @ de)[None, None]
        dw = dw.to(w.dtype)
    dn = _noise_grad(at_least_f32(slope()[2]), noise).to(noise.dtype) if need_dn else None
    db = at_least_f32(slope()[2]).sum(dim=(0, 1, 2)).to(bias.dtype) if need_db else None
    return dx, dw, ds, dn, db


def modconv3x3_backward(g, x, w, styles, y, noise, bias, resid, gain, alpha, demodulate,
                        needs, plain=False):
    """Cotangents (dx, dw, ds, dnoise, dbias) of K1: its adjoint launch, which
    forms gd from g, y and resid itself, and its dw taps
    (`_modulated_backward`). Where dw is asked for (training), gd for the dw
    taps is formed once in torch, with g * mask, which dnoise and dbias need
    anyway."""
    needs = (needs[0], needs[1], needs[2] and styles is not None, needs[3], needs[4])

    def taps(d, slope, *need):
        if plain:
            y_, _, _, gd = slope()
            return _k1_taps_plain(gd, x, w, styles, y_, (gain, alpha), noise, *need)
        return _k1_taps(g, x, w, styles, d, y, resid, noise, gain, alpha, slope, *need)

    def dw_taps(gd):
        if plain:
            return conv_dw_plain(x, gd, styles, 1, 1, 3, (0, 0))[0]
        return conv_dw(x, gd, styles)

    return _modulated_backward(g, lambda: y if resid is None else y - resid, w, styles, noise,
                               bias, gain, alpha, demodulate, needs, taps, dw_taps)


def upconv2_backward(g, x, w, styles, f, y, noise, bias, gain, alpha, demodulate,
                     flip_weight, needs, plain=False):
    """Cotangents (dx, dw, ds, dnoise, dbias) of K2: K3's adjoint launch and
    K3's dw role (`upconv2_dw`; `upconv2_dw_plain` on the plain route),
    through `_modulated_backward`."""
    need_dx, need_dw, need_ds, need_dn, need_db = needs
    needs = (need_dx, need_dw, need_ds and styles is not None, need_dn, need_db)

    def taps(d, slope, *need):
        if plain:
            return _k3_taps_plain(slope()[3], x, w, styles, f, flip_weight, y, (gain, alpha),
                                  noise, *need)
        return _k3_taps(g, lambda: slope()[3], x, w, styles, f, flip_weight, d, y, noise, gain,
                        alpha, *need)

    def dw_taps(gd):
        return (upconv2_dw_plain if plain else upconv2_dw)(x, gd, styles, w, f, flip_weight)

    return _modulated_backward(g, lambda: y, w, styles, noise, bias, gain, alpha, demodulate,
                               needs, taps, dw_taps)


def downconv2_backward(g, x, w, f, y, bias, resid, gain, alpha, flip_weight, needs,
                       plain=False):
    """Cotangents (dx, dw, dbias) of K3-forward for output cotangent g: gz =
    g * lrelu'(y - resid) (resid is added after the activation, so y is
    peeled of it first, `_dconv_bwd_impl` :2131-2137); dx is K2's use_dw
    launch, dw the least-work dw kernel (`downconv2_dw`;
    `downconv2_dw_plain` on the plain route)."""
    need_dx, need_dw, need_db = needs
    if resid is not None:
        y = y - resid
    gz = g * _slope(y, gain, alpha)
    dx = dw = db = None
    if need_dx:
        dx = (downconv2_adjoint_plain if plain else downconv2_adjoint)(gz, w, f, flip_weight)
    if need_dw:
        dw = (downconv2_dw_plain if plain else downconv2_dw)(x, gz, w, f, flip_weight)
    if need_db:
        db = at_least_f32(gz).sum(dim=(0, 1, 2))
    return dx, dw, db


# ---------------------------------------------------------------------------
# Autograd Functions.
# ---------------------------------------------------------------------------


_ONCE = ("this kernel's backward is differentiable once here; take second derivatives "
         "inside second_order_scope() (ops/second_order.py) or under force_unpacked() "
         "(ops/packed_override.py)")


def first_order_only(backward):
    """`once_differentiable`, and a raise as soon as the backward runs under
    create_graph=True. `once_differentiable` alone defers its error to a
    node that `torch.autograd.grad(..., allow_unused=True)` never runs, and
    the second derivative then comes back as None, a wrong zero. Second
    derivatives go through `second_order_scope()` (the fused Functions) or
    the unpacked route (`force_unpacked()`)."""
    inner = once_differentiable(backward)

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError(_ONCE)
        return inner(ctx, *grads)
    return wrapper


# The grad Functions of the second-order route (`ModConv3x3Grad`,
# `UpConv2Grad`, `DownConv2Grad`), registered by ops/second_order.py, which
# builds on this module (ops/__init__.py imports both).
GRAD_FUNCTIONS = {}


def _engine_runs(node):
    """Whether the running backward pass executes `node` (one of a fused
    node's next functions), i.e. needs the cotangent that flows into it."""
    if node is None:
        return False
    try:
        return torch._C._will_engine_execute_node(node)
    except RuntimeError:
        # Raised for a leaf that autograd.grad() takes as one of its inputs:
        # its cotangent is exactly what the call returns.
        return True


def _needs(ctx, names, inputs):
    """The cotangents a fused Function's backward forms: those asked for;
    under create_graph=True (a second derivative) only those of the inputs
    that the `second_order_scope()` it was built in names, and outside a
    scope it raises (`first_order_only`'s guard against a wrong zero). An
    input the scope leaves out on which the running gradient depends (the
    engine will run its node) raises too: its cotangent would be a wrong
    zero. `inputs` are the tensors (or None) that `names` name, in the
    forward's order: a node's next functions hold its tensor inputs alone."""
    need = ctx.needs_input_grad
    if not torch.is_grad_enabled():
        return need
    if ctx.reaches is None:
        raise RuntimeError(_ONCE)
    edges = iter(ctx.next_functions)
    for asked, name, t in zip(need, names, inputs):
        if t is None:
            continue
        node, _ = next(edges)
        if asked and name not in ctx.reaches and _engine_runs(node):
            raise RuntimeError(
                f"the gradient being taken depends on the cotangent of {name!r}, which "
                f"second_order_scope(reaches={sorted(ctx.reaches)}) leaves out")
    return tuple(n and name in ctx.reaches for n, name in zip(need, names))


class FusedModConv3x3(torch.autograd.Function):
    """K1 with its adjoint and dw taps: gradients of x, w, styles, noise,
    bias and resid, each only when asked for; twice differentiable through
    `ModConv3x3Grad` when built inside `second_order_scope()`."""

    @staticmethod
    def forward(ctx, x, w, styles, noise, bias, resid, gain, alpha, demodulate, plain):
        fwd = modconv3x3_plain if plain else _modconv3x3_forward
        y = fwd(x, w, styles, noise, bias, resid, gain, alpha, demodulate)
        ctx.save_for_backward(x, w, styles, noise, bias, resid, y)
        ctx.opts = (gain, alpha, demodulate, plain)
        ctx.reaches = scope_reaches()
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, styles, noise, bias, resid, y = ctx.saved_tensors
        need = _needs(ctx, ("x", "w", "styles", "noise", "bias", "resid"),
                      (x, w, styles, noise, bias, resid))
        gain, alpha, demodulate, plain = ctx.opts
        g = g.contiguous()
        if torch.is_grad_enabled():
            grads = GRAD_FUNCTIONS["modconv3x3"].apply(
                x, w, styles, noise, bias, resid, y, g, gain, alpha, demodulate, need[:5], plain)
        else:
            grads = modconv3x3_backward(g, x, w, styles, y, noise, bias, resid, gain, alpha,
                                        demodulate, need[:5], plain)
        return (*grads, (g if need[5] else None), None, None, None, None)


class FusedUpConv2(torch.autograd.Function):
    """K2 with K3 as its adjoint and K3's dw taps: gradients of x, w,
    styles, noise and bias (not of the FIR), each only when asked for;
    twice differentiable through `UpConv2Grad` when built inside
    `second_order_scope()`."""

    @staticmethod
    def forward(ctx, x, w, styles, f, noise, bias, gain, alpha, demodulate, flip_weight,
                plain):
        fwd = upconv2_plain if plain else _upconv2_forward
        y = fwd(x, w, styles, f, noise, bias, gain, alpha, demodulate, flip_weight)
        ctx.save_for_backward(x, w, styles, f, noise, bias, y)
        ctx.opts = (gain, alpha, demodulate, flip_weight, plain)
        ctx.reaches = scope_reaches()
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, styles, f, noise, bias, y = ctx.saved_tensors
        need = _needs(ctx, ("x", "w", "styles", "f", "noise", "bias"),
                      (x, w, styles, f, noise, bias))
        gain, alpha, demodulate, flip_weight, plain = ctx.opts
        g = g.contiguous()
        need = (need[0], need[1], need[2], need[4], need[5])
        if torch.is_grad_enabled():
            dx, dw, ds, dn, db = GRAD_FUNCTIONS["upconv2"].apply(
                x, w, styles, f, noise, bias, y, g, gain, alpha, demodulate, flip_weight, need,
                plain)
        else:
            dx, dw, ds, dn, db = upconv2_backward(g, x, w, styles, f, y, noise, bias, gain,
                                                  alpha, demodulate, flip_weight, need, plain)
        return dx, dw, ds, None, dn, db, None, None, None, None, None


class FusedDownConv2(torch.autograd.Function):
    """K3-forward with K2's use_dw role as its adjoint and the down-conv's dw
    taps: gradients of x, w, bias and resid (not of the FIR), each only when
    asked for; twice differentiable through `DownConv2Grad` when built
    inside `second_order_scope()`."""

    @staticmethod
    def forward(ctx, x, w, f, bias, resid, gain, alpha, flip_weight, plain):
        fwd = downconv2_plain if plain else _downconv2_forward
        y = fwd(x, w, f, bias, resid, gain, alpha, flip_weight)
        ctx.save_for_backward(x, w, f, bias, resid, y)
        ctx.opts = (gain, alpha, flip_weight, plain)
        ctx.reaches = scope_reaches()
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, f, bias, resid, y = ctx.saved_tensors
        need = _needs(ctx, ("x", "w", "f", "bias", "resid"), (x, w, f, bias, resid))
        gain, alpha, flip_weight, plain = ctx.opts
        g = g.contiguous()
        needs = (need[0], need[1], need[3])
        if torch.is_grad_enabled():
            dx, dw, db = GRAD_FUNCTIONS["downconv2"].apply(
                x, w, f, bias, resid, y, g, gain, alpha, flip_weight, needs, plain)
        else:
            dx, dw, db = downconv2_backward(g, x, w, f, y, bias, resid, gain, alpha, flip_weight,
                                            needs, plain)
        return dx, dw, None, db, (g if need[4] else None), None, None, None, None


def fused_modconv3x3(x, w, styles, noise=None, bias=None, resid=None,
                     gain=1.0, alpha=0.2, demodulate=True, plain=False):
    """K1: y = lrelu(d * conv3x3_same(x * s, w) + noise + bias, alpha) * gain
    [+ resid], with d = rsqrt(s^2 . sum w^2 + 1e-8) when `demodulate`.
    Shapes as `modconv3x3_plain`; x float32 or bfloat16 (the compute type),
    the rest float32; contiguous. Differentiable in
    every tensor input (`FusedModConv3x3`); `plain=True` runs the plain
    forward and backward on any device."""
    return FusedModConv3x3.apply(x, w, styles, noise, bias, resid, gain, alpha,
                                 demodulate, plain)


def fused_upconv2(x, w, styles, f, noise=None, bias=None, gain=1.0, alpha=0.2,
                  demodulate=True, flip_weight=False, plain=False):
    """K2: 2x-up modulated conv with the FIR composed in, then demod (when
    styles are given and `demodulate`), noise, bias and lrelu * gain.
    Shapes as `upconv2_plain`; x float32 or bfloat16, the rest float32;
    contiguous. Differentiable in x, w,
    styles, noise and bias (`FusedUpConv2`, whose backward is K3);
    `plain=True` runs the plain forward and backward on any device."""
    return FusedUpConv2.apply(x, w, styles, f, noise, bias, gain, alpha, demodulate,
                              flip_weight, plain)


def fused_downconv2(x, w, f, bias=None, resid=None, gain=1.0, alpha=0.2, flip_weight=True,
                    plain=False):
    """K3 forward: the D tower's 2x-down conv with the FIR composed in, bias,
    lrelu * gain and the resnet skip added after. Shapes as
    `downconv2_plain`; x and resid float32 or bfloat16 (the compute type),
    w and bias float32; contiguous. Differentiable in x, w, bias and
    resid (`FusedDownConv2`, whose backward is K2's use_dw role);
    `plain=True` runs the plain forward and backward on any device."""
    return FusedDownConv2.apply(x, w, f, bias, resid, gain, alpha, flip_weight, plain)

