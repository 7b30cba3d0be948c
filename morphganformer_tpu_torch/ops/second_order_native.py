"""Hand-derived second-order (VJP-of-the-backward) formulas of the fused
modulated conv (port of morphganformer_tpu/ops/second_order_native.py).

The first-order backward of y = gain * lrelu_alpha(d * conv(x * s, w) +
noise + bias) is written against three linear primitives,

  conv(a, k)   the conv itself            (the forward launch with styles
                                           1, demod off, gain = alpha = 1)
  convT(a, k)  its transpose in a         (the adjoint launch's dx under the
                                           same degeneration)
  wg(a, b)     its transpose in k         (the dw launch)

and `modconv_bwd_vjp_from_y` is the VJP of that backward, the true
second-order term, with the lrelu mask locally constant (zero second
derivative a.e., as autograd of `torch.where` also gives). Every x-sized
term is one of the three primitives with swapped operands; the rest is
[N,Co] / [Ci,Co]-sized algebra. ops/second_order.py realises the
primitives by the port's kernel launches (or their plain versions) for K1,
K2 and the D down-conv.

NHWC activations, HWIO weights. The dtypes follow JAX's module: every
x-sized stream stays in its input's type (bfloat16 in bfloat16 training,
the [N,C] factors s and d rounded to it where they scale it), the
[N,C]/[C,O]-sized demodulation algebra and every pixel reduction in at
least float32 (`at_least_f32`), so a float64 run is float64 throughout.
`s` may be None for an unmodulated conv (the 1x1 skip, D's conv0): no style
scale and no style cotangent.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.utils.dtype import at_least_f32

_EPS = 1e-8


def _vjp(fn, primal_shape, like, cot):
    """The VJP of the linear map `fn` at cotangent `cot` (JAX's jax.vjp at
    zeros): its transpose applied to cot."""
    with torch.enable_grad():
        p = torch.zeros(primal_shape, dtype=like.dtype, device=like.device, requires_grad=True)
        return torch.autograd.grad(fn(p), p, cot)[0]


def _conv(a, k):
    """3x3 same-padding correlation. a [N,H,W,Ci]; k [3,3,Ci,Co]."""
    out = F.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _convT(a, k):
    """Transpose of `_conv` in its first argument."""
    return _vjp(lambda x_: _conv(x_, k), a.shape[:3] + (k.shape[2],), a, a)


def _wg(a, b):
    """Transpose of `_conv` in its kernel argument: the weight-grad taps.
    a [N,H,W,Ci] (input side), b [N,H,W,Co] (cotangent side)."""
    return _vjp(lambda k_: _conv(a, k_), (3, 3, a.shape[-1], b.shape[-1]), a, b)


def _mask(u, gain, alpha):
    """act'(u) for y = gain * lrelu_alpha(u), a.e., in u's dtype."""
    return torch.where(u >= 0, u.new_full((), gain), u.new_full((), gain * alpha))


def default_conv_ops():
    """(conv, convT, wg) for the same-res 3x3 op."""
    return _conv, _convT, _wg


def upconv2_conv_ops():
    """(conv, convT, wg) for the 2x-up conv: lhs-dilation 2 with a 4x4
    kernel and pad 2, out = (2H - 1) + 4 - 4 + 1 = 2H. The derivation is
    agnostic to which linear conv the three realise."""
    def up(a, k):
        n, h, w, c = a.shape
        az = a.new_zeros(n, 2 * h - 1, 2 * w - 1, c)
        az[:, ::2, ::2] = a
        out = F.conv2d(F.pad(az.permute(0, 3, 1, 2), (2, 2, 2, 2)), k.permute(3, 2, 0, 1))
        return out.permute(0, 2, 3, 1)

    def upT(a, k):
        return _vjp(lambda x_: up(x_, k), (a.shape[0], a.shape[1] // 2, a.shape[2] // 2,
                                           k.shape[2]), a, a)

    def upwg(a, b):
        return _vjp(lambda k_: up(a, k_), (4, 4, a.shape[-1], b.shape[-1]), a, b)

    return up, upT, upwg


def _sN(s, dtype=None):
    """[N,C] -> [N,1,1,C], in `dtype` (an x-sized stream's) when given."""
    s = s[:, None, None, :]
    return s if dtype is None else s.to(dtype)


def _demod(w, s, demodulate):
    """(wsq [Ci,Co], d [N,Co]) of the demodulation, or (None, None)."""
    if not demodulate:
        return None, None
    wsq = w.square().sum(dim=(0, 1))
    return wsq, torch.rsqrt(s.square() @ wsq + _EPS)


def _forward_pieces(x, w, s, noise, bias, gain, alpha, demodulate, conv_ops=None):
    """The forward intermediates the backward consumes: (xs, z, wsq, d, u,
    m); d is ones without demodulation."""
    conv = (conv_ops or default_conv_ops())[0]
    xs = x * _sN(s)
    z = conv(xs, w)
    wsq, d = _demod(w, s, demodulate)
    if d is None:
        d = x.new_ones(x.shape[0], w.shape[-1])
    u = z * _sN(d)
    if noise is not None:
        u = u + noise[..., None]
    if bias is not None:
        u = u + bias
    return xs, z, wsq, d, u, _mask(u, gain, alpha)


def _noise_bias_grads(gu, noise, bias):
    if noise is None:
        dnoise = None
    elif noise.dim() == 2:
        dnoise = gu.sum(dim=(0, 3))
    else:
        dnoise = gu.sum(dim=3)
    return dnoise, (None if bias is None else gu.sum(dim=(0, 1, 2)))


def _bwd(x, w, s, z, wsq, d, m, noise, bias, g, conv_ops):
    _, convT, wg = (conv_ops or default_conv_ops())[:3]
    xs = x * _sN(s)
    gu = g * m
    dnoise, dbias = _noise_bias_grads(gu, noise, bias)
    dz = gu * _sN(d)
    dxs = convT(dz, w)
    dx = dxs * _sN(s)
    ds = (x * dxs).sum(dim=(1, 2))
    dw = wg(xs, dz)
    if wsq is not None:
        dd = (gu * z).sum(dim=(1, 2))
        dq = -0.5 * d ** 3 * dd
        ds = ds + 2.0 * s * (dq @ wsq.T)
        dw = dw + 2.0 * w * (s.square().T @ dq)[None, None]
    return dx, dw, ds, dnoise, dbias


def modconv_bwd_explicit(x, w, s, noise, bias, g, gain, alpha, demodulate, conv_ops=None):
    """First-order backward, spelled against the primitives. Returns (dx,
    dw, ds, dnoise, dbias)."""
    _, z, wsq, d, _, m = _forward_pieces(x, w, s, noise, bias, gain, alpha, demodulate,
                                         conv_ops)
    return _bwd(x, w, s, z, wsq, d, m, noise, bias, g, conv_ops)


def _recover_from_y(y_act, noise, bias, d, gain, alpha):
    """(mask, z) from the saved activation output: u = y / m exactly on both
    lrelu branches, and z = (u - noise - bias) / d."""
    m = _mask(y_act, gain, alpha)
    v = y_act / m
    if noise is not None:
        v = v - noise[..., None]
    if bias is not None:
        v = v - bias
    return m, v / _sN(d)


def modconv_bwd_from_y_explicit(x, w, s, noise, bias, y_act, g, gain, alpha, demodulate,
                                conv_ops=None):
    """First-order backward as a function of the saved output y_act
    (before resid) in place of a recomputed forward: the values of
    `modconv_bwd_explicit` when y_act is the true forward output, with y
    an independent input, the split whose VJP is `modconv_bwd_vjp_from_y`.
    Returns (dx, dw, ds, dnoise, dbias)."""
    wsq, d = _demod(w, s, demodulate)
    if d is None:
        d = x.new_ones(x.shape[0], w.shape[-1])
    m, z = _recover_from_y(y_act, noise, bias, d, gain, alpha)
    return _bwd(x, w, s, z, wsq, d, m, noise, bias, g, conv_ops)


def modconv_bwd_vjp_from_y(x, w, s, noise, bias, y_act, g, cots, gain, alpha, demodulate,
                           conv_ops=None, adj_op=None, conv_resid=None):
    """Hand-derived VJP of `modconv_bwd_from_y_explicit` at output cotangents
    `cots = (cdx, cdw, cds, cdnoise, cdbias)`, each None where nothing
    feeds it: its launches are skipped (path length feeds cdx and cds, R1
    only cdx). Returns (c_x, c_w, c_s, c_noise, c_bias, c_y, c_g), None
    where zero. c_y, the cotangent of y_act, goes back through the op's own
    backward, which already runs for y's other consumers; the recovery's
    fake dependences on noise, bias and d (c_noise, c_bias and the recovery
    terms of c_w, c_s) cancel exactly against it.

    Launch-shaped calls, with `adj_op(dz, c_dxs, k) -> (convT(dz, k),
    wg(c_dxs, dz))` (default: the two primitives):
      A  = adj_op(dz, c_dxs, w)    [only wg(c_dxs, dz) when dxs is unused]
      B  = convT(dz, cdw)          [iff cdw]
      L2 = conv(xs, cdw)           [iff cdw]
      L3 = conv(c_dxs, w)          [+ L2 through `conv_resid(a, k, r)`'s
                                    resid slot, where given]"""
    cdx, cdw, cds, cdn, cdb = cots
    conv, convT, wg = (conv_ops or default_conv_ops())[:3]
    if s is None:
        cds, demodulate = None, False
    wsq, d = _demod(w, s, demodulate)
    m = _mask(y_act, gain, alpha)
    gu = g * m
    gt = gu.dtype
    dz = gu if d is None else gu * _sN(d, gt)

    def red(t):
        return at_least_f32(t).sum(dim=(1, 2))

    def add(a, b):
        return b if a is None else a + b

    c_gu = c_x = c_w = c_s = c_d = None
    if cdb is not None:
        c_gu = add(c_gu, cdb.to(gt)[None, None, None, :])
    if cdn is not None:
        c_gu = add(c_gu, (cdn[None, :, :, None] if cdn.dim() == 2 else cdn[..., None]).to(gt))

    # dx = dxs * s, ds_conv = sum x * dxs, with dxs = convT(dz, w): [A].
    c_dxs = None
    if cdx is not None:
        c_dxs = cdx if s is None else cdx * _sN(s, x.dtype)
    if cds is not None:
        c_dxs = add(c_dxs, _sN(cds, x.dtype) * x)
    # dw_conv = wg(xs, dz): its xs and dz dependences, [B] and [L2].
    c_xs = t2 = None
    if cdw is not None:
        xs = x if s is None else x * _sN(s, x.dtype)
        c_xs = convT(dz, cdw)
        t2 = conv(xs, cdw)
    c_dz = t2
    if c_dxs is not None:
        if cds is not None or (cdx is not None and s is not None):
            dxs, cw_a = (adj_op or (lambda g_, x_, k_: (convT(g_, k_), wg(x_, g_))))(
                dz, c_dxs, w)
            if cdx is not None and s is not None:
                c_s = add(c_s, red(cdx * dxs))
            if cds is not None:
                c_x = add(c_x, (_sN(cds, dxs.dtype) * dxs).to(x.dtype))
        else:
            cw_a = wg(c_dxs, dz)
        c_w = add(c_w, at_least_f32(cw_a))
        if t2 is not None and conv_resid is not None:
            c_dz = conv_resid(c_dxs, w, t2)
        else:
            c_dz = add(c_dz, conv(c_dxs, w))

    # The demodulation chain of the primal (dd, dq, dwsq): live with cds or cdw.
    c_z = z = None
    if d is not None and (cds is not None or cdw is not None):
        _, z = _recover_from_y(y_act, noise, bias, d.to(y_act.dtype), gain, alpha)
        dd = red(gu * z)
        dq = -0.5 * d ** 3 * dd
        c_dq = torch.zeros_like(dq)
        c_wsq = torch.zeros_like(wsq)
        if cds is not None:
            c_s = add(c_s, 2.0 * cds * (dq @ wsq.T))
            c_dq = c_dq + 2.0 * torch.einsum("ni,ni,io->no", cds, s, wsq)
            c_wsq = c_wsq + 2.0 * torch.einsum("ni,ni,no->io", cds, s, dq)
        if cdw is not None:
            c_w = add(c_w, 2.0 * cdw * (s.square().T @ dq)[None, None])
            c_dwsq = 2.0 * (cdw * w).sum(dim=(0, 1))
            c_s = add(c_s, 2.0 * s * torch.einsum("io,no->ni", c_dwsq, dq))
            c_dq = c_dq + torch.einsum("io,ni->no", c_dwsq, s.square())
        c_d = add(c_d, -1.5 * d ** 2 * dd * c_dq)
        c_dd = _sN(-0.5 * d ** 3 * c_dq, gt)
        c_gu = add(c_gu, z.to(gt) * c_dd)
        c_z = gu * c_dd
    else:
        c_wsq = None

    # dz = gu * d
    if c_dz is not None:
        c_dz = c_dz.to(gt)
        c_gu = add(c_gu, c_dz if d is None else c_dz * _sN(d, gt))
        if d is not None:
            c_d = add(c_d, red(gu * c_dz))

    # z = (y / m - noise - bias) / d: the recovery's own dependences. The y
    # part is the real route; the noise, bias and d parts cancel against it.
    c_y = c_n = c_b = None
    if c_z is not None:
        czd = c_z / _sN(d, c_z.dtype)
        c_y = czd / m.to(czd.dtype)
        if noise is not None:
            rr = at_least_f32(czd).sum(dim=-1)
            c_n = -(rr.sum(dim=0) if noise.dim() == 2 else rr)
        if bias is not None:
            c_b = -at_least_f32(czd).sum(dim=(0, 1, 2))
        c_d = add(c_d, -red(z.to(czd.dtype) * czd))

    # xs = x * s
    if c_xs is not None:
        c_x = add(c_x, (c_xs if s is None else c_xs * _sN(s, c_xs.dtype)).to(x.dtype))
        if s is not None:
            c_s = add(c_s, red(x * c_xs.to(x.dtype)))

    # d = rsqrt(q + eps), q = s^2 @ wsq, wsq = sum w^2
    if d is not None and c_d is not None:
        c_q = -0.5 * d ** 3 * c_d
        c_s = add(c_s, 2.0 * s * (c_q @ wsq.T))
        c_wsq = add(c_wsq, s.square().T @ c_q)
    if c_wsq is not None:
        c_w = add(c_w, 2.0 * w * c_wsq[None, None])

    c_g = None if c_gu is None else m * c_gu
    return c_x, c_w, c_s, c_n, c_b, c_y, c_g
