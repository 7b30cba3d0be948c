"""The second-order route of the fused blocks (port of
morphganformer_tpu/ops/second_order.py).

Path length and R1 are reverse-over-reverse: an outer gradient of a loss
that holds an inner `torch.autograd.grad(..., create_graph=True)` through a
net. Inside `second_order_scope()` the fused Functions (`FusedModConv3x3`,
`FusedUpConv2`, `FusedDownConv2`, ops/fused_conv.py) record that their
backward may run under create_graph. It then returns the outputs of a
"grad" Function (`ModConv3x3Grad`, `UpConv2Grad`, `DownConv2Grad`):

  * its forward is the first-order backward, served from the saved output
    y with the same kernel launches as a first-order step; it forms only
    the cotangents that the scope says the inner gradient reaches (JAX's
    real inner perturbation flags: path length's inner pass takes no dw,
    R1's dx alone);
  * y is one of its inputs, so the cotangent c_y of its backward flows into
    the fused Function that produced y, whose first-order backward runs
    again as the adjoint it already is (JAX's c_y route);
  * its backward, the true second-order term, is second_order_native's
    `modconv_bwd_vjp_from_y` (the D down-conv's own collapsed form) written
    against the launch sets below: each x-sized term is a launch of K1, K2
    or K3 with swapped operands (the kernel slot holding a cotangent, styles
    1, demodulation off, gain = alpha = 1). A cotangent that nothing feeds
    arrives as None (`set_materialize_grads(False)`, JAX's symbolic zeros)
    and its launches are skipped.

On a CPU tensor the launch sets take the kernels' plain versions, as every
wrapper does; `plain=True` takes them on any device (JAX's MGT_SO_NATIVE=0
reference legs). Inside the scope a wrapper that refuses an operand raises:
there is no fallback to the plain versions or to the unpacked route.

The policy: `reg_stage_second_order(stage)` reads JAX's tri-state
MGT_PACKED_SECOND_ORDER (unset: the per-stage default, scoped for both
stages; "1": scoped; "0": `force_unpacked()`, ops/packed_override.py).
"""

from __future__ import annotations

import os

import torch

from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import second_order_native as sn
# The scope and its flag live beside force_unpacked(), where the fused
# Functions read them; JAX's module holds them, so they are named here too.
from morphganformer_tpu_torch.ops.packed_override import (  # noqa: F401
    INPUTS,
    packed_second_order,
    second_order_scope,
)

_DEFAULT_REG_SECOND_ORDER = {"pl": True, "r1": True}


def reg_stage_second_order(stage: str = "pl") -> bool:
    """Whether the reg stage ("pl": path length, "r1": R1) runs inside
    `second_order_scope()` (True) or under `force_unpacked()` (False):
    MGT_PACKED_SECOND_ORDER "1" scoped, "0" unpacked, unset the stage's
    default (both scoped, as in JAX)."""
    v = os.environ.get("MGT_PACKED_SECOND_ORDER")
    if v is None:
        return _DEFAULT_REG_SECOND_ORDER[stage]
    return v == "1"


# ---------------------------------------------------------------------------
# Launch sets: the primitives of second_order_native, realised by the port's
# launches. `_c` makes an operand contiguous for the kernels' checks.
# ---------------------------------------------------------------------------


def _c(t):
    return t.contiguous()


def _like(cots, inputs):
    """Each cotangent in its input's type (JAX's `.astype(x.dtype)` on the
    VJP's outputs): the x-sized ones in the compute type, the weights',
    styles', noise's and bias' float32; None stays None."""
    return tuple(None if c is None else c.to(t.dtype) for c, t in zip(cots, inputs))


def modconv3x3_ops(plain):
    """(conv, convT, wg, conv_resid) of K1: conv(a, k) is the forward launch
    with no styles, no demodulation, gain = alpha = 1 (its mask is 1);
    conv_resid(a, k, r) the same with r in its resid slot; convT(a, k) the
    adjoint launch's dx with the same degeneration (its slope is 1 for any
    y, so y is a itself); wg(a, b) K1's dw launch. The port's dw is a launch
    of its own, so JAX's [L0] + [L4] fusion is two launches here."""
    fwd = fc.modconv3x3_plain if plain else fc._modconv3x3_forward
    adjoint = fc.modconv3x3_adjoint_plain if plain else fc.modconv3x3_adjoint

    def conv_resid(a, k, r=None):
        return fwd(_c(a), _c(k), None, None, None, r, 1.0, 1.0, False)

    def conv(a, k):
        return conv_resid(a, k)

    def convT(a, k):
        a = _c(a)
        return adjoint(a, None, _c(k), None, a, gain=1.0, alpha=1.0, demodulate=False,
                       need_ds=False)[0]

    def wg(a, b):
        if plain:
            return fc.conv_dw_plain(a, b, None, 1, 1, 3, (0, 0))[0]
        return fc.conv_dw(_c(a), _c(b), None)

    return conv, convT, wg, conv_resid


def upconv2_ops(f, flip_weight, w_like, plain):
    """(conv, convT, wg) of K2: conv(a, k) the up-conv launch with no styles,
    no demodulation, gain = alpha = 1; convT(a, k) K3's adjoint launch with
    a as gd; wg(a, b) K3's dw launch (`w_like` gives the weight's shape)."""
    fwd = fc.upconv2_plain if plain else fc._upconv2_forward
    dw = fc.upconv2_dw_plain if plain else fc.upconv2_dw

    def conv(a, k):
        return fwd(_c(a), _c(k), None, f, None, None, 1.0, 1.0, False, flip_weight)

    def convT(a, k):
        if plain:
            return fc._k3_taps_plain(a, None, k, None, f, flip_weight, None, None, None, True,
                                     False, False)[0]
        a = _c(a)
        return fc._k3_taps(a, lambda: a, None, _c(k), None, f, flip_weight, None, None, None,
                           1.0, 1.0, True, False, False)[0]

    def wg(a, b):
        return dw(_c(a), _c(b), None, w_like, f, flip_weight)

    return conv, convT, wg


# ---------------------------------------------------------------------------
# The VJPs of the three backwards.
# ---------------------------------------------------------------------------


def modconv3x3_bwd_vjp(x, w, styles, noise, bias, resid, y, g, cots, gain, alpha, demodulate,
                       plain=False):
    """The VJP of `modconv3x3_backward` (served from y) at cots = (cdx, cdw,
    cds, cdnoise, cdbias): (c_x, c_w, c_s, c_noise, c_bias, c_resid, c_y,
    c_g), None where zero. y_act = y - resid, so resid takes -c_y (which
    cancels against c_y's route through the forward's resid)."""
    conv, convT, wg, conv_resid = modconv3x3_ops(plain)
    y_act = y if resid is None else y - resid
    cx, cw, cs, cn, cb, cy, cg = sn.modconv_bwd_vjp_from_y(
        x, w, styles, noise, bias, y_act, g, cots, gain, alpha, demodulate,
        conv_ops=(conv, convT, wg), conv_resid=conv_resid)
    cresid = None if resid is None or cy is None else -cy
    return _like((cx, cw, cs, cn, cb, cresid, cy, cg),
                 (x, w, styles, noise, bias, resid, y, g))


def upconv2_bwd_vjp(x, w, styles, f, noise, bias, y, g, cots, gain, alpha, demodulate,
                    flip_weight, plain=False):
    """The VJP of `upconv2_backward` at cots = (cdx, cdw, cds, cdnoise,
    cdbias): (c_x, c_w, c_s, c_noise, c_bias, c_y, c_g), None where zero.
    The skip's (no styles) is demodulation-free."""
    cx, cw, cs, cn, cb, cy, cg = sn.modconv_bwd_vjp_from_y(
        x, w, styles, noise, bias, y, g, cots, gain, alpha, demodulate,
        conv_ops=upconv2_ops(f, flip_weight, w, plain))
    return _like((cx, cw, cs, cn, cb, cy, cg), (x, w, styles, noise, bias, y, g))


def downconv2_bwd_vjp(x, w, f, resid, y, g, cots, gain, alpha, flip_weight, plain=False):
    """The VJP of `downconv2_backward` at cots = (cdx, cdw, cdbias): (c_x,
    c_w, c_g), None where zero. The op is unmodulated, so with gu = g * m
    (m the mask, locally constant, from y - resid) the VJP is launch-shaped
    alone (`_dconv_bwd_so_bwd`):
        c_x = adjoint(gu; cdw)       K2's use_dw launch, cdw in the kernel slot
        c_w = dw(cdx, gu)            the down-conv's dw launch
        c_g = m * (down(cdx; w) + down(x; cdw) + cdbias)
    the two down-convs chained through K3-forward's resid slot, c_g
    formed in at least float32 and rounded to g's type (`_dconv_bwd_so_bwd`).
    The cotangents of bias, resid and y are zero."""
    cdx, cdw, cdb = cots
    adjoint = fc.downconv2_adjoint_plain if plain else fc.downconv2_adjoint
    dw = fc.downconv2_dw_plain if plain else fc.downconv2_dw
    fwd = fc.downconv2_plain if plain else fc._downconv2_forward
    y_act = y if resid is None else y - resid
    m = fc._slope(y_act, gain, alpha)
    gu = g * m
    cx = None if cdw is None else adjoint(gu, _c(cdw), f, flip_weight)
    cw = None if cdx is None else dw(_c(cdx), gu, w, f, flip_weight)
    pre = None
    if cdw is not None:
        pre = fwd(x, _c(cdw), f, None, None, 1.0, 1.0, flip_weight)
    if cdx is not None:
        pre = fwd(_c(cdx), w, f, None, pre, 1.0, 1.0, flip_weight)
    if cdb is not None:
        pre = cdb if pre is None else pre + cdb
    cg = None if pre is None else (m * pre).to(g.dtype)
    return cx, None if cw is None else cw.to(w.dtype), cg


# ---------------------------------------------------------------------------
# The grad Functions: forward the first-order backward, backward its VJP.
# ---------------------------------------------------------------------------


class ModConv3x3Grad(torch.autograd.Function):
    """(dx, dw, ds, dnoise, dbias) of K1 as a function of its inputs, its
    output y and the output cotangent g; twice differentiable through
    `modconv3x3_bwd_vjp`."""

    @staticmethod
    def forward(ctx, x, w, styles, noise, bias, resid, y, g, gain, alpha, demodulate, needs,
                plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, styles, noise, bias, resid, y, g)
        ctx.opts = (gain, alpha, demodulate, plain)
        return fc.modconv3x3_backward(g, x, w, styles, y, noise, bias, resid, gain, alpha,
                                      demodulate, needs, plain)

    @staticmethod
    def backward(ctx, *cots):
        x, w, styles, noise, bias, resid, y, g = ctx.saved_tensors
        gain, alpha, demodulate, plain = ctx.opts
        return (*modconv3x3_bwd_vjp(x, w, styles, noise, bias, resid, y, g, cots, gain, alpha,
                                    demodulate, plain), None, None, None, None, None)


class UpConv2Grad(torch.autograd.Function):
    """(dx, dw, ds, dnoise, dbias) of K2 as a function of its inputs, its
    output y and g; twice differentiable through `upconv2_bwd_vjp`."""

    @staticmethod
    def forward(ctx, x, w, styles, f, noise, bias, y, g, gain, alpha, demodulate, flip_weight,
                needs, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, styles, f, noise, bias, y, g)
        ctx.opts = (gain, alpha, demodulate, flip_weight, plain)
        return fc.upconv2_backward(g, x, w, styles, f, y, noise, bias, gain, alpha, demodulate,
                                   flip_weight, needs, plain)

    @staticmethod
    def backward(ctx, *cots):
        x, w, styles, f, noise, bias, y, g = ctx.saved_tensors
        gain, alpha, demodulate, flip_weight, plain = ctx.opts
        cx, cw, cs, cn, cb, cy, cg = upconv2_bwd_vjp(x, w, styles, f, noise, bias, y, g, cots,
                                                     gain, alpha, demodulate, flip_weight, plain)
        return cx, cw, cs, None, cn, cb, cy, cg, None, None, None, None, None, None


class DownConv2Grad(torch.autograd.Function):
    """(dx, dw, dbias) of the D down-conv as a function of its inputs, its
    output y and g; twice differentiable through `downconv2_bwd_vjp`."""

    @staticmethod
    def forward(ctx, x, w, f, bias, resid, y, g, gain, alpha, flip_weight, needs, plain):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, f, resid, y, g)
        ctx.opts = (gain, alpha, flip_weight, plain)
        return fc.downconv2_backward(g, x, w, f, y, bias, resid, gain, alpha, flip_weight,
                                     needs, plain)

    @staticmethod
    def backward(ctx, *cots):
        x, w, f, resid, y, g = ctx.saved_tensors
        gain, alpha, flip_weight, plain = ctx.opts
        cx, cw, cg = downconv2_bwd_vjp(x, w, f, resid, y, g, cots, gain, alpha, flip_weight,
                                       plain)
        return cx, cw, None, None, None, None, cg, None, None, None, None, None


fc.GRAD_FUNCTIONS.update(modconv3x3=ModConv3x3Grad, upconv2=UpConv2Grad,
                         downconv2=DownConv2Grad)
