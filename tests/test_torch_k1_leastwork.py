"""K1's least-work kernel (csrc/fused_conv.cu `conv3x3_lw_kernel`, both
roles; K4 is its forward with the slots empty), emulated in torch.

`emulate_forward` follows the kernel's tile loop: a block owns a tile of
TH x TW positions (16 x 32 when the role writes at most 32 channels, else
16 x 16) and OT output channels (32 or 64); the input channels come in
chunks of 8, each chunk's x tile with its 1-pixel halo (zero outside the
image) and the chunk's weights with the style folded in (w * s, per
sample); the chunks' sums add up in the block's accumulators, then the
epilogue (d, noise, bias, lrelu * gain, resid) on them.

`emulate_adjoint` follows the adjoint launch: blocks tiled by the adjoint's
output channels (the forward's C), chunks of the forward's O (4 channels at
C <= 32, else 8). Each chunk stages g, y and resid tiles with the halo and
forms gd = g * mask(y - resid) * d in the tile; the blocks of channel group
k mod groups take chunk k's dd taps over their own pixels; the conv reads
flip(w)^T; each block writes partials of the ds dot sum x * du (before the
scale) and of the dd taps, which the wrapper sums over the blocks in order.

Both are held against the plain versions (`modconv3x3_plain`,
`modconv3x3_adjoint_plain`) and against the JAX package's
`fused_modconv3x3_lrelu` and its VJP (interpret mode, as in
tests/test_torch_adjoint_k1.py), at tiles that do and do not divide a
non-square image, with and without resid, noise (batch-shared and
per-sample), styles and demodulation. Tolerance: 2e-5 of each output's
largest entry, float32 (the same sums in another order)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-5
TH = 16


def tiling(cout):
    """(TW, OT) of a block of a role that writes `cout` channels."""
    return (16, 64) if cout > 32 else (32, 32)


def _tiles(h, w, tw):
    """Each block's tile origin, in block order, and the tile's extent in
    the image."""
    for ty in range(0, h, TH):
        for tx in range(0, w, tw):
            yield ty, tx, min(TH, h - ty), min(tw, w - tx)


def _halo(t, ty, tx, tw):
    """The tile of t [N,H,W,C] at (ty, tx) with a 1-pixel halo, [N, TH+2,
    tw+2, C], zero outside the image."""
    n, h, w, c = t.shape
    out = t.new_zeros(n, TH + 2, tw + 2, c)
    y0, x0 = ty - 1, tx - 1
    ys, xs, ye, xe = max(y0, 0), max(x0, 0), min(y0 + TH + 2, h), min(x0 + tw + 2, w)
    out[:, ys - y0:ye - y0, xs - x0:xe - x0] = t[:, ys:ye, xs:xe]
    return out


def _tile_conv(xt, wc, tw):
    """One chunk's sum over the tile: out[i, j] = sum_{ta,tb} xt[i+ta, j+tb]
    @ wc[ta, tb]; wc [3,3,ck,ot] or per sample [N,3,3,ck,ot]."""
    if wc.dim() == 4:
        wc = wc[None]
    return sum(xt[:, ta:ta + TH, tb:tb + tw] @ wc[:, None, ta, tb]
               for ta in range(3) for tb in range(3))


def _img(t, ty, tx, hh, ww):
    return t[:, ty:ty + hh, tx:tx + ww]


def _noise_tile(noise, ty, tx, hh, ww):
    return _img(fc._noise_nhwc(noise), ty, tx, hh, ww)


def emulate_forward(x, w, s, d, noise, bias, resid, gain, alpha, ck=8):
    n, h, wd, c = x.shape
    o = w.shape[-1]
    tw, ot = tiling(o)
    y = x.new_full((n, h, wd, o), float("nan"))
    for ty, tx, hh, ww in _tiles(h, wd, tw):
        for o0 in range(0, o, ot):
            oc = slice(o0, o0 + ot)
            acc = 0
            for c0 in range(0, c, ck):
                cc = slice(c0, c0 + ck)
                wc = w[:, :, cc, oc] if s is None else w[None, :, :, cc, oc] * s[:, None, None, cc,
                                                                                  None]
                acc = acc + _tile_conv(_halo(x[..., cc], ty, tx, tw), wc, tw)
            v = acc[:, :hh, :ww]
            if d is not None:
                v = v * d[:, None, None, oc]
            if noise is not None:
                v = v + _noise_tile(noise, ty, tx, hh, ww)
            if bias is not None:
                v = v + bias[oc]
            v = torch.where(v >= 0, v, v * alpha) * gain
            if resid is not None:
                v = v + _img(resid, ty, tx, hh, ww)[..., oc]
            y[:, ty:ty + hh, tx:tx + ww, oc] = v
    return y


def emulate_adjoint(g, x, w, s, d, y, resid, noise, gain, alpha, need_dd):
    """(dx, dot, dd1, dd2): dot, dd1 and dd2 are the per-block partials
    [N, nblk, .] summed over the blocks (dd None unless need_dd)."""
    n, h, wd, o = g.shape
    c = w.shape[2]
    tw, ot = tiling(c)
    ck = 8 if c > 32 else 4
    groups = -(-c // ot)
    wt = w.flip((0, 1)).transpose(2, 3)                  # what the pass writes: [3,3,O,C]
    yp = y if resid is None else y - resid
    dx = g.new_full((n, h, wd, c), float("nan"))
    dots, dd1s, dd2s = [], [], []
    for ty, tx, hh, ww in _tiles(h, wd, tw):
        dot = g.new_zeros(n, c)
        dd1, dd2 = g.new_zeros(n, o), g.new_zeros(n, o)
        for grp, o0 in enumerate(range(0, c, ot)):
            oc = slice(o0, o0 + ot)
            acc = 0
            for k, c0 in enumerate(range(0, o, ck)):
                cc = slice(c0, c0 + ck)
                gt, yt = _halo(g[..., cc], ty, tx, tw), _halo(yp[..., cc], ty, tx, tw)
                m = torch.where(yt >= 0, g.new_tensor(gain), g.new_tensor(gain * alpha))
                gd = gt * m * (1.0 if d is None else d[:, None, None, cc])
                if need_dd and k % groups == grp:
                    gi = gd[:, 1:1 + hh, 1:1 + ww]
                    t = yt[:, 1:1 + hh, 1:1 + ww] / m[:, 1:1 + hh, 1:1 + ww]
                    if noise is not None:
                        t = t - _noise_tile(noise, ty, tx, hh, ww)
                    dd1[:, cc] = (gi * t).sum(dim=(1, 2))
                    dd2[:, cc] = gi.sum(dim=(1, 2))
                acc = acc + _tile_conv(gd, wt[:, :, cc, oc], tw)
            du = acc[:, :hh, :ww]
            dot[:, oc] = (_img(x, ty, tx, hh, ww)[..., oc] * du).sum(dim=(1, 2))
            dx[:, ty:ty + hh, tx:tx + ww, oc] = du if s is None else du * s[:, None, None, oc]
        dots.append(dot)
        dd1s.append(dd1)
        dd2s.append(dd2)
    sums = [torch.stack(p, dim=1).sum(1) for p in (dots, dd1s, dd2s)]
    return dx, sums[0], *(sums[1:] if need_dd else (None, None))


# (N, H, W, C, O, styles, demodulate, noise, bias, resid, gain, alpha): the
# conv1 and conv_last forms, D conv0's (no styles, no demodulation), both
# tilings (O <= 32: 16 x 32, else 16 x 16) and adjoint chunkings (C <= 32:
# 4, else 8), tiles that divide the image and tiles that do not.
CASES = [
    (2, 20, 37, 8, 12, True, True, "sample", True, True, 1.0, 0.2),
    (1, 16, 32, 12, 8, True, True, "shared", True, True, math.sqrt(2), 0.2),
    (1, 17, 19, 40, 36, True, True, "shared", True, False, 1.0, 0.2),
    (2, 16, 16, 36, 40, True, True, None, False, False, 1.0, 1.0),
    (1, 18, 20, 8, 8, False, False, None, True, True, math.sqrt(2), 0.2),
    (3, 9, 50, 20, 4, True, False, "sample", True, False, 1.0, 0.2),
]


def _inputs(case, seed=0):
    n, h, w, c, o, styles, demod, noise, bias, resid, gain, alpha = case
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    x, wt = t(n, h, w, c), t(3, 3, c, o, scale=1 / math.sqrt(9 * c))
    s = torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32)) if styles else None
    nz = {None: None, "shared": lambda: t(h, w, scale=0.1),
          "sample": lambda: t(n, h, w, scale=0.1)}[noise]
    nz = nz() if nz else None
    b = t(o, scale=0.1) if bias else None
    r = t(n, h, w, o) if resid else None
    g = t(n, h, w, o)
    return x, wt, s, nz, b, r, g, gain, alpha, demod


def _rel_close(got, want):
    scale = max(want.abs().max().item(), 1e-30)
    assert (got - want).abs().max().item() <= TOL * scale


def _jax_ok(case):
    """JAX's op takes styles and batch-shared noise only."""
    return case[5] and case[7] != "sample"


@pytest.mark.parametrize("case", CASES)
def test_forward_emulation_matches_plain(case):
    x, w, s, nz, b, r, _, gain, alpha, demod = _inputs(case)
    d = demod_coef(w, s) if demod else None
    _rel_close(emulate_forward(x, w, s, d, nz, b, r, gain, alpha),
               fc.modconv3x3_plain(x, w, s, nz, b, r, gain, alpha, demod))


@pytest.mark.parametrize("case", [c for c in CASES if _jax_ok(c)])
def test_forward_emulation_matches_jax(case):
    x, w, s, nz, b, r, _, gain, alpha, demod = _inputs(case)
    d = demod_coef(w, s) if demod else None
    j = lambda t: None if t is None else jnp.asarray(t.numpy())                  # noqa: E731
    want = jpc.fused_modconv3x3_lrelu(j(x), j(w), j(s), j(nz), j(b), j(r), gain, alpha, demod)
    _rel_close(emulate_forward(x, w, s, d, nz, b, r, gain, alpha),
               torch.from_numpy(np.array(want)))


def _emulated_grads(case):
    """(dx, ds, dd1, dd2) as the wrapper returns them, from the emulation."""
    x, w, s, nz, b, r, g, gain, alpha, demod = _inputs(case)
    y = fc.modconv3x3_plain(x, w, s, nz, b, r, gain, alpha, demod)
    d = demod_coef(w, s) if demod else None
    need_dd = demod and s is not None
    dx, dot, dd1, dd2 = emulate_adjoint(g, x, w, s, d, y, r, nz, gain, alpha, need_dd)
    ds = dot if s is not None else None
    if need_dd:
        ds = fc._demod_chain(ds, fc._demod_de(dd1, dd2, d, b), w, s)
    return (dx, ds, dd1, dd2), (x, w, s, nz, b, r, g, y, gain, alpha, demod)


@pytest.mark.parametrize("case", CASES)
def test_adjoint_emulation_matches_plain(case):
    got, (x, w, s, nz, b, r, g, y, gain, alpha, demod) = _emulated_grads(case)
    want = fc.modconv3x3_adjoint_plain(g, x, w, s, y, nz, b, r, gain, alpha, demod)
    for a, e in zip(got, want):
        assert (a is None) == (e is None)
        if e is not None:
            _rel_close(a, e)


@pytest.mark.parametrize("case", [c for c in CASES if _jax_ok(c)])
def test_adjoint_emulation_matches_jax(case):
    """dx and ds against `jax.vjp` of `fused_modconv3x3_lrelu` w.r.t. x and
    styles (w, noise, bias and resid closed over: the projection's path)."""
    got, (x, w, s, nz, b, r, g, _, gain, alpha, demod) = _emulated_grads(case)
    j = lambda t: None if t is None else jnp.asarray(t.numpy())                  # noqa: E731
    _, vjp = jax.vjp(lambda x_, s_: jpc.fused_modconv3x3_lrelu(x_, j(w), s_, j(nz), j(b), j(r),
                                                               gain, alpha, demod), j(x), j(s))
    for a, e in zip(got[:2], vjp(j(g))):
        _rel_close(a, torch.from_numpy(np.array(e)))
