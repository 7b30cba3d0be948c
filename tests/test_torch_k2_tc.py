"""K2's bfloat16 forward as the tensor-core kernel computes it
(csrc/fused_conv.cu `upconv2_tc_kernel`), emulated in torch on the CPU.

`emulate_tc` follows the kernel block by block: an x tile of 8 x 16 cells
(6 x 14 base positions with their halo) scaled by s and rounded to bfloat16,
laid out as rows of a matrix with cell (k, j) at row 16k + j and the rows
past the tile holding NaN (the kernel's buffer holds whatever it holds
there); each of the 9 taps is one product of the tile's rows, shifted by 0,
1, 16 or 17, with the bfloat16 weight tap, summed in float32 into its Z
class (AA, AB, BA, BB; AA alone for the 1x1) by the kernel's tap table;
the classes are stored into the interleaved Z tile with the kernel's masks
(row 7's B classes and column 15's B classes dropped), then the FIR at
output resolution, the epilogue and one rounding to bfloat16.

It is held (a) before the rounding against `emulate` of
tests/test_torch_k2_leastwork.py on the same bfloat16 operands, to 2e-5 of
the largest entry (float32 sums in another order): this pins the tap
table, the shifts, the masks (a NaN that reached a kept Z value would
show) and the tile halo at sizes no tile divides; (b) after the rounding
against the float32 plain version by the bfloat16 rule of
tests/test_torch_kernels_cuda.py (at most BF16_RATIO times the plain
bfloat16 version's error, or within BF16_FLOOR of the largest entry); and
(c) against the JAX package's `fused_packed_upconv2` by the same rule, its
float32 output the reference and its bfloat16 output the yardstick.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

from .test_torch_k2_leastwork import emulate
from .test_torch_kernels_cuda import (BF16_FLOOR, BF16_RATIO, FIR, _bf16_close, _k2_inputs,
                                      _widen, one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TH, TW = 6, 14                  # base positions of a block
XR, XC = TH + 2, TW + 2         # cells: x tile rows and columns (one m16 tile a row)


def _tap(t, kh):
    """The kernel's tap table: (Z class, cell-row shift, cell-column shift)
    of weight tap t = 3 ta + tb (the 1x1's one tap is AA)."""
    ta, tb = divmod(t, 3) if kh == 3 else (1, 1)
    return 2 * (ta != 1) + (tb != 1), int(ta == 0), int(tb == 0)


def _z_tile(cells, wf, kh):
    """The interleaved Z tile [N, ZR, ZC, O] of one block from its cell
    rows [N, XR * XC + XC + 1, I] (the last XC + 1 rows past the tile)."""
    n, co = cells.shape[0], wf.shape[-1]
    acc = cells.new_zeros(n, 4 if kh == 3 else 1, XR * XC, co)
    for t in range(kh * kh):
        cls, dr, dc = _tap(t, kh)
        sh = dr * XC + dc
        acc[:, cls] += cells[:, sh:sh + XR * XC] @ wf[t]
    acc = acc.reshape(n, -1, XR, XC, co)
    if kh == 1:
        return acc[:, 0]
    zr, zc = 2 * TH + 3, 2 * TW + 3
    z = acc.new_full((n, zr, zc, co), float("nan"))
    for cls in range(4):
        r, c = cls >> 1, cls & 1
        nr, nc = (zr - r + 1) // 2, (zc - c + 1) // 2     # the cells whose Z value is kept
        z[:, r::2, c::2] = acc[:, cls, :nr, :nc]
    return z


def _fir(z, fk, kh):
    """The 2TH x 2TW outputs of a block from its Z tile: the 4x4 window for
    the 3x3; for the 1x1 the Z values at the even positions of a zero-
    inserted tile, so output 2m + p reads A[m + p] and A[m + p + 1]."""
    n, _, _, co = z.shape
    zt = z.permute(0, 3, 1, 2)
    if kh == 1:
        zz = zt.new_zeros(n, co, 2 * XR, 2 * XC)
        zz[:, :, ::2, ::2] = zt
        zt = zz
    out = F.conv2d(zt, fk.expand(co, 1, 4, 4), groups=co)
    return out[:, :, :2 * TH, :2 * TW].permute(0, 2, 3, 1)


def emulate_tc(x, wk, fk, s=None, d=None, noise=None, bias=None, gain=1.0, alpha=1.0):
    """x [N,H,W,I] bfloat16; wk [kh,kh,I,O], fk [4,4] from
    `upconv2_leastwork`; s [N,I], d [N,O], noise [2H,2W] or [N,2H,2W] and
    bias [O] float32 (s, wk and noise rounded to bfloat16 as the wrapper
    does). Returns (the float32 output before the rounding, y bfloat16)."""
    kh = int(wk.shape[0])
    n, h, w, ci = x.shape
    co = wk.shape[-1]
    xs = x if s is None else x * s.bfloat16()[:, None, None, :]   # rounded once
    wf = wk.bfloat16().float().reshape(kh * kh, ci, co)
    xp = xs.float().new_zeros(n, h + TH + 2, w + TW + 2, ci)
    xp[:, 1:h + 1, 1:w + 1] = xs.float()
    past = xp.new_full((n, XC + 1, ci), float("nan"))
    v = xp.new_zeros(n, 2 * h, 2 * w, co)
    for ty0 in range(0, h, TH):
        for tx0 in range(0, w, TW):
            cells = xp[:, ty0:ty0 + XR, tx0:tx0 + XC].reshape(n, XR * XC, ci)
            z = _z_tile(torch.cat([cells, past], 1), wf, kh)
            assert torch.isfinite(z).all()
            tile = _fir(z, fk, kh)
            ry, rx = min(2 * TH, 2 * (h - ty0)), min(2 * TW, 2 * (w - tx0))
            v[:, 2 * ty0:2 * ty0 + ry, 2 * tx0:2 * tx0 + rx] = tile[:, :ry, :rx]
    pre = _epilogue(v, d, noise, bias, gain, alpha)
    return pre, pre.bfloat16()


def _epilogue(v, d, noise, bias, gain, alpha):
    if d is not None:
        v = v * d[:, None, None, :]
    if noise is not None:
        nz = noise.bfloat16().float()
        v = v + (nz[..., None] if nz.dim() == 3 else nz[None, :, :, None])
    if bias is not None:
        v = v + bias
    return torch.where(v >= 0, v, v * alpha) * gain


# (N, H, W, Cin, Cout, kh, path) as the CUDA tests' K2_BF16_ODD, smaller:
# sizes no tile divides, Cin and Cout in fours and not in sixteens.
CASES = [(2, 17, 31, 20, 12, 3, "conv0"), (1, 9, 17, 12, 36, 3, "noise"),
         (2, 7, 5, 36, 4, 3, "nodemod"), (1, 30, 30, 4, 8, 3, "skip"),
         (2, 13, 15, 36, 12, 1, "conv0"), (1, 9, 17, 12, 4, 1, "noise"),
         (2, 6, 29, 20, 36, 1, "nodemod"), (1, 20, 14, 4, 12, 1, "skip")]


def _operands(rng, n, h, w, cin, cout, kh, path):
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    skip = path == "skip"
    x = rand(n, h, w, cin).bfloat16()
    wt = rand(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    s = None if skip else torch.from_numpy((rng.rand(n, cin) + 0.5).astype(np.float32))
    nz = None
    if path in ("conv0", "noise"):
        nz = rand(*((n,) if path == "noise" else ()), 2 * h, 2 * w, scale=0.1)
    b = None if skip else rand(cout, scale=0.1)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    return x, wt, s, nz, b, gain, alpha, path in ("conv0", "noise")


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("n,h,w,cin,cout,kh,path", CASES)
def test_tc_emulation_matches_the_float32_sums_and_the_plain_version(n, h, w, cin, cout, kh,
                                                                      path):
    x, wt, s, nz, b, gain, alpha, demod = _operands(np.random.RandomState(31), n, h, w, cin,
                                                    cout, kh, path)
    f = setup_filter(FIR)
    for flip_weight in (False, True):
        wk, fk, pad = fc.upconv2_leastwork(wt, f, flip_weight)
        d = fc.demod_coef(wt, s) if demod else None
        pre, y = emulate_tc(x, wk, fk, s, d, nz, b, gain, alpha)
        xs = x if s is None else x * s.bfloat16()[:, None, None, :]
        want = _epilogue(emulate(xs.float(), wk.bfloat16().float(), fk, pad), d, nz, b, gain,
                         alpha)
        assert _rel_err(pre, want) <= 2e-5
        fwd = (x, wt, s, f, nz, b, gain, alpha, demod, flip_weight)
        _bf16_close(y, fc.upconv2_plain(*fwd), fc.upconv2_plain(*_widen(fwd)))


@pytest.mark.parametrize("kh", [3, 1])
def test_tc_emulation_against_jax(kh):
    """The emulated kernel against `fused_packed_upconv2` (Cin 64, packed;
    Pallas in interpret mode) in float32, held to BF16_RATIO times JAX's own
    bfloat16 error or BF16_FLOOR, as chip_smoke.py holds the kernel to the
    plain version."""
    n, h, cin, cout = 2, 16, 64, 32
    conv0 = kh == 3
    x, w, s, nz, b = _k2_inputs(np.random.RandomState(1), n, h, cin, cout, kh, conv0, conv0,
                                conv0)
    gain, alpha = (math.sqrt(2), 0.2) if conv0 else (math.sqrt(0.5), 1.0)
    xb = torch.from_numpy(x).bfloat16()
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        y = jpc.fused_packed_upconv2(
            jnp.asarray(xb.float().numpy()).astype(dt).reshape(n, h, h * cin // 128, 128),
            jnp.asarray(w), None if s is None else jnp.asarray(s), jsetup_filter(FIR),
            None if nz is None else jnp.asarray(nz), None if b is None else jnp.asarray(b),
            gain, alpha, conv0, False)
        want[dt] = torch.from_numpy(np.array(y.astype(jnp.float32))).reshape(
            n, 2 * h, 2 * h, cout)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    wk, fk, _ = fc.upconv2_leastwork(t(w), setup_filter(FIR), False)
    d = fc.demod_coef(t(w), t(s)) if conv0 else None
    _, y = emulate_tc(xb, wk, fk, t(s), d, t(nz), t(b), gain, alpha)
    ref = want[jnp.float32]
    ek, ej = _rel_err(y.float(), ref), _rel_err(want[jnp.bfloat16], ref)
    assert ek <= max(BF16_RATIO * ej, BF16_FLOOR), (ek, ej)
