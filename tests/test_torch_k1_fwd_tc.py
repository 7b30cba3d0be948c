"""K1's bfloat16 forward as the tensor-core kernel computes it
(csrc/fused_conv.cu `conv3x3_fwd_tc_kernel`), emulated in torch on the CPU.

`emulate_tc` follows the kernel tile by tile (TH x 16 output positions: TH
16 for O <= 32, else 8; NB output channels: 32, 64 or 128, in channel
groups of 128 beyond) and chunk by chunk (16 input channels): x * s formed
and rounded once in bfloat16 (as __hmul2 forms it) in a staged tile of (TH
+ 2) x 18 pixels with the 1-pixel halo, zero outside the image and past C,
held in a flat buffer whose entries past the tile hold NaN; each tap (ta,
tb) one product of the staged rows at the kernel's row offsets ((r + ta) 18
+ j + tb for row r, column j of the tile) against w[ta][tb][c] in
bfloat16, summed in float32; then the epilogue in float32 (d, the noise
rounded to bfloat16, the bias, lrelu, the gain, then resid) and one
rounding to bfloat16.

It is held (a) before the epilogue against the float32 sums of
`modconv3x3_plain` on the same bfloat16 x * s and weight, to 2e-5 of the
largest entry (float32 sums in another order): this pins the tap table, the
row offsets (a NaN that reached a sum would show), the halo and the zero
fill past C at sizes no tile divides, C and O in 4, 8 and 16 tails; (b)
after the rounding against the float32 plain version by the bfloat16 rule
of tests/test_torch_kernels_cuda.py (at most BF16_RATIO times the plain
bfloat16 version's error, or within BF16_FLOOR of the largest entry); (c)
against the JAX package's `fused_modconv3x3_lrelu` (Pallas in interpret
mode) by the same rule, its float32 output the reference and its bfloat16
output the yardstick, with the noise, the bias, resid, gain sqrt(2) and
alpha 0.2, and the demodulation each on and off.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef

from .test_torch_kernels_cuda import (BF16_FLOOR, BF16_RATIO, _bf16_close, _widen,
                                      one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TW, CK, XC = 16, 16, 18        # columns of a tile; input channels a chunk; staged columns
NAN = float("nan")


def tiling(o):
    """(TH, NB) of the kernel for an output of o channels: rows of a tile,
    output channels of a block."""
    if o <= 32:
        return 16, 32
    return (8, 64) if o <= 64 else (8, 128)


def emulate_tc(x, w, s=None, d=None, noise=None, bias=None, resid=None, gain=1.0, alpha=1.0):
    """x [N,H,W,C] and resid [N,H,W,O] (or None) bfloat16; w [3,3,C,O] and
    s [N,C] (or None: no scale) rounded to bfloat16 here, as the wrapper
    casts them; d [N,O] or None and bias [O] or None float32; noise [H,W]
    or [N,H,W] (or None), rounded to bfloat16. Returns (the float32 sums
    before the epilogue, y bfloat16)."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    th, nb = tiling(o)
    groups, nchunks = -(-o // nb), -(-c // CK)
    xs = x.float()
    if s is not None:
        xs = (xs * s.bfloat16().float()[:, None, None, :]).bfloat16().float()
    wf = w.bfloat16().float().reshape(9, c, o)       # tap 3 ta + tb: w[ta][tb]
    xp = torch.nn.functional.pad(xs, (0, nchunks * CK - c, 1, XC, 1, th + 2))  # halo, then 0
    acc_all = xs.new_zeros(n, h, wd, o)
    tiles_x, tiles_y = -(-wd // TW), -(-h // th)
    for tile in range(tiles_x * tiles_y):
        ty0, tx0 = tile // tiles_x * th, tile % tiles_x * TW
        rr, rc = min(th, h - ty0), min(TW, wd - tx0)
        for grp in range(groups):
            cs = slice(grp * nb, min(o, (grp + 1) * nb))
            acc = xs.new_zeros(n, th * TW, cs.stop - cs.start)
            for k in range(nchunks):
                ks = slice(k * CK, (k + 1) * CK)
                # The staged tile, flat as the kernel holds it: pixel (r, col)
                # at r * XC + col; every entry past the tile NaN.
                staged = xs.new_full((n, (th + 2) * XC + 2 * XC, CK), NAN)
                staged[:, :(th + 2) * XC] = xp[:, ty0:ty0 + th + 2, tx0:tx0 + XC, ks].reshape(
                    n, (th + 2) * XC, CK)
                wk = torch.nn.functional.pad(wf[:, ks.start:min(c, ks.stop), cs],
                                             (0, 0, 0, max(0, ks.stop - c)))  # [9, CK, NB]
                for ta in range(3):
                    for tb in range(3):
                        rows = torch.tensor([(r + ta) * XC + j + tb for r in range(th)
                                             for j in range(TW)])
                        acc += staged[:, rows] @ wk[3 * ta + tb]
            assert torch.isfinite(acc).all()
            acc_all[:, ty0:ty0 + rr, tx0:tx0 + rc, cs] = acc.reshape(n, th, TW, -1)[:, :rr, :rc]
    y = acc_all if d is None else acc_all * d[:, None, None, :]
    if noise is not None:
        nz = noise.bfloat16().float()
        y = y + (nz[..., None] if nz.dim() == 3 else nz[None, :, :, None])
    if bias is not None:
        y = y + bias
    y = torch.where(y >= 0, y, y * alpha) * gain
    if resid is not None:
        y = y + resid.float()
    return acc_all, y.bfloat16()


# (N, H, W, C, O, path): sizes no tile divides; C and O in 4, 8 and 16 tails
# (C 12, 20 and 36 a partial last k16 step), O 36 the 64-channel tile, 68
# the 128-channel tile, 132 two channel groups. "conv1": styles,
# demodulation, batch-shared noise, bias, resid, lrelu; "noise": per-sample
# noise; "last": conv_last's form (no noise, bias or resid, alpha 1);
# "nodemod": styles without demodulation; "nostyle": no styles (no scale,
# no demodulation), the D conv0 form.
CASES = [(2, 17, 19, 12, 20, "conv1"), (1, 9, 21, 36, 12, "noise"),
         (1, 10, 18, 20, 36, "last"), (2, 9, 17, 8, 8, "nodemod"),
         (1, 7, 20, 16, 68, "conv1"), (1, 9, 18, 24, 132, "nostyle"),
         (1, 6, 33, 40, 40, "conv1")]


def _operands(rng, n, h, w, c, o, path):
    """fused_modconv3x3's arguments: x and resid bfloat16, the rest float32."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    last = path == "last"
    x = rand(n, h, w, c).bfloat16()
    wt = rand(3, 3, c, o, scale=1 / math.sqrt(9 * c))
    s = None if path == "nostyle" else torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32))
    nz = None
    if path in ("conv1", "noise", "nodemod"):
        nz = rand(*((n,) if path == "noise" else ()), h, w, scale=0.1)
    b = None if last else rand(o, scale=0.1)
    r = None if last else rand(n, h, w, o).bfloat16()
    gain, alpha = (1.0, 1.0) if last else (math.sqrt(2), 0.2)
    return (x, wt, s, nz, b, r, gain, alpha, path in ("conv1", "noise", "last"))


def _emulated(args):
    x, wt, s, nz, b, r, gain, alpha, demod = args
    d = demod_coef(wt, s) if demod else None
    return emulate_tc(x, wt, s, d, nz, b, r, gain, alpha)


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("n,h,w,c,o,path", CASES)
def test_tc_emulation_matches_the_float32_sums_and_the_plain_version(n, h, w, c, o, path):
    args = _operands(np.random.RandomState(47), n, h, w, c, o, path)
    x, wt, s = args[:3]
    acc, y = _emulated(args)
    xs = x.float() if s is None else (x * s.bfloat16()[:, None, None, :]).float()
    want = fc.modconv3x3_plain(xs, wt.bfloat16().float(), None, gain=1.0, alpha=1.0,
                               demodulate=False)
    assert want.dtype == torch.float32
    assert _rel_err(acc, want) <= 2e-5
    plain = fc.modconv3x3_plain(*args)
    assert y.dtype == plain.dtype == torch.bfloat16
    _bf16_close(y, plain, fc.modconv3x3_plain(*_widen(args)))


# ((N, H, C, O), noise, bias, resid, gain, alpha, demod); noise "shared"
# [H, W] or "sample" [N, H, W].
JAX_CASES = [((2, 16, 32, 32), "shared", True, True, math.sqrt(2), 0.2, True),
             ((1, 16, 32, 32), None, False, False, 1.0, 1.0, True),
             ((2, 8, 40, 16), "shared", True, False, math.sqrt(2), 0.2, False),
             ((2, 12, 24, 36), "sample", False, True, 1.0, 0.2, True),
             ((1, 8, 16, 68), None, True, True, math.sqrt(2), 1.0, False)]


@pytest.mark.parametrize("case", JAX_CASES)
def test_tc_emulation_against_jax(case):
    """The emulated kernel against `fused_modconv3x3_lrelu` (its forward
    launch in interpret mode) in float32, held to BF16_RATIO times JAX's
    own bfloat16 error or BF16_FLOOR, as chip_smoke.py holds the kernel to
    the plain version."""
    (n, h, c, o), noise, bias, resid, gain, alpha, demod = case
    rng = np.random.RandomState(7)
    x = rng.randn(n, h, h, c).astype(np.float32)
    w = (rng.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    nz = None
    if noise:
        nz = (rng.randn(*((n,) if noise == "sample" else ()), h, h) * 0.1).astype(np.float32)
    b = (rng.randn(o) * 0.1).astype(np.float32) if bias else None
    r = rng.randn(n, h, h, o).astype(np.float32) if resid else None
    xb = torch.from_numpy(x).bfloat16()
    rb = None if r is None else torch.from_numpy(r).bfloat16()
    j = lambda a, dt=None: None if a is None else (  # noqa: E731
        jnp.asarray(a) if dt is None else jnp.asarray(a).astype(dt))
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        y = jpc.fused_modconv3x3_lrelu(j(xb.float().numpy(), dt), j(w), j(s), j(nz), j(b),
                                       None if rb is None else j(rb.float().numpy(), dt), gain,
                                       alpha, demod, False)
        want[dt] = torch.from_numpy(np.array(y.astype(jnp.float32)))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    _, got = _emulated((xb, t(w), t(s), t(nz), t(b), rb, gain, alpha, demod))
    ref = want[jnp.float32]
    ek, ej = _rel_err(got.float(), ref), _rel_err(want[jnp.bfloat16], ref)
    assert ek <= max(BF16_RATIO * ej, BF16_FLOOR), (ek, ej)
