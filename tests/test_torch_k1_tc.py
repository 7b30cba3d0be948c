"""K1's bfloat16 adjoint as the tensor-core kernel computes it
(csrc/fused_conv.cu `conv3x3_adj_tc_kernel`), emulated in torch on the CPU.

`emulate_tc` follows the kernel tile by tile (TH x 16 dx positions: TH 16
for C <= 32, else 8; NB dx channels: 32, 64 or 128, in channel groups of
128 beyond) and chunk by chunk (16 gd channels): gd formed from g, y,
resid and d with JAX's roundings (y - resid in bfloat16; mask = bf16(gain)
where that is >= 0, -0 included, else bf16(gain * alpha); gd = bf16(bf16(g
* mask) * bf16(d))) in a staged tile of (TH + 2) x 18 pixels with the
1-pixel halo, zero outside the image and past O, held in a flat buffer
whose entries past the tile hold NaN; each tap (ta, tb) one product of the
staged rows at the kernel's row offsets ((2 rg + i + ta) 18 + j + tb for
dx row 2 rg + i, column j) against flip(w)^T's rows w[2 - ta][2 - tb][c] in
bfloat16, summed in float32; then dx = bf16(du * s), the ds dot sum x * du
before the scale and the dd taps over each tile's own pixels (in the
blocks of channel group k mod the groups; as the kernel's products on the
tensor cores, sum gd * max(yr, 0) / gain + sum gd * min(yr, 0) / (gain *
alpha) - sum gd * noise, and sum gd), summed over the tiles in order.
(The kernel's partials are per block; below 264 tiles, at every size here,
a block walks one tile.)

It is held (a) before the rounding against `emulate_adjoint` of
tests/test_torch_k1_leastwork.py on the same gd and bfloat16 weight, to
2e-5 of the largest entry (float32 sums in another order): this pins the
tap table, the row offsets (a NaN that reached a sum would show) and the
halo at sizes no tile divides; (b) after the rounding against the float32
plain version by the bfloat16 rule of tests/test_torch_kernels_cuda.py (at
most BF16_RATIO times the plain bfloat16 version's error, or within
BF16_FLOOR of each output's largest entry), its gd equal to the plain
bfloat16 version's; (c) against `jax.vjp` of the JAX package's
`fused_modconv3x3_lrelu` (Pallas in interpret mode) by the same rule, its
float32 cotangents the reference and its bfloat16 ones the yardstick.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.modulated_conv import demod_coef

from .test_torch_k1_leastwork import emulate_adjoint
from .test_torch_kernels_cuda import (BF16_FLOOR, BF16_RATIO, _bf16_close, _widen,
                                      one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TW, CK, XC = 16, 16, 18        # dx columns of a tile; gd channels a chunk; staged columns
NAN = float("nan")


def tiling(c):
    """(TH, NB, WN) of the kernel for a dx of c channels: dx rows of a tile,
    dx channels of a block, dx channels of a warp."""
    if c <= 32:
        return 16, 32, 32
    return (8, 64, 32) if c <= 64 else (8, 128, 64)


def _bf(v):
    """A Python scalar rounded to bfloat16, as the reference rounds the gain."""
    return torch.tensor(v, dtype=torch.bfloat16).float()


def form_gd(g, y, resid, d, gain, alpha):
    """(gd, y - resid), float32 holding bfloat16 values: y - resid rounded
    once, mask = bf16(gain) where it is >= 0 (-0 included) and bf16(gain *
    alpha) elsewhere (y None: mask 1), gd = bf16(bf16(g * mask) * bf16(d))."""
    if y is None:
        yr, mask = None, torch.tensor(1.0)
    else:
        yr = y.float() if resid is None else (y.float() - resid.float()).bfloat16().float()
        mask = torch.where(yr >= 0, _bf(gain), _bf(gain * alpha))
    gd = (g.float() * mask).bfloat16().float()
    if d is not None:
        gd = (gd * d.bfloat16().float()[:, None, None, :]).bfloat16().float()
    return gd, yr


def emulate_tc(g, w, s=None, d=None, x=None, y=None, resid=None, noise=None, gain=1.0,
               alpha=1.0, dd=False):
    """g, y, resid [N,H,W,O] and x [N,H,W,C] bfloat16 (y None: mask 1;
    resid None: none; x None: no ds dot); w [3,3,C,O] the forward's weight
    (rounded to bfloat16 here, as the wrapper does); s [N,C] or None; d
    [N,O] or None; noise [H,W] or [N,H,W] (rounded to bfloat16) for the dd
    taps. Returns (du float32 before the scale and the rounding, dx
    bfloat16, dot [N,C] or None, dd1, dd2 [N,O] or None, gd float32)."""
    n, h, wd, o = g.shape
    c = w.shape[2]
    th, nb, _ = tiling(c)
    groups = -(-c // nb)
    nchunks = -(-o // CK)
    gd, yr = form_gd(g, y, resid, d, gain, alpha)
    wf = w.bfloat16().float().reshape(9, c, o)          # row (tap, c): w[tap // 3][tap % 3][c]
    gdp = torch.nn.functional.pad(gd, (0, nchunks * CK - o, 1, XC, 1, th + 2))  # halo, then 0
    du = gd.new_zeros(n, h, wd, c)
    tiles_x, tiles_y = -(-wd // TW), -(-h // th)
    dots, dd1s, dd2s = [], [], []
    if dd:
        nz = gd.new_zeros(n, h, wd, 1) if noise is None else noise.bfloat16().float()
        nz = nz if nz.dim() == 4 else (nz[..., None] if nz.dim() == 3 else nz[None, :, :, None])
    for tile in range(tiles_x * tiles_y):
        ty0, tx0 = tile // tiles_x * th, tile % tiles_x * TW
        rr, rc = min(th, h - ty0), min(TW, wd - tx0)
        dot = gd.new_zeros(n, c)
        dd1, dd2 = gd.new_zeros(n, o), gd.new_zeros(n, o)
        for grp in range(groups):
            cs = slice(grp * nb, min(c, (grp + 1) * nb))
            acc = gd.new_zeros(n, th * TW, cs.stop - cs.start)
            for k in range(nchunks):
                ks = slice(k * CK, (k + 1) * CK)
                # The staged tile, flat as the kernel holds it: pixel (r, col)
                # at r * XC + col; every entry past the tile NaN.
                staged = gd.new_full((n, (th + 2) * XC + 2 * XC, CK), NAN)
                staged[:, :(th + 2) * XC] = gdp[:, ty0:ty0 + th + 2, tx0:tx0 + XC, ks].reshape(
                    n, (th + 2) * XC, CK)
                wk = torch.nn.functional.pad(wf[:, cs, ks.start:min(o, ks.stop)],
                                             (0, max(0, ks.stop - o)))       # [9, NB, CK]
                for ta in range(3):
                    for tb in range(3):
                        rows = torch.tensor([(r + ta) * XC + j + tb for r in range(th)
                                             for j in range(TW)])
                        acc += staged[:, rows] @ wk[8 - (3 * ta + tb)].T
                if dd and k % groups == grp:
                    # The tile's own pixels of chunk k: sum gd * max(yr, 0), gd *
                    # min(yr, 0), gd * noise and gd, then the gains once.
                    own = (slice(None), slice(ty0, ty0 + rr), slice(tx0, tx0 + rc),
                           slice(ks.start, min(o, ks.stop)))
                    g_, y_ = gd[own], yr[own]
                    sums = [(g_ * v).sum(dim=(1, 2)) for v in (
                        y_.clamp(min=0), y_.clamp(max=0), nz[own[:3]], torch.ones(()))]
                    dd1[:, own[3]] = sums[0] / gain + sums[1] / (gain * alpha) - sums[2]
                    dd2[:, own[3]] = sums[3]
            assert torch.isfinite(acc).all()
            tile_du = acc.reshape(n, th, TW, -1)[:, :rr, :rc]
            du[:, ty0:ty0 + rr, tx0:tx0 + rc, cs] = tile_du
            if x is not None:
                dot[:, cs] = (x[:, ty0:ty0 + rr, tx0:tx0 + rc, cs].float() * tile_du).sum(
                    dim=(1, 2))
        dots.append(dot)
        dd1s.append(dd1)
        dd2s.append(dd2)
    dot, dd1, dd2 = (torch.stack(p, dim=1).sum(1) for p in (dots, dd1s, dd2s))
    dx = (du if s is None else du * s[:, None, None, :]).bfloat16()
    return du, dx, (dot if x is not None else None), *((dd1, dd2) if dd else (None, None)), gd


# (N, H, W, C, O, path): sizes no tile divides, C and O in fours (12, 20,
# 36: not in eights or a partial last chunk; 36 and 68 the 64- and
# 128-channel tiles, 132 two channel groups). "conv1": styles,
# demodulation, batch-shared noise, bias, resid, lrelu; "noise": per-sample
# noise; "last": conv_last's form (no noise, bias or resid, alpha 1);
# "nodemod": styles without demodulation (no dd taps).
CASES = [(2, 17, 19, 12, 20, "conv1"), (1, 9, 21, 36, 12, "noise"),
         (1, 10, 18, 20, 36, "last"), (2, 9, 17, 8, 8, "nodemod"),
         (1, 7, 20, 68, 20, "conv1"), (1, 9, 18, 132, 8, "conv1")]


def _operands(rng, n, h, w, c, o, path):
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    last = path == "last"
    x = rand(n, h, w, c).bfloat16()
    wt = rand(3, 3, c, o, scale=1 / math.sqrt(9 * c))
    s = torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32))
    nz = None
    if path in ("conv1", "noise", "nodemod"):
        nz = rand(*((n,) if path == "noise" else ()), h, w, scale=0.1)
    b = None if last else rand(o, scale=0.1)
    r = None if last else rand(n, h, w, o).bfloat16()
    gain, alpha = (1.0, 1.0) if last else (math.sqrt(2), 0.2)
    demod = path != "nodemod"
    g = rand(n, h, w, o).bfloat16()
    return x, wt, s, nz, b, r, gain, alpha, demod, g


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _emulated_adjoint(g, x, wt, s, y, nz, b, r, gain, alpha, demod):
    """(dx, ds, dd1, dd2) of the emulated kernel, closed as the wrapper
    closes them (`modconv3x3_adjoint`), and du before the rounding, gd."""
    d = demod_coef(wt, s) if demod else None
    need_dd = d is not None
    du, dx, dot, dd1, dd2, gd = emulate_tc(g, wt, s, d, x, y, r, nz if need_dd else None, gain,
                                           alpha, need_dd)
    ds = dot
    if need_dd:
        ds = fc._demod_chain(dot, fc._demod_de(dd1, dd2, d, b), wt, s)
    return (dx, ds, dd1, dd2), du, gd


@pytest.mark.parametrize("n,h,w,c,o,path", CASES)
def test_tc_emulation_matches_the_float32_sums_and_the_plain_version(n, h, w, c, o, path):
    x, wt, s, nz, b, r, gain, alpha, demod, g = _operands(np.random.RandomState(44), n, h, w, c,
                                                          o, path)
    y = fc.modconv3x3_plain(x, wt, s, nz, b, r, gain, alpha, demod)
    got, du, gd = _emulated_adjoint(g, x, wt, s, y, nz, b, r, gain, alpha, demod)
    ones = torch.ones(gd.shape)
    want_du = emulate_adjoint(gd, x.float(), wt.bfloat16().float(), None, None, ones, None, None,
                              1.0, 1.0, False)[0]
    assert _rel_err(du, want_du) <= 2e-5
    yp = y if r is None else y - r
    assert torch.equal(gd, fc._adjoint_gd(g, yp, wt, s, gain, alpha, demod)[1].float())
    args = (g, x, wt, s, y, nz, b, r, gain, alpha, demod)
    want = fc.modconv3x3_adjoint_plain(*args)
    assert [t is None for t in got] == [t is None for t in want]
    _bf16_close(got, want, fc.modconv3x3_adjoint_plain(*_widen(args)))


@pytest.mark.parametrize("c", [20, 36])
def test_the_mask_takes_y_minus_resid_at_exact_zeros_as_nonnegative(c):
    """y - resid exactly +0 (y equal to resid) and -0 (y -0, resid +0) at a
    third of the pixels each: the mask is the gain there, as JAX's
    `where(y >= 0)`, and gd equals the plain bfloat16 version's."""
    rng = np.random.RandomState(45)
    n, h, w, o = 1, 11, 19, 12
    x, wt, s, nz, b, r, gain, alpha, demod, g = _operands(rng, n, h, w, c, o, "conv1")
    y = fc.modconv3x3_plain(x, wt, s, nz, b, r, gain, alpha, demod)
    pick = torch.from_numpy(rng.randint(0, 3, size=(n, h, w, o)))
    r = torch.where(pick == 2, torch.zeros_like(r), r)
    y = torch.where(pick == 1, r, torch.where(pick == 2, torch.full_like(y, -0.0), y))
    yr = form_gd(g, y, r, None, gain, alpha)[1]
    assert bool((yr[pick > 0] == 0).all()) and bool(torch.signbit(yr[pick == 2]).all())
    got, _, gd = _emulated_adjoint(g, x, wt, s, y, nz, b, r, gain, alpha, demod)
    assert torch.equal(gd, fc._adjoint_gd(g, y - r, wt, s, gain, alpha, demod)[1].float())
    args = (g, x, wt, s, y, nz, b, r, gain, alpha, demod)
    _bf16_close(got, fc.modconv3x3_adjoint_plain(*args),
                fc.modconv3x3_adjoint_plain(*_widen(args)))


def test_tap_rows_stay_inside_the_staged_tile():
    """Every tap's row offset, (2 rg + i + ta) 18 + j + tb, lies inside the
    (TH + 2) x 18 staged pixels for both tile heights, and the nine taps
    read nine distinct windows."""
    for th in (16, 8):
        offsets = set()
        for ta in range(3):
            for tb in range(3):
                rows = [(r + ta) * XC + j + tb for r in range(th) for j in range(TW)]
                assert 0 <= min(rows) and max(rows) < (th + 2) * XC
                offsets.add(rows[0])
        assert len(offsets) == 9


@pytest.mark.parametrize("case", [((2, 16, 32, 32), True, True, True, 1.0, 0.2, True),
                                  ((1, 16, 32, 32), False, False, False, 1.0, 1.0, True),
                                  ((2, 8, 40, 16), True, True, True, math.sqrt(2), 0.2, True)])
def test_tc_emulation_against_jax(case):
    """The emulated kernel's dx and ds against `jax.vjp` of
    `fused_modconv3x3_lrelu` (its adjoint launch in interpret mode) in
    float32, held to BF16_RATIO times JAX's own bfloat16 error or
    BF16_FLOOR, as chip_smoke.py holds the kernel to the plain version. The
    emulation masks with JAX's bfloat16 forward output, as JAX's bfloat16
    backward does."""
    (n, h, c, o), noise, bias, resid, gain, alpha, demod = case
    rng = np.random.RandomState(6)
    x = rng.randn(n, h, h, c).astype(np.float32)
    w = (rng.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    nz = (rng.randn(h, h) * 0.1).astype(np.float32) if noise else None
    b = (rng.randn(o) * 0.1).astype(np.float32) if bias else None
    r = rng.randn(n, h, h, o).astype(np.float32) if resid else None
    g = rng.randn(n, h, h, o).astype(np.float32)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    rb = None if r is None else torch.from_numpy(r).bfloat16()
    j = lambda a, dt=None: None if a is None else (  # noqa: E731
        jnp.asarray(a) if dt is None else jnp.asarray(a).astype(dt))
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        def fwd(x_, s_):
            return jpc.fused_modconv3x3_lrelu(x_, j(w), s_, j(nz), j(b),
                                              None if rb is None else j(rb.float().numpy(), dt),
                                              gain, alpha, demod, False)
        y, vjp = jax.vjp(fwd, j(xb.float().numpy(), dt), j(s))
        cots = vjp(j(gb.float().numpy(), dt))
        want[dt] = [y] + [torch.from_numpy(np.array(t.astype(jnp.float32))) for t in cots]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y = torch.from_numpy(np.array(want[jnp.bfloat16][0].astype(jnp.float32))).bfloat16()
    got = _emulated_adjoint(gb, xb, t(w), t(s), y, t(nz), t(b), rb, gain, alpha, demod)[0]
    for i in range(2):
        ref = want[jnp.float32][1 + i]
        ek, ej = _rel_err(got[i].float(), ref), _rel_err(want[jnp.bfloat16][1 + i], ref)
        assert ek <= max(BF16_RATIO * ej, BF16_FLOOR), (i, ek, ej)
