"""K3's bfloat16 adjoint as the tensor-core kernel computes it
(csrc/fused_conv.cu `downconv2_tc_kernel`), emulated in torch on the CPU.

`emulate_tc` follows the kernel block by block (8 x 16 dx positions, the
gd channels in chunks of 16): gd formed from g, y and d with JAX's
roundings (mask = bf16(gain) or bf16(gain * alpha) by the sign of y, gd =
bf16(bf16(g * mask) * bf16(d))); the FIR in float32 over the block's raw
tile (zero outside the image); B split into hi = bf16(B) and lo = bf16(B -
hi); the parity planes, each held in a 9 x 17 array whose entries the kernel
does not write hold NaN (planes (1, *) have 8 rows, planes (*, 1) 16
columns); each tap one product of its plane shifted by the kernel's tap
table, hi and lo each against the bfloat16 weight, summed in float32; then
the ds dot, dx = bf16(du * s) and the dd taps over each block's own pixels.

It is held (a) before the rounding against `emulate` of
tests/test_torch_k3_leastwork.py on the same gd and bfloat16 weight, to
2e-5 of the largest entry (float32 sums in another order; hi + lo stands
for B to 2^-16 of itself): this pins the tap table, the shifts, the planes'
extents (a NaN that reached a sum would show) and the halo at sizes no tile
divides; (b) after the rounding against the float32 plain version by the
bfloat16 rule of tests/test_torch_kernels_cuda.py (at most BF16_RATIO
times the plain bfloat16 version's error, or within BF16_FLOOR of each
output's largest entry); (c) against `jax.vjp` of the JAX package's
`fused_packed_upconv2` (Pallas in interpret mode) by the same rule, its
float32 cotangents the reference and its bfloat16 ones the yardstick.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

from .test_torch_k3_leastwork import emulate
from .test_torch_kernels_cuda import (BF16_FLOOR, BF16_RATIO, FIR, _bf16_close, _k2_inputs,
                                      _widen, one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TH, TW, CK = 8, 16, 16          # dx rows and columns of a block; gd channels a chunk
NAN = float("nan")


def _bf(v):
    """A Python scalar rounded to bfloat16, as the reference rounds the gain."""
    return torch.tensor(v, dtype=torch.bfloat16).float()


def form_gd(g, y, d, gain, alpha):
    """gd = bf16(bf16(g * mask) * bf16(d)) in float32, mask = bf16(gain)
    where y >= 0 and bf16(gain * alpha) elsewhere (y None: the gain)."""
    mask = _bf(gain) if y is None else torch.where(y.float() >= 0, _bf(gain), _bf(gain * alpha))
    gd = (g.float() * mask).bfloat16().float()
    if d is not None:
        gd = (gd * d.bfloat16().float()[:, None, None, :]).bfloat16().float()
    return gd


def split(b):
    """(hi, lo) = (bf16(b), bf16(b - hi)), in float32."""
    hi = b.bfloat16().float()
    return hi, (b - hi).bfloat16().float()


def _tap(t, kh):
    """The kernel's tap table: (plane (pa, pb), row shift, column shift) of
    weight tap t = 3 ta + tb (the 1x1's one tap reads plane (0, 0))."""
    ta, tb = divmod(t, 3) if kh == 3 else (0, 0)
    return (ta & 1, tb & 1), ta >> 1, tb >> 1


def _planes(b, kh):
    """B's planes [2, 2, N, TH + 1, TW + 1, CK] from a block's blurred tile
    (KH 3: [N, 2TH + 1, 2TW + 1, CK]; KH 1: [N, TH, TW, CK] at the even
    positions), NaN where the kernel keeps no plane pixel."""
    n = b.shape[0]
    p = b.new_full((2, 2, n, TH + 1, TW + 1, CK), NAN)
    if kh == 1:
        p[0, 0, :, :TH, :TW] = b
        return p
    for pa in (0, 1):
        for pb in (0, 1):
            p[pa, pb, :, :TH + 1 - pa, :TW + 1 - pb] = b[:, pa::2, pb::2]
    return p


def _block_du(raw, wf, fk, kh):
    """du [N, TH * TW, C] of one block from its raw gd tile [N, RH, RW, O]
    (the rows and columns of its FIR window, zero outside the image)."""
    n, _, _, o = raw.shape
    acc = raw.new_zeros(n, TH * TW, wf.shape[-1])
    for c0 in range(0, o, CK):
        r = F.pad(raw[..., c0:c0 + CK], (0, CK - min(CK, o - c0)))        # zero past O
        b = F.conv2d(r.permute(0, 3, 1, 2), fk.expand(CK, 1, 4, 4), groups=CK)
        b = b.permute(0, 2, 3, 1)
        if kh == 1:
            b = b[:, ::2, ::2]
        w = F.pad(wf[:, c0:c0 + CK], (0, 0, 0, CK - min(CK, o - c0)))    # [taps, CK, C]
        for plane in map(_planes, split(b), (kh, kh)):
            for t in range(kh * kh):
                (pa, pb), dr, dc = _tap(t, kh)
                a = plane[pa, pb, :, dr:dr + TH, dc:dc + TW].reshape(n, TH * TW, CK)
                acc += a @ w[t]
    assert torch.isfinite(acc).all()
    return acc


def emulate_tc(g, y, d, wk, fk, pad, s=None, x=None, noise=None, gain=1.0, alpha=1.0,
               dd=False):
    """g, y [N,2H,2W,O] bfloat16 (y None: the mask is the gain); d [N,O] or
    None; wk [kh,kh,O,C], fk [4,4], pad from `upconv2_adjoint_leastwork`
    (wk rounded to bfloat16 here, as the wrapper does); s [N,C] or None; x
    [N,H,W,C] bfloat16 for the ds dot or None; noise [2H,2W] or [N,2H,2W]
    (rounded to bfloat16) for the dd taps. Returns (du float32 before the
    scale and the rounding, dx bfloat16, dot [N,C] or None, dd1, dd2 [N,O]
    or None, gd float32)."""
    kh = int(wk.shape[0])
    n, ho, wo, o = g.shape
    h, w = ho // 2, wo // 2
    c = wk.shape[-1]
    gd = form_gd(g, y, d, gain, alpha)
    wf = wk.bfloat16().float().reshape(kh * kh, o, c)
    rh, rw = 2 * TH + kh + 1, 2 * TW + kh + 1
    gdp = F.pad(gd, (0, 0, pad, rw, pad, rh))     # raw row 0 of a block = gd row 2 ty0 - pad
    du = gd.new_zeros(n, h, w, c)
    dd1 = dd2 = None
    if dd:
        yf = y.float()
        t = yf / torch.where(yf >= 0, torch.tensor(gain), torch.tensor(gain * alpha))
        if noise is not None:
            nz = noise.bfloat16().float()
            t = t - (nz[..., None] if nz.dim() == 3 else nz[None, :, :, None])
        dd1, dd2 = gd.new_zeros(n, o), gd.new_zeros(n, o)
    for ty0 in range(0, h, TH):
        for tx0 in range(0, w, TW):
            raw = gdp[:, 2 * ty0:2 * ty0 + rh, 2 * tx0:2 * tx0 + rw]
            tile = _block_du(raw, wf, fk, kh).reshape(n, TH, TW, c)
            rr, rc = min(TH, h - ty0), min(TW, w - tx0)
            du[:, ty0:ty0 + rr, tx0:tx0 + rc] = tile[:, :rr, :rc]
            if dd:      # the block's own pixels of gd
                own = (slice(None), slice(2 * ty0, 2 * ty0 + 2 * TH),
                       slice(2 * tx0, 2 * tx0 + 2 * TW))
                dd1 += (gd[own] * t[own]).sum(dim=(1, 2))
                dd2 += gd[own].sum(dim=(1, 2))
    dot = None if x is None else (x.float() * du).sum(dim=(1, 2))
    dx = (du if s is None else du * s[:, None, None, :]).bfloat16()
    return du, dx, dot, dd1, dd2, gd


# (N, H, W of dx, C, O, kh, path): sizes no tile divides, C and O in fours
# (20, 12, 36, 4, 68: not eights, or two channel groups, or a partial last
# chunk). "conv0": styles, demodulation, batch-shared noise, bias, lrelu;
# "noise": the same with per-sample noise; "nodemod": styles and bias, no
# demodulation; "lrelu": no styles, lrelu (the mask from y); "skip": no
# styles, linear (the mask the gain alone).
CASES = [(2, 9, 17, 20, 12, 3, "conv0"), (1, 9, 19, 68, 36, 3, "noise"),
         (2, 5, 7, 36, 4, 3, "nodemod"), (1, 10, 18, 8, 16, 3, "lrelu"),
         (2, 9, 17, 12, 20, 1, "skip"), (1, 7, 9, 8, 12, 1, "lrelu")]


def _operands(rng, n, h, w, c, o, kh, path):
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))

    styles = path in ("conv0", "noise", "nodemod")
    x = rand(n, h, w, c).bfloat16()
    wt = rand(kh, kh, c, o, scale=1 / math.sqrt(kh * kh * c))
    s = torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32)) if styles else None
    nz = None
    if path in ("conv0", "noise"):
        nz = rand(*((n,) if path == "noise" else ()), 2 * h, 2 * w, scale=0.1)
    b = rand(o, scale=0.1) if styles else None
    gain, alpha = (math.sqrt(0.5), 1.0) if path == "skip" else (math.sqrt(2), 0.2)
    demod = path in ("conv0", "noise")
    g = rand(n, 2 * h, 2 * w, o).bfloat16()
    return x, wt, s, nz, b, gain, alpha, demod, g


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _emulated_adjoint(g, x, wt, s, f, y, nz, b, gain, alpha, demod, flip_weight):
    """(dx, ds, dd1, dd2) of the emulated kernel, closed as the wrapper
    closes them (`upconv2_adjoint`), and du before the rounding, gd."""
    wk, fk, pad = fc.upconv2_adjoint_leastwork(wt, f, flip_weight)
    d = fc.demod_coef(wt, s) if (s is not None and demod) else None
    need_dd = d is not None
    du, dx, dot, dd1, dd2, gd = emulate_tc(
        g, y if (need_dd or alpha != 1.0) else None, d, wk, fk, pad, s,
        x if s is not None else None, nz if need_dd else None, gain, alpha, need_dd)
    ds = dot
    if need_dd:
        ds = fc._demod_chain(dot, fc._demod_de(dd1, dd2, d, b), wt, s)
    return (dx, ds, dd1, dd2), du, gd, (wk, fk, pad)


@pytest.mark.parametrize("n,h,w,c,o,kh,path", CASES)
def test_tc_emulation_matches_the_float32_sums_and_the_plain_version(n, h, w, c, o, kh, path):
    x, wt, s, nz, b, gain, alpha, demod, g = _operands(np.random.RandomState(41), n, h, w, c, o,
                                                       kh, path)
    f = setup_filter(FIR)
    for flip_weight in (False, True):
        fwd = (x, wt, s, f, nz, b, gain, alpha, demod, flip_weight)
        y = fc.upconv2_plain(*fwd)
        got, du, gd, (wk, fk, pad) = _emulated_adjoint(g, x, wt, s, f, y, nz, b, gain, alpha,
                                                       demod, flip_weight)
        assert _rel_err(du, emulate(gd, wk.bfloat16().float(), fk, pad)) <= 2e-5
        args = (g, x, wt, s, f, y, nz, b, gain, alpha, demod, flip_weight)
        want = fc.upconv2_adjoint_plain(*args)
        assert [t is None for t in got] == [t is None for t in want]
        _bf16_close(got, want, fc.upconv2_adjoint_plain(*_widen(args)))


@pytest.mark.parametrize("kh", [3, 1])
def test_hi_plus_lo_holds_the_float32_blur(kh):
    """hi + lo reproduces B, the float32 FIR of gd, to 2^-16 of its largest
    entry (each value to 2^-16 of itself)."""
    rng = np.random.RandomState(43)
    g = torch.from_numpy(rng.randn(2, 2 * TH + kh + 1, 2 * TW + kh + 1, CK).astype(np.float32))
    gd = form_gd(g.bfloat16(), None, None, math.sqrt(2), 0.2)
    fk = fc.upconv2_adjoint_leastwork(torch.zeros(kh, kh, 4, 4), setup_filter(FIR))[1]
    b = F.conv2d(gd.permute(0, 3, 1, 2), fk.expand(CK, 1, 4, 4), groups=CK)
    hi, lo = split(b)
    err = ((b - hi) - lo).abs()        # exact in float32
    assert float(err.max()) <= 2.0 ** -16 * float(b.abs().max())
    assert bool((err <= 2.0 ** -16 * b.abs()).all())
    assert float((hi - b).abs().max()) > 2.0 ** -12 * float(b.abs().max())   # lo matters


def test_tap_table_reads_each_plane_inside_its_extent():
    """The 9 taps of the 3x3 read planes (0,0), (0,1), (0,0), (1,0), (1,1),
    (1,0), (0,0), (0,1), (0,0) with the shifts of ta >> 1 and tb >> 1: no
    tap reads row TH of planes (1, *) or column TW of planes (*, 1), which
    the kernel does not hold."""
    for t in range(9):
        (pa, pb), dr, dc = _tap(t, 3)
        assert dr + TH <= TH + 1 - pa and dc + TW <= TW + 1 - pb
    assert [_tap(t, 3)[0] for t in range(9)] == [(0, 0), (0, 1), (0, 0), (1, 0), (1, 1),
                                                 (1, 0), (0, 0), (0, 1), (0, 0)]
    assert _tap(0, 1) == ((0, 0), 0, 0)


@pytest.mark.parametrize("kh", [3, 1])
def test_tc_emulation_against_jax(kh):
    """The emulated kernel's dx and ds against `jax.vjp` of
    `fused_packed_upconv2` (Cin 64, packed; its adjoint launch in interpret
    mode) in float32, held to BF16_RATIO times JAX's own bfloat16 error or
    BF16_FLOOR, as chip_smoke.py holds the kernel to the plain version. The
    emulation masks with JAX's bfloat16 forward output, as JAX's bfloat16
    backward does."""
    n, h, cin, cout = 2, 16, 64, 32
    conv0 = kh == 3
    x, w, s, nz, b = _k2_inputs(np.random.RandomState(5), n, h, cin, cout, kh, conv0, conv0,
                                conv0)
    g = np.random.RandomState(6).randn(n, 2 * h, 2 * h, cout).astype(np.float32)
    gain, alpha = (math.sqrt(2), 0.2) if conv0 else (math.sqrt(0.5), 1.0)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        def fwd(x_, *s_):
            return jpc.fused_packed_upconv2(
                x_.reshape(n, h, h * cin // 128, 128), jnp.asarray(w), s_[0] if s_ else None,
                jsetup_filter(FIR), None if nz is None else jnp.asarray(nz),
                None if b is None else jnp.asarray(b), gain, alpha, conv0,
                False).reshape(n, 2 * h, 2 * h, cout)

        primals = [jnp.asarray(xb.float().numpy()).astype(dt)] + ([jnp.asarray(s)] if conv0
                                                                  else [])
        y, vjp = jax.vjp(fwd, *primals)
        cots = vjp(jnp.asarray(gb.float().numpy()).astype(dt))
        want[dt] = [y] + [torch.from_numpy(np.array(t.astype(jnp.float32))) for t in cots]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    y = torch.from_numpy(np.array(want[jnp.bfloat16][0].astype(jnp.float32))).bfloat16()
    got = _emulated_adjoint(gb, xb, t(w), t(s), setup_filter(FIR), y, t(nz), t(b), gain, alpha,
                            conv0, False)[0]
    for i, mine in enumerate(got[:2] if conv0 else got[:1]):
        ref = want[jnp.float32][1 + i]
        ek, ej = _rel_err(mine.float(), ref), _rel_err(want[jnp.bfloat16][1 + i], ref)
        assert ek <= max(BF16_RATIO * ej, BF16_FLOOR), (i, ek, ej)
