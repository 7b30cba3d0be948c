"""The FIR dw in bfloat16 as the tensor-core kernel computes it
(csrc/fused_conv.cu `fir_dw_tc_kernel`, `mgt_fir_dw_bf16`), emulated in torch
on the CPU.

`emulate_tc` follows the kernel block by block: the base grid in tiles of
TH x TW positions, walked by slices of `fc.dw_slices` in the kernel's order
(columns of tiles fastest, then rows, then images); per tile the raw src
tile (its full-resolution rows and columns with the FIR's and the taps'
halo, zero outside the image), the FIR in float32 over it, B split into
hi = bf16(B) and lo = bf16(B - hi), the parity planes, each held in a
(TH + 1) x (TW + 1) array whose entries the kernel does not write hold NaN
(planes (1, *) have TH rows, planes (*, 1) TW columns; KH 1 keeps plane
(0, 0) alone, B at the even positions); each tap one product of its plane
shifted by the kernel's tap table against base' = bf16(base * s) (base
zero past the image's edge), hi and lo each summed in float32; the tile's
sums into its slice's float32 partial; then the wrapper's sum of the slices.

It is held (a) against `fir_dw_plain`, which takes B unrounded, to 1e-5 of
the largest entry: hi + lo holds each B value to 2^-16 of itself (1.5e-5)
with an error of either sign, and the float32 sums run in another order
(2.7e-6 at most here); this pins the tap table, the
shifts, the planes' extents (a NaN that reached a sum would show) and the
halo at sizes no tile divides; (b) through the autograd Functions, in place
of the kernel, against JAX's bfloat16 K3 dw cotangent and K2 `use_dw` block
cotangent (`jax.vjp` of `fused_packed_upconv2` and `fused_packed_dconv2`,
Pallas in interpret mode) by tests/test_torch_bf16.py's `_closer`; (c) at
single pixels on every tile edge; (d) by its tile table against the
kernel's source.
"""

import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

from .test_torch_bf16 import BF, _closer, _j, _t
from .test_torch_kernels_cuda import FIR, K2_CASES, _k2_inputs
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TH, TW = 4, 16          # base rows and columns of a tile
U, V = 32, 64           # B and base channels of a block
NAN = float("nan")
F32, TBF = jax.numpy.float32, torch.bfloat16
SOURCE = Path(fc.__file__).resolve().parent.parent / "csrc" / "fused_conv.cu"


def split(b):
    """(hi, lo) = (bf16(b), bf16(b - hi)), in float32."""
    hi = b.bfloat16().float()
    return hi, (b - hi).bfloat16().float()


def _tap(t, kh):
    """The kernel's tap table: (plane (pa, pb), row shift, column shift) of
    tap t = kh ta + tb (the 1x1's one tap reads plane (0, 0))."""
    ta, tb = divmod(t, kh)
    return (ta & 1, tb & 1), ta >> 1, tb >> 1


def _planes(b, kh):
    """B's planes [2, 2, N, TH + 1, TW + 1, C] from a tile's blurred values
    (KH 3: [N, 2TH + 1, 2TW + 1, C]; KH 1: [N, TH, TW, C] at the even
    positions), NaN where the kernel keeps no plane pixel."""
    p = b.new_full((2, 2, b.shape[0], TH + 1, TW + 1, b.shape[-1]), NAN)
    if kh == 1:
        p[0, 0, :, :TH, :TW] = b
        return p
    for pa in (0, 1):
        for pb in (0, 1):
            p[pa, pb, :, :TH + 1 - pa, :TW + 1 - pb] = b[:, pa::2, pb::2]
    return p


def _tile_taps(raw, base, fk, kh):
    """[N, kh, kh, C, V] of one tile: its raw src tile [N, RH, RW, C] (zero
    outside the image) and its base' tile [N, TH, TW, V] (zero past the
    edge)."""
    c = raw.shape[-1]
    b = F.conv2d(raw.permute(0, 3, 1, 2), fk.expand(c, 1, 4, 4), groups=c).permute(0, 2, 3, 1)
    if kh == 1:
        b = b[:, ::2, ::2]
    out = raw.new_zeros(raw.shape[0], kh * kh, c, base.shape[-1])
    for plane in map(_planes, split(b), (kh, kh)):
        for t in range(kh * kh):
            (pa, pb), dr, dc = _tap(t, kh)
            a = plane[pa, pb, :, dr:dr + TH, dc:dc + TW]
            out[:, t] += torch.einsum("nhwc,nhwv->ncv", a, base)
    assert torch.isfinite(out).all()
    return out.reshape(raw.shape[0], kh, kh, c, -1)


def tiles(n, h, w):
    """The base tiles of one launch: `mgt_fir_dw_tiles_bf16`'s count."""
    return n * -(-h // TH) * -(-w // TW)


def emulate_tc(src, base, s, fk, pad, kh):
    """src [N,2H,2W,C] and base [N,H,W,K] bfloat16, s [N,K] float32 or None,
    fk [4,4] and pad from the role's least-work operands -> [kh,kh,C,K] in
    float32, as `mgt_fir_dw_bf16` and the wrapper's sum of its slices
    compute it (C padded to U and K to V with zero channels, as the wrapper
    pads them, and cut back)."""
    n, h, w, k = base.shape
    c = src.shape[-1]
    src = F.pad(src.float(), (0, -c % U))
    bp = base.float() if s is None else (base.float() * s[:, None, None, :]).bfloat16().float()
    bp = F.pad(bp, (0, -k % V))
    rh, rw = 2 * TH + kh + 1, 2 * TW + kh + 1
    srcp = F.pad(src, (0, 0, pad, rw, pad, rh))          # raw row 0 of a tile = row 2 TH ty - pad
    bp = F.pad(bp, (0, 0, 0, TW, 0, TH))                 # zero past the edge
    nty, ntx = -(-h // TH), -(-w // TW)
    per_tile = torch.stack([torch.stack([
        _tile_taps(srcp[:, 2 * TH * ty:2 * TH * ty + rh, 2 * TW * tx:2 * TW * tx + rw],
                   bp[:, TH * ty:TH * (ty + 1), TW * tx:TW * (tx + 1)], fk, kh)
        for tx in range(ntx)], 1) for ty in range(nty)], 1)
    per_tile = per_tile.reshape(n * nty * ntx, *per_tile.shape[3:])   # the kernel's tile order
    assert per_tile.shape[0] == tiles(n, h, w)
    slices, per = fc.dw_slices(per_tile.shape[0], (src.shape[-1] // U) * (bp.shape[-1] // V))
    part = per_tile.new_zeros(slices, *per_tile.shape[1:])
    for t in range(per_tile.shape[0]):
        part[t // per] += per_tile[t]
    return part.sum(0)[..., :c, :k]


def up_dw(x, gd, styles, w, f, flip_weight=False):
    """`fc.upconv2_dw` with the emulated kernel in place of the launch."""
    flip, fk, pad = fc.upconv2_dw_leastwork(w, f, flip_weight)
    dwk = emulate_tc(gd, x, styles, fk, pad, int(w.shape[0])).transpose(2, 3)
    return dwk.flip((0, 1)) if flip else dwk


def down_dw(x, gz, w, f, flip_weight=True):
    """`fc.downconv2_dw` with the emulated kernel in place of the launch."""
    flip, fk, pad = fc.downconv2_dw_leastwork(w, f, flip_weight)
    dwk = emulate_tc(x, gz, None, fk, pad, int(w.shape[0]))
    return dwk.flip((0, 1)) if flip else dwk


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _operands(rng, role, n, h, w, cin, cout, kh, scaled):
    """(x, t, s, wt) of a role: K3's dw ("up": x [N,H,W,I], gd [N,2H,2W,O])
    or the D down-conv's ("down": x [N,2H,2W,I], gz [N,H,W,O])."""
    def rand(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    wt = rand(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)
    s = torch.from_numpy((rng.rand(n, cin) + 0.5).astype(np.float32)) if scaled else None
    if role == "up":
        return rand(n, h, w, cin).bfloat16(), rand(n, 2 * h, 2 * w, cout).bfloat16(), s, wt
    return rand(n, 2 * h, 2 * w, cin).bfloat16(), rand(n, h, w, cout).bfloat16(), None, wt


# (role, n, h, w, cin, cout, kh, scaled): both roles, KH 3 and 1, with and
# without s (K3's role), at sizes no tile divides, widths the wrapper pads
# (36, 40, 72, 100) and more than one channel group.
CASES = [("up", 2, 9, 17, 64, 32, 3, True), ("up", 1, 5, 21, 100, 36, 3, False),
         ("up", 2, 9, 11, 64, 32, 1, True), ("up", 1, 7, 18, 36, 40, 1, False),
         ("down", 2, 6, 5, 40, 72, 3, False), ("down", 1, 9, 19, 32, 128, 3, False),
         ("down", 1, 7, 13, 64, 128, 1, False), ("down", 2, 5, 33, 32, 64, 1, False)]


@pytest.mark.parametrize("role,n,h,w,cin,cout,kh,scaled", CASES)
def test_emulation_matches_fir_dw_plain(role, n, h, w, cin, cout, kh, scaled):
    """The emulated kernel against `fir_dw_plain` on the role's least-work
    operands (B unrounded, base * s rounded alike), and through the role's
    map onto w against the plain route's folded cotangent, to 1e-5 of the
    largest entry (hi + lo holds B to 2^-16 of itself; float32 sums in
    another order)."""
    x, t, s, wt = _operands(np.random.RandomState(71), role, n, h, w, cin, cout, kh, scaled)
    f = setup_filter(FIR)
    for flip_weight in (False, True):
        if role == "up":
            _, fk, pad = fc.upconv2_dw_leastwork(wt, f, flip_weight)
            src, base = t, x
            got_w = up_dw(x, t, s, wt, f, flip_weight)
            want_w = fc.upconv2_dw_plain(x, t, s, wt, f, flip_weight)
        else:
            _, fk, pad = fc.downconv2_dw_leastwork(wt, f, flip_weight)
            src, base = x, t
            got_w = down_dw(x, t, wt, f, flip_weight)
            want_w = fc.downconv2_dw_plain(x, t, wt, f, flip_weight)
        got = emulate_tc(src, base, s, fk, pad, kh)
        assert _rel_err(got, fc.fir_dw_plain(src, base, s, fk, pad, kh)) <= 1e-5
        assert got_w.shape == want_w.shape and _rel_err(got_w, want_w) <= 1e-5


@pytest.mark.parametrize("kh", [3, 1])
def test_hi_plus_lo_holds_the_float32_blur(kh):
    """hi + lo reproduces B, the float32 FIR of a bfloat16 src, to 2^-16 of
    each value, where hi alone is off by more than 2^-12 of the largest."""
    rng = np.random.RandomState(72)
    src = torch.from_numpy(rng.randn(2, 2 * TH + kh + 1, 2 * TW + kh + 1, U).astype(np.float32))
    fk = fc.downconv2_dw_leastwork(torch.zeros(kh, kh, 4, 4), setup_filter(FIR))[1]
    b = F.conv2d(src.bfloat16().float().permute(0, 3, 1, 2), fk.expand(U, 1, 4, 4), groups=U)
    hi, lo = split(b)
    err = ((b - hi) - lo).abs()        # b - hi is exact in float32
    assert bool((err <= 2.0 ** -16 * b.abs()).all())
    assert float((hi - b).abs().max()) > 2.0 ** -12 * float(b.abs().max())   # lo matters


def test_tap_table_reads_each_plane_inside_its_extent():
    """The 9 taps read planes (0,0), (0,1), (0,0), (1,0), (1,1), (1,0), (0,0),
    (0,1), (0,0) shifted by ta >> 1 rows and tb >> 1 columns: no tap reads
    row TH of planes (1, *) or column TW of planes (*, 1), which the kernel
    does not hold, and every plane pixel the kernel writes is read by a
    tap."""
    read = torch.zeros(2, 2, TH + 1, TW + 1, dtype=torch.bool)
    for t in range(9):
        (pa, pb), dr, dc = _tap(t, 3)
        assert dr + TH <= TH + 1 - pa and dc + TW <= TW + 1 - pb
        read[pa, pb, dr:dr + TH, dc:dc + TW] = True
    for pa in (0, 1):
        for pb in (0, 1):
            assert bool(read[pa, pb, :TH + 1 - pa, :TW + 1 - pb].all())
            assert not bool(read[pa, pb, TH + 1 - pa:].any() or read[pa, pb, :, TW + 1 - pb:].any())
    assert [_tap(t, 3)[0] for t in range(9)] == [(0, 0), (0, 1), (0, 0), (1, 0), (1, 1),
                                                 (1, 0), (0, 0), (0, 1), (0, 0)]
    assert _tap(0, 1) == ((0, 0), 0, 0)


def _source_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


# The FIR dw's calls of a 1024^2 training iteration at batch 4 (base grids:
# D b1024 and b512's conv1 and skip at 512^2 and 256^2; G b256, b512 and
# b1024's conv0 and skip at 128^2, 256^2 and 512^2), the reg route's at
# batch 2 and 4, and odd sizes.
TILE_CASES = [(4, 512, 512), (4, 256, 256), (4, 128, 128), (2, 128, 128), (2, 256, 256),
              (2, 512, 512), (1, 9, 17), (2, 5, 33), (3, 1, 1), (1, 4, 16), (1, 13, 15)]


@pytest.mark.parametrize("n,h,w", TILE_CASES)
def test_tile_table_matches_the_kernel_source(n, h, w):
    """The emulation's tiles, blocks and tile count are the kernel's: the
    constants kFwTH, kFwTW, kFwU and kFwV of fused_conv.cu, and the body of
    `mgt_fir_dw_tiles_bf16`, evaluated here at the call shapes and at odd
    sizes."""
    assert (_source_constant("kFwTH"), _source_constant("kFwTW")) == (TH, TW)
    assert (_source_constant("kFwU"), _source_constant("kFwV")) == (U, V)
    body = re.search(r"int mgt_fir_dw_tiles_bf16\(int N, int H, int W\) \{\s*return (.*?);\s*\}",
                     SOURCE.read_text(), re.S)
    assert body, "mgt_fir_dw_tiles_bf16"
    expr = body.group(1).replace("/", "//").replace("kFwTH", str(TH)).replace("kFwTW", str(TW))
    assert eval(expr, {}, {"N": n, "H": h, "W": w}) == tiles(n, h, w)
    slices, per = fc.dw_slices(tiles(n, h, w), 1)
    assert (slices - 1) * per < tiles(n, h, w) <= slices * per


def _edges(size, tile):
    """Positions on both sides of every tile edge, and the image's borders."""
    out = {0, size - 1}
    for e in range(tile, size, tile):
        out |= {e - 1, e, e + 1}
    return sorted(p for p in out if 0 <= p < size)


@pytest.mark.parametrize("kh", [3, 1])
@pytest.mark.parametrize("operand", ["src", "base"])
def test_single_pixels_on_every_tile_edge(kh, operand):
    """One nonzero pixel of src (or of base) at a time on a 9 x 33 base grid
    (rows 3 | 4 | 5 and 7 | 8, columns 15 | 16 | 17 and 31 | 32), the other
    operand random: the emulated kernel keeps exactly the nonzero entries of
    `fir_dw_plain` and agrees with it to 2^-15 of the largest, through every
    tap, plane and shift on both sides of each tile edge."""
    rng = np.random.RandomState(73)
    n, h, w, c, k = 1, 9, 33, 32, 64
    f = setup_filter(rng.rand(4, 4) + 0.1)          # no zero tap, no symmetry
    _, fk, pad = fc.downconv2_dw_leastwork(torch.zeros(kh, kh, c, k), f)
    s = torch.from_numpy((rng.rand(n, k) + 0.5).astype(np.float32))
    hs, ws = (2 * h, 2 * w) if operand == "src" else (h, w)
    step = 1 if operand == "base" else 2
    for py in _edges(hs, step * TH):
        for px in _edges(ws, step * TW):
            src = torch.from_numpy(rng.randn(n, 2 * h, 2 * w, c).astype(np.float32)).bfloat16()
            base = torch.from_numpy(rng.randn(n, h, w, k).astype(np.float32)).bfloat16()
            one = src if operand == "src" else base
            keep = one[0, py, px].clone()
            one.zero_()
            one[0, py, px] = keep
            got = emulate_tc(src, base, s, fk, pad, kh)
            want = fc.fir_dw_plain(src, base, s, fk, pad, kh)
            assert bool(((got != 0) == (want != 0)).all()), (py, px)
            assert _rel_err(got, want) <= 2.0 ** -15, (py, px)


@pytest.mark.parametrize("role", ["k3", "k3_skip"])
def test_k3_dw_cotangent_matches_jax(monkeypatch, role):
    """K3's dw role in bfloat16 with the emulated kernel in place of the
    launch (KH 3 with s, the skip's KH 1 without): the cotangent of w from
    `torch.autograd.grad` of `fused_upconv2` against `jax.vjp` of
    `fused_packed_upconv2` with respect to x and w (Pallas in interpret
    mode), by `_closer`."""
    cin, kh, styles, noise, bias, demod, gain, alpha = K2_CASES[0 if role == "k3" else 1]
    n, h, cout = 2, 16, cin // 2
    rng = np.random.RandomState(4)
    x, w, s, nz, b = _k2_inputs(rng, n, h, cin, cout, kh, styles, noise, bias)
    g = rng.randn(n, 2 * h, 2 * h, cout).astype(np.float32)

    def jfwd(x_, w_):
        return jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128), w_, _j(s),
                                        jsetup_filter(FIR), _j(nz), _j(b), gain, alpha, demod,
                                        False).reshape(n, 2 * h, 2 * h, cout)
    want = {}
    for dt in (F32, BF):
        want[dt] = jax.vjp(jfwd, _j(x, dt), _j(w))[1](_j(g, dt))[1]
    calls = []
    monkeypatch.setattr(fc, "upconv2_dw", lambda *a: calls.append(a) or up_dw(*a))
    xt, wt = _t(x, TBF, True), _t(w, grad=True)
    y = fc.fused_upconv2(xt, wt, _t(s), setup_filter(FIR), _t(nz), _t(b), gain, alpha, demod,
                         False)
    got = torch.autograd.grad(y, (xt, wt), _t(g, TBF))[1]
    assert len(calls) == 1 and got.dtype == torch.float32
    _closer(got, want[BF], want[F32])


@pytest.mark.parametrize("kh", [3, 1])
def test_d_downconv_dw_cotangent_matches_jax(monkeypatch, kh):
    """The D down-conv's dw (K2's use_dw block cotangent) in bfloat16 with
    the emulated kernel in place of the launch: the cotangent of w from
    `torch.autograd.grad` of `fused_downconv2` against `jax.vjp` of
    `fused_packed_dconv2` (Pallas in interpret mode), by `_closer`."""
    n, h, cin, cout = 2, 16, 8, 16
    q = 128 // cin                               # JAX packs q pixels per 128 lanes
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    g = rng.randn(n, h // 2, h // 2, cout).astype(np.float32)
    gain, alpha = (1.0, 0.2) if kh == 3 else (math.sqrt(0.5), 1.0)

    def jfwd(x_, w_, b_):
        y = jpc.fused_packed_dconv2(x_.reshape(n, h, h // q, q * cin), w_, jsetup_filter(FIR),
                                    b_, None, gain, alpha, True)
        return y.reshape(n, h // 2, h // 2, cout)
    want = {}
    for dt in (F32, BF):
        want[dt] = jax.vjp(jfwd, _j(x, dt), _j(w), _j(b))[1](_j(g, dt))[1]
    calls = []
    monkeypatch.setattr(fc, "downconv2_dw", lambda *a: calls.append(a) or down_dw(*a))
    xt, wt, bt = _t(x, TBF, True), _t(w, grad=True), _t(b, grad=True)
    y = fc.fused_downconv2(xt, wt, setup_filter(FIR), bt, None, gain, alpha)
    got = torch.autograd.grad(y, (xt, wt, bt), _t(g, TBF))[1]
    assert len(calls) == 1 and got.dtype == torch.float32
    _closer(got, want[BF], want[F32])
