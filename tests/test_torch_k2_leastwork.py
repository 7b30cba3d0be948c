"""K2's least-work operands (ops/fused_conv.py `upconv2_leastwork`,
`downconv2_adjoint_leastwork`): the small weight in the role's orientation,
the 4x4 FIR and the pad that the CUDA kernel takes in both of its roles.

`emulate` runs the kernel's function in torch with exactly those operands:
a zero-insert, a kh x kh correlation (the stride-2 transposed conv), then
the FIR at output resolution. It is held against the composed plain
versions (`upconv2_plain`, `downconv2_adjoint_plain`), against the JAX
package's `fused_packed_upconv2` and against the VJP of
`fused_packed_dconv2` with respect to x (the JAX launches run in interpret
mode here, as in tests/test_torch_k3_leastwork.py), for kh 3 and 1 and both
`flip_weight` values, and at single pixels on every edge of a non-square
image with a FIR of no symmetry.

`emulate_tiled` follows the kernel's tile loop (csrc/fused_conv.cu,
`upconv2_lw_kernel`): each output tile is computed from its own x tile only
(one base row and column of halo on each side), through the kernel's four
Z values per cell (AA, AB, BA, BB, or AA alone for the 1x1) and its FIR
over the interleaved Z tile. It must equal `emulate` at tile sizes that do
and do not divide the image, which pins the halo on the CPU.

Tolerance: 2e-5 of the output's largest entry, float32 (the same sums in
another order)."""

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

from .test_torch_kernels_cuda import FIR, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-5


def _zero_insert(x):
    """[N,H,W,C] -> NCHW [N,C,2H,2W] with x at the even positions."""
    n, h, w, c = x.shape
    xz = x.new_zeros(n, c, 2 * h, 2 * w)
    xz[:, :, ::2, ::2] = x.permute(0, 3, 1, 2)
    return xz


def emulate(x, wk, fk, pad):
    """Z[q] = sum_a wk[a] xz[q - a] (xz the zero-inserted x), then y[o] =
    sum_i fk[i] Z[o + i - pad], each spatial dimension.
    x [N,H,W,I]; wk [kh,kh,I,O]; fk [4,4] -> [N,2H,2W,O]."""
    kh, co = wk.shape[0], wk.shape[-1]
    lo = pad + kh - 1                   # Z from q = -pad to 2H + 2 - pad
    xp = F.pad(_zero_insert(x), (lo, 3 - pad, lo, 3 - pad))
    z = F.conv2d(xp, wk.flip((0, 1)).permute(3, 2, 0, 1))
    return F.conv2d(z, fk.expand(co, 1, 4, 4), groups=co).permute(0, 2, 3, 1)


def _cells(xt, wk):
    """The kernel's Z tile from an x tile [N, th+2, tw+2, I]: KH 3 gives the
    interleaved [N, 2th+3, 2tw+3, O] of the four values per cell, KH 1 the
    A values [N, th+2, tw+2, O]."""
    mm = lambda t, a, b: t @ wk[a, b]                                   # noqa: E731
    if wk.shape[0] == 1:
        return mm(xt, 0, 0)
    n, r, c, _ = xt.shape
    z = xt.new_zeros(n, 2 * r - 1, 2 * c - 1, wk.shape[-1])
    x00, x01, x10, x11 = xt[:, :-1, :-1], xt[:, :-1, 1:], xt[:, 1:, :-1], xt[:, 1:, 1:]
    z[:, 0::2, 0::2] = mm(xt, 1, 1)                                                 # AA
    z[:, 0::2, 1::2] = mm(xt[:, :, 1:], 1, 0) + mm(xt[:, :, :-1], 1, 2)             # AB
    z[:, 1::2, 0::2] = mm(xt[:, 1:], 0, 1) + mm(xt[:, :-1], 2, 1)                   # BA
    z[:, 1::2, 1::2] = mm(x11, 0, 0) + mm(x10, 0, 2) + mm(x01, 2, 0) + mm(x00, 2, 2)  # BB
    return z


def _fir_tile(z, fk, th, tw, kh):
    """The 2th x 2tw outputs of one tile from its Z tile."""
    out = z.new_zeros(z.shape[0], 2 * th, 2 * tw, z.shape[-1])
    for ly in range(2 * th):
        for lx in range(2 * tw):
            if kh == 3:
                out[:, ly, lx] = torch.einsum("ij,nijo->no", fk, z[:, ly:ly + 4, lx:lx + 4])
            else:
                py, px, ay, ax = ly & 1, lx & 1, ly // 2 + (ly & 1), lx // 2 + (lx & 1)
                for i in range(2):
                    for j in range(2):
                        out[:, ly, lx] += fk[py + 2 * i, px + 2 * j] * z[:, ay + i, ax + j]
    return out


def emulate_tiled(x, wk, fk, pad, th, tw):
    """`emulate` as the kernel computes it, tile by tile: th x tw base
    positions per tile, each from the x rows ty0-1 ... ty0+th and columns
    tx0-1 ... tx0+tw only (zero outside the image)."""
    kh = wk.shape[0]
    assert pad == (1 if kh == 3 else 2)
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, tw + 1, 1, th + 1))     # x[r][c] at xp[r+1][c+1]
    y = x.new_zeros(n, 2 * h, 2 * w, wk.shape[-1])
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            z = _cells(xp[:, ty0:ty0 + th + 2, tx0:tx0 + tw + 2], wk)
            tile = _fir_tile(z, fk, th, tw, kh)
            ry, rx = min(2 * th, 2 * (h - ty0)), min(2 * tw, 2 * (w - tx0))
            y[:, 2 * ty0:2 * ty0 + ry, 2 * tx0:2 * tx0 + rx] = tile[:, :ry, :rx]
    return y


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("flip_weight", [False, True])
@pytest.mark.parametrize("kh", [3, 1])
def test_forward_operands_match_plain_and_jax(kh, flip_weight):
    n, h, cin, cout = 1, 8, 64, 32
    rng = np.random.RandomState(0)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter(FIR)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = emulate(xt, *fc.upconv2_leastwork(wt, f, flip_weight))
    _rel_close(got, fc.upconv2_plain(xt, wt, None, f, gain=1.0, alpha=1.0, demodulate=False,
                                     flip_weight=flip_weight))
    y = jpc.fused_packed_upconv2(jnp.asarray(x).reshape(n, h, h * cin // 128, 128),
                                 jnp.asarray(w), None, jsetup_filter(FIR), None, None, 1.0, 1.0,
                                 False, flip_weight)
    _rel_close(got, np.asarray(y).reshape(n, 2 * h, 2 * h, cout))


@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_use_dw_operands_match_plain_and_jax_vjp(kh, flip_weight):
    n, h, cin, cout = 2, 16, 8, 16
    q = 128 // cin
    rng = np.random.RandomState(1)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    gz = _rand(rng, n, h // 2, h // 2, cout)
    f = setup_filter(FIR)
    wt, gt = torch.from_numpy(w), torch.from_numpy(gz)
    got = emulate(gt, *fc.downconv2_adjoint_leastwork(wt, f, flip_weight))
    _rel_close(got, fc.downconv2_adjoint_plain(gt, wt, f, flip_weight))

    def fwd(x_):
        # gain 1, alpha 1, no bias: the cotangent reaches the conv unchanged.
        y = jpc.fused_packed_dconv2(x_.reshape(n, h, h // q, q * cin), jnp.asarray(w),
                                    jsetup_filter(FIR), None, None, 1.0, 1.0, flip_weight)
        return y.reshape(n, h // 2, h // 2, cout)

    _, vjp = jax.vjp(fwd, jnp.asarray(x))
    _rel_close(got, vjp(jnp.asarray(gz))[0])


@pytest.mark.parametrize("tile", [(2, 4), (6, 16)])
@pytest.mark.parametrize("role", ["forward", "use_dw"])
@pytest.mark.parametrize("kh", [3, 1])
def test_tiled_emulation_equals_the_whole(kh, role, tile):
    """The kernel's tile loop (each tile from its own halo, the four Z
    values per cell, the FIR over the interleaved Z tile) against
    `emulate`, on a 7 x 11 base image that neither tile divides, and one
    the small tile does; a FIR with no symmetry."""
    rng = np.random.RandomState(4)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    ci, co = 3, 5
    for h, wd in ((7, 11), (6, 8)):
        x = torch.from_numpy(_rand(rng, 2, h, wd, ci))
        for flip_weight in (False, True):
            if role == "forward":
                ops = fc.upconv2_leastwork(torch.from_numpy(_rand(rng, kh, kh, ci, co)), f,
                                           flip_weight)
            else:
                ops = fc.downconv2_adjoint_leastwork(
                    torch.from_numpy(_rand(rng, kh, kh, co, ci)), f, flip_weight)
            _rel_close(emulate_tiled(x, *ops, *tile), emulate(x, *ops))


def _edge_pixels(hh, ww):
    """The four corners, a pixel inside each edge, and one inside."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2)]


@pytest.mark.parametrize("role", ["forward", "use_dw"])
@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_single_pixels_on_every_edge(kh, flip_weight, role):
    """A single non-zero input pixel (x for the forward, the cotangent gz
    for the use_dw role) at each corner and edge of a 5 x 7 base image,
    through the emulation and its tiled form against the composed plain
    version: every output it reaches, and none other. The FIR is a 4x4 with
    no symmetry, so that each flip of it shows."""
    h, wd, cin, cout = 5, 7, 3, 2
    rng = np.random.RandomState(2)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    w = torch.from_numpy(_rand(rng, kh, kh, cin, cout))
    for py, px in _edge_pixels(h, wd):
        if role == "forward":
            inp = torch.zeros(1, h, wd, cin)
            inp[0, py, px] = torch.from_numpy(_rand(rng, cin))
            ops = fc.upconv2_leastwork(w, f, flip_weight)
            want = fc.upconv2_plain(inp, w, None, f, gain=1.0, alpha=1.0, demodulate=False,
                                    flip_weight=flip_weight)
        else:
            wd_ = w.transpose(2, 3).contiguous()               # down-conv 2 -> 3, gz has 3
            inp = torch.zeros(1, h, wd, cin)
            inp[0, py, px] = torch.from_numpy(_rand(rng, cin))
            ops = fc.downconv2_adjoint_leastwork(wd_, f, flip_weight)
            want = fc.downconv2_adjoint_plain(inp, wd_, f, flip_weight)
        got = emulate(inp, *ops)
        assert want.abs().max() > 0, (py, px)
        _rel_close(got, want)
        _rel_close(emulate_tiled(inp, *ops, 2, 4), want)
        assert torch.equal(got != 0, want != 0), (py, px)


def test_operands_in_each_role():
    """The operands as the kernel gets them: the G's up-conv (flip_weight
    False) takes w as it is and 4 times the flipped FIR; the D down-conv's
    dx (flip_weight True) takes w with I and O swapped and the FIR as it is;
    the pad is 1 for a 3x3 and 2 for a 1x1 in both roles."""
    f = setup_filter([1, 2, 3, 4])                               # not symmetric
    for kh, pad in ((3, 1), (1, 2)):
        w = torch.randn(kh, kh, 4, 8)
        wk, fk, p = fc.upconv2_leastwork(w, f)
        assert torch.equal(wk, w) and torch.equal(fk, 4 * f.flip((0, 1))) and p == pad
        wk, _, p = fc.upconv2_leastwork(w, f, flip_weight=True)
        assert torch.equal(wk, w.flip((0, 1))) and p == pad
        wk, fk, p = fc.downconv2_adjoint_leastwork(w, f)
        assert torch.equal(wk, w.transpose(2, 3)) and torch.equal(fk, f) and p == pad
        wk, _, p = fc.downconv2_adjoint_leastwork(w, f, flip_weight=False)
        assert torch.equal(wk, w.flip((0, 1)).transpose(2, 3)) and p == pad


def test_what_the_kernel_does_not_take_raises():
    """No FIR, a FIR that is not 4x4, a 2x2 weight, and channel counts not
    in fours raise before any launch."""
    w = torch.randn(3, 3, 4, 8)
    for f in (None, setup_filter([1, 2, 1])):
        with pytest.raises(ValueError, match="4x4 FIR"):
            fc.upconv2_leastwork(w, f)
        with pytest.raises(ValueError, match="4x4 FIR"):
            fc.downconv2_adjoint_leastwork(w, f)
    f = setup_filter(FIR)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="in fours"):
        fc._lw_weights(*fc.upconv2_leastwork(torch.randn(3, 3, 4, 6), f)[:2], cpu)
    with pytest.raises(ValueError, match="in fours"):
        fc._lw_weights(*fc.downconv2_adjoint_leastwork(torch.randn(1, 1, 6, 8), f)[:2], cpu)
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        fc._lw_weights(torch.randn(2, 2, 4, 8), f, cpu)
