"""K1's weight cotangent on the least-work kernel (ops/fused_conv.py
`conv_dw`, csrc/fused_conv.cu `conv_dw_lw_kernel`), its walk emulated in
torch.

`emulate` runs the kernel's order of operations with exactly the operands
the wrapper passes: the wrapper's channel padding (C and O to 32) and gd
channel tile (`k1_dw_ot`: 64 where it divides O, else 32), its slices
(`dw_slices`), each TH x 16 tile of the image staged with x's 1-pixel
halo (zero outside the image) and gd zero past the image's edge, x scaled
by s once it is staged, all nine taps taken from the staged tile, at OT 32
the tile's two bands of 4 rows summed apart and added band 0 + band 1, one
partial per slice in the kernel's (c, o) layout, and the partials summed
in order. It is held against `conv_dw_plain` (the plain route), against
autograd of the plain forward, and against the JAX package's weight
cotangent of `fused_modconv3x3_lrelu` (its in-kernel dw taps, run in
interpret mode here, as tests/test_packed_dw.py runs it), with and without
styles and demodulation, at non-square, ragged sizes and widths off the
tiles, and with single pixels on every edge for each tap. Tolerance: 2e-5
of the largest entry, float32 (the same sums in another order)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu_torch.ops import fused_conv as fc

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-5
# conv_dw_lw_kernel's tiles (csrc/fused_conv.cu kCdTW, kCdR, kCdC).
TW, R, TC = 16, 4, 32


def tiling(co):
    """(OT, TH, bands) of a launch whose gd has co (padded) channels."""
    ot = fc.k1_dw_ot(co)
    bands = 64 // ot
    return ot, R * bands, bands


def emulate(x, gd, s):
    """`conv_dw` on the card: x [N,H,W,C], gd [N,H,W,O], s [N,C] or None ->
    the summed partials, [3,3,C,O]."""
    n, h, wd, ci = x.shape
    co = gd.shape[-1]
    pc, po = -ci % TC, -co % TC
    x, gd = F.pad(x, (0, pc)), F.pad(gd, (0, po))
    s = None if s is None else F.pad(s, (0, pc))
    ci_, co_ = ci + pc, co + po
    ot, th, bands = tiling(co_)
    tiles_y, tiles_x = -(-h // th), -(-wd // TW)
    ntiles = n * tiles_y * tiles_x
    slices, per = fc.dw_slices(ntiles, (ci_ // TC) * (co_ // ot))
    assert (slices - 1) * per < ntiles <= slices * per
    # Zero outside the image: the staged tiles read padded copies.
    xp = F.pad(x, (0, 0, 1, TW + 1, 1, th + 1))
    gp = F.pad(gd, (0, 0, 0, TW, 0, th))
    parts = []
    for sl in range(slices):
        acc = torch.zeros(bands, 9, ci_, co_, dtype=x.dtype)
        for t in range(sl * per, min(ntiles, (sl + 1) * per)):
            tx, ty, nn = t % tiles_x, (t // tiles_x) % tiles_y, t // (tiles_x * tiles_y)
            xt = xp[nn, th * ty:th * ty + th + 2, TW * tx:TW * tx + TW + 2]
            if s is not None:
                xt = xt * s[nn]
            gt = gp[nn, th * ty:th * (ty + 1), TW * tx:TW * (tx + 1)]
            for b in range(bands):
                rows = slice(R * b, R * (b + 1))
                for ta in range(3):
                    for tb in range(3):
                        xs = xt[R * b + ta:R * (b + 1) + ta, tb:tb + TW]
                        acc[b, 3 * ta + tb] += torch.einsum("ijc,ijo->co", xs, gt[rows])
        part = acc[0]
        for b in range(1, bands):
            part = part + acc[b]
        parts.append(part.reshape(3, 3, ci_, co_))
    return torch.stack(parts).sum(0)[..., :ci, :co]


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (n, h, w, cin, cout, styles): OT 32 (8 x 16 tiles, two bands) and 64
# (4 x 16), tiles that divide the image and tiles that do not, images
# smaller than a tile, widths off the 32-wide channel tiles (padded), three
# gd channel tiles of 32, and D conv0's form without styles.
CASES = [
    (2, 16, 16, 32, 32, True), (2, 8, 32, 64, 64, True), (1, 13, 21, 32, 32, False),
    (2, 9, 11, 64, 32, True), (3, 5, 7, 32, 64, False), (1, 7, 18, 36, 100, True),
    (1, 6, 17, 96, 96, True), (2, 11, 5, 8, 12, True),
]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_plain_and_autograd(case):
    """The emulated walk against `conv_dw_plain` and against autograd of the
    plain modulated conv (demodulation off, linear, so gd reaches the conv
    unchanged)."""
    n, h, w, ci, co, styles = case
    rng = np.random.RandomState(sum(case))
    x, g = _t(_rand(rng, n, h, w, ci)), _t(_rand(rng, n, h, w, co))
    s = _t((rng.rand(n, ci) + 0.5).astype(np.float32)) if styles else None
    got = emulate(x, g, s)
    want = fc.conv_dw_plain(x, g, s, 1, 1, 3, (0, 0))[0]
    _rel_close(got, want)
    wt = torch.from_numpy(_rand(rng, 3, 3, ci, co)).requires_grad_(True)
    y = fc.modconv3x3_plain(x, wt, s, gain=1.0, alpha=1.0, demodulate=False)
    _rel_close(got, torch.autograd.grad(y, wt, g)[0])


def test_slices_walk_several_tiles(monkeypatch):
    """A slice count small enough that each slice walks several tiles, the
    last one short, at both gd channel tiles."""
    monkeypatch.setattr(fc, "_FD_BLOCKS", 8)
    rng = np.random.RandomState(5)
    for n, h, w, ci, co in ((2, 17, 35, 64, 64), (1, 21, 35, 32, 32)):
        ot, th, _ = tiling(co)
        ntiles = n * -(-h // th) * -(-w // TW)
        slices, per = fc.dw_slices(ntiles, (ci // TC) * (co // ot))
        assert slices > 1 and per > 1 and ntiles % per
        x, g = _t(_rand(rng, n, h, w, ci)), _t(_rand(rng, n, h, w, co))
        s = _t((rng.rand(n, ci) + 0.5).astype(np.float32))
        _rel_close(emulate(x, g, s), fc.conv_dw_plain(x, g, s, 1, 1, 3, (0, 0))[0])


def test_tiling_and_slices():
    """The wrapper's choices as the kernel takes them: OT 64 where 64
    divides O, else 32; one wave of `_FD_BLOCKS` blocks over the channel
    tiles, every slice non-empty, at the 1024^2 call shapes at batch 4."""
    assert [fc.k1_dw_ot(c) for c in (32, 64, 96, 128, 160)] == [32, 64, 32, 64, 32]
    for res, c in ((256, 128), (512, 64), (1024, 32)):
        ot, th, _ = tiling(c)
        ntiles = 4 * -(-res // th) * -(-res // TW)
        groups = (c // TC) * (c // ot)
        slices, per = fc.dw_slices(ntiles, groups)
        assert slices * groups <= fc._FD_BLOCKS and (slices - 1) * per < ntiles <= slices * per
        assert slices * groups >= fc._FD_BLOCKS - groups


def _jax_dw(x, w, s, g, gain, alpha, demod, noise=None, bias=None):
    """The w-cotangent of JAX's `fused_modconv3x3_lrelu` with x, w and s all
    differentiated, so the adjoint launch runs and dw comes from its
    in-kernel taps (interpret mode)."""
    j = lambda t: None if t is None else jnp.asarray(t)                          # noqa: E731
    _, vjp = jax.vjp(lambda x_, w_, s_: jpc.fused_modconv3x3_lrelu(
        x_, w_, s_, j(noise), j(bias), None, gain, alpha, demod), j(x), j(w), j(s))
    return np.array(vjp(j(g))[1])


@pytest.mark.parametrize("n,h,w,ci,co", [(2, 16, 16, 8, 8), (1, 9, 20, 36, 40)])
def test_emulation_matches_jax_dw_taps(n, h, w, ci, co):
    """Demodulation off, linear: the cotangent of w is the dw taps alone,
    emulated, against JAX's."""
    rng = np.random.RandomState(10 + ci)
    x, g = _rand(rng, n, h, w, ci), _rand(rng, n, h, w, co)
    wt = _rand(rng, 3, 3, ci, co, scale=1 / math.sqrt(9 * ci))
    s = (rng.rand(n, ci) + 0.5).astype(np.float32)
    _rel_close(emulate(_t(x), _t(g), _t(s)), _jax_dw(x, wt, s, g, 1.0, 1.0, False))


def test_k1_backward_with_emulated_taps_matches_jax(monkeypatch):
    """The whole w-cotangent of K1 as training forms it (demodulation,
    noise, bias, lrelu): `FusedModConv3x3`'s backward with the dw taps
    replaced by the emulated kernel, then the demodulation term in torch,
    against JAX's."""
    rng = np.random.RandomState(20)
    n, h, w, ci, co = 2, 16, 16, 8, 8
    x, g = _rand(rng, n, h, w, ci), _rand(rng, n, h, w, co)
    wt = _rand(rng, 3, 3, ci, co, scale=1 / math.sqrt(9 * ci))
    s = (rng.rand(n, ci) + 0.5).astype(np.float32)
    noise, bias = _rand(rng, h, w, scale=0.1), _rand(rng, co, scale=0.1)
    calls = []

    def taps(x_, gd_, s_):
        calls.append(1)
        return emulate(x_, gd_, s_)
    monkeypatch.setattr(fc, "conv_dw", taps)
    ins = [_t(a).clone().requires_grad_(True) for a in (x, wt, s)]
    y = fc.fused_modconv3x3(ins[0], ins[1], ins[2], _t(noise), _t(bias), None, math.sqrt(2), 0.2)
    got = torch.autograd.grad(y, ins[1], _t(g))[0]
    assert calls == [1]
    _rel_close(got, _jax_dw(x, wt, s, g, math.sqrt(2), 0.2, True, noise, bias))


def _edge_pixels(hh, ww):
    """The four corners, a pixel inside each edge, and one inside."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2)]


@pytest.mark.parametrize("operand", ["x", "gd"])
@pytest.mark.parametrize("co", [32, 64])
def test_single_pixels_on_every_edge_for_every_tap(co, operand):
    """One non-zero pixel of x or of gd at each corner and edge of a
    non-square image the tiles do not divide, the other operand random:
    each of the nine taps of the emulation is the plain version's, exactly
    zero where the tap reaches outside the image from that pixel, so a tap
    read from the wrong side of the halo, or a transposed or flipped dw,
    shows even where its norm is right."""
    h, w, ci = 11, 19, 4
    rng = np.random.RandomState(30 + co)
    s = _t((rng.rand(1, ci) + 0.5).astype(np.float32))
    for py, px in _edge_pixels(h, w):
        x, g = _t(_rand(rng, 1, h, w, ci)), _t(_rand(rng, 1, h, w, co))
        one = x if operand == "x" else g
        keep = one[0, py, px].clone()
        one.zero_()
        one[0, py, px] = keep
        got, want = emulate(x, g, s), fc.conv_dw_plain(x, g, s, 1, 1, 3, (0, 0))[0]
        # The taps that reach a pixel of the other operand from this one.
        live = np.zeros((3, 3), bool)
        for ta in range(3):
            for tb in range(3):
                d = 1 if operand == "x" else -1
                live[ta, tb] = 0 <= py + d * (1 - ta) < h and 0 <= px + d * (1 - tb) < w
        assert np.array_equal(want.abs().sum((2, 3)).numpy() > 0, live), (py, px)
        assert np.array_equal(got.abs().sum((2, 3)).numpy() > 0, live), (py, px)
        for ta in range(3):
            for tb in range(3):
                if live[ta, tb]:
                    _rel_close(got[ta, tb], want[ta, tb])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor `conv_dw` is `conv_dw_plain`, bit for bit, at widths
    on and off the tiles, with and without styles, and counts no launch."""
    rng = np.random.RandomState(40)
    before = dict(fc.launch_counts)
    for ci, co, styles in ((32, 64, True), (12, 20, False)):
        x, g = _t(_rand(rng, 2, 5, 7, ci)), _t(_rand(rng, 2, 5, 7, co))
        s = _t((rng.rand(2, ci) + 0.5).astype(np.float32)) if styles else None
        assert torch.equal(fc.conv_dw(x, g, s), fc.conv_dw_plain(x, g, s, 1, 1, 3, (0, 0))[0])
    assert dict(fc.launch_counts) == before


def test_same_function_yardstick_is_the_plain_cotangent():
    """The one PyTorch call that chip_smoke.py and bench_k1dw time beside
    K1's dw (`conv2d_weight` of x * s and gd, the multiply included) gives
    `conv_dw_plain`'s cotangent, in [O, C, 3, 3]."""
    from morphganformer_tpu_torch.bench_k1dw import same_function_call

    rng = np.random.RandomState(50)
    x, g = _t(_rand(rng, 2, 6, 9, 8)), _t(_rand(rng, 2, 6, 9, 12))
    for s in (_t((rng.rand(2, 8) + 0.5).astype(np.float32)), None):
        got = same_function_call(x, g, s)().permute(2, 3, 1, 0)
        _rel_close(got, fc.conv_dw_plain(x, g, s, 1, 1, 3, (0, 0))[0])
