"""The least-work weight cotangents of K3 (the up-conv's dw) and of the D
down-conv (ops/fused_conv.py `upconv2_dw`, `downconv2_dw`): the FIR applied
once to the full-resolution operand, then the small weight's stride-2 taps,
whose cotangent maps onto w with a flip alone.

`emulate` runs the CUDA kernel's order of operations (`fir_dw_kernel`) in
torch with exactly the operands the wrapper passes: the wrapper's channel
padding and slices, each 4 x 8 tile of the base grid staged with its raw
full-resolution tile (zero outside the image), the FIR run down the raw
tile, the taps taken from the filtered tile, one partial per slice in the
kernel's (c, o) layout, and the partials summed in order. It is held
against three references: the composed plain version (`conv_dw_plain` +
`_fold`, the plain route), `torch.autograd` of the plain forwards, and the
JAX package's `jax.vjp` of `fused_packed_upconv2` and `fused_packed_dconv2`
with respect to w (the in-kernel dw taps, run in interpret mode here, as
in tests/test_torch_adjoint_k3.py). kh 3 and 1, both `flip_weight` values,
with and without styles, non-square images, and single pixels on every
edge. Tolerance: 2e-5 of the largest entry, float32 (the same sums in
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
# fir_dw_kernel's tiles (csrc/fused_conv.cu kFdTH, kFdTW, kFdU, kFdV).
TH, TW, TU, TV = 4, 8, 32, 64


def _slices(ntiles, cu, cv):
    """The wrapper's slices (`_fir_dw_launch`): (slices, tiles per slice)."""
    per = -(-ntiles // max(1, min(ntiles, fc._FD_BLOCKS // ((cu // TU) * (cv // TV)))))
    return -(-ntiles // per), per


def emulate(src, base, s, fk, pad, kh):
    """`mgt_fir_dw` as the kernel runs it: src [N,2H,2W,U] filtered, base
    [N,H,W,V] (scaled by s [N,V]) -> the summed partials, [kh,kh,U,V]."""
    n, h, wd, cv = base.shape
    cu = src.shape[-1]
    pu, pv = -cu % TU, -cv % TV
    src, base = F.pad(src, (0, pu)), F.pad(base, (0, pv))
    s = None if s is None else F.pad(s, (0, pv))
    cu_, cv_ = cu + pu, cv + pv
    step = 1 if kh == 3 else 2
    rh, rw = 2 * TH + kh + 1, 2 * TW + kh + 1
    br, bc = (2 * TH + 1, 2 * TW + 1) if kh == 3 else (TH, TW)
    tiles_y, tiles_x = -(-h // TH), -(-wd // TW)
    ntiles = n * tiles_y * tiles_x
    slices, per = _slices(ntiles, cu_, cv_)
    # Zero outside the image: the raw tile and the base tile read a padded copy.
    srcp = F.pad(src, (0, 0, pad, rw, pad, rh))
    basep = F.pad(base, (0, 0, 0, TW, 0, TH))
    parts = []
    for sl in range(slices):
        acc = torch.zeros(kh, kh, cu_, cv_, dtype=src.dtype)
        for t in range(sl * per, min(ntiles, (sl + 1) * per)):
            tx, ty, nn = t % tiles_x, (t // tiles_x) % tiles_y, t // (tiles_x * tiles_y)
            raw = srcp[nn, 2 * TH * ty:2 * TH * ty + rh, 2 * TW * tx:2 * TW * tx + rw]
            bt = basep[nn, TH * ty:TH * (ty + 1), TW * tx:TW * (tx + 1)]
            if s is not None:
                bt = bt * s[nn]
            b = torch.zeros(br, bc, cu_, dtype=src.dtype)
            for iy in range(4):
                for ix in range(4):
                    b = b + fk[iy, ix] * raw[iy:iy + step * br:step, ix:ix + step * bc:step]
            for ta in range(kh):
                for tb in range(kh):
                    bs = b[ta:ta + 2 * TH:2, tb:tb + 2 * TW:2] if kh == 3 else b
                    acc[ta, tb] += torch.einsum("iju,ijv->uv", bs, bt)
        parts.append(acc)
    return torch.stack(parts).sum(0)[..., :cu, :cv]


def emulate_up(x, gd, styles, w, f, flip_weight, dw=emulate):
    """`upconv2_dw` on the card (or, with dw=fc.fir_dw_plain, in the
    least-work plain version): gd filtered, x (scaled) the base."""
    flip, fk, pad = fc.upconv2_dw_leastwork(w, f, flip_weight)
    dwk = dw(gd, x, styles, fk, pad, int(w.shape[0])).transpose(2, 3)
    return dwk.flip((0, 1)) if flip else dwk


def emulate_down(x, gz, w, f, flip_weight, dw=emulate):
    """`downconv2_dw` on the card (or, with dw=fc.fir_dw_plain, in the
    least-work plain version): x filtered, gz the base."""
    flip, fk, pad = fc.downconv2_dw_leastwork(w, f, flip_weight)
    dwk = dw(x, gz, None, fk, pad, int(w.shape[0]))
    return dwk.flip((0, 1)) if flip else dwk


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


@pytest.mark.parametrize("styles", [True, False])
@pytest.mark.parametrize("flip_weight", [False, True])
@pytest.mark.parametrize("kh", [3, 1])
def test_up_dw_matches_the_composed_plain_and_autograd(kh, flip_weight, styles):
    """K3-dw on a non-square image with a 4x4 FIR of no symmetry: the
    emulation and the least-work plain version against `conv_dw_plain` +
    `_fold` and against autograd of `upconv2_plain` (gain 1, alpha 1, no
    demodulation, so gd reaches the conv unchanged)."""
    n, h, wd, cin, cout = 2, 5, 11, 6, 36
    rng = np.random.RandomState(10 + kh)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    x, w = _t(_rand(rng, n, h, wd, cin)), _t(_rand(rng, kh, kh, cin, cout))
    s = _t((rng.rand(n, cin) + 0.5).astype(np.float32)) if styles else None
    gd = _t(_rand(rng, n, 2 * h, 2 * wd, cout))
    got = emulate_up(x, gd, s, w, f, flip_weight)
    want = fc.upconv2_dw_plain(x, gd, s, w, f, flip_weight)
    _rel_close(got, want)
    _rel_close(emulate_up(x, gd, s, w, f, flip_weight, dw=fc.fir_dw_plain), want)
    w_ = w.clone().requires_grad_(True)
    y = fc.upconv2_plain(x, w_, s, f, gain=1.0, alpha=1.0, demodulate=False,
                         flip_weight=flip_weight)
    _rel_close(got, torch.autograd.grad(y, w_, gd)[0])


@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_down_dw_matches_the_composed_plain_and_autograd(kh, flip_weight):
    """The D down-conv's dw on a non-square image with a 4x4 FIR of no
    symmetry: the emulation and the least-work plain version against
    `conv_dw_plain` + `_fold` and against autograd of `downconv2_plain`."""
    n, h, wd, cin, cout = 2, 6, 5, 40, 12
    rng = np.random.RandomState(20 + kh)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    x, w = _t(_rand(rng, n, 2 * h, 2 * wd, cin)), _t(_rand(rng, kh, kh, cin, cout))
    gz = _t(_rand(rng, n, h, wd, cout))
    got = emulate_down(x, gz, w, f, flip_weight)
    want = fc.downconv2_dw_plain(x, gz, w, f, flip_weight)
    _rel_close(got, want)
    _rel_close(emulate_down(x, gz, w, f, flip_weight, dw=fc.fir_dw_plain), want)
    w_ = w.clone().requires_grad_(True)
    y = fc.downconv2_plain(x, w_, f, gain=1.0, alpha=1.0, flip_weight=flip_weight)
    _rel_close(got, torch.autograd.grad(y, w_, gz)[0])


@pytest.mark.parametrize("flip_weight", [False, True])
@pytest.mark.parametrize("kh", [3, 1])
def test_up_dw_matches_jax_vjp(kh, flip_weight):
    """K3-dw against `jax.vjp` of `fused_packed_upconv2` w.r.t. (x, w, s),
    whose dw is the in-kernel taps of its adjoint launch (interpret mode)."""
    n, h, cin, cout = 1, 8, 64, 32
    rng = np.random.RandomState(30 + kh)
    x, w = _rand(rng, n, h, h, cin), _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * cin))
    s = (rng.rand(n, cin) + 0.5).astype(np.float32)
    g = _rand(rng, n, 2 * h, 2 * h, cout)

    def fwd(x_, w_, s_):
        y_ = jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128), w_, s_,
                                      jsetup_filter(FIR), None, None, 1.0, 1.0, False,
                                      flip_weight)
        return y_.reshape(n, 2 * h, 2 * h, cout)

    _, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w), jnp.asarray(s))
    want = vjp(jnp.asarray(g))[1]
    got = emulate_up(_t(x), _t(g), _t(s), _t(w), setup_filter(FIR), flip_weight)
    _rel_close(got, want)


@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_down_dw_matches_jax_vjp(kh, flip_weight):
    """The D down-conv's dw against `jax.vjp` of `fused_packed_dconv2`
    w.r.t. (x, w), whose dw is the block cotangent of K2's use_dw launch
    (interpret mode)."""
    n, h, cin, cout = 1, 16, 8, 16
    q = 128 // cin
    rng = np.random.RandomState(40 + kh)
    x, w = _rand(rng, n, h, h, cin), _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * cin))
    g = _rand(rng, n, h // 2, h // 2, cout)

    def fwd(x_, w_):
        y_ = jpc.fused_packed_dconv2(x_.reshape(n, h, h // q, q * cin), w_, jsetup_filter(FIR),
                                     None, None, 1.0, 1.0, flip_weight)
        return y_.reshape(n, h // 2, h // 2, cout)

    _, vjp = jax.vjp(fwd, jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))[1]
    got = emulate_down(_t(x), _t(g), _t(w), setup_filter(FIR), flip_weight)
    _rel_close(got, want)


def _edge_pixels(hh, ww):
    """The four corners, a pixel inside each edge, and one inside."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2)]


@pytest.mark.parametrize("operand", ["filtered", "base"])
@pytest.mark.parametrize("role", ["up", "down"])
@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_single_pixels_on_every_edge(kh, flip_weight, role, operand):
    """One non-zero pixel of one operand (the filtered one at full
    resolution, or the base one) at each corner and edge of a non-square
    image, the other operand random: the emulation against the composed
    plain version, a 4x4 FIR of no symmetry, so that a transposed or flipped
    dw shows even where its norm is right."""
    h, wd, cin, cout = 5, 9, 3, 2
    rng = np.random.RandomState(50 + kh)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    w = _t(_rand(rng, kh, kh, cin, cout))
    s = _t((rng.rand(1, cin) + 0.5).astype(np.float32))
    full_c, base_c = (cout, cin) if role == "up" else (cin, cout)
    hh, ww = (2 * h, 2 * wd) if operand == "filtered" else (h, wd)
    for py, px in _edge_pixels(hh, ww):
        full = _t(_rand(rng, 1, 2 * h, 2 * wd, full_c))
        base = _t(_rand(rng, 1, h, wd, base_c))
        one = full if operand == "filtered" else base
        keep = one[0, py, px].clone()
        one.zero_()
        one[0, py, px] = keep
        if role == "up":
            got = emulate_up(base, full, s, w, f, flip_weight)
            want = fc.upconv2_dw_plain(base, full, s, w, f, flip_weight)
        else:
            got = emulate_down(full, base, w, f, flip_weight)
            want = fc.downconv2_dw_plain(full, base, w, f, flip_weight)
        assert want.abs().max() > 0, (py, px)
        _rel_close(got, want)


@pytest.mark.parametrize("role", ["up", "down"])
def test_widths_off_the_tiles_and_several_slices(role, monkeypatch):
    """Channel counts the kernel's tiles (32 filtered, 64 base) do not
    divide, and a slice count small enough that each slice walks several
    tiles, through the emulation: the wrapper's padding and slicing."""
    monkeypatch.setattr(fc, "_FD_BLOCKS", 12)
    rng = np.random.RandomState(60)
    n, h, wd = 2, 9, 17
    f = setup_filter(FIR)
    assert _slices(n * 3 * 3, 64, 128) == (3, 6)        # 18 tiles, 2 x 2 channel tiles
    if role == "up":
        cin, cout = 68, 36
        x, gd = _t(_rand(rng, n, h, wd, cin)), _t(_rand(rng, n, 2 * h, 2 * wd, cout))
        s = _t((rng.rand(n, cin) + 0.5).astype(np.float32))
        w = _t(_rand(rng, 3, 3, cin, cout))
        _rel_close(emulate_up(x, gd, s, w, f, False), fc.upconv2_dw_plain(x, gd, s, w, f))
    else:
        cin, cout = 36, 68
        x, gz = _t(_rand(rng, n, 2 * h, 2 * wd, cin)), _t(_rand(rng, n, h, wd, cout))
        w = _t(_rand(rng, 3, 3, cin, cout))
        _rel_close(emulate_down(x, gz, w, f, True), fc.downconv2_dw_plain(x, gz, w, f))


def test_operands_in_each_role():
    """The operands as the kernel gets them: K3-dw filters gd with 4 f (the
    K3 adjoint's FIR) and flips dwk onto w when flip_weight; the down-conv
    filters x with flip(f) (K3-forward's FIR) and flips when not
    flip_weight; the pad is 2 for a 3x3 and 1 for a 1x1 in both roles."""
    f = setup_filter([1, 2, 3, 4])                               # not symmetric
    for kh, pad in ((3, 2), (1, 1)):
        w = torch.randn(kh, kh, 4, 8)
        for fw in (False, True):
            flip, fk, p = fc.upconv2_dw_leastwork(w, f, fw)
            assert flip == fw and torch.equal(fk, 4 * f) and p == pad
            flip, fk, p = fc.downconv2_dw_leastwork(w, f, fw)
            assert flip == (not fw) and torch.equal(fk, f.flip((0, 1))) and p == pad
    with pytest.raises(ValueError, match="4x4 FIR"):
        fc.upconv2_dw_leastwork(torch.randn(3, 3, 4, 8), setup_filter([1, 2, 1]))
    with pytest.raises(ValueError, match="4x4 FIR"):
        fc.downconv2_dw_leastwork(torch.randn(3, 3, 4, 8), None)


def test_wrappers_take_the_composed_plain_version_on_the_cpu():
    """On a CPU tensor `upconv2_dw` and `downconv2_dw` are the composed
    plain versions, bit for bit, and count no launch."""
    rng = np.random.RandomState(70)
    f = setup_filter(FIR)
    x, gd, s = _t(_rand(rng, 1, 4, 6, 8)), _t(_rand(rng, 1, 8, 12, 4)), _t(_rand(rng, 1, 8))
    w = _t(_rand(rng, 3, 3, 8, 4))
    before = dict(fc.launch_counts)
    assert torch.equal(fc.upconv2_dw(x, gd, s, w, f), fc.upconv2_dw_plain(x, gd, s, w, f))
    xd, gz = _t(_rand(rng, 1, 8, 12, 4)), _t(_rand(rng, 1, 4, 6, 8))
    wd = _t(_rand(rng, 1, 1, 4, 8))
    assert torch.equal(fc.downconv2_dw(xd, gz, wd, f), fc.downconv2_dw_plain(xd, gz, wd, f))
    assert dict(fc.launch_counts) == before


@pytest.mark.parametrize("role", ["K3-dw", "K2-use_dw-dw"])
@pytest.mark.parametrize("kh", [3, 1])
def test_same_function_yardstick_is_the_plain_cotangent(kh, role):
    """The one PyTorch call that chip_smoke.py and bench_dw time beside each
    dw role (`conv2d_weight` of the FIR-composed kernel at stride 2), folded
    onto w, gives that role's composed plain cotangent."""
    from morphganformer_tpu_torch.bench_dw import same_function_dw_call

    rng = np.random.RandomState(80)
    h, wd, ci, co = 5, 7, 6, 4
    f = setup_filter(rng.rand(4, 4) + 0.1)
    w = _t(_rand(rng, kh, kh, ci, co))
    flip_weight = role == "K2-use_dw-dw"
    call, fold = same_function_dw_call(role, w, f, flip_weight)
    if role == "K3-dw":
        x, s = _t(_rand(rng, 2, h, wd, ci)), _t((rng.rand(2, ci) + 0.5).astype(np.float32))
        gd = _t(_rand(rng, 2, 2 * h, 2 * wd, co))
        got = fold(call(gd.permute(0, 3, 1, 2), (x * s[:, None, None, :]).permute(0, 3, 1, 2)))
        want = fc.upconv2_dw_plain(x, gd, s, w, f, flip_weight)
    else:
        x, gz = _t(_rand(rng, 2, 2 * h, 2 * wd, ci)), _t(_rand(rng, 2, h, wd, co))
        got = fold(call(x.permute(0, 3, 1, 2), gz.permute(0, 3, 1, 2)))
        want = fc.downconv2_dw_plain(x, gz, w, f, flip_weight)
    _rel_close(got, want)
