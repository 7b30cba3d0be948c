"""K3's least-work operands (ops/fused_conv.py `downconv2_leastwork`,
`upconv2_adjoint_leastwork`): the small weight in the role's orientation,
the 4x4 FIR and the pad of the composed correlation that the CUDA kernel
takes in both of its roles.

`emulate` runs the kernel's order of operations in torch with exactly those
operands: the FIR over the zero-padded input at every input position, then a
stride-2 correlation with the small weight. It is held against the composed
plain versions (`downconv2_plain`, `upconv2_adjoint_plain`), against the
JAX package's `fused_packed_dconv2` and against the VJP of
`fused_packed_upconv2` (the JAX launches run in interpret mode here, as in
tests/test_torch_adjoint_k3.py), for kh 3 and 1 and both `flip_weight`
values, and at single pixels on every edge of a non-square image.
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


def emulate(inp, wk, fk, pad):
    """out[m] = sum_a wk[a] B[2m + a] with B[p] = sum_i fk[i] inp[p + i - pad]
    (each spatial dimension; inp zero outside the image).
    inp [N,2H,2W,I]; wk [kh,kh,I,O]; fk [4,4] -> [N,H,W,O]."""
    ci, kh = inp.shape[-1], wk.shape[0]
    hi = kh + 2 - pad
    xp = F.pad(inp.permute(0, 3, 1, 2), (pad, hi, pad, hi))
    b = F.conv2d(xp, fk.expand(ci, 1, 4, 4), groups=ci)
    return F.conv2d(b, wk.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)


def _rel_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_forward_operands_match_plain_and_jax(kh, flip_weight):
    n, h, cin, cout = 2, 16, 8, 16
    q = 128 // cin
    rng = np.random.RandomState(0)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter(FIR)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = emulate(xt, *fc.downconv2_leastwork(wt, f, flip_weight))
    _rel_close(got, fc.downconv2_plain(xt, wt, f, gain=1.0, alpha=1.0, flip_weight=flip_weight))
    y = jpc.fused_packed_dconv2(jnp.asarray(x).reshape(n, h, h // q, q * cin), jnp.asarray(w),
                                jsetup_filter(FIR), None, None, 1.0, 1.0, flip_weight)
    _rel_close(got, np.asarray(y).reshape(n, h // 2, h // 2, cout))


@pytest.mark.parametrize("flip_weight", [False, True])
@pytest.mark.parametrize("kh", [3, 1])
def test_adjoint_operands_match_plain_and_jax_vjp(kh, flip_weight):
    n, h, cin, cout = 1, 8, 64, 32
    rng = np.random.RandomState(1)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    g = _rand(rng, n, 2 * h, 2 * h, cout)
    f = setup_filter(FIR)
    xt, wt, gt = (torch.from_numpy(a) for a in (x, w, g))
    got = emulate(gt, *fc.upconv2_adjoint_leastwork(wt, f, flip_weight))
    # gain 1, alpha 1, no styles: the cotangent reaches the conv unchanged.
    y = fc.upconv2_plain(xt, wt, None, f, gain=1.0, alpha=1.0, demodulate=False,
                         flip_weight=flip_weight)
    want = fc.upconv2_adjoint_plain(gt, xt, wt, None, f, y, gain=1.0, alpha=1.0,
                                    demodulate=False, flip_weight=flip_weight)[0]
    _rel_close(got, want)

    def fwd(x_):
        y_ = jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128), jnp.asarray(w), None,
                                      jsetup_filter(FIR), None, None, 1.0, 1.0, False, flip_weight)
        return y_.reshape(n, 2 * h, 2 * h, cout)

    _, vjp = jax.vjp(fwd, jnp.asarray(x))
    _rel_close(got, vjp(jnp.asarray(g))[0])


def _edge_pixels(hh, ww):
    """The four corners, a pixel inside each edge, and one inside."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2)]


@pytest.mark.parametrize("role", ["forward", "adjoint"])
@pytest.mark.parametrize("flip_weight", [True, False])
@pytest.mark.parametrize("kh", [3, 1])
def test_single_pixels_on_every_edge(kh, flip_weight, role):
    """A single non-zero input pixel (x for the forward, the cotangent gd
    for the adjoint) at each corner and edge of a 10 x 14 image, through the
    emulation against the composed plain version: every output it reaches,
    and none other. The FIR is a 4x4 with no symmetry, so that each flip
    of it shows."""
    h, wd, cin, cout = 5, 7, 3, 2
    rng = np.random.RandomState(2)
    f = setup_filter(rng.rand(4, 4) + 0.1)
    w = torch.from_numpy(_rand(rng, kh, kh, cin, cout))
    x = torch.from_numpy(_rand(rng, 1, h, wd, cin))
    for py, px in _edge_pixels(2 * h, 2 * wd):
        if role == "forward":
            inp = torch.zeros(1, 2 * h, 2 * wd, cin)
            inp[0, py, px] = torch.from_numpy(_rand(rng, cin))
            got = emulate(inp, *fc.downconv2_leastwork(w, f, flip_weight))
            want = fc.downconv2_plain(inp, w, f, gain=1.0, alpha=1.0, flip_weight=flip_weight)
        else:
            wt = w.transpose(2, 3).contiguous()                  # [kh,kh,2,3]: up-conv 2 -> 3
            gd = torch.zeros(1, 2 * h, 2 * wd, cin)
            gd[0, py, px] = torch.from_numpy(_rand(rng, cin))
            got = emulate(gd, *fc.upconv2_adjoint_leastwork(wt, f, flip_weight))
            xs = torch.from_numpy(_rand(rng, 1, h, wd, cout))
            y = fc.upconv2_plain(xs, wt, None, f, gain=1.0, alpha=1.0, demodulate=False,
                                 flip_weight=flip_weight)
            want = fc.upconv2_adjoint_plain(gd, xs, wt, None, f, y, gain=1.0, alpha=1.0,
                                            demodulate=False, flip_weight=flip_weight)[0]
        assert want.abs().max() > 0, (py, px)
        _rel_close(got, want)
        assert torch.equal(got != 0, want != 0), (py, px)


@pytest.mark.parametrize("role", ["K3-forward", "K3-adjoint", "K2", "K2-use_dw"])
@pytest.mark.parametrize("kh", [3, 1])
def test_same_function_yardstick_is_the_plain_convolution(kh, role):
    """The one PyTorch call that chip_smoke.py and bench_k3 time beside each
    K2/K3 role computes that role's convolution: against the plain version
    with gain 1, alpha 1 and no styles, 2e-5 of the largest entry."""
    from morphganformer_tpu_torch.bench_k3 import same_function_call

    rng = np.random.RandomState(3)
    h, wd, ci, co = 5, 7, 6, 4
    f = setup_filter(rng.rand(4, 4) + 0.1)
    flip_weight = role in ("K3-forward", "K2-use_dw")
    w = torch.from_numpy(_rand(rng, kh, kh, ci, co))
    op, weight, pad = same_function_call(role, w, f, flip_weight)
    if role == "K3-forward":
        t = torch.from_numpy(_rand(rng, 2, 2 * h, 2 * wd, ci))
        want = fc.downconv2_plain(t, w, f, gain=1.0, alpha=1.0, flip_weight=flip_weight)
    elif role == "K2-use_dw":
        t = torch.from_numpy(_rand(rng, 2, h, wd, co))
        want = fc.downconv2_adjoint_plain(t, w, f, flip_weight)
    elif role == "K2":
        t = torch.from_numpy(_rand(rng, 2, h, wd, ci))
        want = fc.upconv2_plain(t, w, None, f, gain=1.0, alpha=1.0, demodulate=False,
                                flip_weight=flip_weight)
    else:
        t = torch.from_numpy(_rand(rng, 2, 2 * h, 2 * wd, co))
        x = torch.zeros(2, h, wd, ci)
        y = fc.upconv2_plain(x, w, None, f, gain=1.0, alpha=1.0, demodulate=False)
        want = fc.upconv2_adjoint_plain(t, x, w, None, f, y, gain=1.0, alpha=1.0,
                                        demodulate=False)[0]
    got = op(t.permute(0, 3, 1, 2), weight, stride=2, padding=pad).permute(0, 2, 3, 1)
    _rel_close(got, want)


def test_operands_in_each_role():
    """The operands as the kernel gets them: the D's forward (flip_weight
    True) takes w as it is and the flipped FIR; the up-conv's adjoint
    (flip_weight False) takes w with I and O swapped and 4 times the FIR;
    the pad is 2 for a 3x3 and 1 for a 1x1 in both roles."""
    f = setup_filter([1, 2, 3, 4])                               # not symmetric
    for kh, pad in ((3, 2), (1, 1)):
        w = torch.randn(kh, kh, 4, 8)
        wk, fk, p = fc.downconv2_leastwork(w, f)
        assert torch.equal(wk, w) and torch.equal(fk, f.flip((0, 1))) and p == pad
        wk, fk, p = fc.downconv2_leastwork(w, f, flip_weight=False)
        assert torch.equal(wk, w.flip((0, 1))) and p == pad
        wk, fk, p = fc.upconv2_adjoint_leastwork(w, f)
        assert torch.equal(wk, w.transpose(2, 3)) and torch.equal(fk, 4 * f) and p == pad
        wk, _, p = fc.upconv2_adjoint_leastwork(w, f, flip_weight=True)
        assert torch.equal(wk, w.flip((0, 1)).transpose(2, 3)) and p == pad


def test_what_the_kernel_does_not_take_raises():
    """No FIR, a FIR that is not 4x4, a 2x2 weight, and channel counts not
    in fours raise before any launch."""
    w = torch.randn(3, 3, 4, 8)
    for f in (None, setup_filter([1, 2, 1])):
        with pytest.raises(ValueError, match="4x4 FIR"):
            fc.downconv2_leastwork(w, f)
        with pytest.raises(ValueError, match="4x4 FIR"):
            fc.upconv2_adjoint_leastwork(w, f)
    f = setup_filter(FIR)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="in fours"):
        fc._lw_weights(*fc.downconv2_leastwork(torch.randn(3, 3, 6, 12), f)[:2], cpu)
    with pytest.raises(ValueError, match="1x1 or 3x3"):
        fc._lw_weights(torch.randn(2, 2, 4, 8), f, cpu)
