"""The training roles of the fused ops (ops/fused_conv.py) against the JAX
package: K3's D-tower forward and its backward (K2's use_dw role), and the
weight, bias and noise cotangents of K1 and K2 (K1's and K3's dw taps),
with per-sample noise.

The port's Functions take their plain versions on the CPU; they are held
against `jax.vjp` of the JAX fused ops (`fused_packed_dconv2`,
`fused_modconv3x3_lrelu`, `fused_packed_upconv2` and `_c256`, whose Pallas
launches run in interpret mode here, as tests/test_packed_dw.py runs them),
w.r.t. every differentiable input. Tolerance 2e-4, the JAX suite's own
(tests/test_packed_pipeline.py:95, test_packed_dw.py). Also: the down-conv
against conv2d_resample(down=2) + bias_act, and its taps and its adjoint's
taps at single pixels of each parity and at the edges."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import bias_act, conv2d_resample, setup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc

from .test_torch_kernels_cuda import FIR, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _port_grads(fn, arrays, g):
    """(y, grads) of a port op on CPU tensors made from `arrays` (None stays
    None and gets no gradient)."""
    ts = [None if a is None else torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fn(*ts)
    live = [t for t in ts if t is not None]
    return y, torch.autograd.grad(y, live, torch.from_numpy(g))


# --------------------------------------------------------------------------
# K3 forward (the D down-conv) and K2's use_dw role.
# --------------------------------------------------------------------------

# (kh, FIR, bias, resid, gain, alpha): D conv1 (resid = the skip), conv1
# without resid, the skip (1x1, linear, no bias), and no FIR with resid.
DCONV_CASES = [
    (3, True, True, True, 1.0, 0.2),
    (3, True, True, False, math.sqrt(2), 0.2),
    (1, True, False, False, math.sqrt(0.5), 1.0),
    (3, False, True, True, 1.4, 0.2),
]


@pytest.mark.parametrize("kh,fir,bias,resid,gain,alpha", DCONV_CASES)
def test_downconv2_matches_jax_forward_and_vjp(kh, fir, bias, resid, gain, alpha):
    n, h, cin, cout = 2, 16, 8, 16
    q = 128 // cin                               # JAX packs q pixels per 128 lanes
    rng = np.random.RandomState(0)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    b = _rand(rng, cout, scale=0.1) if bias else None
    r = _rand(rng, n, h // 2, h // 2, cout) if resid else None
    g = _rand(rng, n, h // 2, h // 2, cout)
    fj = jsetup_filter(FIR) if fir else None

    def jfwd(x_, w_, *rest):
        it = iter(rest)
        b_ = next(it) if bias else None
        r_ = next(it).reshape(n, h // 2, h // q, q // 2 * cout) if resid else None
        y = jpc.fused_packed_dconv2(x_.reshape(n, h, h // q, q * cin), w_, fj, b_, r_,
                                    gain, alpha, True)
        return y.reshape(n, h // 2, h // 2, cout)

    primals = [jnp.asarray(a) for a in (x, w, b, r) if a is not None]
    y_j, vjp = jax.vjp(jfwd, *primals)
    want = vjp(jnp.asarray(g))

    ft = setup_filter(FIR) if fir else None
    y_t, got = _port_grads(lambda *a: fc.fused_downconv2(a[0], a[1], ft, a[2], a[3], gain, alpha),
                           [x, w, b, r], g)
    _close(y_t.detach(), y_j)
    assert len(got) == len(want)
    for gt, wt in zip(got, want):
        _close(gt, wt)
    assert fc.launch_counts["downconv2"] == fc.launch_counts["downconv2_adj"] == 0


@pytest.mark.parametrize("kh", [3, 1])
def test_downconv2_is_conv2d_resample_and_bias_act(kh):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_rand(rng, 2, 10, 10, 6))
    w = torch.from_numpy(_rand(rng, kh, kh, 6, 12))
    b = torch.from_numpy(_rand(rng, 12))
    f = setup_filter(FIR)
    want = bias_act(conv2d_resample(x, w, f=f, down=2, padding=kh // 2, flip_weight=True), b,
                    act="lrelu", gain=1.3)
    torch.testing.assert_close(fc.downconv2_plain(x, w, f, b, None, 1.3, 0.2), want,
                               rtol=1e-5, atol=1e-5)


def _composed(w, f):
    from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir

    return _compose_kernel_fir(w, f, True, False), w.shape[0] // 2 + 1


@pytest.mark.parametrize("kh,pixel", [(3, (0, 0)), (3, (1, 2)), (3, (4, 3)), (1, (0, 4)),
                                      (1, (2, 1)), (1, (4, 4))])
def test_downconv2_taps_at_single_pixels(kh, pixel):
    """y at one output pixel summed tap by tap (y[m] = sum_t K[t] x[2m + t -
    q0], zero outside the image), and dx at one input pixel of each parity
    (dx[j] gathers K[j - 2m + q0] gz[m]) at the edges and inside, against the
    plain forward and the plain K2 use_dw adjoint."""
    rng = np.random.RandomState(2)
    h, cin, cout = 5, 3, 2
    x = torch.from_numpy(_rand(rng, 1, 2 * h, 2 * h, cin))
    w = torch.from_numpy(_rand(rng, kh, kh, cin, cout))
    gz = torch.from_numpy(_rand(rng, 1, h, h, cout))
    f = setup_filter(FIR)
    k, q0 = _composed(w, f)
    L = k.shape[0]
    my, mx = pixel
    want = torch.zeros(cout)
    for ty in range(L):
        for tx in range(L):
            iy, ix = 2 * my + ty - q0, 2 * mx + tx - q0
            if 0 <= iy < 2 * h and 0 <= ix < 2 * h:
                want += x[0, iy, ix] @ k[ty, tx]
    y = fc.downconv2_plain(x, w, f, gain=1.0, alpha=1.0)
    _close(y[0, my, mx], want, 1e-5)

    dx = fc.downconv2_adjoint_plain(gz, w, f)
    for jy, jx in ((2 * my, 2 * mx), (2 * my + 1, 2 * mx), (2 * my, 2 * mx + 1),
                   (2 * my + 1, 2 * mx + 1)):
        want = torch.zeros(cin)
        for ny in range(h):
            for nx in range(h):
                ty, tx = jy - 2 * ny + q0, jx - 2 * nx + q0
                if 0 <= ty < L and 0 <= tx < L:
                    want += k[ty, tx] @ gz[0, ny, nx]
        _close(dx[0, jy, jx], want, 1e-5)


# --------------------------------------------------------------------------
# K1: dw (and dnoise, dbias) with every input differentiated.
# --------------------------------------------------------------------------

# (noise: None / "shared" / "sample", bias, resid, gain, alpha, styles: "rand" / "ones",
# demod): G conv1, G conv_last, the D conv0 form, per-sample noise through the dd taps.
K1_CASES = [
    ("shared", True, True, 1.0, 0.2, "rand", True),
    (None, False, False, 1.0, 1.0, "rand", True),
    (None, True, False, math.sqrt(2), 0.2, "ones", False),
    ("sample", True, True, 1.0, 0.2, "rand", True),
]


@pytest.mark.parametrize("noise,bias,resid,gain,alpha,styles,demod", K1_CASES)
def test_modconv3x3_grads_match_jax(noise, bias, resid, gain, alpha, styles, demod):
    n, h, c, o = 2, 8, 16, 16
    rng = np.random.RandomState(3)
    x = _rand(rng, n, h, h, c)
    w = _rand(rng, 3, 3, c, o, scale=1 / math.sqrt(9 * c))
    s = ((rng.rand(n, c) + 0.5).astype(np.float32) if styles == "rand"
         else np.ones((n, c), np.float32))
    nz = {None: None, "shared": _rand(rng, h, h, scale=0.1),
          "sample": _rand(rng, n, h, h, scale=0.1)}[noise]
    b = _rand(rng, o, scale=0.1) if bias else None
    r = _rand(rng, n, h, h, o) if resid else None
    g = _rand(rng, n, h, h, o)
    grad_s = styles == "rand"
    arrays = [x, w, s if grad_s else None, nz, b, r]
    live = [a for a in arrays if a is not None]

    def jfwd(*args):
        it = iter(args)
        x_, w_ = next(it), next(it)
        s_ = next(it) if grad_s else jnp.asarray(s)
        vals = [next(it) if a is not None else None for a in (nz, b, r)]
        return jpc.fused_modconv3x3_lrelu(x_, w_, s_, *vals, gain, alpha, demod)

    y_j, vjp = jax.vjp(jfwd, *[jnp.asarray(a) for a in live])
    want = vjp(jnp.asarray(g))

    s_const = torch.from_numpy(s)

    def tfwd(x_, w_, s_, nz_, b_, r_):
        return fc.fused_modconv3x3(x_, w_, s_ if grad_s else s_const, nz_, b_, r_, gain, alpha,
                                   demod)

    y_t, got = _port_grads(tfwd, arrays, g)
    _close(y_t.detach(), y_j)
    for gt, wt in zip(got, want):
        _close(gt, wt)


# --------------------------------------------------------------------------
# K2 with K3's dw taps: conv0 and the 1x1 skip, and the 256-channel form.
# --------------------------------------------------------------------------

# (cin, kh, styles/demod, noise, bias, gain, alpha)
K2_CASES = [
    (16, 3, True, "sample", True, math.sqrt(2), 0.2),
    (16, 1, False, None, False, math.sqrt(0.5), 1.0),
    (16, 3, True, "shared", False, 1.0, 0.2),
    (256, 3, True, "sample", True, math.sqrt(2), 0.2),
]


@pytest.mark.parametrize("cin,kh,styles,noise,bias,gain,alpha", K2_CASES)
def test_upconv2_grads_match_jax(cin, kh, styles, noise, bias, gain, alpha):
    n, cout = 2, cin // 2
    h = 8 if cin == 16 else 4
    p = max(1, 128 // cin)
    rng = np.random.RandomState(4)
    x = _rand(rng, n, h, h, cin)
    w = _rand(rng, kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    s = (rng.rand(n, cin) + 0.5).astype(np.float32) if styles else None
    nz = {None: None, "shared": _rand(rng, 2 * h, 2 * h, scale=0.1),
          "sample": _rand(rng, n, 2 * h, 2 * h, scale=0.1)}[noise]
    b = _rand(rng, cout, scale=0.1) if bias else None
    g = _rand(rng, n, 2 * h, 2 * h, cout)
    f = jsetup_filter(FIR)
    arrays = [x, w, s, nz, b]
    live = [a for a in arrays if a is not None]

    def jfwd(*args):
        it = iter(args)
        x_, w_ = next(it), next(it)
        s_, nz_, b_ = (next(it) if a is not None else None for a in (s, nz, b))
        rest = (w_, s_, f, nz_, b_, gain, alpha, styles, False)
        if cin == 256:
            return jpc.fused_packed_upconv2_c256(x_, *rest)
        y = jpc.fused_packed_upconv2(x_.reshape(n, h, h // p, p * cin), *rest)
        return y.reshape(n, 2 * h, 2 * h, cout)

    y_j, vjp = jax.vjp(jfwd, *[jnp.asarray(a) for a in live])
    want = vjp(jnp.asarray(g))

    ft = setup_filter(FIR)
    y_t, got = _port_grads(
        lambda x_, w_, s_, nz_, b_: fc.fused_upconv2(x_, w_, s_, ft, nz_, b_, gain, alpha,
                                                     styles, False), arrays, g)
    _close(y_t.detach(), y_j)
    for gt, wt in zip(got, want):
        _close(gt, wt)
    assert fc.launch_counts["upconv2_dw"] == 0


# --------------------------------------------------------------------------
# The dw taps and the fold, on their own.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("role", ["k1", "k3", "k2_use_dw"])
def test_dw_taps_are_autograd_of_the_plain_forwards(role):
    """Each role's weight cotangent (dw taps, then the fold through the
    parity weights) equals torch.autograd of its plain forward, in float64,
    without demodulation (whose term is held against JAX above)."""
    rng = np.random.RandomState(5)
    f = setup_filter(FIR).double()
    d = lambda *s: torch.from_numpy(rng.randn(*s))       # noqa: E731
    if role == "k1":
        x, w, s = d(2, 6, 6, 4), d(3, 3, 4, 5), d(2, 4).abs() + 0.5
        fwd = lambda w_: fc.modconv3x3_plain(x, w_, s, demodulate=False)       # noqa: E731
        op = lambda w_: fc.fused_modconv3x3(x, w_, s, demodulate=False)        # noqa: E731
    elif role == "k3":
        x, w, s = d(2, 5, 5, 4), d(3, 3, 4, 2), d(2, 4).abs() + 0.5
        fwd = lambda w_: fc.upconv2_plain(x, w_, s, f, demodulate=False)       # noqa: E731
        op = lambda w_: fc.fused_upconv2(x, w_, s, f, demodulate=False)        # noqa: E731
    else:
        x, w = d(2, 10, 10, 3), d(3, 3, 3, 6)
        fwd = lambda w_: fc.downconv2_plain(x, w_, f, gain=1.0, alpha=0.2)     # noqa: E731
        op = lambda w_: fc.fused_downconv2(x, w_, f, gain=1.0, alpha=0.2)      # noqa: E731
    w.requires_grad_(True)
    y = fwd(w)
    g = torch.from_numpy(rng.randn(*y.shape))
    want = torch.autograd.grad(y, w, g)[0]
    got = torch.autograd.grad(op(w), w, g)[0]
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)


def test_functions_compute_only_what_is_asked(monkeypatch):
    """With only x differentiated, no dw taps run and no weight cotangent
    is formed (JAX's symbolic zeros); with only w, no dx."""
    calls = []
    real = fc.conv_dw_plain
    monkeypatch.setattr(fc, "conv_dw_plain", lambda *a: calls.append("dw") or real(*a))
    rng = np.random.RandomState(6)
    x = torch.from_numpy(_rand(rng, 1, 8, 8, 4)).requires_grad_(True)
    w = torch.from_numpy(_rand(rng, 3, 3, 4, 8))
    f = setup_filter(FIR)
    y = fc.fused_downconv2(x, w, f, None, None, 1.0, 0.2)
    torch.autograd.grad(y.sum(), x)
    assert calls == []
    x.requires_grad_(False)
    w.requires_grad_(True)
    y = fc.fused_downconv2(x, w, f, None, None, 1.0, 0.2)
    (dw,) = torch.autograd.grad(y.sum(), w)
    assert calls == ["dw"] and dw.shape == w.shape
