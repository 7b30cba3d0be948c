"""K3 in its adjoint role, the backward of K2 (ops/fused_conv.py), against
the JAX package.

`upconv2_adjoint_plain` and the backward of `FusedUpConv2` against `jax.vjp`
of `fused_packed_upconv2` (Cin 64, packed [N,H,G,128]) and
`fused_packed_upconv2_c256` w.r.t. (x, styles) with w, noise and bias closed
over (the skip, styles None, w.r.t. x); JAX's adjoint launch runs in
interpret mode here. Tolerance 2e-4, the JAX suite's own
(tests/test_packed_pipeline.py:95). Also: the plain adjoint equals
torch.autograd of the plain forward, gradcheck in float64, and single input
pixels of each parity gathered tap by tap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import second_order as jso
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

from .test_torch_kernels_cuda import FIR, K2_CASES, _k2_inputs, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_k3_adjoint_matches_jax(cin, kh, styles, noise, bias, demod, gain, alpha):
    n, cout = 2, cin // 2
    h = 16 if cin == 64 else 8
    rng = np.random.RandomState(1)
    x, w, s, nz, b = _k2_inputs(rng, n, h, cin, cout, kh, styles, noise, bias)
    g = rng.randn(n, 2 * h, 2 * h, cout).astype(np.float32)
    f = jsetup_filter(FIR)

    def fwd(x_, *s_):
        args = (_j(w), s_[0] if s_ else None, f, _j(nz), _j(b), gain, alpha, demod, False)
        if cin == 256:
            return jpc.fused_packed_upconv2_c256(x_.reshape(n, h, h, cin), *args)
        return jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128),
                                        *args).reshape(n, 2 * h, 2 * h, cout)

    primals = [_j(x)] + ([_j(s)] if styles else [])
    _, vjp = jax.vjp(fwd, *primals)
    want = vjp(jnp.asarray(g))

    ft = setup_filter(FIR)
    y = fc.upconv2_plain(_t(x), _t(w), _t(s), ft, _t(nz), _t(b), gain, alpha, demod)
    dx, ds, dd1, _ = fc.upconv2_adjoint_plain(_t(g), _t(x), _t(w), _t(s), ft, y, _t(nz), _t(b),
                                              gain, alpha, demod)
    _close(dx, want[0])
    if styles:
        _close(ds, want[1])
    else:
        assert ds is None and dd1 is None       # the skip: dx only

    inputs = [_t(x, True)] + ([_t(s, True)] if styles else [])
    out = fc.fused_upconv2(inputs[0], _t(w), inputs[1] if styles else None, ft, _t(nz), _t(b),
                           gain, alpha, demod, False)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    assert fc.launch_counts["upconv2_adj"] == 0
    for gt, wt in zip(got, want):
        _close(gt, wt)


@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_k3_adjoint_is_autograd_of_the_plain_forward(cin, kh, styles, noise, bias, demod,
                                                     gain, alpha):
    n, cout, h = 1, cin // 2, 4
    rng = np.random.RandomState(2)
    x, w, s, nz, b = _k2_inputs(rng, n, h, cin, cout, kh, styles, noise, bias)
    g = torch.from_numpy(rng.randn(n, 2 * h, 2 * h, cout).astype(np.float32))
    ft = setup_filter(FIR)
    inputs = [_t(x, True)] + ([_t(s, True)] if styles else [])
    y = fc.upconv2_plain(inputs[0], _t(w), inputs[1] if styles else None, ft, _t(nz), _t(b),
                         gain, alpha, demod)
    want = torch.autograd.grad(y, inputs, g)
    dx, ds, _, _ = fc.upconv2_adjoint_plain(g, _t(x), _t(w), _t(s), ft, y.detach(), _t(nz),
                                            _t(b), gain, alpha, demod)
    torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
    if styles:
        torch.testing.assert_close(ds, want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kh,styles", [(3, True), (1, False)])
def test_k3_function_gradcheck_float64(kh, styles):
    rng = np.random.RandomState(3)
    x, w, s, nz, b = (None if a is None else torch.from_numpy(a.astype(np.float64))
                      for a in _k2_inputs(rng, 1, 3, 4, 2, kh, styles, styles, styles))
    f = setup_filter(FIR).double()
    args = [x.requires_grad_()] + ([s.requires_grad_()] if styles else [])

    def fn(x_, *s_):
        return fc.fused_upconv2(x_, w, s_[0] if s_ else None, f, nz, b, 1.4,
                                0.2 if styles else 1.0, False, False)

    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("kh,pixel", [(3, (2, 1)), (3, (1, 2)), (3, (0, 4)), (1, (3, 2)),
                                      (1, (2, 3)), (1, (4, 0))])
def test_k3_gathers_each_parity_tap_by_hand(kh, pixel):
    """dx at one input pixel (odd/even row and column, and the edges), summed
    tap by tap from the taps of `_taps_upconv2_polyphase` (output 2n+r reads
    input n + (r+t-p0)/2 through composed tap t, so input j gathers output
    2(j-off)+r), against the plain adjoint and jax.vjp of that JAX function."""
    from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir

    rng = np.random.RandomState(4)
    h, cin, cout = 5, 3, 2
    x = torch.from_numpy(rng.randn(1, h, h, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(kh, kh, cin, cout).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 2 * h, 2 * h, cout).astype(np.float32))
    f = setup_filter(FIR)
    y = fc.upconv2_plain(x, w, None, f, gain=1.0, alpha=1.0, demodulate=False)
    dx = fc.upconv2_adjoint_plain(g, x, w, None, f, y, gain=1.0, alpha=1.0,
                                  demodulate=False)[0]
    k = _compose_kernel_fir(w, f, False, False, gain=4.0)
    L, p0 = k.shape[0], kh // 2 + 2

    def taps(r):
        return [(t, (r + t - p0) // 2) for t in range((p0 + r) % 2, L, 2)]

    jy, jx = pixel
    want = torch.zeros(cin)
    for ry in (0, 1):
        for rx in (0, 1):
            for ty, oy in taps(ry):
                for tx, ox in taps(rx):
                    ny, nx = jy - oy, jx - ox
                    if 0 <= ny < h and 0 <= nx < h:
                        want += k[ty, tx] @ g[0, 2 * ny + ry, 2 * nx + rx]
    _close(dx[0, jy, jx], want)
    _, vjp = jax.vjp(lambda x_: jso._taps_upconv2_polyphase(x_, jnp.asarray(k.numpy()), p0),
                     jnp.asarray(x.numpy()))
    _close(dx, vjp(jnp.asarray(g.numpy()))[0])


def test_k3_function_refuses_training_gradients():
    """Since training was ported the Function no longer refuses the
    gradients of w, noise and bias: each, asked for alone, equals autograd
    of the plain forward."""
    rng = np.random.RandomState(5)
    x, w, s, nz, b = (_t(a) for a in _k2_inputs(rng, 1, 3, 4, 2, 3, True, True, True))
    f = setup_filter(FIR)
    for name, t in (("w", w), ("noise", nz), ("bias", b)):
        t.requires_grad_(True)
        y = fc.fused_upconv2(x, w, s, f, nz, b)
        (got,) = torch.autograd.grad(y.sum(), t)
        (want,) = torch.autograd.grad(fc.upconv2_plain(x, w, s, f, nz, b).sum(), t)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=name)
        t.requires_grad_(False)
