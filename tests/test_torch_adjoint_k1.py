"""The K1 adjoint of the port (ops/fused_conv.py) against the JAX package.

`modconv3x3_adjoint_plain` and the backward of `FusedModConv3x3` (which takes
the plain adjoint on the CPU) against `jax.vjp` of `fused_modconv3x3_lrelu`
w.r.t. (x, styles, resid) with w, noise and bias closed over, so that JAX
takes the symbolic-zeros path the projection takes (its adjoint launch runs
in interpret mode here). Tolerance 2e-4, the JAX suite's own
(tests/test_packed_pipeline.py:95). The plain adjoint also equals
torch.autograd of the plain forward, and gradcheck passes in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu_torch.ops import fused_conv as fc

from .test_torch_kernels_cuda import K1_CASES, _k1_inputs, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def _t(a, grad=False):
    return None if a is None else torch.from_numpy(a).requires_grad_(grad)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_k1_adjoint_matches_jax(shape, noise, bias, resid, gain, alpha, demod):
    n, h, c, o = shape
    rng = np.random.RandomState(0)
    x, w, s, nz, b, r = _k1_inputs(rng, n, h, c, o, noise, bias, resid)
    g = rng.randn(n, h, h, o).astype(np.float32)

    def fwd(x_, s_, *r_):
        return jpc.fused_modconv3x3_lrelu(x_, _j(w), s_, _j(nz), _j(b), r_[0] if r_ else None,
                                          gain, alpha, demod)

    primals = [_j(x), _j(s)] + ([_j(r)] if resid else [])
    _, vjp = jax.vjp(fwd, *primals)
    want = vjp(jnp.asarray(g))

    y = fc.modconv3x3_plain(_t(x), _t(w), _t(s), _t(nz), _t(b), _t(r), gain, alpha, demod)
    dx, ds, dd1, dd2 = fc.modconv3x3_adjoint_plain(_t(g), _t(x), _t(w), _t(s), y, _t(nz),
                                                   _t(b), _t(r), gain, alpha, demod)
    _close(dx, want[0])
    _close(ds, want[1])
    assert (dd1 is None) == (not demod) and (dd2 is None) == (not demod)

    inputs = [_t(x, True), _t(s, True)] + ([_t(r, True)] if resid else [])
    out = fc.fused_modconv3x3(inputs[0], _t(w), inputs[1], _t(nz), _t(b),
                              inputs[2] if resid else None, gain, alpha, demod)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    assert fc.launch_counts["modconv3x3_adj"] == 0      # the CPU path launches no kernel
    for gt, wt in zip(got, want):
        _close(gt, wt)
    if resid:
        np.testing.assert_array_equal(got[2].numpy(), g)


@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_k1_adjoint_is_autograd_of_the_plain_forward(shape, noise, bias, resid, gain, alpha,
                                                     demod):
    n, h, c, o = shape
    rng = np.random.RandomState(1)
    x, w, s, nz, b, r = _k1_inputs(rng, n, h, c, o, noise, bias, resid)
    g = torch.from_numpy(rng.randn(n, h, h, o).astype(np.float32))
    xt, st = _t(x, True), _t(s, True)
    y = fc.modconv3x3_plain(xt, _t(w), st, _t(nz), _t(b), _t(r), gain, alpha, demod)
    want = torch.autograd.grad(y, [xt, st], g)
    dx, ds, _, _ = fc.modconv3x3_adjoint_plain(g, _t(x), _t(w), _t(s), y.detach(), _t(nz),
                                               _t(b), _t(r), gain, alpha, demod)
    torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ds, want[1], rtol=1e-5, atol=1e-5)
    # Only what is asked for is computed.
    dx_only = fc.modconv3x3_adjoint_plain(g, _t(x), _t(w), _t(s), y.detach(), _t(nz), _t(b),
                                          _t(r), gain, alpha, demod, need_ds=False)
    assert dx_only[1] is None and dx_only[2] is None
    torch.testing.assert_close(dx_only[0], dx, rtol=0, atol=0)


@pytest.mark.parametrize("noise,bias,resid,alpha", [(True, True, True, 0.2),
                                                    (False, False, False, 1.0)])
def test_k1_function_gradcheck_float64(noise, bias, resid, alpha):
    """Without demodulation every step is float64 (demod_coef computes in
    float32 by design, so the demodulated cases are held against autograd
    above instead)."""
    rng = np.random.RandomState(2)
    x, w, s, nz, b, r = (None if a is None else torch.from_numpy(a.astype(np.float64))
                         for a in _k1_inputs(rng, 1, 4, 3, 2, noise, bias, resid))
    args = [x.requires_grad_(), s.requires_grad_()] + ([r.requires_grad_()] if resid else [])

    def f(x_, s_, *r_):
        return fc.fused_modconv3x3(x_, w, s_, nz, b, r_[0] if r_ else None, 1.5, alpha, False)

    assert torch.autograd.gradcheck(f, args)


def test_k1_function_refuses_training_gradients():
    """Since training was ported the Function no longer refuses the
    gradients of w, noise and bias: each, asked for alone, equals autograd
    of the plain forward."""
    rng = np.random.RandomState(3)
    x, w, s, nz, b, r = (_t(a) for a in _k1_inputs(rng, 1, 4, 3, 2, True, True, True))
    for name, t in (("w", w), ("noise", nz), ("bias", b)):
        t.requires_grad_(True)
        y = fc.fused_modconv3x3(x, w, s, nz, b, r)
        (got,) = torch.autograd.grad(y.sum(), t)
        (want,) = torch.autograd.grad(fc.modconv3x3_plain(x, w, s, nz, b, r).sum(), t)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, msg=name)
        t.requires_grad_(False)
