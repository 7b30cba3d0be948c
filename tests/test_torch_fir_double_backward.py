"""The port's `upfirdn2d`, whose depthwise FIR runs as a pair of autograd
Functions (the FIR and its transpose, each the other's backward), against
JAX's `upfirdn2d` on the CPU: its value, its VJP, and the VJP of that VJP
through a smooth nonlinearity (the shape of the path-length and R1
penalties), for the up-2, down-2 and separable filters. rtol 1e-5 (float32
sums in another order), atol 1e-5 of each result's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu import ops as jfir
from morphganformer_tpu_torch import ops as tfir

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = {
    "up2": ([1, 3, 3, 1], 2, 1, [2, 1, 2, 1], 4),
    "down2": ([1, 3, 3, 1], 1, 2, [1, 1, 1, 1], 1),
    "separable": ([1, 2, 3, 4, 4, 3, 2, 1], 2, 1, [4, 3, 4, 3], 4),
}


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_fir_double_backward_matches_jax(case):
    taps, up, down, padding, gain = CASES[case]
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 10, 3).astype(np.float32)
    fir = dict(up=up, down=down, padding=padding, gain=gain)

    def jf(a):
        return jfir.upfirdn2d(a, jfir.setup_filter(taps), **fir)

    y = np.asarray(jf(jnp.asarray(x)))
    r = rng.randn(*y.shape).astype(np.float32)
    h = rng.randn(*x.shape).astype(np.float32)

    def jloss(a):
        return jnp.sum(jnp.tanh(jf(a)) * r)

    want_vjp = jax.vjp(jf, jnp.asarray(x))[1](jnp.asarray(r))[0]
    want_grad = jax.grad(jloss)(jnp.asarray(x))
    want_second = jax.grad(lambda a: jnp.sum(jax.grad(jloss)(a) * h))(jnp.asarray(x))

    f = tfir.setup_filter(taps)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tfir.upfirdn2d(xt, f, **fir)
    _close(yt.detach(), y)
    got_vjp, = torch.autograd.grad(yt, xt, torch.from_numpy(r), retain_graph=True)
    _close(got_vjp, want_vjp)
    got_grad, = torch.autograd.grad((torch.tanh(yt) * torch.from_numpy(r)).sum(), xt,
                                    create_graph=True)
    _close(got_grad.detach(), want_grad)
    got_second, = torch.autograd.grad((got_grad * torch.from_numpy(h)).sum(), xt)
    _close(got_second, want_second)


def test_fir_refuses_a_filter_that_requires_grad():
    f = tfir.setup_filter([1, 3, 3, 1]).requires_grad_(True)
    with pytest.raises(ValueError, match="constant filter"):
        tfir.upfirdn2d(torch.zeros(1, 4, 4, 1), f)
