"""The port's plain ops against the JAX ops on the same numpy inputs.

Tolerance: 1e-5 relative to the output's largest magnitude (float32 sums in
another order; XLA:CPU and PyTorch's CPU convolutions differ in the last
bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu import ops as jops
from morphganformer_tpu_torch import ops as tops

RTOL = 1e-5


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(1.0, np.abs(want).max()))


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("act", ["linear", "relu", "lrelu", "tanh", "sigmoid", "swish"])
@pytest.mark.parametrize("with_bias,gain,clamp", [(True, None, None), (False, 0.5, 0.3)])
def test_bias_act(act, with_bias, gain, clamp):
    rng = np.random.RandomState(0)
    x, b = _rand(rng, 2, 5, 6, 7), _rand(rng, 7)
    bb = b if with_bias else None
    want = jops.bias_act(jnp.asarray(x), None if bb is None else jnp.asarray(bb),
                         act=act, gain=gain, clamp=clamp)
    got = tops.bias_act(torch.from_numpy(x), None if bb is None else torch.from_numpy(bb),
                        act=act, gain=gain, clamp=clamp)
    _close(got, want)


@pytest.mark.parametrize("taps,up,down,padding,flip,gain", [
    ([1, 3, 3, 1], 2, 1, [2, 1, 2, 1], False, 4),
    ([1, 3, 3, 1], 1, 2, [1, 1, 1, 1], True, 1),
    ([1, 2, 1], 1, 1, [1, 1, 1, 1], False, 1),
    ([1, 3, 3, 1], 2, 2, [-1, 2, 0, 1], False, 2),
    ([1, 2, 3, 4, 4, 3, 2, 1], 2, 1, [4, 3, 4, 3], True, 4),     # separable
])
def test_upfirdn2d(taps, up, down, padding, flip, gain):
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 8, 10, 3)
    want = jops.upfirdn2d(jnp.asarray(x), jops.setup_filter(taps), up=up, down=down,
                          padding=padding, flip_filter=flip, gain=gain)
    got = tops.upfirdn2d(torch.from_numpy(x), tops.setup_filter(taps), up=up, down=down,
                         padding=padding, flip_filter=flip, gain=gain)
    _close(got, want)


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample2d_and_nearest_kernel(factor):
    rng = np.random.RandomState(2)
    x = _rand(rng, 1, 4, 4, 5)
    _close(tops.nearest_neighbors_kernel(factor), jops.nearest_neighbors_kernel(factor))
    want = jops.upsample2d(jnp.asarray(x), jops.nearest_neighbors_kernel(factor), up=factor)
    got = tops.upsample2d(torch.from_numpy(x), tops.nearest_neighbors_kernel(factor), up=factor)
    _close(got, want)
    want = jops.upsample2d(jnp.asarray(x), jops.setup_filter([1, 3, 3, 1]))
    got = tops.upsample2d(torch.from_numpy(x), tops.setup_filter([1, 3, 3, 1]))
    _close(got, want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("up,down", [(1, 1), (2, 1), (1, 2)])
@pytest.mark.parametrize("flip_weight", [True, False])
def test_conv2d_resample(k, up, down, flip_weight):
    rng = np.random.RandomState(3)
    x, w = _rand(rng, 2, 8, 8, 6), _rand(rng, k, k, 6, 5)
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), f=jops.setup_filter([1, 3, 3, 1]),
                                up=up, down=down, padding=k // 2, flip_weight=flip_weight)
    got = tops.conv2d_resample(torch.from_numpy(x), torch.from_numpy(w),
                               f=tops.setup_filter([1, 3, 3, 1]), up=up, down=down,
                               padding=k // 2, flip_weight=flip_weight)
    _close(got, want)


def test_compose_kernel_fir():
    from morphganformer_tpu.ops.conv2d_resample import _compose_kernel_fir as jcompose
    from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir as tcompose

    rng = np.random.RandomState(4)
    w = _rand(rng, 3, 3, 4, 2)
    for flip_w in (True, False):
        for flip_f in (True, False):
            want = jcompose(jnp.asarray(w), jops.setup_filter([1, 3, 3, 1]), flip_w, flip_f, 4.0)
            got = tcompose(torch.from_numpy(w), tops.setup_filter([1, 3, 3, 1]), flip_w, flip_f, 4.0)
            _close(got, want)


@pytest.mark.parametrize("up,k,demod,noise", [
    (1, 3, True, True), (1, 3, False, False), (2, 3, True, True), (2, 1, False, False),
    (1, 1, False, True),
])
def test_modulated_conv2d(up, k, demod, noise):
    rng = np.random.RandomState(5)
    x, w = _rand(rng, 2, 8, 8, 6), _rand(rng, k, k, 6, 4)
    s = rng.rand(2, 6).astype(np.float32) + 0.5
    n = _rand(rng, 1, 8 * up, 8 * up, 1) if noise else None
    kw = dict(up=up, padding=k // 2, demodulate=demod, flip_weight=(up == 1))
    want = jops.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                 None if n is None else jnp.asarray(n),
                                 resample_kernel=jops.setup_filter([1, 3, 3, 1]), **kw)
    got = tops.modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s),
                                None if n is None else torch.from_numpy(n),
                                resample_kernel=tops.setup_filter([1, 3, 3, 1]), **kw)
    _close(got, want)
