"""The port's pixel losses and loss stack against the JAX package: values
and gradients at 1e-5 relative, on NHWC images in [-1, 1]."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses import pixel as jpixel
from morphganformer_tpu.losses import stack as jstack
from morphganformer_tpu_torch.losses import build_loss_stack, parse_loss_spec, pixel
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["mse_loss", "l1_loss", "psnr", "psnr_loss", "ssim", "dssim_loss"]


def _images(seed, shape=(1, 24, 20, 3)):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + 0.3 * rng.randn(*shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", NAMES)
def test_pixel_loss_and_gradient_match_jax(name):
    a, b = _images(0)
    want, want_grad = jax.value_and_grad(getattr(jpixel, name))(jnp.asarray(a), jnp.asarray(b))
    at = torch.tensor(a, requires_grad=True)
    got = getattr(pixel, name)(at, torch.from_numpy(b))
    got_grad, = torch.autograd.grad(got, at)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want_grad)).max())


@pytest.mark.parametrize("spec,weights", [
    ("mse", {"mse": 1.0}),
    ("ssim+mse", {"ssim": 1.0, "mse": 1.0}),
    ("0.5*l1 + 2*psnr", {"l1": 0.5, "psnr": 2.0}),
    ("mse+mse", {"mse": 2.0}),
    ("lpips+0.01*wing+1*mse", {"lpips": 1.0, "wing": 0.01, "mse": 1.0}),
])
def test_parse_loss_spec_matches_jax(spec, weights):
    assert parse_loss_spec(spec) == weights == jstack.parse_loss_spec(spec)


def test_loss_stack_is_per_image_and_matches_jax():
    a, b = _images(1, (2, 16, 16, 3))
    weights = {"mse": 1.0, "ssim": 0.5, "l1": 0.25, "psnr": 0.01}
    total, comps = build_loss_stack(weights)(torch.from_numpy(a), torch.from_numpy(b))
    assert total.shape == (2,) and set(comps) == set(weights)
    jloss = jstack.build_loss_stack(weights)
    for i in range(2):
        want, want_comps = jloss(jnp.asarray(a[i:i + 1]), jnp.asarray(b[i:i + 1]))
        np.testing.assert_allclose(total[i].item(), float(want), rtol=1e-5)
        for k in weights:
            np.testing.assert_allclose(comps[k][i].item(), float(want_comps[k]), rtol=1e-5)


def test_loss_stack_refuses_unknown_terms():
    with pytest.raises(KeyError, match="nope"):
        build_loss_stack({"nope": 1.0, "mse": 1.0})
    with pytest.raises(KeyError):
        jstack.build_loss_stack({"nope": 1.0})
    # A zero weight is not a term.
    assert set(build_loss_stack({"lpips": 0.0, "mse": 1.0})(
        torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3))[1]) == {"mse"}
