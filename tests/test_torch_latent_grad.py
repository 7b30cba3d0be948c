"""Latent gradients of the port's generator against the JAX generator, with
the weights carried over by checkpoint/convert.py.

`jax.grad` of an MSE loss through the JAX generator (its unpacked path,
MGT_PACKED_SYNTH=0) against torch.autograd through the port, whose fused
blocks run `FusedModConv3x3` / `FusedUpConv2` (on the CPU their plain
forwards and plain adjoints, so the backward wiring of every kernel call
site is under test), in z mode (mapping with truncation 0.7) and in W+ mode
(synthesis only), with const and no noise. Tolerance 2e-4 relative to the
largest gradient entry (an MSE over the image makes every entry small)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models.generator import Generator as JGenerator

from .test_torch_generator import carried  # noqa: F401  (module-scoped fixture)
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4


def _jax_images(model, variables, mode, noise_mode):
    if mode == "z":
        return lambda lat: model.apply(variables, lat, truncation_psi=0.7, noise_mode=noise_mode)
    return lambda lat: model.apply(variables, lat, noise_mode=noise_mode,
                                   method=JGenerator.run_synthesis)[0]


@pytest.mark.parametrize("mode", ["z", "w_plus"])
@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_latent_gradient_matches_jax(carried, mode, noise_mode, monkeypatch):  # noqa: F811
    model, variables, G = carried
    G.requires_grad_(False)
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    cfg = G.cfg
    rng = np.random.RandomState(0)
    z = rng.randn(2, cfg.k, cfg.z_dim).astype(np.float32)
    res = cfg.img_resolution
    target = rng.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    if mode == "z":
        latent = z
    else:
        latent = np.asarray(model.apply(variables, jnp.asarray(z), truncation_psi=0.7,
                                        skip_w_avg_update=True, method=JGenerator.run_mapping))
    images = _jax_images(model, variables, mode, noise_mode)
    want = np.asarray(jax.grad(lambda lat: jnp.mean((images(lat) - target) ** 2))(
        jnp.asarray(latent)))
    assert np.abs(want).max() > 0

    for plain in (False, True):
        lat = torch.tensor(latent, requires_grad=True)
        if mode == "z":
            img = G(z=lat, truncation_psi=0.7, noise_mode=noise_mode, plain=plain)
        else:
            img = G.run_synthesis(lat, noise_mode=noise_mode, plain=plain)
        got, = torch.autograd.grad(torch.mean((img - torch.from_numpy(target)) ** 2), lat)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())
