"""The bfloat16 generator whole against the JAX package in bfloat16: its
image, a projection that converges, and the loss and latent gradient at
one latent, on tests/test_torch_generator.py's small config with the
weights carried by `load_flax`. The criterion is tests/test_torch_bf16.py's
(`_closer`): the port in bfloat16 lies closer to JAX in bfloat16 than JAX
in bfloat16 lies to JAX in float32. JAX's generator runs unpacked on the
CPU (MGT_PACKED_SYNTH=0); the port runs its fused blocks on the plain
versions, which round where JAX's Pallas wrappers round."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.losses import build_loss_stack
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator, set_compute_dtype
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, loss_and_grad, project

from .test_torch_bf16 import _closer
from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def small():
    """(JAX config, model, variables, the port's generator with those
    weights), the small config of tests/test_torch_generator.py."""
    jc, tc = _cfg(jcfg, "small"), _cfg(tcfg, "small")
    model = JGenerator(jc)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "mask", "dropout"))}
    variables = model.init(rngs, jnp.zeros((1, jc.k, jc.z_dim)), noise_mode="const")
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(s in jax.tree_util.keystr(p)
                                    for s in ("noise_strength", "w_avg")) else x, variables)
    G = load_flax(init_generator(tc, seed=5, device="cpu"), jax.device_get(variables))
    return jc, model, variables, G


def _jax_images(jc, variables, z):
    return {dt: np.asarray(JGenerator(dataclasses.replace(jc, dtype=dt)).apply(
        variables, jnp.asarray(z), truncation_psi=0.7, noise_mode="const"))
        for dt in ("float32", "bfloat16")}


def test_bf16_generator_lies_closer_to_jax_bf16_than_jax_bf16_to_f32(small, monkeypatch):
    jc, _, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    z = np.random.RandomState(0).randn(2, jc.k, jc.z_dim).astype(np.float32)
    want = _jax_images(jc, variables, z)
    set_compute_dtype(G, "bfloat16")
    try:
        assert [r for r in G.cfg.block_resolutions
                if tsyn.packed_structural_ok(G.cfg, r, "const")] == [8, 16]
        with torch.no_grad():
            img = G(z=torch.from_numpy(z), truncation_psi=0.7, noise_mode="const")
            assert img.dtype == torch.float32               # the RGB accumulates in float32
            _closer(img, want["bfloat16"], want["float32"])
            # Unfused, every op rounds where XLA's does: one-ulp flips of
            # another order of sums alone (measured 2.5e-6 / 3.9e-3).
            monkeypatch.setattr(tsyn, "packed_structural_ok", lambda *a: False)
            img_u = G(z=torch.from_numpy(z), truncation_psi=0.7, noise_mode="const")
        d = np.abs(img_u.numpy() - want["bfloat16"])
        assert d.mean() < 1e-4 and d.max() < 2e-2, (d.mean(), d.max())
    finally:
        set_compute_dtype(G, "float32")



def test_bf16_projection_converges(small):
    """As JAX requires of its own bf16 projection (tests/test_projection.py:
    138-152): the best loss below 0.35 of the first step's in 120 steps."""
    _, _, _, G = small
    set_compute_dtype(G, "bfloat16")
    try:
        z = torch.randn((1, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            target = G(z=z, truncation_psi=0.7)
        mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(4), 256)
        res = project(G, target, build_loss_stack({"mse": 1.0}),
                      ProjectionConfig(steps=120, chunk=60, lr=0.05), mean, std,
                      generator=torch.Generator().manual_seed(5))
    finally:
        set_compute_dtype(G, "float32")
    first = float(res.loss_history[0])
    assert res.best_loss < first * 0.35, (first, res.best_loss)
    assert res.latent.dtype == torch.float32 and res.best_img.dtype == torch.float32


def test_bf16_loss_and_latent_gradient_match_jax(small, monkeypatch):
    """At one latent (z, truncation 0.7, const noise, MSE to a JAX G(z)
    target): the port's bf16 loss and latent gradient against JAX's bf16
    ones (unpacked), within 2e-2 (loss, relative) and 5e-2 of the
    gradient's largest entry. Measured: loss 8.5e-3, gradient 1.8e-3 mean
    and 2.4e-2 max of its largest entry; JAX's own bf16 against its f32
    5.6e-3 and 1.3e-3 / 1.4e-2: the port's fused b8 and b16 round as JAX's
    Pallas kernels, JAX's unpacked blocks as XLA's ops. With the port's
    blocks unfused as JAX's the gradient lies closer to JAX's bf16 one than
    that to JAX's f32 (measured 4.8e-4 / 2.5e-3), as the ops' backwards
    round where XLA's do (bias_act's lrelu takes JAX's gradient at an exact
    zero)."""
    jc, model, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    rng = np.random.RandomState(7)
    z = rng.randn(1, jc.k, jc.z_dim).astype(np.float32)
    target = np.asarray(model.apply(variables, jnp.asarray(rng.randn(1, jc.k, jc.z_dim)
                                                           .astype(np.float32)),
                                    truncation_psi=0.7, noise_mode="const"))
    jloss_fn = jbuild_loss_stack({"mse": 1.0})
    want = {}
    for dt in ("float32", "bfloat16"):
        m = JGenerator(dataclasses.replace(jc, dtype=dt))

        def loss(z_):
            img = m.apply(variables, z_, truncation_psi=0.7, noise_mode="const")
            return jnp.mean(jloss_fn(img, jnp.asarray(target))[0])
        want[dt] = jax.value_and_grad(loss)(jnp.asarray(z))
    args = (torch.from_numpy(z), torch.from_numpy(target), build_loss_stack({"mse": 1.0}),
            ProjectionConfig())
    set_compute_dtype(G, "bfloat16")
    try:
        per_img, _, grad = loss_and_grad(G, *args)
        monkeypatch.setattr(tsyn, "packed_structural_ok", lambda *a: False)
        _, _, grad_u = loss_and_grad(G, *args)
    finally:
        set_compute_dtype(G, "float32")
    assert grad.dtype == torch.float32
    want_loss, want_grad = float(want["bfloat16"][0]), np.asarray(want["bfloat16"][1])
    assert float(per_img.mean()) == pytest.approx(want_loss, rel=2e-2)
    scale = np.abs(want_grad).max()
    assert np.abs(grad.numpy() - want_grad).max() < 5e-2 * scale
    _closer(grad_u, want["bfloat16"][1], want["float32"][1])
