"""The port's projection engine (projection/engine.py) against the JAX
engine, with the weights carried over by checkpoint/convert.py, and its own
convergence on the CPU.

The JAX side runs the unpacked generator (MGT_PACKED_SYNTH=0); the port runs
its fused blocks on the plain kernels and adjoints. JAX's per-step latent
noise is replayed into the port through `noise_seq` (the two PRNGs differ)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu.projection import engine as jengine
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.losses import build_loss_stack
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.projection import (
    ProjectionConfig,
    cosine_ramp_lr,
    latent_stats,
    project,
)

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def small():
    """(JAX model, variables, the port's generator with the same weights)."""
    jc, tc = _cfg(jcfg, "small"), _cfg(tcfg, "small")
    model = JGenerator(jc)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "mask", "dropout"))}
    variables = model.init(rngs, jnp.zeros((1, jc.k, jc.z_dim)), noise_mode="const")
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(s in jax.tree_util.keystr(p)
                                    for s in ("noise_strength", "w_avg")) else x, variables)
    G = load_flax(init_generator(tc, seed=5, device="cpu"), jax.device_get(variables))
    return model, variables, G


def _target(G, seed, batch=1):
    z = torch.randn((batch, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return G(z=z, truncation_psi=0.7)


def _jax_noise(rng, pcfg, shape):
    """The JAX engine's per-step noise: one key per chunk-sized window."""
    n_windows = max(1, math.ceil(pcfg.steps / pcfg.chunk))
    _, *keys = jax.random.split(rng, n_windows + 1)
    return np.concatenate([np.asarray(jax.random.normal(
        keys[i], (min(pcfg.steps, (i + 1) * pcfg.chunk) - i * pcfg.chunk, *shape)))
        for i in range(n_windows)])


@pytest.mark.parametrize("t", [0.0, 0.01, 0.05, 0.3, 0.7, 0.76, 0.9, 1.0])
def test_cosine_ramp_lr_matches_jax(t):
    assert cosine_ramp_lr(t, 0.1) == pytest.approx(
        float(jengine.cosine_ramp_lr(jnp.asarray(t), 0.1)), abs=1e-7)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_adam_with_coupled_decay_is_the_optax_chain(dtype, tol):
    """torch.optim.Adam(weight_decay) == add_decayed_weights -> scale_by_adam
    -> p + lr*u, over 5 steps with a changing lr: equal to float64 rounding
    in float64; in float32 the two sum in other orders (a few ulp of |p| ~ 2
    after 5 steps)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64).astype(dtype)
    grads = [rng.randn(64).astype(dtype) for _ in range(5)]
    lrs = [0.0, 0.05, 0.1, 0.1, 0.02]
    with jax.enable_x64(dtype == np.float64):
        opt = jengine._make_opt(jengine.ProjectionConfig())
        pj = jnp.asarray(p0)
        state = opt.init(pj)
        pt = torch.tensor(p0, requires_grad=True)
        topt = torch.optim.Adam([pt], lr=0.1, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        for g, lr in zip(grads, lrs):
            u, state = opt.update(jnp.asarray(g), state, pj)
            pj = pj + lr * u
            pt.grad = torch.from_numpy(g)
            topt.param_groups[0]["lr"] = lr
            topt.step()
            assert np.asarray(pj).dtype == dtype
            np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=tol, atol=tol)
    assert isinstance(opt, optax.GradientTransformation)


def test_latent_stats_streaming_formula():
    cfg = _cfg(tcfg, "small")
    mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), n_mean_latent=5000,
                             batch=777)
    gen = torch.Generator().manual_seed(0)
    z = torch.cat([torch.randn((min(777, 5000 - lo), cfg.k, cfg.z_dim), generator=gen)
                   for lo in range(0, 5000, 777)])
    torch.testing.assert_close(mean, z.mean(0), rtol=0, atol=1e-6)
    torch.testing.assert_close(std, torch.sqrt(((z - z.mean(0)) ** 2).sum() / 5000),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("steps,tol", [(3, 2e-4), (20, 2e-2)])
def test_projection_trajectory_matches_jax(small, steps, tol, monkeypatch):
    """Three steps (the first with lr 0, then two Adam updates) and a
    20-step trajectory from the same latent, target and noise: per-step
    losses, best latent and best image against JAX's project().

    Three steps hold 2e-4. Over 20 steps the measured spread is 6.7e-3
    (loss, relative), 6.1e-3 (latent) and 6.7e-3 (image): after step 2 the
    two runs' latents differ by 5e-7 (float32 rounding of the Adam update,
    which sums in another order), and there the gradient changes by 1.7e-3
    of its size within that distance (an activation kink), in both
    frameworks alike (at one latent they agree to 3e-7). Tolerance 2e-2."""
    model, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    target = _target(G, 42)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 512)
    kw = dict(steps=steps, chunk=8, lr=0.05)
    rng = jax.random.PRNGKey(2)
    want = jengine.project(model, variables, jnp.asarray(target.numpy()),
                           jbuild_loss_stack({"mse": 1.0}), jengine.ProjectionConfig(**kw),
                           jnp.asarray(mean.numpy()), jnp.asarray(std.numpy()), rng=rng)
    noise = _jax_noise(rng, jengine.ProjectionConfig(**kw), (1, G.cfg.k, G.cfg.z_dim))
    got = project(G, target, build_loss_stack({"mse": 1.0}), ProjectionConfig(**kw), mean, std,
                  noise_seq=noise)
    np.testing.assert_allclose(got.loss_history.numpy(), np.asarray(want.loss_history),
                               rtol=tol, atol=1e-6)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.best_img.numpy(), np.asarray(want.best_img), rtol=tol,
                               atol=tol)
    assert got.best_step == want.best_step
    np.testing.assert_allclose(got.components_history["mse"][:, 0].numpy(),
                               np.asarray(want.components_history["mse"])[:, 0], rtol=tol,
                               atol=1e-6)


def test_projection_converges_on_self_target(small):
    _, _, G = small
    target = _target(G, 42)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 512)
    res = project(G, target, build_loss_stack({"mse": 1.0}),
                  ProjectionConfig(steps=150, chunk=50, lr=0.05, n_mean_latent=512), mean, std,
                  generator=torch.Generator().manual_seed(2))
    first = float(res.loss_history[0])
    assert res.best_loss < first * 0.25, f"no convergence: {first} -> {res.best_loss}"
    assert res.latent.shape == (1, G.cfg.k, G.cfg.z_dim)
    assert res.best_img.shape == target.shape and res.loss_history.shape == (150,)
    mse = float(torch.mean((res.best_img - target) ** 2))
    assert mse == pytest.approx(res.best_loss, rel=1e-3)


def test_batched_projection_tracks_each_image(small):
    _, _, G = small
    targets = _target(G, 7, batch=2)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 256)
    calls = []
    res = project(G, targets, build_loss_stack({"mse": 1.0}),
                  ProjectionConfig(steps=60, chunk=25, lr=0.05), mean, std,
                  generator=torch.Generator().manual_seed(2),
                  progress=lambda s, loss, best: calls.append(s))
    assert calls == [25, 50, 60]
    assert res.latent.shape == (2, G.cfg.k, G.cfg.z_dim) and res.per_image_loss.shape == (2,)
    for i in range(2):
        mse = float(torch.mean((res.best_img[i] - targets[i]) ** 2))
        assert mse == pytest.approx(float(res.per_image_loss[i]), rel=1e-3)
    assert res.best_step == int(res.per_image_step.max())
    # The noise windows depend on the seed only, not on the progress callback.
    again = project(G, targets, build_loss_stack({"mse": 1.0}),
                    ProjectionConfig(steps=60, chunk=25, lr=0.05), mean, std,
                    generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(again.latent, res.latent, rtol=0, atol=0)


def test_w_plus_projection_converges(small):
    _, _, G = small
    target = _target(G, 3)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 256)
    res = project(G, target, build_loss_stack({"mse": 1.0}),
                  ProjectionConfig(steps=60, chunk=30, lr=0.05, w_plus=True), mean, std,
                  generator=torch.Generator().manual_seed(2))
    assert res.latent.shape == (1, G.cfg.k, G.cfg.num_ws, G.cfg.w_dim)
    assert res.best_loss < float(res.loss_history[0]) * 0.5
    with torch.no_grad():
        img = G.run_synthesis(res.latent, noise_mode="const")
    torch.testing.assert_close(img, res.best_img, rtol=0, atol=1e-5)


def test_unported_options_raise(small):
    _, _, G = small
    target = _target(G, 1)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 64)
    loss_fn = build_loss_stack({"mse": 1.0})
    with pytest.raises(ValueError, match="batch 1"):
        project(G, torch.cat([target] * 2), loss_fn,
                ProjectionConfig(steps=2, noise_regularize=1e5), mean, std)
    with pytest.raises(ValueError, match="must divide the mesh"):
        project(G, target, loss_fn, ProjectionConfig(steps=2), mean, std, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="noise_seq"):
        project(G, target, loss_fn, ProjectionConfig(steps=2), mean, std,
                noise_seq=np.zeros((3, 1, G.cfg.k, G.cfg.z_dim), np.float32))
