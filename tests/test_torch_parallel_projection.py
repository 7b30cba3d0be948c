"""The sharded projection (projection/engine.py with `mesh`, a list of
devices): its rows split into one block a device, each with its own
replica of G, against the unsharded run and against JAX's
`project(mesh=...)` on a 2-device data mesh.

Both blocks lie on the CPU here (`mesh=["cpu", "cpu"]`). The per-image
losses of a block equal the batch's bit for bit; the latent gradient of a
2-row block differs from the 4-row batch's by float32 rounding (1.5e-8 in
a 4-row run: the CPU's backward rounds by the batch it is given), which
Adam carries into the latents: tolerance 1e-6 relative, 1e-7 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from morphganformer_tpu.projection import engine as jengine
from morphganformer_tpu_torch.losses import build_loss_stack
from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, project

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_projection import _jax_noise, small  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _targets(G, batch=4):
    z = torch.randn((batch, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        return G(z=z, truncation_psi=0.7)


def test_sharded_projection_equals_unsharded(small):
    _, _, G = small
    target = _targets(G)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 256)
    pcfg = ProjectionConfig(steps=6, chunk=3, lr=0.05)
    loss_fn = build_loss_stack({"mse": 1.0})
    seen = []
    ref = project(G, target, loss_fn, pcfg, mean, std,
                  generator=torch.Generator().manual_seed(2))
    got = project(G, target, loss_fn, pcfg, mean, std,
                  generator=torch.Generator().manual_seed(2), mesh=["cpu", "cpu"],
                  progress=lambda *a: seen.append(a))
    assert [s[0] for s in seen] == [3, 6]
    assert got.latent.shape == ref.latent.shape == (4, G.cfg.k, G.cfg.z_dim)
    for name in ("latent", "best_img", "per_image_loss", "loss_history"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name), rtol=1e-6,
                                   atol=1e-7 if name != "best_img" else 1e-5, msg=name)
    torch.testing.assert_close(got.components_history["mse"], ref.components_history["mse"],
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(got.per_image_step, ref.per_image_step)
    # One block on G's device is the unsharded run, bit for bit.
    one = project(G, target, loss_fn, pcfg, mean, std,
                  generator=torch.Generator().manual_seed(2), mesh=["cpu"])
    assert torch.equal(one.latent, ref.latent) and torch.equal(one.loss_history,
                                                               ref.loss_history)


def test_sharded_projection_matches_jax_mesh(small, monkeypatch):
    """Three steps (the first with lr 0) at batch 4 over 2 devices on both
    sides, JAX's per-step noise replayed through `noise_seq`: losses, best
    latents and best images within test_torch_projection's 3-step 2e-4."""
    model, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    target = _targets(G)
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 512)
    kw = dict(steps=3, chunk=8, lr=0.05)
    rng = jax.random.PRNGKey(2)
    want = jengine.project(model, variables, jnp.asarray(target.numpy()),
                           jbuild_loss_stack({"mse": 1.0}), jengine.ProjectionConfig(**kw),
                           jnp.asarray(mean.numpy()), jnp.asarray(std.numpy()), rng=rng,
                           mesh=jax_data_mesh(jax.devices()[:2]))
    noise = _jax_noise(rng, jengine.ProjectionConfig(**kw), (4, G.cfg.k, G.cfg.z_dim))
    got = project(G, target, build_loss_stack({"mse": 1.0}), ProjectionConfig(**kw), mean, std,
                  noise_seq=noise, mesh=["cpu", "cpu"])
    tol = 2e-4
    np.testing.assert_allclose(got.loss_history.numpy(), np.asarray(want.loss_history),
                               rtol=tol, atol=1e-6)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.best_img.numpy(), np.asarray(want.best_img), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got.per_image_loss.numpy(), np.asarray(want.per_image_loss),
                               rtol=tol, atol=1e-6)


def test_sharded_projection_keeps_jax_refusals(small):
    _, _, G = small
    mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(1), 64)
    loss_fn = build_loss_stack({"mse": 1.0})
    with pytest.raises(ValueError, match="must divide the mesh"):
        project(G, _targets(G, 3), loss_fn, ProjectionConfig(steps=2), mean, std,
                mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="sharding needs a batch"):
        project(G, _targets(G, 1), loss_fn, ProjectionConfig(steps=2, noise_regularize=1e5),
                mean, std, mesh=["cpu"])
    with pytest.raises(ValueError, match="empty"):
        project(G, _targets(G, 1), loss_fn, ProjectionConfig(steps=2), mean, std, mesh=[])
