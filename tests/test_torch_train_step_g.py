"""G_main's first-order step of the port against the JAX package's
GANTrainer: the loss, every gradient leaf, one Adam update and the w_avg
update, with randomness off on both sides, on tests/test_torch_train_step.py's
small configs, pair and tolerances (see its docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.training import loss as jloss

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)
from .test_torch_train_step import _check_updates, _flat, _inputs, _pair, rel_err
from .test_torch_train_step import force_fused_d  # noqa: F401  (an autouse fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_g_main_step_matches_jax():
    jtrainer, jstate, host, ttrainer, tstate = _pair()
    z, _ = _inputs(1, 4)

    def loss_fn(params):
        g_vars = {"params": params, "moving_stats": host["g"]["moving_stats"]}
        return jloss.g_main_loss(jtrainer.G, jtrainer.D, g_vars, {"params": host["d"]["params"]},
                                 jnp.asarray(z[0]), None, jax.random.PRNGKey(0),
                                 jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(host["g"]["params"])
    grads_j = _flat(grads_j)
    grads_t, stats = ttrainer.g_main_grads(tstate, torch.from_numpy(z))
    names = [n for n, _ in tstate.G.named_parameters()]
    assert set(names) == set(grads_j)
    np.testing.assert_allclose(stats["Loss/G/loss"], float(loss_j), rtol=1e-5)
    for name, g in zip(names, grads_t):
        assert rel_err(g, grads_j[name]) <= 1e-4, name
    # D was frozen for the stage and is trainable again.
    assert all(p.requires_grad for p in tstate.D.parameters())

    # One update: Adam after the stage, and w_avg moved once.
    jstate, jaux = jtrainer.g_main_step(jstate, jnp.asarray(z), None, jax.random.PRNGKey(0))
    tstate.G.mapping.w_avg.copy_(torch.tensor(host["g"]["moving_stats"]["mapping"]["w_avg"]))
    tstats = ttrainer.g_main_step(tstate, torch.from_numpy(z))
    np.testing.assert_allclose(tstats["Loss/G/loss"], float(jaux["Loss/G/loss"]), rtol=1e-5)
    lr = jtrainer.cfg.g_lr * 4 / 5
    _check_updates(tstate.G.named_parameters(), _flat(host["g"]["params"]),
                   _flat(jax.device_get(jstate["g"]["params"])), grads_j, lr)
    np.testing.assert_allclose(tstate.G.mapping.w_avg.numpy(),
                               np.asarray(jstate["g"]["moving_stats"]["mapping"]["w_avg"]),
                               rtol=1e-5, atol=1e-6)
