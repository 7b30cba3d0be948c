"""One step-0 training iteration of the conditional pair of
tests/test_torch_conditional.py against JAX's `train_iteration(..., c=...)`:
all four stages due, batch 4 in two accumulation rounds, the labels split
into the rounds with the reals and z. JAX's z and path-length noise (its
own draws from the iteration's key) are handed to the port, as
tests/test_torch_reg.py does; the weights after the iteration are held by
that test's bound on two Adam steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_conditional import force_fused_d, labels, pair, trainers  # noqa: F401
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_reg import _adam_moves, _flat, _pl_noise

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")


def test_train_iteration_with_labels_matches_jax_at_step_0(pair, monkeypatch):
    jtrainer, jstate, ttrainer, tstate = trainers(pair, batch_gpu=2)
    assert jtrainer.n_accum == ttrainer.n_accum == 2
    real = np.random.RandomState(2).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    c = labels(4)
    key = jax.random.PRNGKey(5)
    # JAX's own draws in `train_iteration` (train_step.py:370-386) and
    # `g_reg_step` (:256), as `_g_pl_loss` splits them.
    rngs = jax.random.split(key, 8)
    z = np.asarray(jax.random.normal(rngs[0], (2, 2, 9, 8)))
    noises = iter([torch.from_numpy(_pl_noise(r, 1)) for r in jax.random.split(rngs[2], 2)])
    real_pl = tloss.g_pl_loss
    monkeypatch.setattr(tts, "g_pl_loss", lambda *a: real_pl(*a, pl_noise=next(noises)))
    stage_grads, real_stage_grads = [], tts.stage_grads

    def recording(params, rounds, mesh=None):
        out = real_stage_grads(params, rounds, mesh)
        stage_grads.append([g.numpy() for g in out[0]])
        return out
    monkeypatch.setattr(tts, "stage_grads", recording)

    jstate, jstats = jtrainer.train_iteration(jstate, jnp.asarray(real), key, step=0,
                                              c=jnp.asarray(c))
    tstats = ttrainer.train_iteration(tstate, torch.from_numpy(real), 0,
                                      z=torch.from_numpy(z.reshape(4, 9, 8)),
                                      c=torch.from_numpy(c))
    assert set(tstats) == set(jstats)
    for k, v in tstats.items():
        np.testing.assert_allclose(v, float(jstats[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tstate.pl_mean), float(jstate["pl_mean"]), rtol=1e-5)
    assert tstate.cur_nimg == int(jstate["cur_nimg"]) == 4
    cfg = jtrainer.cfg
    g_main, g_reg, d_main, d_reg = stage_grads
    for net, params, (s1, s2), r in ((tstate.G, jstate["g"]["params"], (g_main, g_reg),
                                      cfg.g_reg_interval),
                                     (tstate.D, jstate["d"]["params"], (d_main, d_reg),
                                      cfg.d_reg_interval)):
        ratio = r / (r + 1)
        lr, b2 = cfg.g_lr * ratio, cfg.beta2 ** ratio
        want = _flat(jax.device_get(params))
        floors = [1e-3 * max(np.abs(g).max() for g in s) for s in (s1, s2)]
        for (name, p), g1, g2 in zip(net.named_parameters(), s1, s2):
            d1, d2 = (1e-4 * max(np.abs(g).max(), f) for g, f in zip((g1, g2), floors))
            tol = 1e-6 + _adam_moves(g1.astype(np.float64), g2.astype(np.float64), lr, b2,
                                     d1, d2)
            assert (np.abs(p.detach().numpy() - want[name]) <= tol).all(), name
