"""The first-order training step of the port (training/) against the JAX
package's GANTrainer, on small G and D configs with the weights carried over.

JAX's random draws cannot be reproduced in torch, so the stages are held
with randomness off on both sides (no local noise, attention dropout 0, no
component dropout, `LossConfig(style_mixing=0)`): then G_main and D_main are
deterministic given z, which both sides get from numpy. The random pieces
are tested on their own: the mixing cutoff against JAX's `_mix_axis`, the
attention dropout by its keep rate and by its result on fixed masks, the
per-sample noise through the fused ops in test_torch_training_ops.py.
G_main's step is held in tests/test_torch_train_step_g.py, with this
file's pair, inputs and tolerances.

The port runs its fused blocks (G's b8 and b16, D's b16 under a forced
gate) on their plain versions; JAX runs its unpacked path. Tolerances:
losses 1e-5 relative; every gradient leaf within 1e-4 of its largest entry
(float32 sums in another order), and within 1e-8 absolute where that entry
is below 1e-4 (leaves whose true gradient is zero); the updated weights
within 1e-6 plus the most Adam's first step, lr * g / (|g| + eps), can move
when g moves by twice that gradient tolerance: a few 1e-6 where |g| is well
above the tolerance, up to 2 lr where it is not, since a gradient that
rounds to the other sign flips its element's step."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models.transformer import attention_dropout, dropout_masks
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D_GATE = tdisc.packed_d_block_eligible     # the real gate (a fixture forces it below)


def _cfgs(mod, **g_kw):
    g = mod.GANformerConfig(img_resolution=16, z_dim=8, w_dim=8, k=3, channel_base=256,
                            channel_max=32, end_res=3, local_noise=False,
                            mapping=mod.MappingConfig(num_layers=2),
                            attention=mod.AttentionConfig(dropout=0.0), **g_kw)
    d = mod.DiscriminatorConfig(img_resolution=16, channel_base=256, channel_max=32,
                                mbstd_group_size=2)
    return g, d


def _train_cfg(mod, loss_mod, **kw):
    return mod.TrainConfig(batch_size=4, batch_gpu=kw.pop("batch_gpu", 4),
                           loss=loss_mod.LossConfig(style_mixing=0.0), **kw)


@pytest.fixture(autouse=True)
def force_fused_d(monkeypatch):
    """D's b16 (16 -> 32 channels) on the fused ops, as b1024/b512 at 1024^2."""
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def rel_err(got, want):
    """Max abs error over the leaf's largest entry, that floored at 1e-4: a
    leaf whose true gradient is zero (the key bias before a softmax) holds
    only rounding noise near 1e-10 on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-4))


def _pair(**train_kw):
    """JAX trainer and state; the port's trainer and state with the same
    weights (w_avg moved off zero so its update is seen)."""
    jg, jd = _cfgs(jcfg)
    tg, td = _cfgs(tcfg)
    jtrainer = jts.GANTrainer(jg, jd, _train_cfg(jts, jloss, **train_kw))
    jstate = jtrainer.init_state(seed=0)
    jstate["g"]["moving_stats"] = jax.tree_util.tree_map(lambda v: v + 0.3,
                                                         jstate["g"]["moving_stats"])
    host = jax.device_get({"g": jstate["g"], "d": jstate["d"]})
    ttrainer = tts.GANTrainer(tg, td, _train_cfg(tts, tloss, **train_kw), device="cpu")
    G = load_flax(init_generator(tg, seed=1, device="cpu"), host["g"])
    D = load_flax(tdisc.init_discriminator(td, seed=1, device="cpu"), host["d"])
    return jtrainer, jstate, host, ttrainer, ttrainer.make_state(G, D, seed=0)


def _inputs(n_accum, micro):
    rng = np.random.RandomState(0)
    z = rng.randn(n_accum, micro, 3, 8).astype(np.float32)
    real = rng.randn(n_accum, micro, 16, 16, 3).astype(np.float32)
    return z, real


def _check_updates(new_t, old, new_j, grads_j, lr, eps=1e-8):
    """Updated weights after Adam's first step u = lr g / (|g| + eps): within
    1e-6 plus the most u can move when g moves by 2 delta, delta the
    gradient tolerance of `rel_err` (see the module docstring)."""
    for name, p in new_t:
        got, want = p.detach().numpy(), new_j[name]
        g = np.abs(grads_j[name]).astype(np.float64)
        delta = 1e-4 * max(g.max(), 1e-4)
        near = np.maximum(g - 2 * delta, 0.0) + eps
        tol = 1e-6 + lr * np.minimum(2.0, 2 * delta * eps / near ** 2)
        assert (np.abs(got - want) <= tol).all(), name
        assert not np.array_equal(want, old[name]) or g.max() == 0, name


def test_d_main_step_matches_jax():
    jtrainer, jstate, host, ttrainer, tstate = _pair()
    z, real = _inputs(1, 4)

    def loss_fn(params):
        return jloss.d_main_loss(jtrainer.G, jtrainer.D, host["g"], {"params": params},
                                 jnp.asarray(real[0]), jnp.asarray(z[0]), None,
                                 jax.random.PRNGKey(0), jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(host["d"]["params"])
    grads_j = _flat(grads_j)
    grads_t, stats = ttrainer.d_main_grads(tstate, torch.from_numpy(real), torch.from_numpy(z))
    names = [n for n, _ in tstate.D.named_parameters()]
    assert set(names) == set(grads_j)
    for key in ("Loss/D/loss", "Loss/scores/fake", "Loss/scores/real"):
        np.testing.assert_allclose(stats[key], float(aux_j[key]), rtol=1e-5, atol=1e-6)
    for name, g in zip(names, grads_t):
        assert rel_err(g, grads_j[name]) <= 1e-4, name

    jstate, _ = jtrainer.d_main_step(jstate, jnp.asarray(real), jnp.asarray(z), None,
                                     jax.random.PRNGKey(0))
    ttrainer.d_main_step(tstate, torch.from_numpy(real), torch.from_numpy(z))
    lr = jtrainer.cfg.d_lr * 16 / 17
    _check_updates(tstate.D.named_parameters(), _flat(host["d"]["params"]),
                   _flat(jax.device_get(jstate["d"]["params"])), grads_j, lr)
    assert tstate.cur_nimg == int(jstate["cur_nimg"]) == 4


def test_two_round_accumulation_matches_jax():
    """batch 4 in two rounds of 2: the mean of the rounds' gradients, w_avg
    threaded through the rounds, one Adam step (JAX's scan)."""
    jtrainer, jstate, host, ttrainer, tstate = _pair(batch_gpu=2)
    assert jtrainer.n_accum == ttrainer.n_accum == 2
    z, real = _inputs(2, 2)
    grads, _ = ttrainer.g_main_grads(tstate, torch.from_numpy(z))
    w_avg_after = tstate.G.mapping.w_avg.clone()
    tstate.G.mapping.w_avg.copy_(torch.tensor(host["g"]["moving_stats"]["mapping"]["w_avg"]))
    rounds = [ttrainer.g_main_grads(tstate, torch.from_numpy(z[i:i + 1]))[0] for i in (0, 1)]
    for g, a, b in zip(grads, *rounds):
        torch.testing.assert_close(g, (a + b) / 2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(tstate.G.mapping.w_avg, w_avg_after, rtol=0, atol=0)

    tstate.G.mapping.w_avg.copy_(torch.tensor(host["g"]["moving_stats"]["mapping"]["w_avg"]))
    jstate, _ = jtrainer.g_main_step(jstate, jnp.asarray(z), None, jax.random.PRNGKey(0))
    ttrainer.g_main_step(tstate, torch.from_numpy(z))
    np.testing.assert_allclose(tstate.G.mapping.w_avg.numpy(),
                               np.asarray(jstate["g"]["moving_stats"]["mapping"]["w_avg"]),
                               rtol=1e-5, atol=1e-6)
    # The accumulated gradient is the rounds' mean (checked above), so the
    # update is held as a single round's is.
    grads_j = {n: g.numpy() for n, g in zip((n for n, _ in tstate.G.named_parameters()), grads)}
    _check_updates(tstate.G.named_parameters(), _flat(host["g"]["params"]),
                   _flat(jax.device_get(jstate["g"]["params"])), grads_j,
                   jtrainer.cfg.g_lr * 4 / 5)


def test_train_iteration_applies_one_reference_ema_update():
    """The port's counterpart of tests/test_ema_fold.py: one iteration
    applies exactly one EMA update, with the reference beta at the
    pre-advance image count, to the post-G-stage weights; w_avg is copied."""
    tg, td = _cfgs(tcfg)
    cfg = tts.TrainConfig(batch_size=4, batch_gpu=4, g_reg_interval=None, d_reg_interval=None)
    trainer = tts.GANTrainer(tg, td, cfg, device="cpu")
    state = trainer.init_state(seed=0)
    gs0 = {n: p.detach().clone() for n, p in state.G_ema.named_parameters()}
    nimg0 = state.cur_nimg
    real = torch.from_numpy(_inputs(1, 4)[1][0])
    stats = trainer.train_iteration(state, real, step=0)
    assert all(np.isfinite(v) for v in stats.values())
    assert state.cur_nimg == nimg0 + 4
    beta = tts.ema_beta(4, nimg0, cfg.ema_kimg, cfg.ema_rampup)
    np.testing.assert_allclose(beta, float(jts.ema_beta(4, jnp.asarray(nimg0), cfg.ema_kimg,
                                                        cfg.ema_rampup)), rtol=1e-6)
    g_now = dict(state.G.named_parameters())
    for name, e in state.G_ema.named_parameters():
        want = g_now[name] + beta * (gs0[name] - g_now[name])
        torch.testing.assert_close(e, want.detach(), rtol=1e-5, atol=1e-7)
    assert max((e - g_now[n]).abs().max().item() for n, e in state.G_ema.named_parameters()) > 0
    torch.testing.assert_close(state.G_ema.mapping.w_avg, state.G.mapping.w_avg, rtol=0, atol=0)


def test_train_iteration_runs_reg_stages_when_due():
    """G_reg every 4 steps and D_reg every 16, in JAX's order: G_main,
    G_reg, D_main (with the EMA), D_reg; pl_mean moves when G_reg runs."""
    tg, td = _cfgs(tcfg)
    trainer = tts.GANTrainer(tg, td, tts.TrainConfig(batch_size=4, batch_gpu=4), device="cpu")
    state = trainer.init_state(seed=0)
    real = torch.from_numpy(_inputs(1, 4)[1][0])
    ran = []
    for name in ("g_main", "g_reg", "d_main", "d_reg"):
        inner = getattr(trainer, f"{name}_step")
        setattr(trainer, f"{name}_step",
                lambda *a, _inner=inner, _name=name: ran.append(_name) or _inner(*a))
    want = {0: ["g_main", "g_reg", "d_main", "d_reg"], 1: ["g_main", "d_main"],
            4: ["g_main", "g_reg", "d_main"], 16: ["g_main", "g_reg", "d_main", "d_reg"]}
    for step, stages in want.items():
        ran.clear()
        pl_mean = state.pl_mean.clone()
        stats = trainer.train_iteration(state, real, step)
        assert ran == stages, (step, ran)
        assert all(np.isfinite(v) for v in stats.values()), stats
        assert ("Loss/G/reg" in stats) == ("g_reg" in stages)
        assert ("Loss/D/reg" in stats) == ("d_reg" in stages)
        assert (state.pl_mean != pl_mean).item() == ("g_reg" in stages)
    assert state.cur_nimg == 4 * len(want)


def test_train_iterations_with_randomness_on():
    """Noise, attention and component dropout and style mixing on: three
    iterations run with finite losses, and the fused blocks give the same
    gradients as their unfused path from the same draws."""
    tg, td = _cfgs(tcfg)
    tg = dataclasses.replace(tg, local_noise=True, component_dropout=0.2,
                             attention=tcfg.AttentionConfig(dropout=0.12))
    trainer = tts.GANTrainer(tg, td, tts.TrainConfig(batch_size=4, batch_gpu=2), device="cpu")
    state = trainer.init_state(seed=0)
    real = torch.from_numpy(_inputs(1, 4)[1][0])
    for step in (1, 2, 3):
        stats = trainer.train_iteration(state, real, step)
        assert all(np.isfinite(v) for v in stats.values()), stats
    z = torch.from_numpy(_inputs(1, 2)[0])
    w_avg = state.G.mapping.w_avg.clone()
    fused, _ = trainer.g_main_grads(state, z, gen=torch.Generator().manual_seed(5))
    from morphganformer_tpu_torch.models import synthesis as tsyn

    gate = tsyn.packed_structural_ok
    try:
        tsyn.packed_structural_ok = lambda *a: False
        state.G.mapping.w_avg.copy_(w_avg)
        unfused, _ = trainer.g_main_grads(state, z, gen=torch.Generator().manual_seed(5))
    finally:
        tsyn.packed_structural_ok = gate
    for a, b in zip(fused, unfused):
        assert rel_err(a, b) <= 1e-4


@pytest.mark.parametrize("arch", ["skip", "orig"])
def test_layout_stage_grads_match_jax(arch):
    """One G_main and one D_main gradient of the `skip` and `orig` layouts
    (unfused; per-block ToRGB and, for skip, per-block fromrgb) against
    JAX, as test_g_main_step_matches_jax and test_d_main_step_matches_jax
    hold the resnet pair."""
    jg, jd = (dataclasses.replace(c, architecture=arch) for c in _cfgs(jcfg))
    tg, td = (dataclasses.replace(c, architecture=arch) for c in _cfgs(tcfg))
    jtrainer = jts.GANTrainer(jg, jd, _train_cfg(jts, jloss))
    jstate = jtrainer.init_state(seed=0)
    host = jax.device_get({"g": jstate["g"], "d": jstate["d"]})
    ttrainer = tts.GANTrainer(tg, td, _train_cfg(tts, tloss), device="cpu")
    G = load_flax(init_generator(tg, seed=1, device="cpu"), host["g"])
    D = load_flax(tdisc.init_discriminator(td, seed=1, device="cpu"), host["d"])
    tstate = ttrainer.make_state(G, D, seed=0)
    z, real = _inputs(1, 4)

    def g_loss(params):
        g_vars = {"params": params, "moving_stats": host["g"]["moving_stats"]}
        return jloss.g_main_loss(jtrainer.G, jtrainer.D, g_vars, {"params": host["d"]["params"]},
                                 jnp.asarray(z[0]), None, jax.random.PRNGKey(0),
                                 jtrainer.cfg.loss)

    def d_loss(params):
        return jloss.d_main_loss(jtrainer.G, jtrainer.D, host["g"], {"params": params},
                                 jnp.asarray(real[0]), jnp.asarray(z[0]), None,
                                 jax.random.PRNGKey(0), jtrainer.cfg.loss)

    for loss_fn, net, key, run in (
            (g_loss, tstate.G, "g", lambda: ttrainer.g_main_grads(tstate, torch.from_numpy(z))),
            (d_loss, tstate.D, "d", lambda: ttrainer.d_main_grads(
                tstate, torch.from_numpy(real), torch.from_numpy(z)))):
        (loss_j, _), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(host[key]["params"])
        grads_j = _flat(grads_j)
        grads_t, stats = run()
        names = [n for n, _ in net.named_parameters()]
        assert set(names) == set(grads_j)
        np.testing.assert_allclose(stats[f"Loss/{key.upper()}/loss"], float(loss_j), rtol=1e-5)
        for name, g in zip(names, grads_t):
            assert rel_err(g, grads_j[name]) <= 1e-4, (arch, name)


@pytest.mark.parametrize("axis,prob", [(1, 1.0), (2, 0.9), (2, 0.0)])
def test_mix_axis_matches_jax(axis, prob):
    rng = np.random.RandomState(3)
    ws, ws2 = (rng.randn(2, 3, 6, 4).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(7)
    want = jloss._mix_axis(jnp.asarray(ws), jnp.asarray(ws2), key, prob, axis)
    # The cutoff JAX drew from that key (jloss._mix_axis's own draws).
    key_c, key_p = jax.random.split(key)
    n = ws.shape[axis]
    cutoff = int(jnp.where(jax.random.uniform(key_p) < prob,
                           jax.random.randint(key_c, (), 1, n), n))
    got = tloss._mix_axis(torch.from_numpy(ws), torch.from_numpy(ws2), torch.tensor(cutoff), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mixing_cutoff_draws():
    gen = torch.Generator().manual_seed(0)
    draws = np.array([int(tloss.draw_cutoff(6, 0.9, gen, "cpu")) for _ in range(4000)])
    assert draws.min() >= 1 and draws.max() <= 6
    assert abs(np.mean(draws == 6) - 0.1) < 0.02           # no mixing with probability 0.1
    assert abs(np.mean(draws == 3) - 0.9 / 5) < 0.02       # cutoff uniform in [1, 6)


def test_attention_dropout_given_masks_and_keep_rate():
    rng = np.random.RandomState(4)
    probs = rng.rand(2, 1, 5, 4).astype(np.float32)
    m1 = rng.rand(2, 1, 5, 4) < 0.9
    m2 = rng.rand(2, 1, 1, 4) < 0.9
    rate, keep = 0.12, 0.94
    want = np.where(m1, probs / keep, 0.0) * np.where(m2, 1 / keep, 0.0)
    got = attention_dropout(torch.from_numpy(probs), rate, torch.from_numpy(m1),
                            torch.from_numpy(m2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    big = torch.zeros(8, 2, 200, 100)
    a, b = dropout_masks(big, rate, torch.Generator().manual_seed(0))
    assert a.shape == big.shape and b.shape == (8, 2, 1, 100)
    assert abs(a.float().mean().item() - keep) < 0.005
    assert abs(b.float().mean().item() - keep) < 0.02


def test_component_mask_keep_rate():
    tg, _ = _cfgs(tcfg, component_dropout=0.25)
    G = init_generator(tg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    m = G.component_mask(20000, torch.device("cpu"), train=True, gen=gen)
    assert m.shape == (20000, 2) and set(m.unique().tolist()) <= {0.0, 1.0}
    assert abs(m.mean().item() - 0.75) < 0.01
    assert G.component_mask(3, torch.device("cpu")).eq(1).all()


def _smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_launch_counts_match_the_dispatch(monkeypatch):
    """chip_smoke.py asserts exact launches per iteration. On the CPU the
    wrappers take the plain versions, so count the calls of the functions
    that launch on a card, on small configs with the 1024^2 structure (G's
    three top blocks fused, with conv_last; D's two top blocks fused), one
    iteration and one in two rounds."""
    from morphganformer_tpu_torch.ops import fused_conv as fc

    counts = {}

    def count(name, key):
        real = getattr(fc, name)

        def wrapped(*a, **k):
            counts[key] = counts.get(key, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(fc, name, wrapped)

    for name, key in (("_modconv3x3_forward", "modconv3x3"), ("_upconv2_forward", "upconv2"),
                      ("_downconv2_forward", "downconv2"), ("_k1_taps", "modconv3x3_adj"),
                      ("_k3_taps", "upconv2_adj"), ("downconv2_adjoint", "downconv2_adj"),
                      ("conv_dw", "modconv3x3_dw"), ("upconv2_dw", "upconv2_dw"),
                      ("downconv2_dw", "downconv2_dw")):
        count(name, key)
    smoke = _smoke()
    tg = tcfg.GANformerConfig(img_resolution=32, z_dim=8, w_dim=8, k=3, channel_base=256,
                              channel_max=32, end_res=3, mapping=tcfg.MappingConfig(num_layers=2),
                              attention=tcfg.AttentionConfig())
    td = tcfg.DiscriminatorConfig(img_resolution=32, channel_base=256, channel_max=64,
                                  mbstd_group_size=2)
    assert [r for r in td.block_resolutions if tdisc.packed_d_block_eligible(td, r)] == [32, 16]
    for batch, rounds in ((4, 1), (8, 2)):
        trainer = tts.GANTrainer(tg, td, tts.TrainConfig(batch_size=batch, batch_gpu=4),
                                 device="cpu")
        state = trainer.init_state(seed=0)
        counts.clear()
        trainer.train_iteration(state, torch.zeros(batch, 32, 32, 3), step=1)
        want = {k: v for k, v in smoke.per_iteration(rounds).items() if v}
        assert counts == want


def test_smoke_checks_every_training_call_shape():
    """chip_smoke.py holds each training role against its plain version at
    exactly the shapes that one FFHQ-1024 / 1024^2 iteration gives it."""
    from morphganformer_tpu_torch.models import synthesis as tsyn

    smoke = _smoke()
    g, d = tcfg.ffhq1024_config(), tcfg.DiscriminatorConfig()
    want = []
    for res in d.block_resolutions:
        if D_GATE(d, res):
            cin, cout = d.channels(res), d.channels(res // 2)
            for role in ("K3-forward", "K2-use_dw", "K2-use_dw-dw"):
                want += [(role, f"D b{res}", "conv1", res // 2, cin, cout, 3),
                         (role, f"D b{res}", "skip", res // 2, cin, cout, 1)]
            want.append(("K1-dw", f"D b{res}", "conv0", res, cin, cin, 3))
    for res in g.block_resolutions:
        if tsyn.packed_structural_ok(g, res, "random"):
            cin, cout = g.channels(res // 2), g.channels(res)
            want += [("K3-dw", f"G b{res}", "conv0", res // 2, cin, cout, 3),
                     ("K3-dw", f"G b{res}", "skip", res // 2, cin, cout, 1),
                     ("K1-dw", f"G b{res}", "conv1", res, cout, cout, 3)]
    want.append(("K1-dw", f"G b{g.img_resolution}", "conv_last", g.img_resolution, 32, 32, 3))
    assert sorted(smoke.train_calls()) == sorted(want)


def test_smoke_layout_launch_counts_match_the_dispatch(monkeypatch):
    """chip_smoke.py asserts the exact K4 launches of a `skip` iteration with
    MGT_PALLAS_CONV=1. On the CPU, with K4's rule read at 32 times the side
    (so 16^2 stands for 512^2) and its card test taken as passed, count the launches of a small skip
    pair whose blocks of 16^2 and up mirror the 1024^2 structure (G b16
    conv1, b32 conv1 and conv_last; D b32 and b16 conv0), one iteration and
    one in two rounds; and none in the reg stages."""
    from morphganformer_tpu_torch.ops import conv3x3 as k4
    from morphganformer_tpu_torch.ops import fused_conv as fc

    monkeypatch.setenv("MGT_PALLAS_CONV", "1")
    monkeypatch.setattr(k4, "_on_card", lambda t: True)
    real_rule = k4.conv3x3_eligible

    def at_scale(x, w, groups):                  # the rule at 32x the side
        n, h, wd, c = x.shape
        return real_rule(types.SimpleNamespace(shape=(n, 32 * h, 32 * wd, c)), w, groups)
    monkeypatch.setattr(k4, "conv3x3_eligible", at_scale)

    real_launch = k4._conv3x3

    def fake_launch(t, w, key):                  # counted; the plain version on the CPU
        fc.launch_counts[key] += 1
        return real_launch(t, w, key)
    monkeypatch.setattr(k4, "_conv3x3", fake_launch)
    smoke = _smoke()
    tg = tcfg.GANformerConfig(img_resolution=32, z_dim=8, w_dim=8, k=3, channel_base=256,
                              channel_max=32, end_res=3, mapping=tcfg.MappingConfig(num_layers=2),
                              attention=tcfg.AttentionConfig(), architecture="skip")
    td = tcfg.DiscriminatorConfig(img_resolution=32, channel_base=256, channel_max=64,
                                  mbstd_group_size=2, architecture="skip")
    for batch, rounds, step in ((4, 1, 1), (8, 2, 1), (4, 1, 0)):
        trainer = tts.GANTrainer(tg, td, tts.TrainConfig(batch_size=batch, batch_gpu=4),
                                 device="cpu")
        state = trainer.init_state(seed=0)
        fc.reset_launch_counts()
        trainer.train_iteration(state, torch.zeros(batch, 32, 32, 3), step=step)
        assert dict(fc.launch_counts) == smoke.layout_per_iteration(rounds), (batch, step)
