"""The regularisation stages of the port (training/loss.py `g_pl_loss`,
`d_r1_loss`; training/train_step.py G_reg and D_reg) against the JAX
package, on small configs with the weights carried over, and the two
routes that they run on: this module holds the unpacked one
(MGT_PACKED_SECOND_ORDER=0), test_torch_second_order.py the scoped
second-order route, the default.

Randomness is off on both sides as in test_torch_train_step.py (no local
noise, attention dropout 0, no component dropout, no style mixing); the
path-length noise is drawn with JAX's own calls (`_g_pl_loss`,
loss.py:183-195) and handed to the port. JAX runs its unpacked fallback
(MGT_PACKED_SECOND_ORDER=0; on the CPU its packed gates are off anyway).
Tolerances: losses and pl_mean 1e-5 relative; every parameter gradient
within 1e-4 of its leaf's largest entry, floored at 1e-3 of the stage's
largest, for path length, and within 1e-4 of the stage's largest entry for
R1 (float32 sums in another order through a second derivative; see
`test_d_r1_loss_matches_jax`)."""

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
from morphganformer_tpu_torch.ops.packed_override import force_unpacked
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RES = 16


@pytest.fixture(autouse=True)
def unpacked_jax(monkeypatch):
    monkeypatch.setenv("MGT_PACKED_SECOND_ORDER", "0")


@pytest.fixture()
def force_fused_d(monkeypatch):
    """D's b16 (16 -> 32 channels) on the fused ops, as b1024/b512 at 1024^2."""
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))


def _cfgs(mod, arch):
    g = mod.GANformerConfig(img_resolution=RES, z_dim=8, w_dim=8, k=3, channel_base=256,
                            channel_max=32, end_res=3, local_noise=False, architecture=arch,
                            mapping=mod.MappingConfig(num_layers=2),
                            attention=mod.AttentionConfig(dropout=0.0))
    d = mod.DiscriminatorConfig(img_resolution=RES, channel_base=256, channel_max=32,
                                mbstd_group_size=2, architecture=arch)
    return g, d


def _train_cfg(mod, loss_mod, **kw):
    return mod.TrainConfig(batch_size=4, batch_gpu=kw.pop("batch_gpu", 4),
                           loss=loss_mod.LossConfig(style_mixing=0.0), **kw)


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def rel_err(got, want, floor=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


def _check_grads(got, want, floor_of_stage=1e-3):
    """Every leaf within 1e-4 of its largest entry, that floored at
    `floor_of_stage` of the stage's largest: leaves of zero true gradient
    (the key biases before a softmax) hold rounding noise near 1e-8 on both
    sides."""
    assert set(got) == set(want)
    floor = floor_of_stage * max(np.abs(v).max() for v in want.values())
    for name, g in got.items():
        assert rel_err(g, want[name], floor) <= 1e-4, name


def _pair(arch, **train_kw):
    """JAX trainer and state (w_avg off zero, non-zero biases); the port's
    trainer and state with the same weights."""
    jg, jd = _cfgs(jcfg, arch)
    tg, td = _cfgs(tcfg, arch)
    jtrainer = jts.GANTrainer(jg, jd, _train_cfg(jts, jloss, **train_kw))
    jstate = jtrainer.init_state(seed=0)
    rng = np.random.RandomState(9)
    for net in ("g", "d"):
        jstate[net] = jax.tree_util.tree_map_with_path(
            lambda p, x: x + (0.3 if "w_avg" in jax.tree_util.keystr(p) else
                              0.1 * rng.randn(*np.shape(x)).astype(np.float32)
                              if "bias" in jax.tree_util.keystr(p) else 0.0), jstate[net])
    host = jax.device_get({"g": jstate["g"], "d": jstate["d"]})
    ttrainer = tts.GANTrainer(tg, td, _train_cfg(tts, tloss, **train_kw), device="cpu")
    G = load_flax(init_generator(tg, seed=1, device="cpu"), host["g"])
    D = load_flax(tdisc.init_discriminator(td, seed=1, device="cpu"), host["d"])
    return jtrainer, jstate, host, ttrainer, ttrainer.make_state(G, D, seed=0)


def _pl_noise(rng, batch):
    """The path-length noise JAX's `_g_pl_loss` draws from `rng`."""
    _, rng_noise = jax.random.split(rng)
    return np.asarray(jax.random.normal(rng_noise, (batch, RES, RES, 3)) / np.sqrt(RES * RES))


def _grads(loss, net):
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, params, grads)}


@pytest.mark.parametrize("arch", ["resnet", "skip"])
def test_g_pl_loss_matches_jax(arch):
    jtrainer, _, host, ttrainer, tstate = _pair(arch)
    z = np.random.RandomState(0).randn(4, 3, 8).astype(np.float32)
    rng, pl_mean = jax.random.PRNGKey(3), 0.4

    def loss_fn(params):
        g_vars = dict(host["g"], params=params)
        return jloss.g_pl_loss(jtrainer.G, g_vars, jnp.asarray(z), None, rng,
                               jnp.float32(pl_mean), jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        host["g"]["params"])
    grads_j = _flat(grads_j)
    loss_t, aux_t = tloss.g_pl_loss(tstate.G, torch.from_numpy(z), ttrainer.cfg.loss,
                                    torch.Generator(), torch.tensor(pl_mean),
                                    pl_noise=torch.from_numpy(_pl_noise(rng, 2)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for key in ("pl_mean", "Loss/pl_penalty"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5)
    assert float(aux_t["pl_mean"]) != pl_mean
    _check_grads(_grads(loss_t, tstate.G), grads_j)


@pytest.mark.parametrize("arch", ["resnet", "skip"])
def test_d_r1_loss_matches_jax(arch, force_fused_d):
    jtrainer, _, host, ttrainer, tstate = _pair(arch)
    real = np.random.RandomState(1).randn(4, RES, RES, 3).astype(np.float32)

    def loss_fn(params):
        return jloss.d_r1_loss(jtrainer.D, {"params": params}, jnp.asarray(real), None,
                               jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        host["d"]["params"])
    grads_j = _flat(grads_j)
    loss_t, aux_t = tloss.d_r1_loss(tstate.D, torch.from_numpy(real), ttrainer.cfg.loss)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["Loss/r1_penalty"]),
                               float(aux_j["Loss/r1_penalty"]), rtol=1e-5)
    # R1's bias gradients are sums that cancel to 0.4-3 % of the stage's
    # largest entry; float32 rounding moves them by up to 2e-3 of
    # themselves on either side (the port's float32 against its float64:
    # 2.0e-3; JAX's float32 against the port's float64: 7.7e-4), which is
    # 7e-5 of the stage's largest entry. So every leaf is held to 1e-4 of
    # the stage's largest entry.
    _check_grads(_grads(loss_t, tstate.D), grads_j, floor_of_stage=1.0)


def _count_fused(monkeypatch):
    """Count the fused Functions' calls where the layers make them."""
    calls = {"fused": 0}
    import morphganformer_tpu_torch.models.layers as tlayers
    import morphganformer_tpu_torch.models.synthesis as tsyn

    for mod in (tlayers, tsyn):
        for name in ("fused_modconv3x3", "fused_upconv2", "fused_downconv2"):
            if hasattr(mod, name):
                real = getattr(mod, name)

                def counting(*a, _real=real, **k):
                    calls["fused"] += 1
                    return _real(*a, **k)
                monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("packed_second_order", ["0", None])
def test_reg_stages_run_on_the_unpacked_route(monkeypatch, force_fused_d, packed_second_order):
    """With MGT_PACKED_SECOND_ORDER=0 the reg stages run under
    force_unpacked(): neither net reaches a fused Function (the main stages
    do, on the same nets), so R1 and path length differentiate twice; and
    R1 through fused blocks built outside a scope raises instead of
    returning a wrong zero. With it unset they run inside
    second_order_scope() on the fused Functions, with the penalties and
    parameter gradients of the unpacked route (the tolerances of the stage
    tests above)."""
    calls = _count_fused(monkeypatch)
    _, _, _, ttrainer, tstate = _pair("resnet")
    z = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 8).astype(np.float32))
    real = torch.from_numpy(np.random.RandomState(1).randn(4, RES, RES, 3).astype(np.float32))

    def stages():
        return [(tloss.g_pl_loss(tstate.G, z, ttrainer.cfg.loss, torch.Generator(),
                                 torch.tensor(0.0)), tstate.G),
                (tloss.d_r1_loss(tstate.D, real, ttrainer.cfg.loss), tstate.D)]

    tloss.d_main_loss(tstate.G, tstate.D, real, z, ttrainer.cfg.loss, torch.Generator())
    assert calls["fused"] > 0
    calls["fused"] = 0
    unpacked = stages()
    for (loss, _), _ in unpacked:
        assert torch.isfinite(loss)
        assert loss.requires_grad
    assert calls["fused"] == 0
    if packed_second_order is None:
        monkeypatch.delenv("MGT_PACKED_SECOND_ORDER")
        for ((loss, stats), net), ((want, want_stats), _), floor in zip(stages(), unpacked,
                                                                        (1e-3, 1.0)):
            np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
            for key, v in stats.items():
                np.testing.assert_allclose(float(v), float(want_stats[key]), rtol=1e-5)
            _check_grads({k: v.numpy() for k, v in _grads(loss, net).items()},
                         {k: v.numpy() for k, v in _grads(want, net).items()}, floor)
        assert calls["fused"] > 0
        return
    x = real.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(tstate.D(x).sum(), x, create_graph=True)
    with force_unpacked():
        g, = torch.autograd.grad(tstate.D(x).sum(), x, create_graph=True)
    assert g.requires_grad


def _adam_moves(g1, g2, lr, b2, d1, d2, eps=1e-8):
    """The most that two Adam steps (beta1 0, as in the reference) can move
    an element between two runs whose gradients differ by up to 2 d1 in the
    first step and 2 d2 in the second: the spread of u1 = g1 / (|g1| + eps)
    and of u2 = g2 / (sqrt((b2 g1^2 + g2^2) / (1 + b2)) + eps), times lr,
    over that box. u1 rises with g1, u2 with g2, and |u2| falls with |g1|,
    so the extremes lie at the box's corners or at g1 = 0."""
    u1 = lambda a: a / (np.abs(a) + eps)                                   # noqa: E731
    u2 = lambda a, b: b / (np.sqrt((b2 * a * a + b * b) / (1 + b2)) + eps)  # noqa: E731
    a_lo, a_hi, b_lo, b_hi = g1 - 2 * d1, g1 + 2 * d1, g2 - 2 * d2, g2 + 2 * d2
    a_mid = np.where((a_lo <= 0) & (a_hi >= 0), 0.0, g1)
    vals = np.stack([u2(a, b) for a in (a_lo, a_hi, a_mid) for b in (b_lo, b_hi)])
    return lr * (u1(a_hi) - u1(a_lo) + vals.max(0) - vals.min(0))


def test_train_iteration_matches_jax_at_step_0(monkeypatch, force_fused_d):
    """All four stages at step 0, batch 4 in two rounds, JAX's z and
    path-length noise (its own draws from the iteration's key) handed to
    the port: the stats, pl_mean, and the weights after the iteration, which
    took two Adam steps on each net, within 1e-6 plus the most those steps
    can move an element when each stage's gradient moves by twice the
    gradient tolerance (1e-4 of its leaf's largest entry, floored at 1e-3 of
    the stage's): the existing tolerance of test_torch_train_step.py carried
    to two steps, with the port's own stage gradients for the sizes."""
    jtrainer, jstate, host, ttrainer, tstate = _pair("resnet", batch_gpu=2)
    real = np.random.RandomState(2).randn(4, RES, RES, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    # JAX's own draws in `train_iteration` (train_step.py:370-386) and
    # `g_reg_step` (:256), as `_g_pl_loss` splits them.
    rngs = jax.random.split(key, 8)
    z = np.asarray(jax.random.normal(rngs[0], (2, 2, 3, 8)))
    noises = iter([torch.from_numpy(_pl_noise(r, 1)) for r in jax.random.split(rngs[2], 2)])
    real_pl = tloss.g_pl_loss
    monkeypatch.setattr(tts, "g_pl_loss", lambda *a: real_pl(*a, pl_noise=next(noises)))
    stage_grads, real_stage_grads = [], tts.stage_grads

    def recording(params, rounds, mesh=None):
        out = real_stage_grads(params, rounds, mesh)
        stage_grads.append([g.numpy() for g in out[0]])
        return out
    monkeypatch.setattr(tts, "stage_grads", recording)

    jstate, jstats = jtrainer.train_iteration(jstate, jnp.asarray(real), key, step=0)
    tstats = ttrainer.train_iteration(tstate, torch.from_numpy(real), 0,
                                      z=torch.from_numpy(z.reshape(4, 3, 8)))
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
