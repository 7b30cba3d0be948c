"""The conditional generator and discriminator (c_dim > 0) of the port
against the JAX package, and their training stages with labels.

G is the iterative-conditional set of chip_smoke.py's phase options at a
small size: k 9, the iterative carry with kmeans_iters 2, the linear
encoding, c_dim 3 with the non-resnet mapping (JAX's resnet mapping fails
on labels). D has c_dim 3 and its 16^2 block on the fused ops (their plain
versions here), as b1024/b512 at 1024^2. Weights and checkpoints as
tests/test_torch_options.py; the training stages with randomness off as
tests/test_torch_reg.py (JAX's path-length noise handed to the port), and
held by its tolerances: main stages and path length, every leaf within
1e-4 of its largest entry, floored at 1e-3 of the stage's; R1 within 1e-4
of the stage's largest entry."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from morphganformer_tpu.checkpoint import io as jio
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.discriminator import Discriminator as JDiscriminator
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch.checkpoint import io as tio
from morphganformer_tpu_torch.checkpoint import load_flax, to_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_checkpoint_io import assert_bit_equal, leaves
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_options import TOL, carry_set, check_forward, perturbed, round_trip
from .test_torch_reg import _check_grads, _flat, _pl_noise

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

C_DIM = 3
G_KW = dict(k=9, c_dim=C_DIM, local_noise=False, mapping=dict(resnet=False),
            attention=dict(iterative=True, kmeans_iters=2, pos_type="linear", dropout=0.0))


def d_cfg(mod):
    return mod.DiscriminatorConfig(img_resolution=16, channel_base=256, channel_max=32,
                                   mbstd_group_size=2, c_dim=C_DIM)


@pytest.fixture(autouse=True)
def force_fused_d(monkeypatch):
    """D's b16 (16 -> 32 channels) on the fused ops, as b1024/b512 at 1024^2."""
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))


def carry_d(tmp, seed=2):
    """(JAX D, its tree, the port's D from JAX's checkpoint of it)."""
    tree = perturbed(to_flax(tdisc.init_discriminator(d_cfg(tcfg), seed=seed, device="cpu")),
                     seed)
    model = JDiscriminator(d_cfg(jcfg))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 16, 3)),
                                               jnp.zeros((2, C_DIM))))
    assert {k: v.shape for k, v in leaves(tree).items()} == {
        "/".join(str(getattr(k, "key", k)) for k in p): tuple(v.shape)
        for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    assert tree["params"]["b4"]["out"]["weight"].shape == (32, C_DIM)
    jio.save_discriminator(str(tmp), d_cfg(jcfg), tree)
    cfg, D = tio.load_discriminator(str(tmp), device="cpu")
    assert cfg == d_cfg(tcfg)
    return model, tree, D


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("conditional") / "jax"
    return carry_set(G_KW, tmp) + carry_d(tmp)


def labels(seed, n=4):
    return np.random.RandomState(seed).randn(n, C_DIM).astype(np.float32)


def test_conditional_generator_matches_jax(pair):
    model, tree, G = pair[:3]
    check_forward(model, tree, G)


def test_conditional_resnet_mapping_without_transformer(tmp_path):
    """JAX's resnet mapping takes labels where the global chain's input,
    z_dim + embed_dim, is the layer width and there are no components."""
    kw = dict(k=1, c_dim=C_DIM, transformer=False, mapping=dict(layer_dim=16))
    model, tree, G, _ = carry_set(kw, tmp_path / "jax")
    check_forward(model, tree, G)


def test_conditional_discriminator_matches_jax(pair):
    jd, tree, D = pair[4:]
    img = np.random.RandomState(1).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    c = labels(2)
    want = np.asarray(jax.jit(jd.apply)(tree, jnp.asarray(img), jnp.asarray(c)))
    with torch.no_grad():
        got = D(torch.from_numpy(img), torch.from_numpy(c))
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="c_dim 3"):
        D(torch.from_numpy(img))


def test_checkpoint_round_trip(pair, tmp_path):
    _, g_tree, G, ckpt, _, d_tree, D = pair
    round_trip(g_tree, G, ckpt, tmp_path)
    assert_bit_equal(to_flax(D), d_tree)
    tio.save_discriminator(str(tmp_path), D.cfg, D)
    with open(tmp_path / "D.msgpack", "rb") as f:
        assert_bit_equal(serialization.msgpack_restore(f.read()), d_tree)
    assert json.load(open(tmp_path / "arch.json"))["D"] == json.load(open(ckpt / "arch.json"))["D"]


def trainers(pair, batch_gpu=4):
    """JAX's trainer with a state built from the carried trees (JAX's
    `init_state` runs G's init without labels, which a conditional G
    cannot), and the port's trainer with a state around the same nets."""
    _, g_tree, G, _, _, d_tree, D = pair
    jg, jd = jcfg.GANformerConfig.from_json(G.cfg.to_json()), d_cfg(jcfg)
    cfg = dict(batch_size=4, batch_gpu=batch_gpu)
    jtrainer = jts.GANTrainer(jg, jd, jts.TrainConfig(
        loss=jloss.LossConfig(style_mixing=0.0), **cfg))
    host = {"g": jax.tree_util.tree_map(jnp.asarray, g_tree),
            "d": jax.tree_util.tree_map(jnp.asarray, d_tree)}
    jstate = {"g": host["g"], "d": host["d"],
              "gs_params": jax.tree_util.tree_map(jnp.copy, host["g"]["params"]),
              "gs_stats": jax.tree_util.tree_map(jnp.copy, host["g"]["moving_stats"]),
              "g_opt": jtrainer.g_opt.init(host["g"]["params"]),
              "d_opt": jtrainer.d_opt.init(host["d"]["params"]),
              "pl_mean": jnp.zeros([], jnp.float32), "cur_nimg": jnp.zeros([], jnp.int32)}
    ttrainer = tts.GANTrainer(G.cfg, D.cfg, tts.TrainConfig(
        loss=tloss.LossConfig(style_mixing=0.0), **cfg), device="cpu")
    G2 = load_flax(type(G)(G.cfg), g_tree)
    D2 = load_flax(type(D)(D.cfg), d_tree)
    return jtrainer, jstate, ttrainer, ttrainer.make_state(G2, D2, seed=0)


@pytest.mark.parametrize("stage", ["g_main", "d_main", "g_reg", "d_reg"])
def test_stage_gradients_with_labels_match_jax(pair, monkeypatch, stage):
    """G_main, D_main, G_reg (path length) and D_reg (R1) at the carried
    weights, each with the batch's labels: the loss and every parameter
    gradient against JAX's stage loss under `jax.value_and_grad` (the reg
    stages' gradients divided by their interval, which the trainer folds
    in)."""
    jtrainer, jstate, ttrainer, tstate = trainers(pair)
    rng = np.random.RandomState(0)
    z = rng.randn(4, 9, 8).astype(np.float32)
    real = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    c = labels(3)
    zj, realj, cj = jnp.asarray(z), jnp.asarray(real), jnp.asarray(c)
    zt, realt, ct = (torch.from_numpy(a)[None] for a in (z, real, c))
    key, cfg = jax.random.PRNGKey(0), jtrainer.cfg.loss
    g_vars, d_vars = jstate["g"], jstate["d"]
    pl_rng = jax.random.PRNGKey(3)
    real_pl = tloss.g_pl_loss
    monkeypatch.setattr(tts, "g_pl_loss", lambda *a: real_pl(
        *a, pl_noise=torch.from_numpy(_pl_noise(pl_rng, 2))))
    jax_loss, params, port, key_stat, gain, floor = {
        "g_main": (lambda p: jloss.g_main_loss(jtrainer.G, jtrainer.D, dict(g_vars, params=p),
                                               d_vars, zj, cj, key, cfg),
                   g_vars["params"], lambda: ttrainer.g_main_grads(tstate, zt, c=ct),
                   "Loss/G/loss", 1, 1e-3),
        "d_main": (lambda p: jloss.d_main_loss(jtrainer.G, jtrainer.D, g_vars, {"params": p},
                                               realj, zj, cj, key, cfg),
                   d_vars["params"], lambda: ttrainer.d_main_grads(tstate, realt, zt, c=ct),
                   "Loss/D/loss", 1, 1e-3),
        "g_reg": (lambda p: jloss.g_pl_loss(jtrainer.G, dict(g_vars, params=p), zj, cj, pl_rng,
                                            jnp.float32(0.0), cfg),
                  g_vars["params"], lambda: ttrainer.g_reg_grads(tstate, zt, c=ct)[:2],
                  "Loss/G/reg", jtrainer.cfg.g_reg_interval, 1e-3),
        "d_reg": (lambda p: jloss.d_r1_loss(jtrainer.D, {"params": p}, realj, cj, cfg),
                  d_vars["params"], lambda: ttrainer.d_reg_grads(tstate, realt, c=ct),
                  "Loss/D/reg", jtrainer.cfg.d_reg_interval, 1.0),
    }[stage]
    (loss_j, _), want = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    grads, stats = port()
    net = tstate.G if stage.startswith("g") else tstate.D
    got = {n: g.numpy() / gain for (n, _), g in zip(net.named_parameters(), grads)}
    np.testing.assert_allclose(float(stats[key_stat]), float(loss_j), rtol=1e-5)
    _check_grads(got, _flat(jax.device_get(want)), floor)
