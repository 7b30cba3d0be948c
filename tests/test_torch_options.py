"""The GANformer attention options of the port against the JAX package:
gating of the attention's rows and columns (`img_gate`, `ltnt_gate`, and
`ltnt_gate` on the mapping's self-attention), `kmeans_iters` 2 with and
without k-means, two heads, the iterative centroid carry, and the trainable
and linear positional encodings.

Each set's weights are the port's init with every bias, gain and
positional table perturbed from a numpy seed; they go through a JAX
checkpoint directory (JAX's `save_generator`) into the port's
`load_generator` (and so `load_flax`), and their tree is held against the
paths and shapes of JAX's own init (`jax.eval_shape`). The synthesis has
attention at 4^2 and 8^2 and a fused 16^2 block (on the CPU the kernels'
plain versions), so the carry passes through the fused block as JAX's
packed branch passes it. Tolerance 2e-4, as tests/test_torch_generator.py.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from morphganformer_tpu.checkpoint import io as jio
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu_torch.checkpoint import io as tio
from morphganformer_tpu_torch.checkpoint import to_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator, set_compute_dtype
from morphganformer_tpu_torch.models import synthesis as tsyn

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_bf16 import _closer
from .test_torch_checkpoint_io import assert_bit_equal, leaves
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

TOL = 2e-4

SETS = {
    "gated": dict(k=5, mapping=dict(ltnt_gate=True),
                  attention=dict(ltnt_gate=True, img_gate=True, kmeans_iters=2,
                                 pos_type="trainable")),
    "gated_heads2": dict(k=5, attention=dict(num_heads=2, ltnt_gate=True, img_gate=True,
                                             pos_init="normal")),
    "iters_without_kmeans": dict(k=5, attention=dict(kmeans=False, kmeans_iters=2)),
    "iterative": dict(k=9, attention=dict(iterative=True, kmeans_iters=2, pos_type="linear")),
}


def g_cfg(mod, k, mapping=None, attention=None, **kw):
    """16^2, attention at 4^2 and 8^2 (end_res 4), b16 fused."""
    base = dict(img_resolution=16, z_dim=8, w_dim=8, channel_base=256, channel_max=32,
                end_res=4)
    base.update(kw)
    return mod.GANformerConfig(k=k, mapping=mod.MappingConfig(num_layers=2, **(mapping or {})),
                               attention=mod.AttentionConfig(**(attention or {})), **base)


def perturbed(tree, seed):
    """The tree with every bias, gain, table and const-noise strength moved
    off its init (numpy seed): a fresh init's zeros and ones would hide a
    wrong path."""
    rng = np.random.RandomState(seed)

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in ("noise_strength", "w_avg"):
            return node + np.float32(0.3)
        if name in ("bias", "att_weight", "pos0", "pos1"):
            return (node + 0.1 * rng.randn(*node.shape)).astype(np.float32)
        return node
    return walk(tree)


def jax_init_shapes(model, cfg):
    """{path: shape} of JAX's init tree, traced only."""
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "mask", "dropout"))}
    c = jnp.zeros((1, cfg.c_dim)) if cfg.c_dim else None
    tree = jax.eval_shape(lambda: model.init(rngs, jnp.zeros((1, cfg.k, cfg.z_dim)), c,
                                             noise_mode="const"))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def carry_set(kw, tmp, seed=1):
    """(JAX model, the tree, the port's G loaded from JAX's checkpoint of
    it, the checkpoint directory)."""
    jc, tc = g_cfg(jcfg, **kw), g_cfg(tcfg, **kw)
    tree = perturbed(to_flax(init_generator(tc, seed=seed, device="cpu")), seed)
    model = JGenerator(jc)
    assert {k: v.shape for k, v in leaves(tree).items()} == jax_init_shapes(model, jc)
    jio.save_generator(str(tmp), jc, tree)
    cfg, G = tio.load_generator(str(tmp), device="cpu")
    assert cfg == tc
    return model, tree, G, tmp


def round_trip(tree, G, ckpt, tmp):
    """The port's G from a JAX checkpoint holds its tree leaf for leaf, and
    writes it back leaf for leaf, with the same arch.json."""
    assert_bit_equal(to_flax(G), tree)
    tio.save_generator(str(tmp), G.cfg, G)
    with open(tmp / "Gs.msgpack", "rb") as f:
        assert_bit_equal(serialization.msgpack_restore(f.read()), tree)
    assert json.load(open(tmp / "arch.json"))["Gs"] == json.load(open(ckpt / "arch.json"))["Gs"]


def inputs(cfg, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    z = rng.randn(batch, cfg.k, cfg.z_dim).astype(np.float32)
    c = rng.randn(batch, cfg.c_dim).astype(np.float32) if cfg.c_dim else None
    return z, c


def jax_forward(model, tree, z, c=None, return_att=False):
    fn = jax.jit(lambda v, zz, cc: model.apply(v, zz, cc, truncation_psi=0.7,
                                               noise_mode="const", return_ws=True,
                                               return_att=return_att))
    return [np.asarray(a) for a in fn(tree, jnp.asarray(z), None if c is None else jnp.asarray(c))]


def check_forward(model, tree, G):
    """Image and ws against JAX, on the fused route and on the unfused one."""
    z, c = inputs(G.cfg)
    img_j, ws_j = jax_forward(model, tree, z, c)
    ct = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        img_t, ws_t = G(torch.from_numpy(z), ct, truncation_psi=0.7, return_ws=True)
    np.testing.assert_allclose(ws_t.numpy(), ws_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=TOL, atol=TOL)
    return z, ct, img_t


@pytest.fixture(scope="module", params=list(SETS))
def carried(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    return (request.param,) + carry_set(SETS[request.param], tmp / "jax")


def test_image_and_ws_match_jax(carried, monkeypatch):
    name, model, tree, G, _ = carried
    fused = [r for r in G.cfg.block_resolutions if tsyn.packed_structural_ok(G.cfg, r, "const")]
    assert fused == [16]
    z, _, img = check_forward(model, tree, G)
    monkeypatch.setattr(tsyn, "packed_structural_ok", lambda *a: False)
    with torch.no_grad():
        img_u = G(torch.from_numpy(z), truncation_psi=0.7)
    np.testing.assert_allclose(img_u.numpy(), img.numpy(), rtol=TOL, atol=TOL)


def test_checkpoint_round_trip(carried, tmp_path):
    _, _, tree, G, ckpt = carried
    round_trip(tree, G, ckpt, tmp_path)


@pytest.fixture(scope="module")
def gated_and_iterative(tmp_path_factory):
    return {name: carry_set(SETS[name], tmp_path_factory.mktemp(name) / "jax")
            for name in ("gated", "iterative")}


@pytest.mark.parametrize("name", ["gated", "iterative"])
def test_return_att_matches_jax(gated_and_iterative, name):
    """The gated (and carried) probabilities that JAX's `return_att`
    returns, up-sampled to the image, and the same image."""
    model, tree, G, _ = gated_and_iterative[name]
    z, _ = inputs(G.cfg, seed=3)
    img_j, att_j, _ = jax_forward(model, tree, z, return_att=True)
    with torch.no_grad():
        img_t, att_t = G(torch.from_numpy(z), truncation_psi=0.7, return_att=True)
    assert att_t.shape == att_j.shape == (2, G.cfg.k - 1, 3, G.cfg.attention.num_heads, 16, 16)
    np.testing.assert_allclose(att_t.numpy(), att_j, rtol=TOL, atol=2e-5)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=TOL, atol=TOL)
    if name == "gated":
        # Gated rows no longer sum to 1 over the components.
        assert np.abs(att_j.sum(axis=1) - 1).max() > 1e-2


@pytest.mark.parametrize("name", ["gated", "iterative"])
def test_ws_gradient_matches_jax_vjp(gated_and_iterative, name):
    """The gradient of sum(img * g) w.r.t. ws against `jax.vjp` of JAX's
    synthesis, through the gates and through the carry."""
    model, tree, G, _ = gated_and_iterative[name]
    cfg = G.cfg
    rng = np.random.RandomState(4)
    ws = (0.5 * rng.randn(2, cfg.k, cfg.num_ws, cfg.w_dim)).astype(np.float32)
    cot = rng.randn(2, 16, 16, 3).astype(np.float32)

    def synth(w):
        return model.apply(tree, ws=w, noise_mode="const")

    want = np.asarray(jax.jit(lambda w, g: jax.vjp(synth, w)[1](g)[0])(jnp.asarray(ws),
                                                                     jnp.asarray(cot)))
    ws_t = torch.from_numpy(ws).requires_grad_(True)
    (G(ws=ws_t) * torch.from_numpy(cot)).sum().backward()
    got = ws_t.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["gated", "iterative"])
def test_bf16_generator_lies_closer_to_jax_bf16(gated_and_iterative, name):
    """In bfloat16 (gates, k-means passes and the carry on bfloat16
    activations, the probabilities float32) the port's image lies closer
    to JAX's bfloat16 image than JAX's bfloat16 lies to its float32
    (tests/test_torch_bf16.py's criterion)."""
    model, tree, G, _ = gated_and_iterative[name]
    z, _ = inputs(G.cfg, seed=5)
    want = {dt: np.asarray(jax_forward(JGenerator(dataclasses.replace(model.cfg, dtype=dt)),
                                       tree, z)[0])
            for dt in ("float32", "bfloat16")}
    set_compute_dtype(G, "bfloat16")
    try:
        with torch.no_grad():
            img = G(torch.from_numpy(z), truncation_psi=0.7)
    finally:
        set_compute_dtype(G, "float32")
    _closer(img, want["bfloat16"], want["float32"])
