"""The GANformer mapping options of the port against the JAX package: the
StyleGAN2-like generator without the transformer (k 1 and k 5), the shared
mapping (k 2, resnet and not, with the trainable2d encoding), the iterative
carry alone at k 9; one transformer layer in each attention mode against
JAX's layer; and the configurations that JAX itself fails on, which the
port refuses at construction with a ValueError that names the shapes.

Weights, checkpoints and tolerances as tests/test_torch_options.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models import transformer as jtr
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import transformer as ttr

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_options import (TOL, carry_set, check_forward, g_cfg, jax_init_shapes,
                                 perturbed, round_trip)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

SETS = {
    "stylegan2_k1": dict(k=1, transformer=False),
    "no_transformer_k5": dict(k=5, transformer=False),
    "shared_k2": dict(k=2, mapping=dict(shared=True), attention=dict(pos_type="trainable2d")),
    "shared_k2_plain_mlp": dict(k=2, mapping=dict(shared=True, resnet=False)),
    "iterative_k9": dict(k=9, attention=dict(iterative=True)),
}


@pytest.fixture(scope="module", params=list(SETS))
def carried(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    return (request.param,) + carry_set(SETS[request.param], tmp / "jax")


def test_image_and_ws_match_jax(carried):
    name, model, tree, G, _ = carried
    check_forward(model, tree, G)
    if name == "stylegan2_k1":
        assert tuple(G.pos.shape) == (0, G.cfg.w_dim)
        assert not hasattr(G.mapping, "mlp")


def test_checkpoint_round_trip(carried, tmp_path):
    _, _, tree, G, ckpt = carried
    round_trip(tree, G, ckpt, tmp_path)


# (options, what JAX raises, what the port's ValueError says)
FAILING = {
    "conditional_resnet_mapping": (dict(k=5, c_dim=3), AssertionError, "resnet MLP layer 0"),
    "shared_k5": (dict(k=5, mapping=dict(shared=True)), TypeError, "needs k = 2"),
    "iterative_k17": (dict(k=17, attention=dict(iterative=True)), TypeError, r"F\*N = 2\*T"),
    "conditional_no_transformer_k5": (dict(k=5, c_dim=3, transformer=False,
                                           mapping=dict(resnet=False)), TypeError,
                                      "needs k = 1"),
}


@pytest.mark.parametrize("name", list(FAILING))
def test_configs_jax_fails_on_are_refused(name):
    """JAX fails inside its init (traced: `jax.eval_shape`); the port
    refuses the same configuration when it builds the generator."""
    kw, jax_error, message = FAILING[name]
    with pytest.raises(jax_error):
        jax_init_shapes(JGenerator(g_cfg(jcfg, **kw)), g_cfg(jcfg, **kw))
    with pytest.raises(ValueError, match=message):
        init_generator(g_cfg(tcfg, **kw), device="cpu")


def test_conditional_generator_needs_labels():
    """A conditional G called without c raises a ValueError naming c_dim."""
    G = init_generator(g_cfg(tcfg, k=1, c_dim=3, transformer=False,
                             mapping=dict(resnet=False)), device="cpu")
    with pytest.raises(ValueError, match="c_dim 3"):
        G(torch.zeros(1, 1, 8))
    with pytest.raises(ValueError, match="c_dim 3"):
        G(torch.zeros(2, 1, 8), torch.zeros(1, 3))
    assert G(torch.zeros(2, 1, 8), torch.zeros(2, 3)).shape == (2, 16, 16, 3)


LAYER_CASES = {
    "kmeans_iters2_gates": dict(kmeans=True, kmeans_iters=2, from_gate=True, to_gate=True),
    "plain_iters2_heads2_gates": dict(kmeans=False, kmeans_iters=2, num_heads=2,
                                      from_gate=True, to_gate=True),
    "iterative_first": dict(kmeans=True, iterative=True, kmeans_iters=2),
    "iterative_carried": dict(kmeans=True, iterative=True, kmeans_iters=2, to_gate=True),
    "iterative_no_kmeans": dict(kmeans=False, iterative=True),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_transformer_layer_matches_jax(case):
    """One layer on 8^2 tokens against 8 components, with a component mask
    that drops two of them (every pass masks its scores again), positions
    on both sides, and, for the carry, assignments from a 4^2 grid that the
    layer up-samples: out, the probabilities and the assignments it hands
    on."""
    kw = LAYER_CASES[case]
    f_len, t_len, dim = 64, 8, 16
    carried = case in ("iterative_carried", "iterative_no_kmeans")
    if case == "iterative_first":
        f_len = 16                      # F * N = 2 * T
    heads = kw.get("num_heads", 1)
    rng = np.random.RandomState(5)
    x = rng.randn(2, f_len, dim).astype(np.float32)
    y = rng.randn(2, t_len, 8).astype(np.float32)
    fpos = rng.randn(f_len, 8).astype(np.float32)
    tpos = rng.randn(t_len, 8).astype(np.float32)
    mask = np.ones((2, t_len), np.float32)
    mask[0, 3] = mask[1, 6] = 0.0
    to_from = None
    if carried:
        a = rng.uniform(size=(2, heads, t_len, f_len // 4)).astype(np.float32)
        to_from = a / a.sum(-1, keepdims=True)
    common = dict(dim=dim, pos_dim=8, from_len=f_len, to_len=t_len, from_dim=dim, to_dim=8,
                  integration="both", norm="layer", attention_dropout=0.0)
    jl = jtr.TransformerLayer(**common, **kw)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(fpos), jnp.asarray(tpos),
            {"centroid_assignments": None if to_from is None else jnp.asarray(to_from)},
            jnp.asarray(mask))
    variables = jl.init(jax.random.PRNGKey(0), *args)
    variables = perturbed(jax.device_get(variables), 6)
    out_j, att_j, vars_j = jl.apply(variables, *args)
    tl = ttr.TransformerLayer(**common, **kw, from_pos=True, to_pos=True,
                              first=case == "iterative_first")
    load_flax(tl, variables)
    with torch.no_grad():
        out_t, att_t, vars_t = tl(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(fpos),
            torch.from_numpy(tpos),
            {"centroid_assignments": None if to_from is None else torch.from_numpy(to_from)},
            torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(att_t.numpy(), np.asarray(att_j), rtol=TOL, atol=1e-6)
    a_j, a_t = vars_j["centroid_assignments"], vars_t["centroid_assignments"]
    assert (a_j is None) == (a_t is None)
    if a_j is not None:
        assert a_t.shape == a_j.shape
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=TOL, atol=1e-6)


def test_upsample_assignments_is_jaxs_nearest_upsample():
    """The 2x repeat over the F grid, and over the T grid, equals JAX's
    `upsample2d` with `nearest_neighbors_kernel(2)`."""
    rng = np.random.RandomState(7)
    for shape, to_len, from_len in (((2, 2, 16, 16), 16, 64), ((2, 1, 4, 16), 16, 64)):
        a = rng.randn(*shape).astype(np.float32)
        want = np.asarray(jtr._upsample_assignments(jnp.asarray(a), shape[1], to_len, from_len))
        got = ttr.upsample_assignments(torch.from_numpy(a), shape[1], to_len, from_len)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
