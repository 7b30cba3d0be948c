"""The port's discriminator (models/discriminator.py) against the JAX
discriminator, with the weights carried over by checkpoint/convert.py.

On the CPU the JAX tower runs its unpacked XLA path (its packed gate needs a
TPU). The port runs its fused blocks through the K1 and K3-forward
wrappers, which take their plain versions on the CPU; the fused gate is
forced down to the small config's b32 and b16 blocks, as
tests/test_packed_discriminator.py forces JAX's. Logits within 2e-4 (the
JAX suite's tolerance); the gradients of a scalar of the logits w.r.t. the
image and every parameter within 1e-4 of each leaf's largest entry (float32
sums over every pixel, in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.discriminator import Discriminator as JDiscriminator
from morphganformer_tpu_torch.checkpoint import from_flax, load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.ops import fused_conv as fc

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(mod):
    # channels 32 -> 64 (b32), 64 -> 128 (b16): both double, so both fuse
    # under the forced gate; b8 (128 -> 128) stays unfused.
    return mod.DiscriminatorConfig(img_resolution=32, channel_base=1024, channel_max=128,
                                   mbstd_group_size=2)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture()
def force_fused(monkeypatch):
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))


@pytest.fixture(scope="module")
def carried():
    """(JAX model, its variables with non-zero biases, the port's D)."""
    model = JDiscriminator(_cfg(jcfg))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((4, 32, 32, 3)))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    rng = np.random.RandomState(0)
    bump = {jax.tree_util.keystr(p): (0.1 * rng.randn(*np.shape(x))).astype(np.float32)
            for p, x in leaves if "bias" in jax.tree_util.keystr(p)}
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + bump.get(jax.tree_util.keystr(p), 0.0), variables)
    D = load_flax(tdisc.init_discriminator(_cfg(tcfg), seed=3, device="cpu"),
                  jax.device_get(variables))
    return model, variables, D


def _flat_params(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("fused", [True, False])
def test_discriminator_matches_jax(carried, fused, request):
    if fused:
        request.getfixturevalue("force_fused")
    model, variables, D = carried
    img = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)

    def loss(params, im):
        return jnp.sum(jnp.sin(model.apply({"params": params}, im)))

    logits_j = model.apply(variables, jnp.asarray(img))
    gp, gi = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(img))

    x = torch.from_numpy(img).requires_grad_(True)
    calls = {"downconv2": 0, "modconv3x3": 0}
    for name in calls:
        real = getattr(fc, f"fused_{name}")

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        request.getfixturevalue("monkeypatch").setattr(
            "morphganformer_tpu_torch.models.layers.fused_" + name, counting)
    logits_t = D(x)
    assert calls == ({"downconv2": 4, "modconv3x3": 2} if fused
                     else {"downconv2": 0, "modconv3x3": 0})
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=2e-4, atol=2e-4)
    names, params = zip(*D.named_parameters())
    grads = torch.autograd.grad(torch.sin(logits_t).sum(), (x,) + params)
    assert rel_err(grads[0], gi) <= 1e-4
    want = _flat_params(gp)
    assert set(want) == set(names)
    for name, g in zip(names, grads[1:]):
        assert rel_err(g, want[name]) <= 1e-4, name


def test_load_flax_carries_the_discriminator(carried):
    _, variables, D = carried
    tree = jax.device_get(variables)
    assert set(from_flax(tree)) == set(D.state_dict())
    want = _flat_params(tree["params"])
    for name, p in D.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])


def test_fused_gate_picks_b1024_and_b512():
    cfg = tcfg.DiscriminatorConfig()
    assert [r for r in cfg.block_resolutions if tdisc.packed_d_block_eligible(cfg, r)] \
        == [1024, 512]
    assert [(cfg.channels(r), cfg.channels(r // 2)) for r in (1024, 512)] == [(32, 64), (64, 128)]


def test_minibatch_std_matches_jax():
    from morphganformer_tpu.models.discriminator import minibatch_std as jmbstd

    x = np.random.RandomState(2).randn(4, 4, 4, 6).astype(np.float32)
    for group in (2, 4, None):
        np.testing.assert_allclose(
            tdisc.minibatch_std(torch.from_numpy(x), group, 2).numpy(),
            np.asarray(jmbstd(jnp.asarray(x), group, 2)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["skip", "orig"])
def test_layouts_match_jax(arch):
    """The `skip` layout (a fromrgb of the FIR-down-sampled image in every
    block and in the epilogue) and `orig`, unfused, against JAX with carried
    weights: logits, and the gradients w.r.t. the image and every
    parameter (as test_discriminator_matches_jax)."""
    cfgs = [dataclasses.replace(_cfg(m), architecture=arch) for m in (jcfg, tcfg)]
    model = JDiscriminator(cfgs[0])
    variables = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((4, 32, 32, 3)))
    rng = np.random.RandomState(3)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + (0.1 * rng.randn(*np.shape(x))).astype(np.float32)
        if "bias" in jax.tree_util.keystr(p) else x, variables)
    D = load_flax(tdisc.init_discriminator(cfgs[1], seed=3, device="cpu"),
                  jax.device_get(variables))
    fromrgb = sorted({k.split(".")[0] for k in D.state_dict() if ".fromrgb." in k})
    assert fromrgb == (sorted(f"b{r}" for r in (*cfgs[1].block_resolutions, 4))
                       if arch == "skip" else ["b32"])
    img = np.random.RandomState(1).randn(4, 32, 32, 3).astype(np.float32)

    def loss(params, im):
        return jnp.sum(jnp.sin(model.apply({"params": params}, im)))

    logits_j = model.apply(variables, jnp.asarray(img))
    gp, gi = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    logits_t = D(x)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=2e-4, atol=2e-4)
    names, params = zip(*D.named_parameters())
    grads = torch.autograd.grad(torch.sin(logits_t).sum(), (x,) + params)
    assert rel_err(grads[0], gi) <= 1e-4
    want = _flat_params(gp)
    assert set(want) == set(names)
    for name, g in zip(names, grads[1:]):
        assert rel_err(g, want[name]) <= 1e-4, name
