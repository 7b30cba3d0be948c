"""The iterative-conditional generator of chip_smoke.py's phase options
against the JAX package at a depth whose carry crosses several blocks:
64^2 with attention at 4^2 to 32^2, so the centroid assignments are carried
from the first layer's queries2centroids through three 2x upsamplings,
then the fused 64^2 block (its plain versions here). k 9 (JAX's carry
needs F = 2 (k - 1) at 4^2), kmeans_iters 2, the linear encoding, c_dim 3
with the non-resnet mapping, narrow widths. Weights as
tests/test_torch_conditional.py. The image and ws, and the ws-gradient
against `jax.vjp`, within its tolerances (2e-4).

The path length (JAX's noise handed to the port) is a second-order
quantity that float32 does not reach at 1e-4 at this depth, in either
package: against the port's float64 run, JAX's float32 penalty misses by
3.9e-5 of itself and its gradients by up to 7.6e-4 of a leaf's largest
entry (the linear encoding's tables and the affine of b16), the port's
float32 by 8.6e-5 and 2.1e-3 (the same leaves). So the port's float64 run
is the reference: JAX's float32 and the port's float32 each within float32's
reach of it, the penalty and pl_mean within 1e-4 of themselves and every
leaf within 5e-3 of its largest entry (floored at 1e-3 of the stage's).
JAX in float32 lying that close to the port's exact arithmetic is what
shows that the port computes JAX's function."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.training import loss as tloss

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_conditional import G_KW
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_options import TOL, carry_set, check_forward
from .test_torch_reg import _flat

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

RES = 64
DEPTH_KW = dict(G_KW, img_resolution=RES, end_res=6, channel_base=2048)


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    return carry_set(DEPTH_KW, tmp_path_factory.mktemp("depth") / "jax")


def test_carry_at_depth_image_and_ws_match_jax(deep):
    model, tree, G, _ = deep
    attention = [r for r in G.cfg.block_resolutions if G.cfg.use_attention(r)]
    fused = [r for r in G.cfg.block_resolutions if tsyn.packed_structural_ok(G.cfg, r, "const")]
    assert attention == [4, 8, 16, 32] and fused == [RES]
    check_forward(model, tree, G)


def test_carry_at_depth_ws_gradient_matches_jax_vjp(deep):
    model, tree, G, _ = deep
    cfg = G.cfg
    rng = np.random.RandomState(4)
    ws = (0.5 * rng.randn(2, cfg.k, cfg.num_ws, cfg.w_dim)).astype(np.float32)
    cot = rng.randn(2, RES, RES, 3).astype(np.float32)

    def synth(w):
        return model.apply(tree, ws=w, noise_mode="const")

    want = np.asarray(jax.jit(lambda w, g: jax.vjp(synth, w)[1](g)[0])(jnp.asarray(ws),
                                                                     jnp.asarray(cot)))
    ws_t = torch.from_numpy(ws).requires_grad_(True)
    (G(ws=ws_t) * torch.from_numpy(cot)).sum().backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(ws_t.grad.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


def _leaf_errors(got, want, floor_of_stage=1e-3):
    assert set(got) == set(want)
    floor = floor_of_stage * max(np.abs(v).max() for v in want.values())
    return {n: float(np.abs(got[n] - w).max() / max(np.abs(w).max(), floor))
            for n, w in want.items()}


def test_carry_at_depth_path_length_matches_jax(deep):
    """The penalty, the new pl_mean and every parameter gradient, with
    labels: JAX's `g_pl_loss` under `jax.value_and_grad` and the port's in
    float32, each against the port's in float64."""
    model, tree, G, _ = deep
    rng = np.random.RandomState(0)
    z = rng.randn(4, G.cfg.k, G.cfg.z_dim).astype(np.float32)
    c = rng.randn(4, G.cfg.c_dim).astype(np.float32)
    pl_rng, pl_mean = jax.random.PRNGKey(3), 0.4
    _, rng_noise = jax.random.split(pl_rng)
    noise = np.array(jax.random.normal(rng_noise, (2, RES, RES, 3)) / np.sqrt(RES * RES))

    def jax_loss(p):
        return jloss.g_pl_loss(model, dict(tree, params=p), jnp.asarray(z), jnp.asarray(c),
                               pl_rng, jnp.float32(pl_mean), jloss.LossConfig(style_mixing=0.0))

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        tree["params"])
    runs = {"jax": (float(loss_j), float(aux_j["pl_mean"]),
                    {n: np.asarray(g, np.float64)
                     for n, g in _flat(jax.device_get(grads_j)).items()})}
    for name, dt in (("port", torch.float32), ("port64", torch.float64)):
        net = copy.deepcopy(G).to(dt)
        loss, aux = tloss.g_pl_loss(net, torch.from_numpy(z).to(dt),
                                    tloss.LossConfig(style_mixing=0.0), torch.Generator(),
                                    torch.tensor(pl_mean, dtype=dt), c=torch.from_numpy(c).to(dt),
                                    pl_noise=torch.from_numpy(noise).to(dt))
        names, params = zip(*net.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        runs[name] = (loss.item(), float(aux["pl_mean"]),
                      {n: (np.zeros(p.shape) if g is None else g.double().numpy())
                       for n, p, g in zip(names, params, grads)})
    loss64, mean64, grads64 = runs["port64"]
    for name in ("jax", "port"):
        loss, mean, grads = runs[name]
        errs = _leaf_errors(grads, grads64)
        worst = max(errs, key=errs.get)
        print(f"{name} float32 vs the port's float64: loss {abs(loss - loss64) / loss64:.3e}, "
              f"pl_mean {abs(mean - mean64) / mean64:.3e}, worst leaf {errs[worst]:.3e} ({worst})")
        np.testing.assert_allclose(loss, loss64, rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(mean, mean64, rtol=1e-4, err_msg=name)
        assert errs[worst] <= 5e-3, (name, worst, errs[worst])
