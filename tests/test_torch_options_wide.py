"""The iterative-conditional set of chip_smoke.py's phase options at
FFHQ-1024's widths (z = w = 32, channel_base 32<<10, channel_max 512),
cut to 32^2 (attention at every block: 4^2 to 32^2, at 512 channels),
from the port's seed-0 init as on the card, against the JAX package at the
same weights. The correctness of the carry at depth is
tests/test_torch_options_depth.py's; this file shows that the conditioning
the card meets at 1024^2 is the model's own.

At these widths the first k-means pass saturates the softmax, and from 8^2
on some centroid draws no attention at all: its column of probabilities
sums to zero, and `compute_assignments` divides it by that sum plus 1e-8.
The carry then hands on assignments whose derivative is about 1e8 times
the probabilities they come from, so the image, and more still the path
length, a gradient of it, move far under float32 rounding. That is JAX's
function as much as the port's. The port's float64 run is the reference:
JAX's float32 and the port's float32 each lie within float32's reach of
it, the image within 1e-3 of its largest entry and the path-length
penalty within 25 % of itself (measured: JAX 6.7e-5 and 3.8 %, the port
2.9e-5 and 12 %: two float32 runs scatter that far on this penalty)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu_torch.checkpoint import to_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import transformer as ttr
from morphganformer_tpu_torch.training import loss as tloss

from .test_torch_attention import concrete_nearest_kernels  # noqa: F401
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread", "concrete_nearest_kernels")

RES = 32


def wide_cfg(mod):
    return mod.ffhq1024_config(
        img_resolution=RES, k=9, c_dim=8, local_noise=False,
        mapping=mod.MappingConfig(resnet=False),
        attention=mod.AttentionConfig(iterative=True, kmeans_iters=2, pos_type="linear",
                                      dropout=0.0))


def test_wide_carry_is_ill_conditioned_in_jax_as_in_the_port(monkeypatch):
    G = init_generator(wide_cfg(tcfg), seed=0, device="cpu")
    assert all(G.cfg.use_attention(r) for r in G.cfg.block_resolutions)
    tree, model = to_flax(G), JGenerator(wide_cfg(jcfg))
    G64 = copy.deepcopy(G).double()
    rng = np.random.RandomState(0)
    z = rng.randn(2, 9, 32).astype(np.float32)
    c = np.eye(8, dtype=np.float32)[[1, 5]]

    masses = []
    assign = ttr.compute_assignments

    def spy(att_probs):
        masses.append(att_probs.detach().sum(dim=-2).min().item())
        return assign(att_probs)

    imgs = {}
    for name, net in (("port", G), ("port64", G64)):
        dt = next(net.parameters()).dtype
        with monkeypatch.context() as m:
            m.setattr(ttr, "compute_assignments", spy)
            with torch.no_grad():
                imgs[name] = net(torch.from_numpy(z).to(dt), torch.from_numpy(c).to(dt),
                                 truncation_psi=0.7, noise_mode="const").double().numpy()
    imgs["jax"] = np.asarray(jax.jit(lambda v, zz, cc: model.apply(
        v, zz, cc, truncation_psi=0.7, noise_mode="const"))(tree, jnp.asarray(z),
                                                             jnp.asarray(c)), np.float64)
    # Two float32 forwards and one float64 forward, each through every
    # carrying pass (the first layer's two passes build their own).
    empty = [m for m in masses[len(masses) // 2:] if m < 1e-6]
    print(f"float64 forward: {len(empty)} of {len(masses) // 2} carrying passes with an empty "
          f"centroid (least column mass {min(masses[len(masses) // 2:]):.3e})")
    assert empty

    z = np.random.RandomState(1).randn(4, 9, 32).astype(np.float32)
    c = np.eye(8, dtype=np.float32)[[0, 3, 5, 7]]
    pl_rng = jax.random.PRNGKey(3)
    _, rng_noise = jax.random.split(pl_rng)
    noise = np.array(jax.random.normal(rng_noise, (2, RES, RES, 3)) / np.sqrt(RES * RES))
    _, aux = jax.jit(lambda p: jloss.g_pl_loss(
        model, dict(tree, params=p), jnp.asarray(z), jnp.asarray(c), pl_rng, jnp.float32(0.0),
        jloss.LossConfig(style_mixing=0.0)))(tree["params"])
    penalty = {"jax": float(aux["Loss/pl_penalty"])}
    for name, net in (("port", G), ("port64", G64)):
        dt = next(net.parameters()).dtype
        _, aux = tloss.g_pl_loss(net, torch.from_numpy(z).to(dt),
                                 tloss.LossConfig(style_mixing=0.0), torch.Generator(),
                                 torch.tensor(0.0, dtype=dt), c=torch.from_numpy(c).to(dt),
                                 pl_noise=torch.from_numpy(noise).to(dt))
        penalty[name] = float(aux["Loss/pl_penalty"])

    scale = np.abs(imgs["port64"]).max()
    for name in ("jax", "port"):
        img_err = np.abs(imgs[name] - imgs["port64"]).max() / scale
        pl_err = abs(penalty[name] - penalty["port64"]) / penalty["port64"]
        print(f"{name} float32 vs the port's float64: image {img_err:.3e} of its largest entry "
              f"{scale:.3f}, path-length penalty {penalty[name]:.3f} vs {penalty['port64']:.3f} "
              f"({pl_err:.3e})")
        assert img_err <= 1e-3, (name, img_err)
        assert pl_err <= 0.25, (name, penalty)
