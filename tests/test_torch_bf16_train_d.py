"""The discriminator in bfloat16 training against the JAX package in
bfloat16: the small D's logits and input gradient, fused (JAX's packed
Pallas tower in interpret mode against the port's fused blocks on their
plain versions) and unfused, and its R1 stage on the scoped second-order
route. The criteria are tests/test_torch_bf16_train.py's: `_closer` for
the outputs, the distance from the port's own float64 stage for the
gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models import discriminator as jdisc
from morphganformer_tpu.models.discriminator import Discriminator as JDiscriminator
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.ops.packed_override import force_unpacked
from morphganformer_tpu_torch.training import loss as tloss

from .test_torch_bf16 import _closer
from .test_torch_bf16_train import (BF16_FLOOR, D_ARGS, _as_float64, _dcfg, _flat, _grads,
                                    _hold_to_float64)
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def small_d():
    """JAX's D variables (biases off zero) and the port's bfloat16 D with
    them."""
    variables = JDiscriminator(_dcfg(jcfg, **D_ARGS)).init(jax.random.PRNGKey(0),
                                                          jnp.zeros((2, 32, 32, 3)))
    rng = np.random.RandomState(2)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: v + (0.1 * rng.randn(*np.shape(v)).astype(np.float32)
                          if "bias" in jax.tree_util.keystr(p) else 0.0), variables)
    variables = jax.device_get(variables)
    D = tdisc.init_discriminator(_dcfg(tcfg, "bfloat16", **D_ARGS), device="cpu")
    return variables, load_flax(D, variables)


@pytest.mark.parametrize("fused", [True, False])
def test_bf16_discriminator_and_its_input_gradient_match_jax(small_d, monkeypatch, fused):
    """The small D's logits and the gradient of their sum w.r.t. the image in
    bfloat16: the b32 and b16 blocks fused on both sides (JAX's packed
    Pallas tower, its gate forced as tests/test_packed_discriminator.py
    forces it, against the port's fused blocks on their plain versions), or
    unfused on both (XLA's ops against the port's plain PyTorch ops). The
    logits come out float32."""
    variables, D = small_d
    monkeypatch.setattr(jdisc, "packed_d_block_eligible",
                        lambda cfg, res: fused and jdisc.packed_d_structural_ok(cfg, res))
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: fused and res >= 16 and
                        tdisc.packed_d_structural_ok(cfg, res))
    img = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = {}
    for dt in ("float32", "bfloat16"):
        net = JDiscriminator(_dcfg(jcfg, dt, **D_ARGS))
        logits, vjp = jax.vjp(lambda i: net.apply(variables, i), jnp.asarray(img))
        want[dt] = (logits, *vjp(jnp.ones_like(logits)))
    calls = {"fused": 0}
    real = tdisc.Conv2dLayer._forward_fused

    def counting(*a, **k):
        calls["fused"] += 1
        return real(*a, **k)
    monkeypatch.setattr(tdisc.Conv2dLayer, "_forward_fused", counting)
    it = torch.from_numpy(img).requires_grad_(True)
    logits = D(it)
    grad, = torch.autograd.grad(logits.sum(), it)
    assert logits.dtype == grad.dtype == torch.float32
    assert calls["fused"] == (6 if fused else 0)
    for got, w_bf, w_f32 in zip((logits, grad), want["bfloat16"], want["float32"]):
        _closer(got, w_bf, w_f32)



def test_bf16_r1_matches_jax(small_d, monkeypatch):
    """D_r1 in bfloat16 on the default scoped route, the b32 and b16 blocks
    fused (the second-order route through their plain versions), against
    JAX's R1 in bfloat16 through its packed Pallas tower on the same forced
    gate (JAX's second-order route, in interpret mode): the gradients by
    their distance from the port's float64 R1 (unfused), at most BF16_RATIO
    times JAX's (measured 0.043 against 0.038); the penalty within
    BF16_FLOOR of the float64 one (5.4e-3 of itself). Both
    fused routes recover the lrelu mask from y - resid rounded to bfloat16
    (`_dconv_bwd_impl` :2131-2137), so pixels near zero take the wrong
    slope: the down-conv's second derivative alone is 4.6x noisier than
    unfused (relative L2 0.118 against 0.026; 0.026 with resid 0), and the
    unfused route is no yardstick for a fused one. The penalty is a sum of
    squares of noisy gradients: JAX's packed and unpacked bfloat16 routes
    put it 1e-4 and 1.9e-2 of itself from float64 on this input."""
    variables, D = small_d
    monkeypatch.setattr(jdisc, "packed_d_block_eligible",
                        lambda cfg, res: jdisc.packed_d_structural_ok(cfg, res))
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))
    real = np.random.RandomState(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    cfg = jloss.LossConfig()
    want = {}
    for dt in ("float32", "bfloat16"):
        net = JDiscriminator(_dcfg(jcfg, dt, **D_ARGS))
        with monkeypatch.context() as m:
            if dt == "float32":        # JAX's function, unpacked (quick): the sanity check
                m.setattr(jdisc, "packed_d_block_eligible", lambda cfg, res: False)

            def loss_fn(params):
                return jloss.d_r1_loss(net, {"params": params}, jnp.asarray(real), None, cfg)
            (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
        want[dt] = (float(aux["Loss/r1_penalty"]), _flat(grads))
    calls = {"fused": 0}
    real_fwd = tdisc.Conv2dLayer._forward_fused

    def counting(*a, **k):
        calls["fused"] += 1
        return real_fwd(*a, **k)
    monkeypatch.setattr(tdisc.Conv2dLayer, "_forward_fused", counting)
    loss, aux = tloss.d_r1_loss(D, torch.from_numpy(real), tloss.LossConfig())
    got = {k: v.detach().double().numpy() for k, v in _grads(loss, D).items()}
    assert calls["fused"] == 6
    D64 = _as_float64(D)
    with force_unpacked():
        loss64, aux64 = tloss.d_r1_loss(D64, torch.from_numpy(real).double(), tloss.LossConfig())
        ref = {k: v.detach().numpy() for k, v in _grads(loss64, D64).items()}
    pen, pen64 = float(aux["Loss/r1_penalty"]), float(aux64["Loss/r1_penalty"])
    print("penalties", pen, pen64, want["bfloat16"][0])
    assert abs(pen - pen64) <= BF16_FLOOR * pen64, (pen, pen64, want["bfloat16"][0])
    _hold_to_float64(got, want["bfloat16"][1], want["float32"][1], ref)
