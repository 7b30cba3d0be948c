"""K4 (ops/conv3x3.py) in bfloat16 on the CPU, against the JAX package's
`conv3x3_same` and `conv3x3_same_packed` in bfloat16 (the Pallas kernel in
interpret mode, as tests/test_pallas_conv.py runs it): the forward, dx and
dw through the port's `conv3x3_same` (its plain version on the CPU), held
by tests/test_torch_bf16.py's `_closer` (the port in bfloat16 lies closer to
JAX in bfloat16 than JAX in bfloat16 lies to JAX in float32, in mean and in
max abs). Also: the plain version's bfloat16 sums (float32 on the widened
operands, rounded once; its float32 results unchanged), the route's cast of
the weight to x's type, and the eligibility rule in bfloat16.

On a card the route launches `mgt_conv3x3_fwd_bf16` and
`mgt_conv3x3_dx_bf16` (the tensor-core K1 kernels); they are held against
the plain version there (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from morphganformer_tpu.ops.pallas_conv import conv3x3_same as jconv3x3_same
from morphganformer_tpu.ops.pallas_conv import conv3x3_same_packed as jconv3x3_same_packed
from morphganformer_tpu_torch.ops import conv3x3 as k4
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample

from .test_torch_bf16 import BF, _closer, _gaps
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (N, H, W, C, O): C 3 and 17, O != C, odd widths; the last at K4's 32
# channels.
SHAPES = [(2, 8, 12, 3, 5), (1, 16, 16, 17, 32), (1, 12, 10, 32, 32)]


def _inputs(seed, n, h, w, c, o):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, o) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(n, h, w, o).astype(np.float32)
    return x, wt, g


def _bf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("jax_fn", [jconv3x3_same, jconv3x3_same_packed],
                         ids=["conv3x3_same", "conv3x3_same_packed"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bf16_k4_and_its_vjp_match_jax(jax_fn, shape):
    """y, dx and dw of the port's `conv3x3_same` on bfloat16 x, w and g
    against JAX's on the same values: each in bfloat16 (y and dx rounded
    once from float32 sums, dw the float32 tap sums rounded to w's type).
    The packed variant's dw sums the packed kernel's bfloat16 cotangent
    back onto w in bfloat16 (the transpose of `_pack_kernel`), a rounding
    the port, which does not pack, has not: there the port's dw lies at
    least as close to JAX's float32 dw as JAX's bfloat16 one does, in mean
    and in max abs."""
    x, wt, g = _inputs(0, *shape)
    want = {}
    for dt in (jnp.float32, BF):
        y, vjp = jax.vjp(jax_fn, jnp.asarray(x, dt), jnp.asarray(wt, dt))
        want[dt] = (y, *vjp(jnp.asarray(g, dt)))
    xt, wtt = _bf(x).requires_grad_(True), _bf(wt).requires_grad_(True)
    y = k4.conv3x3_same(xt, wtt)
    dx, dw = torch.autograd.grad(y, (xt, wtt), _bf(g))
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    for got, w_bf, w_f32 in zip((y, dx, dw), want[BF], want[jnp.float32]):
        assert w_bf.dtype == BF
        if got is dw and jax_fn is jconv3x3_same_packed:
            (m1, x1), (m2, x2) = _gaps(got, w_f32, w_bf)
            assert m1 <= m2 and x1 <= x2, ((m1, x1), (m2, x2))
        else:
            _closer(got, w_bf, w_f32)


@pytest.mark.parametrize("shape", SHAPES[1:], ids=str)
def test_bf16_plain_version_sums_in_float32_and_rounds_once(shape):
    """The plain version in bfloat16 is the float32 convolution of the
    widened operands, rounded once (as `_conv3x3_kernel` sums with
    preferred_element_type float32); in float32 it is F.conv2d as before,
    to the bit. The dw sums in float32 whatever the operands' type."""
    x, wt, g = _inputs(1, *shape)
    xb, wb, gb = _bf(x), _bf(wt), _bf(g)
    want = F.conv2d(xb.float().permute(0, 3, 1, 2), wb.float().permute(3, 2, 0, 1), padding=1)
    got = k4.conv3x3_same_plain(xb, wb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.permute(0, 2, 3, 1).to(torch.bfloat16))
    f32 = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(wt).permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    assert torch.equal(k4.conv3x3_same_plain(torch.from_numpy(x), torch.from_numpy(wt)), f32)
    dw = k4.conv3x3_dw(xb, gb)
    assert dw.dtype == torch.float32
    assert torch.equal(dw, k4.conv3x3_dw(xb.float(), gb.float()))


def test_bf16_route_casts_the_weight_to_x_type(monkeypatch):
    """`conv2d_resample` with MGT_PALLAS_CONV=1 on bfloat16 x and a float32
    weight sends K4 the weight rounded to bfloat16 (JAX's
    `k.astype(x.dtype)`); the weight's cotangent comes back float32, the
    bfloat16-rounded dw. The gate is made to see a card, so that the route
    is taken here (K4's plain version on the CPU); no kernel launches."""
    monkeypatch.setenv("MGT_PALLAS_CONV", "1")
    monkeypatch.setattr(k4, "_on_card", lambda x: True)
    seen = []
    real = k4.conv3x3_same
    monkeypatch.setattr(k4, "conv3x3_same", lambda x, w: seen.append(w.dtype) or real(x, w))
    x, wt, g = _inputs(2, 1, 512, 512, 4, 4)
    xt = _bf(x)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    before = dict(fc.launch_counts)
    y = conv2d_resample(xt, wtt, padding=1)
    dw, = torch.autograd.grad(y, (wtt,), _bf(g))
    assert seen == [torch.bfloat16] and y.dtype == torch.bfloat16
    assert dw.dtype == torch.float32
    assert torch.equal(dw, k4.conv3x3_dw(xt, _bf(g)).to(torch.bfloat16).float())
    assert torch.equal(y, k4.conv3x3_same_plain(xt, torch.from_numpy(wt).to(torch.bfloat16)))
    assert fc.launch_counts == before


def test_bf16_eligibility(monkeypatch):
    """In bfloat16 the rule is JAX's, as in float32, plus what the
    tensor-core kernels take: channel counts in fours, an image's offsets
    in 32 bits."""
    monkeypatch.setattr(k4, "_on_card", lambda x: True)
    w = torch.zeros(3, 3, 32, 32)
    assert k4.conv3x3_eligible(torch.zeros(1, 512, 512, 32, dtype=torch.bfloat16), w, 1)
    big = types.SimpleNamespace(shape=(1, 8192, 8192, 32), dtype=torch.bfloat16)
    assert not k4.conv3x3_eligible(big, w, 1)
    assert not k4.conv3x3_eligible(torch.zeros(1, 512, 512, 30, dtype=torch.bfloat16),
                                   torch.zeros(3, 3, 30, 32), 1)
    assert not k4.conv3x3_eligible(torch.zeros(1, 256, 256, 32, dtype=torch.bfloat16), w, 1)
