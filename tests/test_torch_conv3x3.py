"""K4 (ops/conv3x3.py) on the CPU: its plain version against the JAX
package's `conv3x3_same` (the Pallas kernel in interpret mode, as
tests/test_pallas_conv.py runs it) and `conv3x3_same_packed`, forward and
VJP; the eligibility rule; the once-differentiable backward; and the route
in `conv2d_resample`.

On the CPU `Conv3x3Same` takes the plain version; the kernel itself is held
against it on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
Tolerances: the forward within 1e-5 of the output's largest entry, dx and
dw within 1e-5 of theirs (float32 sums of the same terms in another order;
dw sums over every pixel)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops.pallas_conv import conv3x3_same as jconv3x3_same
from morphganformer_tpu.ops.pallas_conv import conv3x3_same_packed as jconv3x3_same_packed
from morphganformer_tpu_torch.ops import conv3x3 as k4
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample
from morphganformer_tpu_torch.ops.packed_override import force_unpacked

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (N, H, W, C, O): C 3, 17 and 32, O != C, odd widths.
SHAPES = [(2, 8, 12, 3, 5), (1, 16, 16, 17, 32), (2, 8, 8, 32, 17), (1, 12, 10, 32, 32)]


def _inputs(seed, n, h, w, c, o):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(3, 3, c, o) / np.sqrt(9 * c)).astype(np.float32)
    g = rng.randn(n, h, w, o).astype(np.float32)
    return x, wt, g


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_vjp(x, wt, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    y = k4.conv3x3_same(xt, wtt)
    dx, dw = torch.autograd.grad(y, (xt, wtt), torch.from_numpy(g))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


@pytest.mark.parametrize("jax_fn", [jconv3x3_same, jconv3x3_same_packed],
                         ids=["conv3x3_same", "conv3x3_same_packed"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_version_matches_jax(jax_fn, shape):
    x, wt, g = _inputs(0, *shape)
    want, vjp = jax.vjp(jax_fn, jnp.asarray(x), jnp.asarray(wt))
    want_dx, want_dw = vjp(jnp.asarray(g))
    np.testing.assert_allclose(k4.conv3x3_same_plain(torch.from_numpy(x), torch.from_numpy(wt)),
                               np.asarray(want), atol=1e-5 * np.abs(want).max(), rtol=0)
    y, dx, dw = _port_vjp(x, wt, g)
    assert _rel(y, want) <= 1e-5
    assert _rel(dx, want_dx) <= 1e-5
    assert _rel(dw, want_dw) <= 1e-5


@pytest.mark.parametrize("pixel", [(0, 0), (0, 9), (7, 0), (7, 9), (3, 4)])
def test_dx_role_at_single_pixels_and_edges(pixel):
    """The dx launch correlates g with flip(w)^T: a unit cotangent at one
    output pixel (corners, edges, inside) spreads w's taps, unflipped, over
    the 3x3 input window that pixel reads, cut at the border."""
    n, h, w, c, o = 1, 8, 10, 3, 4
    _, wt, _ = _inputs(1, n, h, w, c, o)
    py, px = pixel
    g = np.zeros((n, h, w, o), np.float32)
    g[0, py, px, 2] = 1.0
    dx = k4.conv3x3_dx(torch.from_numpy(g), torch.from_numpy(wt)).numpy()
    want = np.zeros((n, h, w, c), np.float32)
    for dy in range(3):
        for dxx in range(3):
            iy, ix = py + dy - 1, px + dxx - 1
            if 0 <= iy < h and 0 <= ix < w:
                want[0, iy, ix] = wt[dy, dxx, :, 2]
    np.testing.assert_allclose(dx, want, rtol=0, atol=1e-7)


def test_adjoint_weights_are_flip_transpose():
    _, wt, _ = _inputs(2, 1, 4, 4, 3, 5)
    got = k4.conv3x3_adjoint_weights(torch.from_numpy(wt)).numpy()
    np.testing.assert_array_equal(got, wt[::-1, ::-1].transpose(0, 1, 3, 2))


def test_only_the_asked_cotangents_are_formed(monkeypatch):
    calls = []
    for name in ("conv3x3_dx", "conv3x3_dw"):
        real = getattr(k4, name)
        monkeypatch.setattr(k4, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    x, wt, _ = _inputs(3, 1, 6, 6, 3, 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    k4.conv3x3_same(xt, torch.from_numpy(wt)).sum().backward()
    assert calls == ["conv3x3_dx"]
    calls.clear()
    wtt = torch.from_numpy(wt).requires_grad_(True)
    k4.conv3x3_same(torch.from_numpy(x), wtt).sum().backward()
    assert calls == ["conv3x3_dw"]


def test_double_backward_raises():
    """An R1-shaped second derivative through K4 raises at the first
    backward: once_differentiable alone would let autograd.grad with
    allow_unused=True (as the trainer's stage_grads calls it) return None."""
    x, wt, _ = _inputs(4, 1, 6, 6, 3, 4)
    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    y = torch.nn.functional.leaky_relu(k4.conv3x3_same(xt, wtt), 0.2)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(y.sum(), xt, create_graph=True)
    # First-order gradients are untouched.
    assert torch.autograd.grad(y.sum(), xt)[0].shape == xt.shape


# (x shape, w shape, groups, eligible) on a card: JAX's rule, and channel
# counts in fours, which the kernel takes.
ELIGIBILITY = [
    ((1, 512, 512, 64), (3, 3, 64, 64), 1, True),
    ((4, 1024, 1024, 32), (3, 3, 32, 32), 1, True),
    ((1, 512, 512, 4), (3, 3, 4, 20), 1, True),
    ((1, 512, 512, 3), (3, 3, 3, 17), 1, False),        # C, O not in fours: the kernel's
    ((1, 256, 256, 64), (3, 3, 64, 64), 1, False),      # below 512
    ((1, 512, 1024, 32), (3, 3, 32, 32), 1, False),     # not square
    ((1, 512, 512, 128), (3, 3, 128, 64), 1, False),    # C > 64
    ((1, 512, 512, 64), (3, 3, 64, 128), 1, False),     # O > 64
    ((1, 512, 512, 64), (1, 1, 64, 64), 1, False),      # not 3x3
    ((1, 512, 512, 64), (3, 3, 32, 64), 2, False),      # grouped
    ((1, 513, 513, 32), (3, 3, 32, 32), 1, False),      # odd width
]


@pytest.mark.parametrize("x_shape,w_shape,groups,eligible", ELIGIBILITY)
def test_eligibility_rule(monkeypatch, x_shape, w_shape, groups, eligible):
    x, w = torch.empty(x_shape), torch.empty(w_shape)
    assert not k4.conv3x3_eligible(x, w, groups)             # a CPU tensor: never
    monkeypatch.setattr(k4, "_on_card", lambda t: True)
    assert k4.conv3x3_eligible(x, w, groups) == eligible
    with force_unpacked():
        assert not k4.conv3x3_eligible(x, w, groups)
    assert k4.conv3x3_eligible(x, w, groups) == eligible    # the override is scoped


@pytest.mark.parametrize("flip_weight", [True, False])
def test_route_takes_k4_only_with_the_switch_on(monkeypatch, flip_weight):
    """With the tensor taken for a card's, conv2d_resample sends an eligible
    SAME 3x3 conv to K4 only under MGT_PALLAS_CONV=1 and never under the
    override; the result and its gradients equal the F.conv2d path's, for
    correlation and true convolution (flip_weight False) alike."""
    monkeypatch.setattr(k4, "_on_card", lambda t: True)
    calls = []
    real = k4.conv3x3_same
    monkeypatch.setattr(k4, "conv3x3_same", lambda x, w: calls.append(1) or real(x, w))
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 512, 512, 4).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 4, 4) / 6).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 512, 512, 4).astype(np.float32))

    def run():
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv2d_resample(xt, wt, padding=1, flip_weight=flip_weight)
        return (y.detach(), *torch.autograd.grad(y, (xt, wt), g))

    monkeypatch.delenv("MGT_PALLAS_CONV", raising=False)
    want = run()
    assert calls == []
    monkeypatch.setenv("MGT_PALLAS_CONV", "1")
    got = run()
    assert calls == [1]
    # y and dx within 1e-5; dw, a float32 sum over 512^2 pixels in another
    # order, within 1e-4 of its largest entry.
    for a, b, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        assert _rel(a, b) <= tol
    with force_unpacked():
        run()
    assert calls == [1]
    # Not a SAME 3x3 stride-1 conv, or channels the kernel does not take:
    # never K4.
    conv2d_resample(x, w, padding=1, down=2, f=None)
    conv2d_resample(x, w[:1, :1], padding=0)
    conv2d_resample(x[..., :3], w[:, :, :3, :2], padding=1)
    assert calls == [1]


def test_cpu_tensors_never_launch():
    before = dict(fc.launch_counts)
    x, wt, g = _inputs(6, 1, 6, 6, 3, 4)
    _port_vjp(x, wt, g)
    assert fc.launch_counts == before


def test_smoke_checks_every_k4_call_shape(monkeypatch):
    """chip_smoke.py holds K4 at exactly the SAME 3x3 convs that the rule
    sends to it in the `skip` layouts at FFHQ-1024 widths: G conv1 and
    conv_last (their input is the block's width), D conv0."""
    import importlib.util
    import pathlib

    from morphganformer_tpu_torch.models import config as tcfg

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(k4, "_on_card", lambda t: True)
    g, d = tcfg.ffhq1024_config(architecture="skip"), tcfg.DiscriminatorConfig(architecture="skip")
    convs = [("G", res, layer, g.channels(res)) for res in g.block_resolutions
             for layer in ("conv1", "conv_last") if layer == "conv1" or res == g.img_resolution]
    convs += [("D", res, "conv0", d.channels(res)) for res in d.block_resolutions]
    want = [(f"{net} b{res}", layer, res, c, c) for net, res, layer, c in convs
            if k4.conv3x3_eligible(types.SimpleNamespace(shape=(1, res, res, c)),
                                   types.SimpleNamespace(shape=(3, 3, c, c)), 1)]
    assert sorted(smoke.k4_calls()) == sorted(want)
