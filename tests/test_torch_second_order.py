"""The second-order route of the port (ops/second_order_native.py,
ops/second_order.py) against the JAX package and against autograd.

* The native formulas against JAX's functions of the same name, on the same
  numpy inputs, at JAX's own tolerance (rtol 3e-4, atol 3e-5;
  tests/test_second_order_native.py).
* Each grad Function (`ModConv3x3Grad`, `UpConv2Grad`, `DownConv2Grad`),
  reached through its fused Function inside `second_order_scope()`: the
  double backward against torch's double backward of the plain forward, in
  float64, to 1e-10 of the largest entry of its results, on both launch sets
  (`plain=True`, and the kernels' wrappers, which take the plain versions
  for a CPU tensor).
* The policy (`reg_stage_second_order`, `second_order_scope`), the raise
  outside the scope, and the reg stages on the scoped route against JAX
  with test_torch_reg.py's tolerances (JAX's packed gates are off on the
  CPU, so it computes the same function on either route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import second_order_native as jsn
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import packed_override
from morphganformer_tpu_torch.ops import second_order as so
from morphganformer_tpu_torch.ops import second_order_native as tsn
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter
from morphganformer_tpu_torch.training import loss as tloss

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_reg import (  # noqa: F401
    _check_grads,
    _count_fused,
    _flat,
    _grads,
    _pair,
    _pl_noise,
    force_fused_d,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GAIN, ALPHA = float(np.sqrt(2.0)), 0.2


@pytest.fixture()
def env_unset(monkeypatch):
    monkeypatch.delenv("MGT_PACKED_SECOND_ORDER", raising=False)


# ---------------------------------------------------------------------------
# The native formulas against JAX.
# ---------------------------------------------------------------------------


def _np_pieces(seed=0, n=2, h=8, ci=4, co=5, kh=3, up=1):
    rng = np.random.RandomState(seed)
    ho = h * up
    return dict(x=rng.randn(n, h, h, ci), w=rng.randn(kh, kh, ci, co) * 0.4,
                s=rng.rand(n, ci) + 0.5, noise=rng.randn(n, ho, ho),
                bias=rng.randn(co) * 0.1, g=rng.randn(n, ho, ho, co))


def _both(p):
    """(jax arrays, torch tensors) of a dict of float32 numpy arrays."""
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, name=""):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5, err_msg=name)


def test_primitives_match_jax():
    """_conv, _convT, _wg, _mask, and the two op sets."""
    rng = np.random.RandomState(1)
    a = rng.randn(2, 6, 6, 3).astype(np.float32)
    b = rng.randn(2, 6, 6, 4).astype(np.float32)
    k = rng.randn(3, 3, 3, 4).astype(np.float32)
    ja, jb, jk = map(jnp.asarray, (a, b, k))
    ta, tb, tk = map(torch.from_numpy, (a, b, k))
    _close(tsn._conv(ta, tk), jsn._conv(ja, jk), "conv")
    _close(tsn._convT(tb, tk), jsn._convT(jb, jk), "convT")
    _close(tsn._wg(ta, tb), jsn._wg(ja, jb), "wg")
    _close(tsn._mask(ta, GAIN, ALPHA), jsn._mask(ja, GAIN, ALPHA), "mask")
    for t_op, j_op in zip(tsn.default_conv_ops(), jsn.default_conv_ops()):
        assert t_op.__name__ == j_op.__name__
    up, upT, upwg = tsn.upconv2_conv_ops()
    jup, jupT, jupwg = jsn.upconv2_conv_ops()
    k4 = rng.randn(4, 4, 3, 4).astype(np.float32)
    b2 = rng.randn(2, 12, 12, 4).astype(np.float32)
    _close(up(ta, torch.from_numpy(k4)), jup(ja, jnp.asarray(k4)), "up")
    _close(upT(torch.from_numpy(b2), torch.from_numpy(k4)), jupT(jnp.asarray(b2), jnp.asarray(k4)),
           "upT")
    _close(upwg(ta, torch.from_numpy(b2)), jupwg(ja, jnp.asarray(b2)), "upwg")


@pytest.mark.parametrize("demod", [False, True])
@pytest.mark.parametrize("extras", [False, True])
def test_bwd_explicit_matches_jax(demod, extras):
    j, t = _both(_np_pieces(seed=2))
    opt = lambda d, k: d[k] if extras else None  # noqa: E731
    want = jsn.modconv_bwd_explicit(j["x"], j["w"], j["s"], opt(j, "noise"), opt(j, "bias"),
                                    j["g"], GAIN, ALPHA, demod)
    got = tsn.modconv_bwd_explicit(t["x"], t["w"], t["s"], opt(t, "noise"), opt(t, "bias"),
                                   t["g"], GAIN, ALPHA, demod)
    for name, a, b in zip(("dx", "dw", "ds", "dnoise", "dbias"), got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            _close(a, b, name)


@pytest.mark.parametrize("demod", [False, True])
def test_recover_and_bwd_from_y_match_jax(demod):
    j, t = _both(_np_pieces(seed=3))
    y_j = jsn.modconv_fwd_explicit(j["x"], j["w"], j["s"], j["noise"], j["bias"], GAIN, ALPHA,
                                   demod)
    y_t = torch.from_numpy(np.array(y_j))
    d = (np.asarray(jax.lax.rsqrt(jnp.square(j["s"]) @ jnp.sum(jnp.square(j["w"]), axis=(0, 1))
                                  + 1e-8)) if demod else np.ones((2, 5), np.float32))
    m_j, z_j = jsn._recover_from_y(y_j, j["noise"], j["bias"], jnp.asarray(d), GAIN, ALPHA)
    m_t, z_t = tsn._recover_from_y(y_t, t["noise"], t["bias"], torch.from_numpy(d), GAIN, ALPHA)
    _close(m_t, m_j, "mask")
    _close(z_t, z_j, "z")
    want = jsn.modconv_bwd_from_y_explicit(j["x"], j["w"], j["s"], j["noise"], j["bias"], y_j,
                                           j["g"], GAIN, ALPHA, demod)
    got = tsn.modconv_bwd_from_y_explicit(t["x"], t["w"], t["s"], t["noise"], t["bias"], y_t,
                                          t["g"], GAIN, ALPHA, demod)
    for name, a, b in zip(("dx", "dw", "ds", "dnoise", "dbias"), got, want):
        _close(a, b, name)


def _live(cots, live):
    cdx, cdw, cds, cdn, cdb = cots
    if live == "pl":
        return cdx, None, cds, None, None
    if live == "r1":
        return cdx, None, None, None, None
    return cots


@pytest.mark.parametrize("demod", [False, True])
@pytest.mark.parametrize("live", ["all", "pl", "r1"])
@pytest.mark.parametrize("geometry", ["same", "up2"])
def test_vjp_from_y_matches_jax(demod, live, geometry):
    """`modconv_bwd_vjp_from_y` at the live cotangent sets of the reg stages
    (path length feeds cdx and cds, R1 cdx alone), with the 3x3 and the
    up-conv's primitives."""
    up = geometry == "up2"
    p = _np_pieces(seed=4, h=6, kh=4 if up else 3, up=2 if up else 1)
    rng = np.random.RandomState(7)
    p.update({f"c{k}": rng.randn(*p[k].shape) for k in ("x", "w", "s", "noise", "bias")})
    j, t = _both(p)
    j_ops, t_ops = ((jsn.upconv2_conv_ops(), tsn.upconv2_conv_ops()) if up else (None, None))
    y_j = jsn.modconv_fwd_explicit(j["x"], j["w"], j["s"], j["noise"], j["bias"], GAIN, ALPHA,
                                   demod, conv_ops=j_ops)
    y_t = torch.from_numpy(np.array(y_j))
    names = ("cx", "cw", "cs", "cnoise", "cbias")
    want = jsn.modconv_bwd_vjp_from_y(
        j["x"], j["w"], j["s"], j["noise"], j["bias"], y_j, j["g"],
        _live(tuple(j[n] for n in names), live), GAIN, ALPHA, demod, conv_ops=j_ops)
    got = tsn.modconv_bwd_vjp_from_y(
        t["x"], t["w"], t["s"], t["noise"], t["bias"], y_t, t["g"],
        _live(tuple(t[n] for n in names), live), GAIN, ALPHA, demod, conv_ops=t_ops)
    for name, a, b in zip(names + ("cy", "cg"), got, want):
        if b is None:
            assert a is None, name
        else:
            _close(a, b, name)


# ---------------------------------------------------------------------------
# The grad Functions against torch's double backward of the plain forwards.
# ---------------------------------------------------------------------------


def _leaf(gen, *shape, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen, dtype=torch.float64) * scale
            + shift).requires_grad_(True)


def _double_backward(fn, ins, wrt, t):
    """The gradient of a PL/R1-shaped penalty of the inner gradient of
    sum(fn(*ins) * t) w.r.t. `wrt`, w.r.t. every input."""
    y = fn(*ins)
    gs = torch.autograd.grad((y * t).sum(), wrt, create_graph=True)
    pen = sum((g.square() * (1 + g)).sum() for g in gs)
    live = [a for a in ins if a is not None]
    return torch.autograd.grad(pen, live, allow_unused=True)


def _assert_same(got, want):
    """Each result within 1e-10 of the largest entry of all the results: an
    input whose true cotangent is zero (resid, noise and bias through the
    mask) gets the sum of two routes that cancel (the recovery of z from y
    and c_y's route through the forward), rounding alone."""
    scale = max(b.abs().max().item() for b in want if b is not None)
    for a, b in zip(got, want):
        a = torch.zeros(()) if a is None else a
        b = torch.zeros(()) if b is None else b
        assert (a - b).abs().max().item() <= 1e-10 * scale


K1_CASES = {
    # G conv1: styles, demod, per-sample noise, bias, the skip as resid.
    "conv1": dict(styles=True, noise=3, bias=True, resid=True, gain=GAIN, alpha=0.2, demod=True),
    # G conv_last: no noise, no bias, linear.
    "conv_last": dict(styles=True, noise=0, bias=False, resid=False, gain=1.0, alpha=1.0,
                      demod=True),
    # Batch-shared noise.
    "shared_noise": dict(styles=True, noise=2, bias=True, resid=False, gain=GAIN, alpha=0.2,
                         demod=True),
    # D conv0: no styles, no demodulation.
    "d_conv0": dict(styles=False, noise=0, bias=True, resid=False, gain=GAIN, alpha=0.2,
                    demod=False),
}


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("live", ["all", "pl", "r1"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_modconv3x3_grad_double_backward(case, live, plain):
    c = K1_CASES[case]
    gen = torch.Generator().manual_seed(0)
    n, h, ci, co = 2, 6, 4, 8
    ins = [_leaf(gen, n, h, h, ci), _leaf(gen, 3, 3, ci, co, scale=0.3),
           _leaf(gen, n, ci, scale=0.3, shift=1.0) if c["styles"] else None,
           (_leaf(gen, n, h, h, scale=0.2) if c["noise"] == 3 else
            _leaf(gen, h, h, scale=0.2) if c["noise"] == 2 else None),
           _leaf(gen, co, scale=0.1) if c["bias"] else None,
           _leaf(gen, n, h, h, co) if c["resid"] else None]
    t = torch.randn(n, h, h, co, generator=gen, dtype=torch.float64)
    x, w, s = ins[:3]
    wrt = {"all": [a for a in ins if a is not None], "pl": [x] + ([s] if s is not None else []),
           "r1": [x]}[live]
    opts = (c["gain"], c["alpha"], c["demod"])
    with so.second_order_scope():
        got = _double_backward(lambda *a: fc.fused_modconv3x3(*a, *opts, plain=plain), ins, wrt,
                               t)
    want = _double_backward(lambda *a: fc.modconv3x3_plain(*a, *opts), ins, wrt, t)
    _assert_same(got, want)


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("live", ["all", "pl", "r1"])
@pytest.mark.parametrize("case", ["conv0", "skip"])
def test_upconv2_grad_double_backward(case, live, plain):
    """G conv0 (3x3, styles, noise, bias) and the 1x1 skip (no styles,
    linear)."""
    conv0 = case == "conv0"
    gen = torch.Generator().manual_seed(1)
    n, h, ci, co, kh = 2, 4, 4, 8, 3 if conv0 else 1
    ins = [_leaf(gen, n, h, h, ci), _leaf(gen, kh, kh, ci, co, scale=0.3),
           _leaf(gen, n, ci, scale=0.3, shift=1.0) if conv0 else None,
           _leaf(gen, n, 2 * h, 2 * h, scale=0.2) if conv0 else None,
           _leaf(gen, co, scale=0.1) if conv0 else None]
    f = setup_filter([1, 3, 3, 1]).double()
    t = torch.randn(n, 2 * h, 2 * h, co, generator=gen, dtype=torch.float64)
    x, w, s = ins[:3]
    wrt = {"all": [a for a in ins if a is not None], "pl": [x] + ([s] if s is not None else []),
           "r1": [x]}[live]
    gain, alpha = (GAIN, 0.2) if conv0 else (0.7, 1.0)

    def fused(x_, w_, s_, n_, b_):
        return fc.fused_upconv2(x_, w_, s_, f, n_, b_, gain, alpha, conv0, False, plain=plain)

    def ref(x_, w_, s_, n_, b_):
        return fc.upconv2_plain(x_, w_, s_, f, n_, b_, gain, alpha, conv0, False)

    with so.second_order_scope():
        got = _double_backward(fused, ins, wrt, t)
    _assert_same(got, _double_backward(ref, ins, wrt, t))


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("live", ["all", "r1"])
@pytest.mark.parametrize("case", ["conv1", "skip"])
def test_downconv2_grad_double_backward(case, live, plain):
    """D conv1 (3x3, bias, lrelu, the skip as resid) and the 1x1 skip (no
    bias, linear)."""
    conv1 = case == "conv1"
    gen = torch.Generator().manual_seed(2)
    n, h, ci, co, kh = 2, 8, 4, 8, 3 if conv1 else 1
    ins = [_leaf(gen, n, h, h, ci), _leaf(gen, kh, kh, ci, co, scale=0.3),
           _leaf(gen, co, scale=0.1) if conv1 else None,
           _leaf(gen, n, h // 2, h // 2, co) if conv1 else None]
    f = setup_filter([1, 3, 3, 1]).double()
    t = torch.randn(n, h // 2, h // 2, co, generator=gen, dtype=torch.float64)
    wrt = [a for a in ins if a is not None] if live == "all" else [ins[0]]
    gain, alpha = (GAIN, 0.2) if conv1 else (0.7, 1.0)

    def fused(x_, w_, b_, r_):
        return fc.fused_downconv2(x_, w_, f, b_, r_, gain, alpha, True, plain=plain)

    def ref(x_, w_, b_, r_):
        return fc.downconv2_plain(x_, w_, f, b_, r_, gain, alpha, True)

    with so.second_order_scope():
        got = _double_backward(fused, ins, wrt, t)
    _assert_same(got, _double_backward(ref, ins, wrt, t))


def test_reaches_narrows_the_inner_pass(monkeypatch):
    """A scope that names x and styles: the inner backward forms no dw, and
    the second derivative still matches autograd of the plain forward."""
    calls = []
    real = fc.conv_dw
    monkeypatch.setattr(fc, "conv_dw", lambda *a: calls.append(1) or real(*a))
    gen = torch.Generator().manual_seed(3)
    ins = [_leaf(gen, 2, 6, 6, 4), _leaf(gen, 3, 3, 4, 8, scale=0.3),
           _leaf(gen, 2, 4, scale=0.3, shift=1.0), None, _leaf(gen, 8, scale=0.1), None]
    t = torch.randn(2, 6, 6, 8, generator=gen, dtype=torch.float64)
    opts = (GAIN, 0.2, True)
    with so.second_order_scope(("x", "styles")):
        y = fc.fused_modconv3x3(*ins, *opts)
        gs = torch.autograd.grad((y * t).sum(), ins[:3:2], create_graph=True)
    assert not calls
    pen = sum((g.square() * (1 + g)).sum() for g in gs)
    got = torch.autograd.grad(pen, [ins[1], ins[4]])
    assert calls
    want = _double_backward(lambda *a: fc.modconv3x3_plain(*a, *opts), ins, ins[:3:2], t)
    _assert_same(got, [want[1], want[3]])
    with pytest.raises(ValueError, match="unknown inputs"):
        with so.second_order_scope(("x", "weights")):
            pass


@pytest.mark.parametrize("fused", ["modconv3x3", "upconv2", "downconv2"])
def test_scope_that_leaves_out_a_reached_input_raises(fused):
    """A scope whose `reaches` leaves out an input on which the inner
    gradient depends (here x, differentiated directly) raises in the inner
    backward instead of taking its cotangent as a zero; named, the same
    gradient runs."""
    gen = torch.Generator().manual_seed(5)
    f = setup_filter([1, 3, 3, 1]).double()
    if fused == "downconv2":
        x, w = _leaf(gen, 2, 8, 8, 4), _leaf(gen, 3, 3, 4, 8, scale=0.3)

        def fwd():
            return fc.fused_downconv2(x, w, f, None, None, GAIN, ALPHA, True)
    else:
        x, w = _leaf(gen, 2, 4, 4, 4), _leaf(gen, 3, 3, 4, 8, scale=0.3)
        s = _leaf(gen, 2, 4, scale=0.3, shift=1.0)

        def fwd():
            if fused == "modconv3x3":
                return fc.fused_modconv3x3(x, w, s, None, None, None, GAIN, ALPHA, True)
            return fc.fused_upconv2(x, w, s, f, None, None, GAIN, ALPHA, True)
    with so.second_order_scope(("w", "resid")):
        y = fwd()
    with pytest.raises(RuntimeError, match="leaves out"):
        torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with so.second_order_scope(("x", "resid")):
        y = fwd()
    gx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert gx.requires_grad and gx.abs().max().item() > 0


# ---------------------------------------------------------------------------
# The policy and the raise.
# ---------------------------------------------------------------------------


def test_reg_stage_policy_tristate(monkeypatch):
    monkeypatch.setenv("MGT_PACKED_SECOND_ORDER", "1")
    assert so.reg_stage_second_order("pl") and so.reg_stage_second_order("r1")
    assert so.packed_second_order()
    # The env's global form is no scope: K4's gate stays open outside one.
    assert not packed_override.in_second_order_scope()
    with so.second_order_scope():
        assert packed_override.in_second_order_scope()
    monkeypatch.setenv("MGT_PACKED_SECOND_ORDER", "0")
    assert not so.reg_stage_second_order("pl")
    assert not so.reg_stage_second_order("r1")
    assert not so.packed_second_order()
    monkeypatch.delenv("MGT_PACKED_SECOND_ORDER")
    for stage in ("pl", "r1"):
        assert so.reg_stage_second_order(stage) == so._DEFAULT_REG_SECOND_ORDER[stage] is True


def test_scope_routes_without_env(env_unset):
    """second_order_scope() routes the fused Functions per graph with the
    env unset; the graph keeps its route after the scope is left, and a
    fused Function built outside it still raises on a second derivative
    (never a wrong zero)."""
    assert not so.packed_second_order()
    gen = torch.Generator().manual_seed(4)
    x, w, s = (_leaf(gen, 1, 8, 16, 8), _leaf(gen, 3, 3, 8, 8, scale=0.3),
               _leaf(gen, 1, 8, scale=0.5, shift=1.0))
    t = torch.randn(1, 8, 16, 8, generator=gen, dtype=torch.float64)

    def fused(x_, w_, s_):
        return fc.fused_modconv3x3(x_, w_, s_, None, None, None, 1.4, 0.2, True)

    def penalty_grad(y):
        inner, = torch.autograd.grad((y * t).sum(), x, create_graph=True)
        return torch.autograd.grad(inner.square().sum(), (w, s))

    with so.second_order_scope():
        assert so.packed_second_order()
        y_in = fused(x, w, s)
    assert not so.packed_second_order()
    got = penalty_grad(y_in)
    want = penalty_grad(fc.modconv3x3_plain(x, w, s, None, None, None, 1.4, 0.2, True))
    _assert_same(got, want)
    for fn in (lambda: fused(x, w, s),
               lambda: fc.fused_downconv2(x, w, setup_filter([1, 3, 3, 1]).double(), None, None,
                                          1.4, 0.2, True),
               lambda: fc.fused_upconv2(x, w, s, setup_filter([1, 3, 3, 1]).double(), None, None,
                                        1.4, 0.2, True, False)):
        with pytest.raises(RuntimeError, match="differentiable once"):
            torch.autograd.grad(fn().sum(), x, create_graph=True)


# ---------------------------------------------------------------------------
# The reg stages on the scoped route against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["resnet", "skip"])
def test_g_pl_loss_scoped_matches_jax(arch, env_unset, monkeypatch):
    calls = _count_fused(monkeypatch)
    jtrainer, _, host, ttrainer, tstate = _pair(arch)
    z = np.random.RandomState(0).randn(4, 3, 8).astype(np.float32)
    rng, pl_mean = jax.random.PRNGKey(3), 0.4

    def loss_fn(params):
        g_vars = dict(host["g"], params=params)
        return jloss.g_pl_loss(jtrainer.G, g_vars, jnp.asarray(z), None, rng,
                               jnp.float32(pl_mean), jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        host["g"]["params"])
    loss_t, aux_t = tloss.g_pl_loss(tstate.G, torch.from_numpy(z), ttrainer.cfg.loss,
                                    torch.Generator(), torch.tensor(pl_mean),
                                    pl_noise=torch.from_numpy(_pl_noise(rng, 2)))
    assert (calls["fused"] > 0) == (arch == "resnet")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for key in ("pl_mean", "Loss/pl_penalty"):
        np.testing.assert_allclose(float(aux_t[key]), float(aux_j[key]), rtol=1e-5)
    _check_grads(_grads(loss_t, tstate.G), _flat(grads_j))


@pytest.mark.parametrize("arch", ["resnet", "skip"])
def test_d_r1_loss_scoped_matches_jax(arch, env_unset, force_fused_d, monkeypatch):
    calls = _count_fused(monkeypatch)
    jtrainer, _, host, ttrainer, tstate = _pair(arch)
    real = np.random.RandomState(1).randn(4, 16, 16, 3).astype(np.float32)

    def loss_fn(params):
        return jloss.d_r1_loss(jtrainer.D, {"params": params}, jnp.asarray(real), None,
                               jtrainer.cfg.loss)

    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        host["d"]["params"])
    loss_t, aux_t = tloss.d_r1_loss(tstate.D, torch.from_numpy(real), ttrainer.cfg.loss)
    assert (calls["fused"] > 0) == (arch == "resnet")
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(aux_t["Loss/r1_penalty"]),
                               float(aux_j["Loss/r1_penalty"]), rtol=1e-5)
    # The tolerance of test_torch_reg.py's R1 comparison (its comment).
    _check_grads(_grads(loss_t, tstate.D), _flat(grads_j), floor_of_stage=1.0)


def test_reg_inner_passes_form_no_dw(env_unset, force_fused_d, monkeypatch):
    """Neither stage's inner gradient forms a weight cotangent of a fused
    block (path length's reaches x, styles and resid, R1's x and resid);
    the outer gradient does."""
    inner, outer = [], []
    current = outer
    for name in ("conv_dw", "upconv2_dw", "downconv2_dw"):
        real = getattr(fc, name)
        monkeypatch.setattr(fc, name, lambda *a, _r=real, _n=name: current.append(_n) or _r(*a))
    real_grad = torch.autograd.grad

    def grad(*a, **k):
        nonlocal current
        prev = current
        current = inner if k.get("create_graph") else prev
        try:
            return real_grad(*a, **k)
        finally:
            current = prev
    monkeypatch.setattr(torch.autograd, "grad", grad)
    _, _, _, ttrainer, tstate = _pair("resnet")
    z = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 8).astype(np.float32))
    real = torch.from_numpy(np.random.RandomState(1).randn(4, 16, 16, 3).astype(np.float32))
    for net, (loss, _) in ((tstate.G, tloss.g_pl_loss(tstate.G, z, ttrainer.cfg.loss,
                                                       torch.Generator(), torch.tensor(0.0))),
                           (tstate.D, tloss.d_r1_loss(tstate.D, real, ttrainer.cfg.loss))):
        _grads(loss, net)
    assert not inner, inner
    assert {"conv_dw", "upconv2_dw", "downconv2_dw"} <= set(outer), outer
