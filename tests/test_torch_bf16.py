"""bfloat16 synthesis (JAX's default for project, morph and demorph) in the
port against the JAX package in bfloat16.

The criterion throughout: the port in bfloat16 lies closer to JAX in
bfloat16 than JAX in bfloat16 lies to JAX in float32, in mean and in max
abs, on the same inputs (numpy seeds) and weights (carried by `load_flax`).
JAX's generator runs unpacked on the CPU (MGT_PACKED_SYNTH=0), as in
tests/test_torch_projection.py; the fused ops run JAX's Pallas kernels in
interpret mode; the port runs its fused blocks on the plain versions, which
round where JAX's Pallas wrappers round.

Measured on the CPU (small config, const noise, batch 2; gaps as mean /
max abs): JAX bf16 vs f32 8.4e-3 / 5.1e-2; the port bf16 vs JAX bf16
6.5e-3 / 4.7e-2 (its fused b16 block rounds as JAX's Pallas kernel, JAX's
unpacked b16 as XLA's ops); with the port's b16 unfused too, 2.5e-6 /
3.9e-3 (rare one-ulp flips of another order of sums). The fused ops
against JAX's Pallas in bf16: y, dx 0 to 1e-6 mean, ds within 4e-5 mean,
against 1e-3 to 5e-1 from JAX bf16 to f32. The generator whole (its image,
a projection, the loss and latent gradient) is held in
tests/test_torch_bf16_nets.py."""

import argparse
import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops.bias_act import bias_act as jbias_act
from morphganformer_tpu.ops.conv2d_resample import _compose_kernel_fir as jcompose
from morphganformer_tpu.ops.modulated_conv import modulated_conv2d as jmodconv
from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import set_compute_dtype
from morphganformer_tpu_torch.models import synthesis as tsyn
from morphganformer_tpu_torch.ops.bias_act import bias_act as tbias_act
from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir as tcompose
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.modulated_conv import modulated_conv2d as tmodconv
from morphganformer_tpu_torch.ops import setup_filter
from morphganformer_tpu_torch.utils.dtype import compute_dtype, scalar

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import FIR, K1_CASES, K2_CASES, _k1_inputs, _k2_inputs
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF = jnp.bfloat16
# tests/test_misc_ops.py:98-99: JAX's own caps on its bf16 image against f32.
CAP_MEAN, CAP_MAX = 0.03, 0.3


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _gaps(port, jax_bf16, jax_f32):
    """((mean, max) of |port - JAX bf16|, (mean, max) of |JAX bf16 - JAX f32|)."""
    a, b, c = _np(port), _np(jax_bf16), _np(jax_f32)
    d1, d2 = np.abs(a - b), np.abs(b - c)
    return (d1.mean(), d1.max()), (d2.mean(), d2.max())


def _closer(port, jax_bf16, jax_f32):
    (m1, x1), (m2, x2) = _gaps(port, jax_bf16, jax_f32)
    assert m1 < m2 and x1 < x2, ((m1, x1), (m2, x2))
    assert m1 < CAP_MEAN and x1 < CAP_MAX, (m1, x1)
    return (m1, x1), (m2, x2)


def _j(a, dt=None):
    return None if a is None else (jnp.asarray(a) if dt is None else jnp.asarray(a).astype(dt))


def _t(a, dt=torch.float32, grad=False):
    return None if a is None else torch.from_numpy(a).to(dt).requires_grad_(grad)


@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_bf16_k1_and_its_adjoint_match_jax(shape, noise, bias, resid, gain, alpha, demod):
    """K1's plain bf16 forward and its latent-path VJP (dx, ds) against
    `fused_modconv3x3_lrelu` in bf16 (Pallas, interpret mode)."""
    n, h, c, o = shape
    x, w, s, nz, b, r = _k1_inputs(np.random.RandomState(0), n, h, c, o, noise, bias, resid)
    g = np.random.RandomState(5).randn(n, h, h, o).astype(np.float32)
    want = {}
    for dt in (jnp.float32, BF):
        def fwd(x_, s_):
            return jpc.fused_modconv3x3_lrelu(x_, _j(w), s_, _j(nz), _j(b), _j(r, dt), gain,
                                              alpha, demod, False)
        y, vjp = jax.vjp(fwd, _j(x, dt), _j(s))
        want[dt] = (y, *vjp(_j(g, dt)))
    bf = torch.bfloat16
    xt, st = _t(x, bf, True), _t(s, grad=True)
    y = fc.fused_modconv3x3(xt, _t(w), st, _t(nz), _t(b), _t(r, bf), gain, alpha, demod)
    dx, ds = torch.autograd.grad(y, (xt, st), _t(g, bf))
    assert y.dtype == dx.dtype == bf and ds.dtype == torch.float32
    assert fc.launch_counts["modconv3x3_bf16"] == fc.launch_counts["modconv3x3_adj_bf16"] == 0
    for i, got in enumerate((y, dx, ds)):
        _closer(got, want[BF][i], want[jnp.float32][i])


@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_bf16_k2_and_k3_adjoint_match_jax(cin, kh, styles, noise, bias, demod, gain, alpha):
    """K2's plain bf16 forward and K3's adjoint (dx, ds) against
    `fused_packed_upconv2` (Cin 64, packed) and `fused_packed_upconv2_c256`
    in bf16."""
    n, cout = 2, cin // 2
    h = 16 if cin == 64 else 8
    x, w, s, nz, b = _k2_inputs(np.random.RandomState(1), n, h, cin, cout, kh, styles, noise,
                                bias)
    g = np.random.RandomState(3).randn(n, 2 * h, 2 * h, cout).astype(np.float32)
    f = jsetup_filter(FIR)
    want = {}
    for dt in (jnp.float32, BF):
        def fwd(x_, *s_):
            args = (_j(w), s_[0] if s_ else None, f, _j(nz), _j(b), gain, alpha, demod, False)
            if cin == 256:
                return jpc.fused_packed_upconv2_c256(x_.reshape(n, h, h, cin), *args)
            return jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128),
                                            *args).reshape(n, 2 * h, 2 * h, cout)
        y, vjp = jax.vjp(fwd, *([_j(x, dt)] + ([_j(s)] if styles else [])))
        want[dt] = (y, *vjp(_j(g, dt)))
    bf = torch.bfloat16
    inputs = [_t(x, bf, True)] + ([_t(s, grad=True)] if styles else [])
    y = fc.fused_upconv2(inputs[0], _t(w), inputs[1] if styles else None, setup_filter(FIR),
                         _t(nz), _t(b), gain, alpha, demod, False)
    got = torch.autograd.grad(y, inputs, _t(g, bf))
    assert y.dtype == got[0].dtype == bf
    for i, t in enumerate((y, *got)):
        _closer(t, want[BF][i], want[jnp.float32][i])


@pytest.mark.parametrize("up", [1, 2])
def test_bf16_plain_ops_round_as_xla(up):
    """The unfused ops of the blocks 4^2 ... 128^2 in bf16: the modulated
    conv (the up-conv composes its FIR in float32 and rounds once) and
    bias_act (slope and gain rounded to bf16, as JAX's weak-typed scalars),
    within one ulp flip of XLA's bf16 results."""
    rng = np.random.RandomState(up)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) / 12).astype(np.float32)
    s = (rng.rand(2, 16) + 0.5).astype(np.float32)
    b = (rng.randn(8) * 0.1).astype(np.float32)
    f = FIR if up == 2 else None
    want = jbias_act(jmodconv(
        jnp.asarray(x, BF), jnp.asarray(w, BF), jnp.asarray(s), up=up, padding=1,
        resample_kernel=None if f is None else jsetup_filter(f), flip_weight=up == 1),
        jnp.asarray(b), act="lrelu")
    got = tbias_act(tmodconv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(s),
        up=up, padding=1, resample_kernel=None if f is None else setup_filter(f),
        flip_weight=up == 1), torch.from_numpy(b), act="lrelu")
    assert got.dtype == torch.bfloat16
    d = np.abs(_np(got) - _np(want))
    assert d.mean() < 1e-4 and d.max() <= 2 ** -6 * np.abs(_np(want)).max(), (d.mean(), d.max())
    if up == 2:
        k = jcompose(jnp.asarray(w, BF), jsetup_filter(FIR), False, False, 4.0)
        kt = tcompose(torch.from_numpy(w).bfloat16(), setup_filter(FIR), False,
                                     False, 4.0)
        np.testing.assert_array_equal(_np(kt), _np(k))


def test_scalar_rounds_as_jax_weak_types():
    x = jnp.asarray(np.random.RandomState(0).randn(1000).astype(np.float32), BF)
    for v in (0.2, math.sqrt(2), 1 / math.sqrt(8)):
        got = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16() * scalar(
            v, torch.bfloat16)
        np.testing.assert_array_equal(_np(got), _np(x * v))
        assert scalar(v, torch.float32) == float(np.float32(v))
        assert scalar(v, torch.float64) == v


def _jax_parser(name, argv_required):
    """The argparse parser of JAX's `cli/<name>.py`, caught at parse time."""
    mod = importlib.import_module(f"cli.{name}")
    if hasattr(mod, "build_parser"):
        return mod.build_parser()

    class Caught(Exception):
        pass

    def catch(self, *a, **k):
        raise Caught(self)
    saved = argparse.ArgumentParser.parse_args, argparse.ArgumentParser.parse_known_args
    argparse.ArgumentParser.parse_args = argparse.ArgumentParser.parse_known_args = catch
    try:
        mod.main()
    except Caught as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args, argparse.ArgumentParser.parse_known_args = saved
    raise AssertionError(f"cli/{name}.py parsed no arguments")


@pytest.mark.parametrize("command,default", [("generate", "float32"), ("merge", "float32"),
                                             ("project", "bfloat16"), ("morph", "bfloat16"),
                                             ("demorph", "bfloat16")])
def test_dtype_flag_defaults_as_in_jax(command, default, monkeypatch):
    """Each entry point's --dtype defaults as JAX's (cli/generate.py:86,
    cli/merge.py:38, cli/project.py:263, cli/morph.py:146, cli/demorph.py:39)
    and reaches get_model."""
    assert _jax_parser(command, None).get_default("dtype") == default
    seen = []

    class Stop(Exception):
        pass

    def get_model(spec, device="cuda", dtype="float32"):
        seen.append(dtype)
        raise Stop
    monkeypatch.setattr(cli, "get_model", get_model)
    required = {"generate": [], "merge": [], "project": ["--img", "a.png"],
                "morph": ["--img-a", "a.png", "--img-b", "b.png"], "demorph": []}[command]
    for argv, want in (([], default), (["--dtype", "float32"], "float32"),
                       (["--dtype", "bfloat16"], "bfloat16")):
        with pytest.raises(Stop):
            cli.main([command, "--model", "init:8", "--device", "cpu", *required, *argv])
        assert seen.pop() == want


def test_get_model_sets_the_compute_dtype():
    cfg, G = cli.get_model("init:8", device="cpu", dtype="bfloat16")
    assert cfg.dtype == "bfloat16" and compute_dtype(cfg) == torch.bfloat16
    assert all(m.cfg is cfg for m in G.modules() if hasattr(m, "cfg")
               and isinstance(m.cfg, tcfg.GANformerConfig))
    assert all(p.dtype == torch.float32 for p in G.parameters())
    with torch.no_grad():
        img = cli.synthesize(G, torch.zeros(1, cfg.k, cfg.z_dim))
    assert img.dtype == torch.float32 and torch.isfinite(img).all()
    with pytest.raises(ValueError, match="dtype"):
        set_compute_dtype(G, "float16")


@pytest.mark.parametrize("base,fused", [(1024, [8, 16]), (1000, [])])
def test_gates_refuse_the_widths_the_bf16_kernels_refuse(base, fused):
    """The bf16 instantiations take channel counts in fours, as the f32
    ones: the gate and the launch checks are the same for both types."""
    cfg = dataclasses.replace(_cfg(tcfg, "small"), channel_base=base, dtype="bfloat16")
    assert [r for r in cfg.block_resolutions
            if tsyn.packed_structural_ok(cfg, r, "const")] == fused
    if not fused:
        with pytest.raises(ValueError, match="fours"):
            fc.k1_widths(cfg.channels(16), cfg.channels(16))
