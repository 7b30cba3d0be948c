"""Training in bfloat16 (`train --dtype bfloat16`) in the port against the
JAX package in bfloat16.

The ops and the nets' outputs are held by tests/test_torch_bf16.py's
`_closer`: the port in bfloat16 lies closer to JAX in bfloat16 than JAX in
bfloat16 lies to JAX in float32, in mean and in max abs, on the same inputs
(numpy seeds) and weights, under JAX's caps (0.03 mean, 0.3 max). The fused
ops run JAX's Pallas kernels in interpret mode; the port takes the plain
versions, which round where JAX's Pallas wrappers round (the composed
D-tower and use_dw kernels rounded after their float32 composition, x * s
rounded before the dw taps). D runs fused on both sides (JAX's packed tower
under a forced gate) or unfused on both.

The stages (G_main, D_main, path length, R1) are held by their losses or
penalties under `_closer` and by their gradients' distance from the port's
own float64 stage, which JAX's float32 gradient meets to 1e-5: the relative
L2 error of the whole gradient at most BF16_RATIO (chip_smoke.py's 1.5)
times JAX's bfloat16 one's. Leaf by leaf two bfloat16 implementations are
two draws of one rounding noise (their backward passes round at other
places; JAX's unpacked nets against the port's fused blocks on their plain
versions), so `_closer` does not hold there; see each test.

Randomness is off on both sides as in tests/test_torch_train_step.py (no
local noise, attention dropout 0, no style mixing); the path-length noise
is drawn with JAX's own calls and handed to the port. The discriminator's
outputs and its R1 stage are held in tests/test_torch_bf16_train_d.py."""

import copy
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.discriminator import Discriminator as JDiscriminator
from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import load_flax, to_flax
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator, set_compute_dtype
from morphganformer_tpu_torch.ops import conv3x3 as k4
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter
from morphganformer_tpu_torch.ops.packed_override import force_unpacked
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts
from morphganformer_tpu_torch.utils.image import write_png

from .test_torch_bf16 import BF, _closer, _j, _np, _t
from .test_torch_kernels_cuda import FIR, K1_CASES, K2_CASES, _k1_inputs, _k2_inputs
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32, TBF = jnp.float32, torch.bfloat16
BF16_RATIO = 1.5          # chip_smoke.py's: a bf16 route's error at most 1.5x the plain one's
BF16_FLOOR = 2.0 ** -7    # ... and its one bfloat16 ulp (relative)
RES = 16


@pytest.fixture()
def force_fused_d(monkeypatch):
    """D's b16 (16 -> 32 channels) on the fused ops, as b1024/b512 at 1024^2."""
    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))


# --------------------------------------------------------------------------
# The fused ops' training roles.
# --------------------------------------------------------------------------

# (kh, bias, resid): D conv1 with and without the skip added in, the 1x1
# skip itself (linear, no bias), and the 1x1 with a resid.
DCONV_CASES = [(3, True, True), (3, True, False), (1, False, False), (1, False, True)]


@pytest.mark.parametrize("kh,bias,resid", DCONV_CASES)
def test_bf16_dconv2_and_its_vjp_match_jax(kh, bias, resid):
    """K3's D-tower forward and its VJP (dx through K2's use_dw role, dw,
    dbias, dresid) in bfloat16 against `fused_packed_dconv2`."""
    n, h, cin, cout = 2, 16, 8, 16
    q = 128 // cin                               # JAX packs q pixels per 128 lanes
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    r = rng.randn(n, h // 2, h // 2, cout).astype(np.float32) if resid else None
    g = rng.randn(n, h // 2, h // 2, cout).astype(np.float32)
    gain, alpha = (1.0, 0.2) if kh == 3 else (math.sqrt(0.5), 1.0)
    want = {}
    for dt in (F32, BF):
        def jfwd(x_, w_, *rest):
            it = iter(rest)
            b_ = next(it) if bias else None
            r_ = next(it).reshape(n, h // 2, h // q, q // 2 * cout) if resid else None
            y = jpc.fused_packed_dconv2(x_.reshape(n, h, h // q, q * cin), w_,
                                        jsetup_filter(FIR), b_, r_, gain, alpha, True)
            return y.reshape(n, h // 2, h // 2, cout)
        primals = [_j(x, dt), _j(w)] + ([_j(b)] if bias else []) + ([_j(r, dt)] if resid else [])
        y, vjp = jax.vjp(jfwd, *primals)
        want[dt] = (y, *vjp(_j(g, dt)))
    inputs = [_t(x, TBF, True), _t(w, grad=True)] + ([_t(b, grad=True)] if bias else []) \
        + ([_t(r, TBF, True)] if resid else [])
    it = iter(inputs[2:])
    bt, rt = (next(it) if bias else None), (next(it) if resid else None)
    y = fc.fused_downconv2(inputs[0], inputs[1], setup_filter(FIR), bt, rt, gain, alpha)
    got = torch.autograd.grad(y, inputs, _t(g, TBF))
    assert y.dtype == got[0].dtype == TBF and got[1].dtype == torch.float32
    assert (bt is None or got[2].dtype == torch.float32) and (rt is None or got[-1].dtype == TBF)
    for i, t in enumerate((y, *got)):
        _closer(t, want[BF][i], want[F32][i])
    assert not any(fc.launch_counts.values())


@pytest.mark.parametrize("role", ["k1", "k1_unstyled", "k3", "k3_skip"])
def test_bf16_weight_cotangents_match_jax(role):
    """K1's dw taps and K3's dw role in bfloat16: `jax.vjp` of
    `fused_modconv3x3_lrelu` and `fused_packed_upconv2` with respect to x and
    w (x differentiated too, so that JAX's dw rides its Pallas adjoint
    launch), dx and dw against the port's. "k1_unstyled" is D's conv0 (JAX's
    styles 1, no demodulation)."""
    rng = np.random.RandomState(4)
    if role.startswith("k1"):
        shape, noise, bias, resid, gain, alpha, demod = K1_CASES[0]
        n, h, c, o = shape
        x, w, s, nz, b, r = _k1_inputs(rng, n, h, c, o, noise, bias, resid)
        if role == "k1_unstyled":
            s, nz, demod = np.ones_like(s), None, False
        g = rng.randn(n, h, h, o).astype(np.float32)

        def jfwd(x_, w_, dt):
            return jpc.fused_modconv3x3_lrelu(x_, w_, _j(s), _j(nz), _j(b), _j(r, dt), gain,
                                              alpha, demod, False)

        def tfwd(x_, w_):
            return fc.fused_modconv3x3(x_, w_, None if role == "k1_unstyled" else _t(s),
                                       _t(nz), _t(b), _t(r, TBF), gain, alpha, demod)
    else:
        cin, kh, styles, noise, bias, demod, gain, alpha = K2_CASES[0 if role == "k3" else 1]
        n, h, cout = 2, 16, cin // 2
        x, w, s, nz, b = _k2_inputs(rng, n, h, cin, cout, kh, styles, noise, bias)
        g = rng.randn(n, 2 * h, 2 * h, cout).astype(np.float32)

        def jfwd(x_, w_, dt):
            return jpc.fused_packed_upconv2(x_.reshape(n, h, h * cin // 128, 128), w_, _j(s),
                                            jsetup_filter(FIR), _j(nz), _j(b), gain, alpha,
                                            demod, False).reshape(n, 2 * h, 2 * h, cout)

        def tfwd(x_, w_):
            return fc.fused_upconv2(x_, w_, _t(s), setup_filter(FIR), _t(nz), _t(b), gain,
                                    alpha, demod, False)
    want = {}
    for dt in (F32, BF):
        _, vjp = jax.vjp(lambda x_, w_: jfwd(x_, w_, dt), _j(x, dt), _j(w))
        want[dt] = vjp(_j(g, dt))
    xt, wt = _t(x, TBF, True), _t(w, grad=True)
    got = torch.autograd.grad(tfwd(xt, wt), (xt, wt), _t(g, TBF))
    assert got[0].dtype == TBF and got[1].dtype == torch.float32
    for i, t in enumerate(got):
        _closer(t, want[BF][i], want[F32][i])


# --------------------------------------------------------------------------
# The discriminator.
# --------------------------------------------------------------------------


def _dcfg(mod, dtype="float32", res=RES, base=256, cmax=32):
    return mod.DiscriminatorConfig(img_resolution=res, channel_base=base, channel_max=cmax,
                                   mbstd_group_size=2, dtype=dtype)


# tests/test_torch_discriminator.py's D: b32 (32 -> 64 channels) and b16
# (64 -> 128) double their channels and fuse, on either side, under the
# forced gates; b8 (128 -> 128) stays unfused.
D_ARGS = dict(res=32, base=1024, cmax=128)


# --------------------------------------------------------------------------
# The stages.
# --------------------------------------------------------------------------


def _cfgs(mod, dtype):
    g = mod.GANformerConfig(img_resolution=RES, z_dim=8, w_dim=8, k=3, channel_base=256,
                            channel_max=32, end_res=3, local_noise=False,
                            mapping=mod.MappingConfig(num_layers=2),
                            attention=mod.AttentionConfig(dropout=0.0), dtype=dtype)
    return g, _dcfg(mod, dtype)


def _train_cfg(mod, loss_mod):
    return mod.TrainConfig(batch_size=4, batch_gpu=4, loss=loss_mod.LossConfig(style_mixing=0.0))


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _as_float64(D):
    """A float64 copy of D (its blocks compute in the parameters' type)."""
    D64 = copy.deepcopy(D).double()
    cfg = dataclasses.replace(D.cfg, dtype="float32")
    for m in D64.modules():
        if isinstance(getattr(m, "cfg", None), tcfg.DiscriminatorConfig):
            m.cfg = cfg
    return D64


@pytest.fixture(scope="module")
def pair():
    """JAX trainers in float32 and bfloat16; the port's bfloat16 trainer and
    state; a float64 copy of that state, the reference; the weights (the
    port's init, biases and w_avg moved off zero) carried to JAX."""
    tg, td = _cfgs(tcfg, "bfloat16")
    G = init_generator(tg, seed=1, device="cpu")
    D = tdisc.init_discriminator(td, seed=1, device="cpu")
    rng = np.random.RandomState(9)
    with torch.no_grad():
        for net in (G, D):
            for name, p in net.named_parameters():
                if name.endswith("bias"):
                    p.add_(torch.from_numpy(0.1 * rng.randn(*p.shape).astype(np.float32)))
        G.mapping.w_avg.add_(0.3)
    host = {"g": to_flax(G), "d": to_flax(D)}
    jtrainers = {dt: jts.GANTrainer(*_cfgs(jcfg, dt), _train_cfg(jts, jloss))
                 for dt in ("float32", "bfloat16")}
    ttrainer = tts.GANTrainer(tg, td, _train_cfg(tts, tloss), device="cpu")
    state = ttrainer.make_state(G, D, seed=0)
    state64 = dataclasses.replace(state, G=set_compute_dtype(copy.deepcopy(G).double(), "float32"),
                                  D=_as_float64(D))
    return jtrainers, host, ttrainer, state, state64


def _reset_w_avg(host, *states):
    """w_avg back to the carried one (each G_main round moves it)."""
    for st in states:
        st.G.mapping.w_avg.copy_(torch.tensor(host["g"]["moving_stats"]["mapping"]["w_avg"]))


def _l2(got, ref):
    """The relative L2 error of a stage's whole gradient, every leaf in one
    vector, against the float64 reference."""
    num = sum(float(np.square(_np(got[k]).astype(np.float64) - v).sum()) for k, v in ref.items())
    return (num / sum(float(np.square(v).sum()) for v in ref.values())) ** 0.5


def _grads(loss, net):
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, params, grads)}


def _named(net, grads):
    return {n: g.detach().double().numpy() for (n, _), g in zip(net.named_parameters(), grads)}


def _hold_to_float64(got, jax_bf16, jax_f32, ref, **others):
    """The gradient criterion of the stages: each bfloat16 route's relative
    L2 error against the port's float64 gradient at most BF16_RATIO times
    JAX's bfloat16 one's (and than each route in `others`), with JAX's
    float32 gradient within 1e-5 of the reference, so that it is JAX's
    function. Returns the errors."""
    gaps = {"port": _l2(got, ref), "jax_bf16": _l2(jax_bf16, ref), "jax_f32": _l2(jax_f32, ref),
            **{k: _l2(v, ref) for k, v in others.items()}}
    assert gaps["jax_f32"] < 1e-5, gaps
    print("relative L2 errors against float64:", gaps)
    for k in ("jax_bf16", *others):
        assert gaps["port"] <= BF16_RATIO * gaps[k], gaps
    return gaps


@pytest.mark.parametrize("stage", ["g_main", "d_main"])
def test_bf16_main_stage_gradients_match_jax(pair, force_fused_d, stage):
    """One G_main and one D_main round in bfloat16 (G's synthesis and D's
    blocks in bfloat16, D's b16 on the fused ops; parameters and losses
    float32) against JAX's stages in bfloat16: the loss by `_closer`; the
    gradients by their distance from the port's float64 stage (unfused),
    at most BF16_RATIO times JAX's bfloat16 one's (measured: G_main 0.055
    against 0.046, D_main 0.034 against 0.060). Leaf by leaf neither
    bfloat16 implementation lies closer to the other than to float32: their
    backward passes round at other places (in one draw of weights 19 to 37
    of G's 69 leaves failed `_closer`, on the port's fused route and on its
    unfused one alike)."""
    jtrainers, host, ttrainer, tstate, state64 = pair
    rng = np.random.RandomState(0)
    z = rng.randn(1, 4, 3, 8).astype(np.float32)
    real = rng.uniform(-1, 1, (1, 4, RES, RES, 3)).astype(np.float32)
    net = "g" if stage == "g_main" else "d"
    want = {}
    for dt, jt in jtrainers.items():
        def loss_fn(params):
            if net == "g":
                return jloss.g_main_loss(jt.G, jt.D, dict(host["g"], params=params),
                                         {"params": host["d"]["params"]}, jnp.asarray(z[0]),
                                         None, jax.random.PRNGKey(0), jt.cfg.loss)
            return jloss.d_main_loss(jt.G, jt.D, host["g"], {"params": params},
                                     jnp.asarray(real[0]), jnp.asarray(z[0]), None,
                                     jax.random.PRNGKey(0), jt.cfg.loss)
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            host[net]["params"])
        want[dt] = (float(loss), _flat(grads))

    def run(state, dtype):
        _reset_w_avg(host, state)
        zt, rt = torch.from_numpy(z).to(dtype), torch.from_numpy(real).to(dtype)
        if net == "g":
            grads, stats = ttrainer.g_main_grads(state, zt)
            return stats["Loss/G/loss"], _named(state.G, grads)
        grads, stats = ttrainer.d_main_grads(state, rt, zt)
        return stats["Loss/D/loss"], _named(state.D, grads)
    loss, got = run(tstate, torch.float32)
    with force_unpacked():
        _, ref = run(state64, torch.float64)
    assert set(got) == set(want["float32"][1])
    _closer(np.float32(loss), np.float32(want["bfloat16"][0]), np.float32(want["float32"][0]))
    _hold_to_float64(got, want["bfloat16"][1], want["float32"][1], ref)


def test_bf16_path_length_matches_jax(pair, monkeypatch):
    """G_pl in bfloat16 on the default scoped route against JAX's bfloat16
    stage (its unpacked route): the penalty within BF16_FLOOR of the float64
    one (a sum of squares of noisy gradients, as R1's); the gradients by
    their distance from the port's float64 stage (unpacked), at most
    BF16_RATIO times JAX's bfloat16 one's and the port's own plain bfloat16
    route's (unpacked, every op rounding as XLA's); measured 0.080 against
    0.097 and 0.089. Path length is ill-conditioned: a 1e-7 weight nudge
    moves its float64 gradient by 2.7e-3 of its largest entry (PERF.md
    section 7), and on the scoped route a bias's gradient is the sum of two
    terms that cancel (the recovery's and the fused node's backward through
    c_y, JAX's saved-y design): in another draw of weights its largest
    entry error ran to 1.9x the unpacked route's while the whole gradient's
    L2 error stayed within 1.1-1.2x, so the gradient is held as one
    vector."""
    jtrainers, host, ttrainer, tstate, state64 = pair
    z = np.random.RandomState(5).randn(4, 3, 8).astype(np.float32)
    rng, pl_mean = jax.random.PRNGKey(3), 0.4
    _, rng_noise = jax.random.split(rng)
    noise = np.asarray(jax.random.normal(rng_noise, (2, RES, RES, 3)) / np.sqrt(RES * RES))
    monkeypatch.setenv("MGT_PACKED_SECOND_ORDER", "0")
    want = {}
    for dt, jt in jtrainers.items():
        def loss_fn(params):
            return jloss.g_pl_loss(jt.G, dict(host["g"], params=params), jnp.asarray(z), None,
                                   rng, jnp.float32(pl_mean), jt.cfg.loss)
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            host["g"]["params"])
        want[dt] = (float(aux["Loss/pl_penalty"]), _flat(grads))

    def port(G, dtype, route):
        _reset_w_avg(host, tstate, state64)
        with monkeypatch.context() as m:
            if route == "scoped":
                m.delenv("MGT_PACKED_SECOND_ORDER")
            zt, nt = (torch.from_numpy(a).to(dtype) for a in (z, noise))
            loss, aux = tloss.g_pl_loss(G, zt, ttrainer.cfg.loss, torch.Generator(),
                                        torch.tensor(pl_mean, dtype=dtype), pl_noise=nt)
            return float(aux["Loss/pl_penalty"]), {k: v.detach().double().numpy()
                                                   for k, v in _grads(loss, G).items()}
    pen64, ref = port(state64.G, torch.float64, "unpacked")
    pen, scoped = port(tstate.G, torch.float32, "scoped")
    plain = port(tstate.G, torch.float32, "unpacked")[1]
    print("penalties", pen, pen64, want["bfloat16"][0])
    assert abs(pen - pen64) <= BF16_FLOOR * pen64, (pen, pen64, want["bfloat16"][0])
    _hold_to_float64(scoped, want["bfloat16"][1], want["float32"][1], ref, plain_bf16=plain)


# --------------------------------------------------------------------------
# The entry point, and D on K4.
# --------------------------------------------------------------------------


def test_train_entry_point_trains_in_bf16(tmp_path, capsys):
    """`train --dtype bfloat16 --device cpu` on six 64^2 PNGs: one tick of
    two iterations (G_reg and D_reg due at step 0) through training_loop,
    a snapshot whose arch.json records bfloat16 for G and D, float32
    weights and finite losses."""
    res = 64
    os.makedirs(tmp_path / "data" / str(res))
    for i, img in enumerate(np.random.RandomState(6).uniform(0, 255, (6, res, res, 3))):
        write_png(str(tmp_path / "data" / str(res) / f"{i:03d}.png"), img.astype(np.uint8))
    cli.main(["train", "--resolution", str(res), "--components-num", "2", "--latent-size", "16",
              "--channel-base", "256", "--channel-max", "32", "--end-res", "3", "--batch", "2",
              "--batch-gpu", "2", "--device", "cpu", "--dtype", "bfloat16",
              "--data-dir", str(tmp_path / "data"), "--result-dir", str(tmp_path / "runs"),
              "--expname", "b", "--kimg-per-tick", "0.004", "--max-ticks", "1",
              "--img-snapshot-ticks", "0", "--vis"])
    capsys.readouterr()
    run = tmp_path / "runs" / "b-000"
    snap = run / "network-snapshot-000000"
    arch = json.load(open(snap / "arch.json"))
    assert arch["Gs"]["dtype"] == arch["G"]["dtype"] == arch["D"]["dtype"] == "bfloat16"
    state = msgpack_restore(open(snap / "train_state.msgpack", "rb").read())
    assert state["cur_nimg"] == 4
    leaves = jax.tree_util.tree_leaves({k: state[k] for k in ("G", "D", "G_ema")})
    assert leaves and all(np.asarray(v).dtype == np.float32 for v in leaves)
    line, = [json.loads(s) for s in open(run / "stats.jsonl")]
    assert line["Loss/G/reg"]["num"] >= 1 and line["Loss/D/reg"]["num"] >= 1
    assert all(math.isfinite(v["mean"]) for v in line.values()
               if isinstance(v, dict) and "mean" in v)


def test_bf16_skip_discriminator_on_k4_matches_jax(monkeypatch):
    """A `skip` D at 512^2 in bfloat16 with MGT_PALLAS_CONV=1: its conv0 at
    512^2 takes K4 on both sides (the port's gate made to see a card, so
    that its plain version runs here; JAX's gate made to take the CPU, so
    that its Pallas kernel runs in interpret mode, through
    `conv3x3_same_packed`). The logits and the gradient of their sum w.r.t.
    the image are held by `_closer` against JAX in bfloat16 and float32 on
    the same route; the float32 port takes K4 there too."""
    res, n = 512, 2
    args = dict(img_resolution=res, channel_base=2048, channel_max=8, architecture="skip",
                mbstd_group_size=1)
    variables = jax.device_get(JDiscriminator(jcfg.DiscriminatorConfig(**args)).init(
        jax.random.PRNGKey(0), jnp.zeros((n, res, res, 3))))
    monkeypatch.setenv("MGT_PALLAS_CONV", "1")
    monkeypatch.setattr(jpc, "pallas_conv_eligible",
                        lambda xs, ws, groups: groups == 1 and tuple(ws[:2]) == (3, 3)
                        and xs[1] == xs[2] and xs[1] >= 512 and xs[3] <= 64 and ws[3] <= 64
                        and xs[2] % 2 == 0)
    calls = {"jax": 0, "port": 0}
    real_j, real_t = jpc.conv3x3_same_packed, k4.conv3x3_same

    def counting(side, real):
        def run(*a, **k):
            calls[side] += 1
            return real(*a, **k)
        return run
    monkeypatch.setattr(jpc, "conv3x3_same_packed", counting("jax", real_j))
    monkeypatch.setattr(k4, "conv3x3_same", counting("port", real_t))
    monkeypatch.setattr(k4, "_on_card", lambda x: True)
    img = np.random.RandomState(4).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    want = {}
    for dt in ("float32", "bfloat16"):
        net = JDiscriminator(jcfg.DiscriminatorConfig(**args, dtype=dt))
        logits, vjp = jax.vjp(lambda i: net.apply(variables, i), jnp.asarray(img))
        want[dt] = (logits, *vjp(jnp.ones_like(logits)))
    assert calls["jax"] == 2
    D = load_flax(tdisc.init_discriminator(tcfg.DiscriminatorConfig(**args, dtype="bfloat16"),
                                           device="cpu"), variables)
    it = torch.from_numpy(img).requires_grad_(True)
    logits = D(it)
    grad, = torch.autograd.grad(logits.sum(), it)
    assert calls["port"] == 1 and logits.dtype == grad.dtype == torch.float32
    assert fc.launch_counts["conv3x3_bf16"] == fc.launch_counts["conv3x3_adj_bf16"] == 0
    for got, w_bf, w_f32 in zip((logits, grad), want["bfloat16"], want["float32"]):
        _closer(got, w_bf, w_f32)
    D32 = tdisc.init_discriminator(tcfg.DiscriminatorConfig(**args), device="cpu")
    with torch.no_grad():
        assert torch.isfinite(D32(torch.zeros(1, res, res, 3))).all()
    assert calls["port"] == 2
