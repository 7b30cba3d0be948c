"""The port's generator against the JAX generator, with the weights carried
over by checkpoint/convert.py.

The JAX side runs its unpacked path (on the CPU the packed Pallas chain is
off; MGT_PACKED_SYNTH=0 makes that explicit). The port runs its fused blocks
through the K1/K2 wrappers, which take their plain versions on the CPU, so
the wiring of every kernel call site is under test here. Tolerance 2e-4,
the JAX suite's own for packed vs unpacked generators
(tests/test_packed_pipeline.py:95)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu_torch.checkpoint import from_flax, load_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models import synthesis as tsyn

TOL = 2e-4


def _cfg(mod, name):
    kw = dict(small=dict(img_resolution=16, channel_base=1024, channel_max=128),
              split=dict(img_resolution=32, channel_base=4096, channel_max=256))[name]
    return mod.GANformerConfig(z_dim=8, w_dim=8, k=3, end_res=3,
                               mapping=mod.MappingConfig(num_layers=2),
                               attention=mod.AttentionConfig(), **kw)


@pytest.fixture(scope="module", params=["small", "split"])
def carried(request):
    """(JAX model, its variables, the port's generator with those weights)."""
    jc, tc = _cfg(jcfg, request.param), _cfg(tcfg, request.param)
    model = JGenerator(jc)
    z = jnp.zeros((1, jc.k, jc.z_dim))
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "mask", "dropout"))}
    variables = model.init(rngs, z, noise_mode="const")
    # Fresh inits have zero noise strengths and w_avg: make both count.
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(s in jax.tree_util.keystr(p)
                                    for s in ("noise_strength", "w_avg")) else x, variables)
    G = load_flax(init_generator(tc, seed=5, device="cpu"), jax.device_get(variables))
    return model, variables, G


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_generator_matches_jax(carried, noise_mode, monkeypatch):
    model, variables, G = carried
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    z = np.random.RandomState(0).randn(2, G.cfg.k, G.cfg.z_dim).astype(np.float32)
    img_j, ws_j = model.apply(variables, jnp.asarray(z), truncation_psi=0.7,
                              noise_mode=noise_mode, return_ws=True)
    with torch.no_grad():
        img_t, ws_t = G(z=torch.from_numpy(z), truncation_psi=0.7, noise_mode=noise_mode,
                        return_ws=True)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=TOL, atol=TOL)
    # The unfused path of the port agrees too (the fused-block gate only
    # picks the implementation).
    monkeypatch.setattr(tsyn, "packed_structural_ok", lambda *a: False)
    with torch.no_grad():
        img_u = G(z=torch.from_numpy(z), truncation_psi=0.7, noise_mode=noise_mode)
    np.testing.assert_allclose(img_u.numpy(), np.asarray(img_j), rtol=TOL, atol=TOL)


def test_fused_blocks_call_each_kernel_site(carried, monkeypatch):
    """The split config's three top blocks are fused like FFHQ-1024's b256,
    b512 and b1024: one forward calls K1 4 times and K2 6 times; with
    plain=True it calls neither wrapper."""
    _, _, G = carried
    calls = {"k1": 0, "k2": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    from morphganformer_tpu_torch.models import layers as tlayers

    monkeypatch.setattr(tsyn, "fused_modconv3x3", counting("k1", tsyn.fused_modconv3x3))
    monkeypatch.setattr(tsyn, "fused_upconv2", counting("k2", tsyn.fused_upconv2))
    monkeypatch.setattr(tlayers, "fused_upconv2", counting("k2", tlayers.fused_upconv2))
    fused = [r for r in G.cfg.block_resolutions if tsyn.packed_structural_ok(G.cfg, r, "const")]
    z = torch.zeros(1, G.cfg.k, G.cfg.z_dim)
    with torch.no_grad():
        a = G(z=z, truncation_psi=0.7)
        assert calls == {"k1": len(fused) + 1, "k2": 2 * len(fused)}
        b = G(z=z, truncation_psi=0.7, plain=True)
    assert calls == {"k1": len(fused) + 1, "k2": 2 * len(fused)}
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("noise_mode,blocks", [("const", [256, 512, 1024]),
                                               ("none", [256, 512, 1024]),
                                               ("random", [])])
def test_fused_gate_picks_the_ffhq1024_top_blocks(noise_mode, blocks):
    cfg = tcfg.ffhq1024_config()
    got = [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, noise_mode)]
    assert got == blocks


def test_from_flax_refuses_unmapped_and_missing_leaves(carried):
    _, variables, G = carried
    tree = jax.device_get(variables)
    state = from_flax(tree)
    assert set(state) == set(G.state_dict())
    with pytest.raises(KeyError, match="unmapped"):
        from_flax(dict(tree, intermediates={"x": np.zeros(1)}))
    extra = dict(tree, params=dict(tree["params"], stray=np.zeros(2)))
    with pytest.raises(KeyError, match="stray"):
        load_flax(G, extra)
    short = dict(tree, params={k: v for k, v in tree["params"].items() if k != "pos"})
    with pytest.raises(KeyError, match="pos"):
        load_flax(G, short)


def test_init_generator_is_seeded():
    cfg = _cfg(tcfg, "small")
    a, b = init_generator(cfg, seed=3, device="cpu"), init_generator(cfg, seed=3, device="cpu")
    c = init_generator(cfg, seed=4, device="cpu")
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, b.state_dict()[k], rtol=0, atol=0)
    assert not torch.equal(a.synthesis.b16.conv1.weight, c.synthesis.b16.conv1.weight)


def test_smoke_checks_every_fused_call_shape():
    """chip_smoke.py checks K1/K2 at exactly the call shapes that the gate
    sends to them in one FFHQ-1024 forward."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = tcfg.ffhq1024_config()
    want = []
    for res in cfg.block_resolutions:
        if tsyn.packed_structural_ok(cfg, res, "const"):
            cin, cout = cfg.channels(res // 2), cfg.channels(res)
            want += [("K2", f"b{res}", "conv0", res // 2, cin, cout),
                     ("K2", f"b{res}", "skip", res // 2, cin, cout),
                     ("K1", f"b{res}", "conv1", res, cout, cout)]
    want.append(("K1", f"b{res}", "conv_last", res, cout, cout))
    assert sorted(smoke.kernel_calls()) == sorted(want)
