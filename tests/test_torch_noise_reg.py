"""The projection's noise_regularize (projection/engine.py) against the JAX
engine, and its entry points (project --noise_regularize, the
<latent>.noises.npz, merge --noises).

The weights are the port's, carried to JAX with `to_flax`, with every noise
strength set to 0.3 (0 at init, where the noise maps' cotangent would be a
zero that checks nothing). JAX runs the unpacked generator
(MGT_PACKED_SYNTH=0); the port its fused blocks on the plain versions of
the kernels, whose noise cotangent is `_noise_grad`. The penalty and the
renormalisation agree to 1e-6 relative; over a 5-step projection the loss
(penalty included), the latent and every noise map to 1e-4 (about 1e-6
measured)."""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu.projection import engine as jengine
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import to_flax
from morphganformer_tpu_torch.checkpoint.io import save_generator
from morphganformer_tpu_torch.losses import build_loss_stack
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.projection import engine
from morphganformer_tpu_torch.utils.image import read_png

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 5
KW = dict(steps=STEPS, chunk=8, lr=0.05, noise_regularize=1e3)


@pytest.fixture(scope="module")
def small():
    """(JAX model, its variables, the port's generator with the same
    weights): the port's init with noise strengths and w_avg made non-zero,
    carried to JAX by to_flax."""
    G = init_generator(_cfg(tcfg, "small"), seed=5, device="cpu")
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.3)
        G.mapping.w_avg.add_(0.3)
    return JGenerator(_cfg(jcfg, "small")), to_flax(G), G


def _maps(seed, shapes=((4, 4), (8, 8), (16, 16), (32, 32), (64, 64))):
    rng = np.random.RandomState(seed)
    return {f"m{i}": (rng.randn(*s) + 0.3 * rng.randn(1, s[1])).astype(np.float32)
            for i, s in enumerate(shapes)}


def test_noise_keys_are_jax_paths(small):
    _, variables, G = small
    keys = list(engine.split_noise_buffers(G))
    assert sorted(keys) == sorted(jengine.split_noise_buffers(variables))
    assert "synthesis/b16/conv1/noise_const" in keys and len(keys) == 5


def test_noise_regularize_loss_matches_jax():
    maps = _maps(0)
    got = float(engine.noise_regularize_loss({k: torch.from_numpy(v) for k, v in maps.items()}))
    want = float(jengine.noise_regularize_loss({k: jnp.asarray(v) for k, v in maps.items()}))
    assert got == pytest.approx(want, rel=1e-6) and got > 0


def test_normalize_noises_matches_jax():
    maps = _maps(1)
    got = {k: torch.from_numpy(v.copy()) for k, v in maps.items()}
    engine.normalize_noises(got)
    want = jengine.normalize_noises({k: jnp.asarray(v) for k, v in maps.items()})
    for k in maps:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)


def test_merge_noise_buffers_and_the_swap(small):
    _, _, G = small
    before = {k: v.clone() for k, v in engine.split_noise_buffers(G).items()}
    key = "synthesis/b8/conv0/noise_const"
    swapped = {key: torch.ones(8, 8)}
    with engine.noise_buffers(G, swapped):
        assert engine.split_noise_buffers(G)[key] is swapped[key]
    for k, v in engine.split_noise_buffers(G).items():
        assert torch.equal(v, before[k])
    with pytest.raises(KeyError, match="no noise buffer"):
        engine.merge_noise_buffers(G, {"synthesis/b8/conv0/weight": np.ones((8, 8))})
    with pytest.raises(ValueError, match="noise map"):
        engine.merge_noise_buffers(G, {key: np.ones((4, 4))})


def _target(G):
    z = torch.randn((1, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(42))
    with torch.no_grad():
        return G(z=z, truncation_psi=0.7)


@pytest.fixture(scope="module")
def both_runs(small):
    """JAX's and the port's 5-step noise_regularize projections from the same
    latent, target and per-step latent noise (JAX's, replayed)."""
    model, variables, G = small
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGT_PACKED_SYNTH", "0")
        target = _target(G)
        mean, std = engine.latent_stats(G.cfg, torch.Generator().manual_seed(1), 512)
        rng = jax.random.PRNGKey(2)
        want = jengine.project(model, variables, jnp.asarray(target.numpy()),
                               jbuild_loss_stack({"mse": 1.0}), jengine.ProjectionConfig(**KW),
                               jnp.asarray(mean.numpy()), jnp.asarray(std.numpy()), rng=rng)
        _, key = jax.random.split(rng, 2)
        noise = np.asarray(jax.random.normal(key, (STEPS, 1, G.cfg.k, G.cfg.z_dim)))
        before = {k: v.clone() for k, v in engine.split_noise_buffers(G).items()}
        got = engine.project(G, target, build_loss_stack({"mse": 1.0}),
                             engine.ProjectionConfig(**KW), mean, std, noise_seq=noise)
        for k, v in engine.split_noise_buffers(G).items():     # G's buffers untouched
            assert torch.equal(v, before[k])
    return got, want


def test_noise_regularize_trajectory_matches_jax(both_runs):
    got, want = both_runs
    np.testing.assert_allclose(got.loss_history.numpy(), np.asarray(want.loss_history),
                               rtol=1e-4)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=1e-4,
                               atol=1e-4)
    assert sorted(got.noises) == sorted(want.noises)
    for k, v in want.noises.items():
        np.testing.assert_allclose(got.noises[k].numpy(), np.asarray(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(got.best_img.numpy(), np.asarray(want.best_img), rtol=1e-4,
                               atol=1e-4)
    assert got.best_step == want.best_step
    assert got.best_loss == pytest.approx(want.best_loss, rel=1e-4)


def test_one_step_gradients_match_jax(small, monkeypatch):
    """d loss / d latent and d loss / d noise map of the whole loss (mean MSE
    + the weighted penalty) against jax.grad of JAX's, at one latent."""
    model, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    target = _target(G)
    latent = torch.randn((1, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(3))
    noises = engine.split_noise_buffers(G)
    pcfg = engine.ProjectionConfig(**KW)
    _, _, loss, dlat, dnoise = engine.loss_and_grads_with_noise(
        G, latent, noises, target, build_loss_stack({"mse": 1.0}), pcfg)

    def jloss(p):
        v = jengine.merge_noise_buffers(variables, p["noises"])
        img = model.apply(v, p["latent"], truncation_psi=0.7, noise_mode="const")
        return (jnp.mean((img - jnp.asarray(target.numpy())) ** 2)
                + KW["noise_regularize"] * jengine.noise_regularize_loss(p["noises"]))

    p = {"latent": jnp.asarray(latent.numpy()),
         "noises": {k: jnp.asarray(v.numpy()) for k, v in noises.items()}}
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(p)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    np.testing.assert_allclose(dlat.numpy(), np.asarray(want["latent"]), rtol=1e-4, atol=1e-5)
    for k, v in want["noises"].items():
        scale = float(np.abs(np.asarray(v)).max())
        assert scale > 0, k                      # the noise cotangent is not a zero
        np.testing.assert_allclose(dnoise[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


def test_noise_regularize_is_batch_1(small):
    _, _, G = small
    target = torch.cat([_target(G)] * 2)
    mean, std = engine.latent_stats(G.cfg, torch.Generator().manual_seed(1), 64)
    with pytest.raises(ValueError, match="batch 1"):
        engine.project(G, target, build_loss_stack({"mse": 1.0}),
                       engine.ProjectionConfig(steps=2, noise_regularize=1e5), mean, std)


def test_noises_npz_crosses_packages(small, both_runs, tmp_path):
    """JAX's best maps, saved as its cli/project.py saves them, regenerate
    JAX's best image in the port; the port's, merged by JAX's
    merge_noise_buffers, land on every noise buffer of JAX's tree."""
    _, variables, G = small
    got, want = both_runs
    path = str(tmp_path / "w.noises.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in want.noises.items()})
    G2 = init_generator(G.cfg, seed=0, device="cpu")
    G2.load_state_dict(G.state_dict())
    engine.merge_noise_buffers(G2, cli.load_noises(path))
    with torch.no_grad():
        img = G2(z=got.latent, truncation_psi=0.7)
    np.testing.assert_allclose(img.numpy(), np.asarray(want.best_img), rtol=1e-4, atol=1e-4)

    np.savez(path, **{k: v.numpy() for k, v in got.noises.items()})
    with np.load(path) as nz:
        merged = jengine.merge_noise_buffers(variables, {k: jnp.asarray(nz[k]) for k in nz.files})
    flat = jengine.split_noise_buffers(merged)
    assert sorted(flat) == sorted(jengine.split_noise_buffers(variables))
    for k, v in got.noises.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v.numpy())


def test_project_writes_noises_and_merge_applies_them(small, tmp_path):
    """project --noise_regularize writes w.noises.npz beside w.mat; merge
    --latents w.mat w.mat --noises w.noises.npz writes the projection's best
    image byte for byte (float32 on the CPU)."""
    _, _, G = small
    ckpt = str(tmp_path / "ckpt")
    save_generator(ckpt, G.cfg, G)
    from morphganformer_tpu_torch.utils.image import to_uint8, write_png
    write_png(str(tmp_path / "face.png"), to_uint8(_target(G)[0].numpy()))
    common = ["--model", ckpt, "--device", "cpu", "--dtype", "float32"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["project", *common, "--img", str(tmp_path / "face.png"), "--step", "4",
                  "--n_mean_latent", "64", "--noise_regularize", "1e3", "--path_to_gen",
                  str(tmp_path / "proj")])
        files = sorted(os.listdir(tmp_path / "proj"))
        assert files[1:] == ["w.mat", "w.noises.npz"] and files[0].startswith("sample_")
        with np.load(tmp_path / "proj" / "w.noises.npz") as nz:
            assert sorted(nz.files) == sorted(engine.split_noise_buffers(G))
        w = str(tmp_path / "proj" / "w.mat")
        cli.main(["merge", *common, "--latents", w, w, "--noises",
                  str(tmp_path / "proj" / "w.noises.npz"), "--out", str(tmp_path / "m")])
    np.testing.assert_array_equal(read_png(str(tmp_path / "m" / "w_w.png")),
                                  read_png(str(tmp_path / "proj" / files[0])))
