"""The morph entry point's CSV mode (cli.py `morph --pairs-csv`): the pairs
a CSV yields under --min-similarity and --img-root, as JAX's cli/morph.py
reads them, and the outputs of a 2-pair CSV projected as one batch-4
projection: per pair the two reconstructions and their latents, the morph
latent (the pair's latents averaged) and the morph image (G of it, from the
one batched generation).

`run_morph_pairs` is held against JAX's `run_pairs` (cli/morph.py) on the
same weights (the port's, carried to JAX by `to_flax`), prior statistics
and per-step latent noise (JAX's, replayed through `noise_seq`): the
projection's losses, best latents and images, every .mat and PNG. The same
2-pair batch-4 projection is held against the two pairs projected as
separate batch-2 projections on the same noise."""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.projection import engine as jengine
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint.io import save_generator
from morphganformer_tpu_torch.projection import engine
from morphganformer_tpu_torch.morph import load_latent_mat
from morphganformer_tpu_torch.utils.image import read_png, to_uint8, write_png

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_noise_reg import small  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CSV = "img_a,img_b,similarity\nalice.png,bob.png,0.9\ncarol.png,dave.png,0.2\n" \
      "erin.png,frank.png,0.5\n"


def _jax_pairs(path, img_root, min_similarity, monkeypatch):
    """The pairs JAX's cli/morph.py main() hands to run_pairs."""
    import cli.morph as jmorph

    seen = []
    monkeypatch.setattr(jmorph, "run_pairs", lambda b, s, pairs, o, a: seen.extend(pairs))
    monkeypatch.setattr("cli.generate.get_model", lambda *a, **k: None)
    monkeypatch.setattr(jmorph, "prepare", lambda *a: None)
    monkeypatch.setattr("morphganformer_tpu.utils.compile_cache.enable_persistent_cache",
                        lambda: None)
    monkeypatch.setattr(sys, "argv", ["morph.py", "--model", "m", "--pairs-csv", path,
                                      "--img-root", img_root, "--min-similarity",
                                      str(min_similarity), "--pairs-per-batch", "1"])
    jmorph.main()
    return seen


@pytest.mark.parametrize("min_similarity", [0.1, 0.5, 0.95])
def test_pairs_csv_matches_jax(tmp_path, monkeypatch, min_similarity):
    path = str(tmp_path / "pairs.csv")
    with open(path, "w") as f:
        f.write(CSV)
    got = cli.read_pairs_csv(path, "root", min_similarity)
    assert got == _jax_pairs(path, "root", min_similarity, monkeypatch)
    assert len(got) == {0.1: 3, 0.5: 2, 0.95: 0}[min_similarity]
    with open(path, "w") as f:
        f.write("img_a,img_b\nx.png,y.png\n")               # no similarity: every row
    assert cli.read_pairs_csv(path) == [("x.png", "y.png")]


def _faces(G, root, names):
    gen = torch.Generator().manual_seed(9)
    for name in names:
        z = torch.randn((1, G.cfg.k, G.cfg.z_dim), generator=gen)
        with torch.no_grad():
            write_png(os.path.join(root, f"{name}.png"), to_uint8(G(z=z, truncation_psi=0.7)[0]
                                                                  .numpy()))


def test_morph_csv_writes_every_pair(small, tmp_path):
    _, _, G = small
    ckpt = str(tmp_path / "ckpt")
    save_generator(ckpt, G.cfg, G)
    os.makedirs(tmp_path / "faces")
    _faces(G, str(tmp_path / "faces"), ["alice", "bob", "carol", "dave", "erin", "frank"])
    path = str(tmp_path / "pairs.csv")
    with open(path, "w") as f:
        f.write(CSV)
    out = str(tmp_path / "out")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cli.main(["morph", "--model", ckpt, "--device", "cpu", "--dtype", "float32",
                  "--pairs-csv", path, "--img-root", str(tmp_path / "faces"),
                  "--pairs-per-batch", "4", "--step", "3", "--n_mean_latent", "64",
                  "--out", out])
    assert "projecting 2 pair(s) as one batch-4 projection" in log.getvalue()
    stems = [("alice", "bob"), ("erin", "frank")]
    want = sorted(f"{n}{ext}" for a, b in stems for n in (a, b) for ext in ("_rec.png", ".mat"))
    want += [f"{a}_{b}_morph{ext}" for a, b in stems for ext in (".png", ".mat")]
    assert sorted(os.listdir(out)) == sorted(want)
    for a, b in stems:
        wa, wb = (load_latent_mat(os.path.join(out, f"{n}.mat")) for n in (a, b))
        w = load_latent_mat(os.path.join(out, f"{a}_{b}_morph.mat"))
        np.testing.assert_allclose(w, 0.5 * wa + 0.5 * wb, rtol=0, atol=1e-6)
        with torch.no_grad():
            img = G(z=torch.from_numpy(w)[None], truncation_psi=0.7)[0].numpy()
        got = read_png(os.path.join(out, f"{a}_{b}_morph.png")).astype(np.int16)
        assert np.abs(got - to_uint8(img).astype(np.int16)).max() <= 1
    log = io.StringIO()
    with contextlib.redirect_stdout(log):      # one CPU device: JAX's message, no sharding
        cli.main(["morph", "--model", ckpt, "--device", "cpu", "--dtype", "float32",
                  "--img-a", str(tmp_path / "faces" / "alice.png"),
                  "--img-b", str(tmp_path / "faces" / "bob.png"), "--shard", "--step", "2",
                  "--n_mean_latent", "64", "--out", str(tmp_path / "sharded")])
    assert "--shard ignored: 1 device(s), batch 2" in log.getvalue()
    assert os.path.exists(tmp_path / "sharded" / "alice_bob_morph.png")
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["morph", "--model", ckpt, "--device", "cpu"])      # no pair given


STEPS = 3
STEMS = [("alice", "bob"), ("erin", "frank")]


def _replay(monkeypatch, mean, std, noises):
    """The port's run_morph_pairs on the given prior statistics, each of its
    projections on the next of `noises` (one [steps, batch, k, z_dim] array
    a group) in place of the generator's draws."""
    it = iter(noises)

    def project(G, target, loss_fn, pcfg, latent_mean, latent_std, generator=None,
                progress=None, mesh=None):
        return engine.project(G, target, loss_fn, pcfg, latent_mean, latent_std,
                              progress=progress, noise_seq=next(it), mesh=mesh)

    monkeypatch.setattr(cli, "latent_stats", lambda *a, **k: (mean, std))
    monkeypatch.setattr(cli, "project", project)


@pytest.fixture(scope="module")
def pair_runs(small, tmp_path_factory):
    """JAX's run_pairs and the port's run_morph_pairs on a 2-pair group
    (one batch-4 projection of STEPS steps), and the port's on the same two
    pairs one pair a group (two batch-2 projections) with the same noise:
    (out dirs, JAX's ProjectionResult, the port's groups of each run)."""
    import argparse

    import cli.morph as jmorph

    model, variables, G = small
    root = tmp_path_factory.mktemp("pairs")
    _faces(G, str(root), [n for pair in STEMS for n in pair])
    pairs = [(str(root / f"{a}.png"), str(root / f"{b}.png")) for a, b in STEMS]
    mean, std = engine.latent_stats(G.cfg, torch.Generator().manual_seed(1), 512)
    rng = jax.random.PRNGKey(4)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MGT_PACKED_SYNTH", "0")
        jproject = jengine.project
        mp.setattr(jengine, "project", lambda *a, **k: seen.append(jproject(*a, **k)) or seen[-1])
        pcfg = jengine.ProjectionConfig(steps=STEPS, lr=0.1, truncation_psi=0.7)
        args = argparse.Namespace(shard=False, step=STEPS, loss="mse", alpha=0.5,
                                  truncation_psi=0.7)
        with contextlib.redirect_stdout(io.StringIO()):
            jmorph.run_pairs((G.cfg, model, variables),
                             (pcfg, jbuild_loss_stack({"mse": 1.0}), jnp.asarray(mean.numpy()),
                              jnp.asarray(std.numpy()), rng), pairs, str(root / "jax"), args)
        # run_pairs projects with rng=split(rng)[1]; the engine draws its one
        # window of noise from split(that, 2)[1].
        _, sub = jax.random.split(rng)
        _, key = jax.random.split(sub, 2)
        noise = np.asarray(jax.random.normal(key, (STEPS, 4, G.cfg.k, G.cfg.z_dim)))
        runs = {}
        for per, noises in ((2, [noise]), (1, [noise[:, :2], noise[:, 2:]])):
            _replay(mp, mean, std, noises)
            with contextlib.redirect_stdout(io.StringIO()):
                runs[per] = cli.run_morph_pairs(G, pairs, str(root / f"port{per}"), "mse", STEPS,
                                                lr=0.1, truncation_psi=0.7, pairs_per_batch=per)
    return root, seen[0], runs


def test_morph_pairs_match_jax_run_pairs(pair_runs):
    """One batch-4 projection of 3 steps (the first at lr 0): the per-step
    losses, each image's best loss and step, the best latents and images to
    2e-4 (as tests/test_torch_projection.py holds 3 steps); every .mat file
    to 2e-4 and every PNG (four reconstructions, two morphs) to one level of
    255. Measured: best losses 1.4e-5, latents 2.0e-6 and best images 3.2e-5
    of their largest entries; three PNGs one level apart at most."""
    root, want, runs = pair_runs
    (got, imgs, w_morphs), = runs[2]
    tol = 2e-4
    np.testing.assert_allclose(got.loss_history.numpy(), np.asarray(want.loss_history),
                               rtol=tol, atol=1e-6)
    np.testing.assert_allclose(got.per_image_loss.numpy(), np.asarray(want.per_image_loss),
                               rtol=tol)
    np.testing.assert_array_equal(got.per_image_step.numpy(), np.asarray(want.per_image_step))
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.best_img.numpy(), np.asarray(want.best_img), rtol=tol,
                               atol=tol)
    files = sorted(os.listdir(root / "jax"))
    assert sorted(os.listdir(root / "port2")) == files and len(files) == 12
    for f in files:
        a, b = root / "jax" / f, root / "port2" / f
        if f.endswith(".mat"):
            np.testing.assert_allclose(load_latent_mat(b), load_latent_mat(a), rtol=tol,
                                       atol=tol, err_msg=f)
        else:
            diff = np.abs(read_png(b).astype(np.int16) - read_png(a).astype(np.int16))
            assert diff.max() <= 1, (f, diff.max())


def test_batched_pairs_match_separate_runs(pair_runs):
    """The 2-pair batch-4 projection against the same pairs as two batch-2
    projections on the same noise. The loss is the batch's mean, so each
    image's gradient is 1/batch of its own; Adam's update does not see that
    scale, but its eps and the coupled weight decay (1e-4 * latent, added to
    the gradient) do, so the two differ by rounding and that shift. Measured
    over 3 steps, of the largest entries: latents 1.2e-5, best losses 4.4e-5,
    morph images 8.9e-5; held to 1e-4."""
    _, _, runs = pair_runs
    (batched, imgs, w_morphs), = runs[2]
    alone = runs[1]
    assert [r.latent.shape[0] for r, _, _ in alone] == [2, 2]
    np.testing.assert_allclose(batched.latent.numpy(),
                               np.concatenate([r.latent.numpy() for r, _, _ in alone]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(batched.per_image_loss.numpy(),
                               np.concatenate([r.per_image_loss.numpy() for r, _, _ in alone]),
                               rtol=1e-4)
    np.testing.assert_array_equal(batched.per_image_step.numpy(),
                                  np.concatenate([r.per_image_step.numpy() for r, _, _ in alone]))
    np.testing.assert_allclose(w_morphs, np.concatenate([w for _, _, w in alone]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(imgs, np.concatenate([i for _, i, _ in alone]), rtol=1e-4,
                               atol=1e-4)
