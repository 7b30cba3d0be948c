"""The port's projection entry points (project, morph, image-mode demorph)
on small random networks on the CPU, project's loss stack flags (the
perceptual terms with --random-perceptual, --size, --lamda, --beta, the
missing weight flags), and its PNG reader and load_target."""

import importlib
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.morph import load_latent_mat, morph_latents
from morphganformer_tpu_torch.utils.image import (
    lanczos_resize,
    load_target,
    read_png,
    to_uint8,
    write_png,
)

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _encode_png(path, img, filters):
    """An 8-bit PNG whose row y uses filter filters[y % len(filters)]."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    out = bytearray()
    for y in range(h):
        ft, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    color = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3])
def test_read_png_inverts_write_png(tmp_path, c):
    img = np.random.RandomState(0).randint(0, 256, (7, 9, c)).astype(np.uint8)
    write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), img)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_read_png_undoes_every_filter(tmp_path, c):
    img = np.random.RandomState(1).randint(0, 256, (10, 6, c)).astype(np.uint8)
    _encode_png(tmp_path / "f.png", img, filters=[0, 1, 2, 3, 4, 4, 3, 2, 1])
    np.testing.assert_array_equal(read_png(tmp_path / "f.png"), img)


def test_load_target_crops_the_centre(tmp_path):
    img = np.random.RandomState(2).randint(0, 256, (10, 15, 3)).astype(np.uint8)
    write_png(tmp_path / "wide.png", img)
    t = load_target(tmp_path / "wide.png", size=10)
    assert t.shape == (1, 10, 10, 3) and t.dtype == np.float32
    np.testing.assert_allclose(t[0], img[:, 2:12] / 127.5 - 1.0, rtol=0, atol=1e-6)
    gray = img[:, :10, :1]
    write_png(tmp_path / "gray.png", gray)
    np.testing.assert_allclose(load_target(tmp_path / "gray.png", size=10)[0],
                               np.repeat(gray, 3, axis=2) / 127.5 - 1.0, rtol=0, atol=1e-6)
    # Another size: the Lanczos resize of the shorter side to 8 (the longer
    # to round(15 * 0.8) = 12), then the centre crop.
    small = load_target(tmp_path / "wide.png", size=8)
    np.testing.assert_allclose(small[0], lanczos_resize(img, 8, 12)[:, 2:10] / 127.5 - 1.0,
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 16^2 network with fused blocks, and two of its images as PNGs."""
    G = init_generator(_cfg(tcfg, "small"), seed=0, device="cpu")
    with torch.no_grad():
        for name, p in G.named_parameters():
            if "noise_strength" in name:
                p.fill_(0.3)
    z = torch.randn((2, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(9))
    imgs = cli.synthesize(G, z).numpy()
    d = tmp_path_factory.mktemp("targets")
    paths = []
    for i, name in enumerate(("alice", "bob")):
        write_png(d / f"{name}.png", to_uint8(imgs[i]))
        paths.append(str(d / f"{name}.png"))
    return G, paths


def test_project_entry_point(tmp_path, small):
    G, (a, _) = small
    res = cli.run_project(G, a, tmp_path, steps=12, n_mean_latent=256, chunk=5, seed=3)
    files = sorted(os.listdir(tmp_path))
    assert files == [f"sample_{res.best_step:06d}_{res.best_loss:.4f}.png", "w.mat"]
    assert res.best_loss < float(res.loss_history[0])
    np.testing.assert_array_equal(load_latent_mat(tmp_path / "w.mat"), res.latent[0].numpy())
    np.testing.assert_array_equal(read_png(tmp_path / files[0]), to_uint8(res.best_img[0].numpy()))
    # W+ from the stored z latent, to another latent path.
    res_w = cli.run_project(G, a, tmp_path / "wp", steps=4, n_mean_latent=64, w_plus=True,
                            init_latent=str(tmp_path / "w.mat"),
                            save_latent=str(tmp_path / "ws.mat"))
    assert load_latent_mat(tmp_path / "ws.mat").shape == (G.cfg.k, G.cfg.num_ws, G.cfg.w_dim)
    assert res_w.latent.shape == (1, G.cfg.k, G.cfg.num_ws, G.cfg.w_dim)


def test_morph_pair_and_image_demorph_entry_points(tmp_path, small):
    G, (a, b) = small
    (res, imgs, ws), = cli.run_morph_pairs(G, [(a, b)], tmp_path / "m", steps=6,
                                           n_mean_latent=128)
    img, w = imgs[0], ws[0]
    assert sorted(os.listdir(tmp_path / "m")) == [
        "alice.mat", "alice_bob_morph.mat", "alice_bob_morph.png", "alice_rec.png",
        "bob.mat", "bob_rec.png"]
    assert res.latent.shape == (2, G.cfg.k, G.cfg.z_dim) and res.per_image_loss.shape == (2,)
    np.testing.assert_allclose(w, morph_latents(res.latent[0].numpy(), res.latent[1].numpy()),
                               rtol=0, atol=0)
    np.testing.assert_allclose(img, cli.synthesize(G, w[None])[0].numpy(), rtol=0, atol=1e-4)

    img_d, w_rec = cli.run_demorph(G, out_dir=tmp_path / "d",
                                   morph_img=str(tmp_path / "m" / "alice_bob_morph.png"),
                                   accomplice_img=a, steps=4, n_mean_latent=64)
    assert img_d.shape == (16, 16, 3) and np.isfinite(img_d).all()
    assert w_rec.shape == (G.cfg.k, G.cfg.z_dim)
    np.testing.assert_allclose(load_latent_mat(tmp_path / "d" / "demorph.mat"), w_rec,
                               rtol=0, atol=0)
    # One latent and one image mix too; a missing input raises.
    _, w_mix = cli.run_demorph(G, tmp_path / "m" / "alice_bob_morph.mat", None, tmp_path / "e",
                               accomplice_img=a, steps=2, n_mean_latent=64)
    assert w_mix.shape == (G.cfg.k, G.cfg.z_dim)
    with pytest.raises(ValueError, match="accomplice"):
        cli.run_demorph(G, tmp_path / "m" / "alice_bob_morph.mat", None, tmp_path / "f")


def test_tag_seed_is_the_same_in_every_process():
    assert cli.tag_seed(0, "morph") == zlib.crc32(b"morph") % 97
    assert cli.tag_seed(5, "accomplice") == 5 + zlib.crc32(b"accomplice") % 97
    assert cli.tag_seed(0, "morph") != cli.tag_seed(0, "accomplice")


def test_main_dispatches_the_projection_commands(tmp_path):
    cfg, G = cli.get_model("init:8", device="cpu")
    z = torch.randn((2, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    imgs = cli.synthesize(G, z).numpy()
    for i, name in enumerate("ab"):
        write_png(tmp_path / f"{name}.png", to_uint8(imgs[i]))
    common = ["--model", "init:8", "--device", "cpu", "--step", "2", "--n_mean_latent", "32"]
    cli.main(["project", *common, "--img", str(tmp_path / "a.png"),
              "--path_to_gen", str(tmp_path / "p"), "--loss", "mse+0.5*l1"])
    assert "w.mat" in os.listdir(tmp_path / "p")
    cli.main(["morph", *common, "--img-a", str(tmp_path / "a.png"),
              "--img-b", str(tmp_path / "b.png"), "--out", str(tmp_path / "m")])
    assert "a_b_morph.png" in os.listdir(tmp_path / "m")
    cli.main(["demorph", *common, "--morph-img", str(tmp_path / "m" / "a_b_morph.png"),
              "--accomplice-latent", str(tmp_path / "m" / "a.mat"), "--out", str(tmp_path / "d")])
    assert sorted(os.listdir(tmp_path / "d")) == ["demorph.mat", "demorph.png"]



def test_project_with_the_perceptual_terms(tmp_path, small):
    """lpips (vgg: the 16^2 images are too small for alex's pools), wing and
    awing on random weights through run_project; each term's history is
    finite and the total is their weighted sum."""
    G, (a, _) = small
    nets = cli.LossNets(lpips_net="vgg", random_perceptual=True)
    res = cli.run_project(G, a, tmp_path, loss="lpips+0.01*wing+1*mse+awing+lbp", steps=3,
                          n_mean_latent=64, chunk=3, nets=nets, lamda=0.05, beta=2.0)
    comps = res.components_history
    assert set(comps) == {"lpips", "wing", "mse", "awing", "lbp"}
    assert all(torch.isfinite(v).all() for v in comps.values())
    total = comps["lpips"] + 0.05 * (comps["wing"] + comps["awing"]) + 2.0 * comps["mse"] \
        + comps["lbp"]
    np.testing.assert_allclose(res.loss_history.numpy(), total[:, 0].numpy(), rtol=1e-5)
    assert "w.mat" in os.listdir(tmp_path)


def test_main_passes_the_loss_flags(tmp_path, monkeypatch):
    """project's flags reach projection_loss as JAX's cli/project.py reads
    them, and the run writes its files."""
    cfg, G = cli.get_model("init:32", device="cpu")
    write_png(tmp_path / "t.png", to_uint8(cli.synthesize(G, torch.zeros(1, cfg.k, cfg.z_dim))[0]
                                           .numpy()))
    seen = {}
    real = cli.projection_loss

    def spy(spec, resolution, device="cuda", size=None, lamda=None, beta=None, nets=None):
        seen.update(spec=spec, resolution=resolution, size=size, lamda=lamda, beta=beta,
                    nets=nets)
        return real(spec, resolution, device, size, lamda, beta, nets)
    monkeypatch.setattr(cli, "projection_loss", spy)
    cli.main(["project", "--model", "init:32", "--device", "cpu", "--step", "2",
              "--n_mean_latent", "32", "--img", str(tmp_path / "t.png"),
              "--path_to_gen", str(tmp_path / "p"), "--loss", "lpips+0.01*wing+1*mse",
              "--random-perceptual", "--lpips-net", "vgg", "--size", "16", "--lamda", "0.02",
              "--beta", "2", "--mdf-weights", "m.npz"])
    assert seen == dict(spec="lpips+0.01*wing+1*mse", resolution=32, size=16, lamda=0.02,
                        beta=2.0, nets=cli.LossNets(lpips_net="vgg", mdf_weights="m.npz",
                                                    random_perceptual=True))
    assert "w.mat" in os.listdir(tmp_path / "p")


def _jax_make_extra_terms():
    return importlib.import_module("cli.project").make_extra_terms


@pytest.mark.parametrize("spec,flag", [("lpips+mse", "--lpips-weights"),
                                       ("facenet", "--facenet-weights"),
                                       ("mse+arcface", "--arcface-weights"),
                                       ("mdf", "--mdf-weights")])
def test_a_missing_weight_flag_exits_as_in_jax(spec, flag):
    import argparse

    from morphganformer_tpu_torch.losses import parse_loss_spec

    with pytest.raises(SystemExit, match=f"needs {flag}") as got:
        cli.projection_loss(spec, 16, "cpu")
    with pytest.raises(SystemExit) as want:
        _jax_make_extra_terms()(parse_loss_spec(spec), argparse.Namespace(lpips_net="alex"))
    assert str(got.value) == str(want.value)


def test_wing_takes_the_bundled_landmarks_and_unknown_terms_exit(capsys):
    loss_fn = cli.projection_loss("wing+awing", 16, "cpu")
    assert "bundled synthetic model" in capsys.readouterr().out
    img = torch.zeros(1, 16, 16, 3)
    total, comps = loss_fn(img, img)
    assert set(comps) == {"wing", "awing"} and total.item() == 0.0
    with pytest.raises(SystemExit, match="unknown loss term 'nope'"):
        cli.projection_loss("mse+nope", 16, "cpu")


@pytest.mark.parametrize("spec,lamda,beta,match", [
    ("mse", 0.1, None, "--lamda sets the wing weight; add wing to --loss"),
    ("wing", None, 2.0, "--beta sets the mse weight; add mse to --loss")])
def test_lamda_and_beta_need_their_terms(spec, lamda, beta, match):
    with pytest.raises(SystemExit, match=match):
        cli.projection_loss(spec, 16, "cpu", lamda=lamda, beta=beta)
