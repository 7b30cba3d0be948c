"""Morph arithmetic, .mat IO, PNG output and the port's three entry points
(generate, merge, demorph) on a small random network on the CPU."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from morphganformer_tpu.morph import morpher as jmorph
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.morph import (demorph_latent, load_latent_mat, morph_latents,
                                            save_latent_mat)
from morphganformer_tpu_torch.utils.image import crop_max_rectangle, to_uint8, write_png


def read_png(path):
    """Decode an 8-bit PNG whose rows all use filter type 0."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(tag + body)
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    c = {0: 1, 2: 3}[color]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert depth == 8 and (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_morph_demorph_round_trip(alpha):
    rng = np.random.RandomState(0)
    w1, w2 = rng.randn(17, 32), rng.randn(17, 32)
    m = morph_latents(w1, w2, alpha)
    np.testing.assert_allclose(m, jmorph.morph_latents(w1, w2, alpha), rtol=0, atol=0)
    np.testing.assert_allclose(demorph_latent(m, w1, alpha), w2, rtol=0, atol=1e-6)
    np.testing.assert_allclose(demorph_latent(m, w1, alpha),
                               jmorph.demorph_latent(m, w1, alpha), rtol=0, atol=0)


def test_mat_round_trip_with_the_jax_package(tmp_path):
    w = np.random.RandomState(1).randn(3, 17, 32).astype(np.float32)
    save_latent_mat(tmp_path / "a.mat", w)
    np.testing.assert_array_equal(jmorph.load_latent_mat(tmp_path / "a.mat"), w)
    jmorph.save_latent_mat(tmp_path / "b.mat", w)
    np.testing.assert_array_equal(load_latent_mat(tmp_path / "b.mat"), w)


@pytest.mark.parametrize("c", [1, 3])
def test_png_round_trip(tmp_path, c):
    img = np.random.RandomState(2).randint(0, 256, (5, 7, c)).astype(np.uint8)
    write_png(tmp_path / "x.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "x.png"), img)


def test_to_uint8_and_crop():
    x = np.array([[[-1.0, 0.0, 1.0]]], np.float32)
    np.testing.assert_array_equal(to_uint8(x), [[[0, 128, 255]]])
    img = np.zeros((8, 12, 3), np.uint8)
    assert crop_max_rectangle(img, 0.75).shape == (8, 6, 3)
    assert crop_max_rectangle(img, 1.0) is img


@pytest.fixture(scope="module")
def small_model():
    return cli.get_model("init:8", device="cpu", seed=0)


def test_generate_entry_point(tmp_path, small_model):
    cfg, G = small_model
    imgs = cli.run_generate(G, tmp_path, images_num=3, batch_size=2, seed=7)
    assert imgs.shape == (3, 8, 8, 3) and np.isfinite(imgs).all()
    assert sorted(os.listdir(tmp_path)) == [f"sample_{i:06d}.png" for i in range(3)]
    np.testing.assert_array_equal(read_png(tmp_path / "sample_000002.png"), to_uint8(imgs[2]))
    again = cli.run_generate(G, tmp_path / "again", images_num=3, batch_size=3, seed=7)
    # Other batch sizes take other CPU conv algorithms: equal to float32 rounding.
    np.testing.assert_allclose(again, imgs, rtol=0, atol=1e-4)


def test_merge_and_demorph_entry_points(tmp_path, small_model):
    cfg, G = small_model
    rng = np.random.RandomState(3)
    za, zb = (rng.randn(cfg.k, cfg.z_dim).astype(np.float32) for _ in range(2))
    save_latent_mat(tmp_path / "a.mat", za)
    save_latent_mat(tmp_path / "b.mat", zb)
    (stem, img, w), = cli.run_merge(G, [str(tmp_path / "a.mat"), str(tmp_path / "b.mat")],
                                    tmp_path / "merged")
    assert stem == "a_b" and img.shape == (8, 8, 3) and np.isfinite(img).all()
    np.testing.assert_allclose(load_latent_mat(tmp_path / "merged" / "a_b.mat"),
                               morph_latents(za, zb), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(read_png(tmp_path / "merged" / "a_b.png"), to_uint8(img))
    # Regenerating the same latent: equal to float32 rounding (PyTorch's CPU
    # convolutions do not promise bitwise-repeatable sums).
    np.testing.assert_allclose(img, cli.synthesize(G, morph_latents(za, zb)[None])[0].numpy(),
                               rtol=0, atol=1e-4)

    img_d, w_rec = cli.run_demorph(G, tmp_path / "merged" / "a_b.mat", tmp_path / "a.mat",
                                   tmp_path / "demorph")
    np.testing.assert_allclose(w_rec, zb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(img_d, cli.synthesize(G, zb[None])[0].numpy(), rtol=0, atol=1e-4)
    assert read_png(tmp_path / "demorph" / "demorph.png").shape == (8, 8, 3)


def test_main_dispatches_each_command(tmp_path):
    cli.main(["generate", "--model", "init:8", "--device", "cpu", "--images-num", "1",
              "--output-dir", str(tmp_path / "g")])
    assert os.listdir(tmp_path / "g") == ["sample_000000.png"]
    rng = np.random.RandomState(4)
    for name in ("a", "b", "c"):
        save_latent_mat(tmp_path / f"{name}.mat", rng.randn(17, 32))
    cli.main(["merge", "--model", "init:8", "--device", "cpu", "--latent-dir", str(tmp_path),
              "--out", str(tmp_path / "m")])
    assert sorted(f for f in os.listdir(tmp_path / "m") if f.endswith(".png")) == \
        ["a_b.png", "a_c.png", "b_c.png"]
    cli.main(["demorph", "--model", "init:8", "--device", "cpu", "--morph-latent",
              str(tmp_path / "m" / "a_b.mat"), "--accomplice-latent", str(tmp_path / "a.mat"),
              "--out", str(tmp_path / "d")])
    np.testing.assert_allclose(load_latent_mat(tmp_path / "d" / "demorph.mat"),
                               load_latent_mat(tmp_path / "b.mat"), rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError, match="init:<res>"):
        cli.get_model("checkpoints/ffhq", device="cpu")
    with pytest.raises(ValueError, match="noise_mode"):
        with torch.no_grad():
            cfg, G = cli.get_model("init:8", device="cpu")
            G(z=torch.zeros(1, cfg.k, cfg.z_dim), noise_mode="random")
