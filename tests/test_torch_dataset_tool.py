"""The port's dataset tool and catalog against the JAX package's: the PNG
pyramid of `create_from_images`, `display`, `extract` and `compare` (and
the entry point's exit code), `catalog.prepare` from a folder and from a
zip archive, `md5_file`, and the refusal of inputs that are not PNGs."""

import dataclasses
import hashlib
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from morphganformer_tpu.data import catalog as jcatalog
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.data import catalog as tcatalog
from morphganformer_tpu_torch.data import dataset_tool as tdt
from morphganformer_tpu_torch.utils.image import read_png

import cli.dataset_tool as jdt

# (size, mode): non-square sizes in both orientations and odd margins;
# gray, gray + alpha and RGBA as well as RGB.
SOURCES = [((45, 37), "RGB"), ((30, 52), "RGB"), ((33, 33), "L"), ((41, 28), "RGBA"),
           ((26, 39), "LA"), ((64, 51), "RGB")]


def write_sources(root, sources=SOURCES, seed=0):
    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    (root / "nested").mkdir(exist_ok=True)
    for i, ((w, h), mode) in enumerate(sources):
        chans = {"RGB": 3, "L": 1, "RGBA": 4, "LA": 2}[mode]
        y, x = np.mgrid[0:h, 0:w]
        img = (np.stack([np.sin(x / 4.0 + c) * np.cos(y / 5.0 - c) for c in range(chans)], -1)
               * 110 + 128 + rng.randn(h, w, chans) * 6).clip(0, 255).astype(np.uint8)
        folder = root / "nested" if i % 3 == 2 else root
        Image.fromarray(img[..., 0] if chans == 1 else img, mode).save(folder / f"s{i:02d}.png")
    return str(root)


def pyramid(out_dir):
    return {os.path.relpath(os.path.join(d, f), out_dir): read_png(os.path.join(d, f))
            for d, _, fs in os.walk(out_dir) for f in fs}


def assert_same_tree(port_dir, jax_dir):
    mine, theirs = pyramid(port_dir), pyramid(jax_dir)
    assert sorted(mine) == sorted(theirs)
    for name in theirs:
        np.testing.assert_array_equal(mine[name], theirs[name], err_msg=name)
    return sorted(mine)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("dstool")
    src = write_sources(root / "src")
    tdt.create_from_images(str(root / "port"), src, 32, lods=3)
    jdt.create_from_images(str(root / "jax"), src, 32, lods=3)
    return root


def test_create_from_images_matches_jax_bit_for_bit(built):
    names = assert_same_tree(str(built / "port"), str(built / "jax"))
    assert names == sorted(f"{r}/{i:08d}.png" for r in (32, 16, 8) for i in range(6))


def test_create_from_images_through_the_entry_point(built, capsys):
    out = built / "cli_out"
    cli.main(["dataset_tool", "create_from_images", str(out), str(built / "src"),
              "--resolution", "16", "--lods", "2"])
    assert "wrote 6 images at levels [16, 8]" in capsys.readouterr().out
    jdt.create_from_images(str(built / "cli_jax"), str(built / "src"), 16, lods=2)
    assert_same_tree(str(out), str(built / "cli_jax"))


def test_display_and_extract_match_jax(built, tmp_path):
    for side, mod in (("port", tdt), ("jax", jdt)):
        mod.display(str(built / side), 32)
        mod.extract(str(built / side), str(tmp_path / side), 16, num=4)
    np.testing.assert_array_equal(read_png(str(built / "port" / "preview_32.png")),
                                  read_png(str(built / "jax" / "preview_32.png")))
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == [
        f"img{i:08d}.png" for i in range(4)]
    cli.main(["dataset_tool", "extract", str(built / "port"), str(tmp_path / "all"),
              "--resolution", "8"])
    assert len(os.listdir(tmp_path / "all")) == 6
    cli.main(["dataset_tool", "display", str(built / "port"), "--resolution", "16"])
    jdt.display(str(built / "jax"), 16)
    np.testing.assert_array_equal(read_png(str(built / "port" / "preview_16.png")),
                                  read_png(str(built / "jax" / "preview_16.png")))


def test_compare_and_its_exit_code(built, tmp_path, capsys):
    flags = ["--resolution", "32"]
    cli.main(["dataset_tool", "compare", str(built / "port"), str(built / "jax")] + flags)
    assert capsys.readouterr().out.strip().endswith("identical")
    # One pixel changed in a copy: one difference, exit code 1, as JAX's.
    copy = tmp_path / "copy"
    tdt.create_from_images(str(copy), str(built / "src"), 32)
    img = read_png(str(copy / "32" / "00000003.png"))
    img[5, 7, 1] ^= 3
    Image.fromarray(img).save(copy / "32" / "00000003.png")
    with pytest.raises(SystemExit) as exc:
        cli.main(["dataset_tool", "compare", str(built / "port"), str(copy)] + flags)
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "item 3 differs (max abs diff 3)" in out and out.strip().endswith("1 differences")
    assert tdt.compare(str(built / "port"), str(copy), 32) == jdt.compare(
        str(built / "jax"), str(copy), 32) == 1
    os.remove(copy / "32" / "00000005.png")
    assert tdt.compare(str(built / "port"), str(copy), 32) == jdt.compare(
        str(built / "jax"), str(copy), 32) == 2


@pytest.mark.parametrize("ext", ["jpg", "jpeg", "bmp", "webp"])
def test_inputs_that_are_not_png_raise_by_name(tmp_path, ext):
    """Of JAX's input extensions the port reads JPEG and BMP; what it
    refuses (a CMYK JPEG, an RLE8 BMP, any WebP) raises by name before
    anything is written."""
    src = write_sources(tmp_path / "src", SOURCES[:2])
    img = Image.fromarray(np.zeros((9, 9, 3), np.uint8))
    path = tmp_path / "src" / f"odd.{ext}"
    (img.convert("CMYK") if ext in ("jpg", "jpeg") else img).save(path)
    if ext == "bmp":                      # BI_RLE8 in the compression field
        data = bytearray(path.read_bytes())
        data[30:34] = (1).to_bytes(4, "little")
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=rf"odd\.{ext}.*is not read by the port.*item 8"):
        tdt.create_from_images(str(tmp_path / "out"), src, 16)
    assert not (tmp_path / "out").exists()
    with pytest.raises(FileNotFoundError, match="no images"):
        tdt.create_from_images(str(tmp_path / "out"), str(tmp_path / "empty"), 16)


def test_catalog_matches_jax(tmp_path):
    assert tcatalog.DATASETS.keys() == jcatalog.DATASETS.keys()
    for name, spec in jcatalog.DATASETS.items():
        assert dataclasses.asdict(tcatalog.DATASETS[name]) == dataclasses.asdict(spec)
    assert tcatalog.PRETRAINED == jcatalog.PRETRAINED
    blob = tmp_path / "blob.bin"
    blob.write_bytes(np.random.RandomState(0).bytes(3 * (1 << 20) + 17))
    assert tcatalog.md5_file(str(blob)) == hashlib.md5(blob.read_bytes()).hexdigest() \
        == jcatalog.md5_file(str(blob))
    assert tcatalog.md5_file(str(blob), chunk=1000) == jcatalog.md5_file(str(blob))


@pytest.mark.parametrize("source", ["dir", "zip"])
def test_catalog_prepare_matches_jax(tmp_path, source):
    src = write_sources(tmp_path / "src", SOURCES[:3], seed=1)
    kw = {"from_dir": src}
    if source == "zip":
        archive = tmp_path / "clevr.zip"
        with zipfile.ZipFile(archive, "w") as z:
            for d, _, fs in os.walk(src):
                for f in fs:
                    z.write(os.path.join(d, f), os.path.relpath(os.path.join(d, f), src))
        kw = {"from_archive": str(archive)}
    got = tcatalog.prepare("clevr", str(tmp_path / "port"), **kw)
    want = jcatalog.prepare("clevr", str(tmp_path / "jax"), **kw)
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax")
    assert assert_same_tree(got, want) == [f"256/{i:08d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "port")) == ["clevr"]      # the unpacked copy is gone


def test_catalog_prepare_without_a_source_names_the_url(tmp_path):
    with pytest.raises(ValueError, match="dl.fbaipublicfiles.com/clevr"):
        tcatalog.prepare("clevr", str(tmp_path))
