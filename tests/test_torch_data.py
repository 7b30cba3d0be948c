"""The port's data feed (data/) against the JAX package's and against PIL:
ImageFolderDataset and infinite_batches give bit-equal batches for the
same seed (mirror and max_items included); `read_png` and the native C++
decoder match PIL on gray, gray + alpha, RGB and RGBA files and on every PNG
filter type;
the raw cache writes the JAX package's bytes and gathers its batches."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from morphganformer_tpu.data import dataset as jds
from morphganformer_tpu.data import raw_cache as jraw
from morphganformer_tpu_torch.data import dataset as tds
from morphganformer_tpu_torch.data import native_loader as tnl
from morphganformer_tpu_torch.data import raw_cache as traw
from morphganformer_tpu_torch.utils.image import read_png

RES = 16


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path, img, filters):
    """An 8-bit PNG of HWC uint8 `img` with row y filtered by
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    rows = []
    for y in range(h):
        cur, up = x[y], x[y - 1] if y else np.zeros_like(x[0])
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        ft = filters[y % len(filters)]
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][ft]
        rows.append(bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                                    0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows), 9)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """12 RGB PNGs written by PIL under <root>/16/."""
    root = tmp_path_factory.mktemp("data")
    (root / str(RES)).mkdir()
    rng = np.random.RandomState(0)
    for i in range(12):
        Image.fromarray((rng.rand(RES, RES, 3) * 255).astype(np.uint8)).save(
            root / str(RES) / f"{i:04d}.png")
    return str(root)


@pytest.mark.parametrize("kw", [{}, {"mirror_augment": True}, {"max_items": 9, "seed": 3},
                                {"max_items": 7, "mirror_augment": True, "seed": 1}],
                         ids=["plain", "mirror", "max_items", "both"])
def test_batches_match_jax(data_root, kw):
    jd, td = jds.ImageFolderDataset(data_root, RES, **kw), tds.ImageFolderDataset(data_root, RES,
                                                                                   **kw)
    assert len(jd) == len(td) and td.img_files == jd.img_files and td.name == jd.name
    for i in range(len(td)):
        np.testing.assert_array_equal(td[i][0], jd[i][0])
    for shard in ((0, 1), (1, 2)):
        jb = jds.infinite_batches(jd, 4, *shard, seed=5)
        tb = tds.infinite_batches(td, 4, *shard, seed=5)
        for _ in range(5):          # beyond one epoch
            (xj, lj), (xt, lt) = next(jb), next(tb)
            assert xt.dtype == np.float32 and xt.tobytes() == xj.tobytes()
            assert lt.shape == lj.shape == (4, 0)


def test_labels_match_jax(data_root, tmp_path):
    root = tmp_path / "lab"
    root.mkdir()
    os.symlink(os.path.join(data_root, str(RES)), root / str(RES))
    np.save(root / "labels.npy", np.arange(12) % 3)
    jd = jds.ImageFolderDataset(str(root), RES, use_labels=True)
    td = tds.ImageFolderDataset(str(root), RES, use_labels=True)
    assert td.label_dim == jd.label_dim == 3
    for i in range(12):
        np.testing.assert_array_equal(td.get_label(i), jd.get_label(i))


def test_missing_folder_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="doesn't exist"):
        tds.ImageFolderDataset(str(tmp_path), RES)
    (tmp_path / str(RES)).mkdir()
    with pytest.raises(FileNotFoundError, match="No .png"):
        tds.ImageFolderDataset(str(tmp_path), RES)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decoders_match_pil(tmp_path, channels, filters):
    img = np.random.RandomState(channels).randint(0, 256, (9, 11, channels)).astype(np.uint8)
    path = str(tmp_path / "f.png")
    encode_png(path, img, filters)
    pil = np.asarray(Image.open(path))
    pil = pil[:, :, None] if pil.ndim == 2 else pil
    np.testing.assert_array_equal(pil, img)
    np.testing.assert_array_equal(read_png(path), pil)
    if not tnl.native_available():
        pytest.skip(f"the native loader did not build: {tnl.build_error()}")
    rgb = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(tnl.decode_png(path, 9, 11, 3), rgb)


def test_read_png_matches_pil_on_pil_files(tmp_path):
    rng = np.random.RandomState(4)
    for mode, shape in (("L", (13, 7)), ("RGB", (13, 7, 3)), ("RGBA", (13, 7, 4))):
        arr = rng.randint(0, 256, shape).astype(np.uint8)
        Image.fromarray(arr, mode).save(tmp_path / f"{mode}.png")
        got = read_png(str(tmp_path / f"{mode}.png"))
        np.testing.assert_array_equal(got, arr.reshape(13, 7, -1))


def test_native_loader_batches(data_root, tmp_path):
    """One thread: every epoch is a permutation of the files; the batches
    hold the decoded images. A file of another size is an error."""
    if not tnl.native_available():
        pytest.skip(f"the native loader did not build: {tnl.build_error()}")
    files = tds.dataset_files(data_root, RES)
    images = {read_png(f).tobytes() for f in files}
    loader = tnl.NativeBatchLoader(files, RES, RES, 3, batch_size=4, num_threads=1, seed=2)
    seen = [next(loader) for _ in range(3)]
    loader.close()
    got = [b.tobytes() for batch in seen for b in batch]
    assert set(got) == images and len(got) == len(images)

    gen = tnl.native_infinite_batches(data_root, RES, 4, seed=2, num_threads=1)
    x, labels = next(gen)
    assert x.dtype == np.float32 and x.shape == (4, RES, RES, 3) and labels.shape == (4, 0)
    np.testing.assert_array_equal(x, seen[0].astype(np.float32) * (2 / 255) - 1)
    gen.close()

    bad = tmp_path / "bad" / str(RES)
    bad.mkdir(parents=True)
    Image.fromarray(np.zeros((RES + 1, RES, 3), np.uint8)).save(bad / "0.png")
    loader = tnl.NativeBatchLoader([str(bad / "0.png")], RES, RES, 3, batch_size=1,
                                   num_threads=1)
    with pytest.raises(IOError, match="failed to decode"):
        next(loader)
    loader.close()


def test_native_build_is_keyed_by_the_source():
    assert os.path.dirname(tnl.library_path()) == str(tnl.BUILD_DIR)
    assert os.path.basename(tnl.library_path()).startswith("libpngloader-")
    assert tnl.SOURCE.endswith(os.path.join("morphganformer_tpu_torch", "data", "native",
                                            "png_loader.cpp"))
    cmd = tnl.build_command("out.so")
    assert cmd[0] == "g++" and "-lz" in cmd and tnl.SOURCE in cmd


def test_raw_cache_is_the_jax_file(data_root, tmp_path, monkeypatch):
    """The port's cache file and meta are byte-equal to JAX's, each reads
    the other's, and RawBatchLoader gathers the same batches."""
    monkeypatch.setenv("MGT_CACHE_DIR", str(tmp_path / "jax_native"))
    raw_j = jraw.build_raw_cache(data_root, RES, force=True)
    bytes_j = open(raw_j, "rb").read()
    meta_j = open(raw_j + ".json").read()
    raw_t = traw.build_raw_cache(data_root, RES, force=True)
    assert raw_t == raw_j
    assert open(raw_t, "rb").read() == bytes_j and open(raw_t + ".json").read() == meta_j
    assert json.loads(meta_j)["count"] == 12
    mtime = os.stat(raw_t).st_mtime_ns
    assert traw.build_raw_cache(data_root, RES) == raw_t        # reused: digest matches
    assert os.stat(raw_t).st_mtime_ns == mtime

    lj = jraw.RawBatchLoader(raw_t, 5, seed=3)
    lt = traw.RawBatchLoader(raw_t, 5, seed=3)
    try:
        for _ in range(4):
            assert next(lt).tobytes() == next(lj).tobytes()
    finally:
        lj.close()
        lt.close()
    gen_t = traw.raw_infinite_batches(data_root, RES, 4, seed=1)
    gen_j = jraw.raw_infinite_batches(data_root, RES, 4, seed=1)
    for _ in range(3):
        assert next(gen_t)[0].tobytes() == next(gen_j)[0].tobytes()
    gen_t.close()
    gen_j.close()
