"""The port's photo decoders against Pillow: `read_image` equals
`np.asarray(Image.open(p))` and `read_image_rgb` equals
`.convert("RGB")`, bit for bit, on the committed fixtures of
tests/data/formats/ (also against their recorded SHA-256, which is what a
machine without Pillow checks) and on cases drawn by hypothesis and made
here with Pillow or with the fixture script's own PNG and JPEG encoders:
every JPEG size from 1 to 70, quality 1-100, subsampling, progressive,
restart interval and colour marker; every PNG bit depth, colour type,
filter and interlace; the BMP and Netpbm variants. Then the entry points
that JAX feeds through `Image.open` (load_target, the dataset tool, the
warp's loader, make_video, morph_qa, the training feed) against JAX's on
JPEG, BMP and PPM inputs, and each refused format raising with its name."""

import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import cli.calc_metrics as jcalc
import cli.dataset_tool as jdt
import cli.make_video as jmake_video
import cli.warp_morphs as jwarp_morphs
from morphganformer_tpu.data import dataset as jds
from morphganformer_tpu.utils.image import load_target as jload_target
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.data import dataset as tds
from morphganformer_tpu_torch.data import dataset_tool as tdt
from morphganformer_tpu_torch.data import raw_cache as traw
from morphganformer_tpu_torch.metrics import fingerprint
from morphganformer_tpu_torch.utils import image as timg
from morphganformer_tpu_torch.utils.image import (
    ImageFormatError,
    check_image,
    load_target,
    read_image,
    read_image_rgb,
    read_png,
)

from .make_format_fixtures import OUT, digest, encode_jpeg, encode_png, photo, pillow_arrays

with open(os.path.join(OUT, "formats.json")) as _f:
    FIXTURES = json.load(_f)
CASES = settings(max_examples=40, deadline=None, derandomize=True,
                 suppress_health_check=[HealthCheck.function_scoped_fixture,
                                        HealthCheck.too_slow])


def assert_like_pillow(path):
    """read_image and read_image_rgb equal Pillow's arrays, mode and dtype
    included."""
    mode, arr, rgb = pillow_arrays(path)
    got = timg.open_image(path)
    assert got.mode == mode, (got.mode, mode)
    assert got.array.dtype == arr.dtype and got.array.shape == arr.shape
    np.testing.assert_array_equal(got.array, arr)
    np.testing.assert_array_equal(read_image_rgb(path), rgb)
    np.testing.assert_array_equal(read_image(path), arr)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_matches_pillow_and_its_hash(name):
    path = os.path.join(OUT, name)
    entry = FIXTURES[name]
    got = timg.open_image(path)
    assert got.mode == entry["mode"]
    assert digest(got.array) == entry["image"]
    assert digest(timg.to_rgb(got)) == entry["rgb"]
    assert_like_pillow(path)


BLOCKER = """
import importlib.abc, sys
BLOCKED = {"jax", "flax", "optax", "PIL", "imageio", "morphganformer_tpu", "tools"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
"""


def test_fixtures_decode_without_pillow():
    """chip_smoke.py's check of the fixtures, in a process whose
    sys.meta_path refuses Pillow, imageio, JAX and the JAX package: every
    hash holds, and Pillow is not importable there."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = BLOCKER + ("import chip_smoke\n"
                      "print(len(chip_smoke.check_format_fixtures()))\n"
                      "try:\n    import PIL\nexcept ImportError:\n    print('no PIL')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root, env=dict(os.environ, PYTHONPATH=root))
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == [str(len(FIXTURES)), "no", "PIL"]


def test_fixtures_are_small_and_listed():
    names = sorted(f for f in os.listdir(OUT) if f != "formats.json")
    assert names == sorted(FIXTURES)
    for name in names:
        size = os.path.getsize(os.path.join(OUT, name))
        assert size <= (150_000 if name == "face.jpg" else 20_000), (name, size)
    assert read_image(os.path.join(OUT, "face.jpg")).shape == (800, 640, 3)


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _pillow_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


@CASES
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       subsampling=st.sampled_from(["4:4:4", "4:2:2", "4:2:0"]), progressive=st.booleans(),
       optimize=st.booleans(), restart=st.integers(0, 4), gray=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_pillow_jpegs_match_pillow(tmp_path, h, w, quality, subsampling, progressive, optimize,
                                   restart, gray, seed):
    img = photo(seed, h, w)
    kw = dict(quality=quality, progressive=progressive, optimize=optimize)
    if restart:
        kw["restart_marker_blocks"] = restart
    if not gray:
        kw["subsampling"] = subsampling
    src = Image.fromarray(img[..., 0] if gray else img)
    assert_like_pillow(_write(tmp_path, "x.jpg", _pillow_bytes(src, "JPEG", **kw)))


SAMPLINGS = (((1, 1),) * 3, ((2, 1), (1, 1), (1, 1)), ((2, 2), (1, 1), (1, 1)),
             ((4, 1), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1)), ((1, 4), (1, 1), (1, 1)),
             ((3, 1), (1, 1), (1, 1)), ((2, 2), (1, 2), (2, 1)), ((1, 1), (2, 2), (2, 2)),
             ((4, 2), (2, 1), (2, 1)))


@CASES
@given(h=st.integers(1, 70), w=st.integers(1, 70), quality=st.integers(1, 100),
       sampling=st.sampled_from(SAMPLINGS), restart=st.integers(0, 3),
       marker=st.sampled_from(["jfif", "adobe", "adobe_rgb", "ids_rgb", None]),
       interleaved=st.booleans(), sof=st.sampled_from([0xC0, 0xC1]), gray=st.booleans(),
       seed=st.integers(0, 2 ** 16))
def test_any_sampling_and_marker_match_pillow(tmp_path, h, w, quality, sampling, restart, marker,
                                              interleaved, sof, gray, seed):
    """The fixture script's encoder: 4:1:1, 4:4:0, 1x4, 3x1, mixed and
    chroma-above-luma factors, one scan or one per component, the colour
    markers libjpeg reads, SOF0 and SOF1."""
    if interleaved and sum(a * b for a, b in sampling) > 10:
        interleaved = False                  # libjpeg's limit of 10 blocks an MCU
    img = photo(seed, h, w)
    data = encode_jpeg(img[..., 1] if gray else img, sampling, quality=quality,
                       restart=restart, interleaved=interleaved, marker=marker, sof=sof)
    assert_like_pillow(_write(tmp_path, "x.jpg", data))


PNG_KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16), (4, 8), (4, 16), (6, 8),
                                                  (6, 16)] + [(3, d) for d in (1, 2, 4, 8)]


@CASES
@given(kind=st.sampled_from(PNG_KINDS), h=st.integers(1, 40), w=st.integers(1, 40),
       interlace=st.integers(0, 1),
       filters=st.lists(st.integers(0, 4), min_size=1, max_size=5).map(tuple),
       trns=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_pngs_match_pillow(tmp_path, kind, h, w, interlace, filters, trns, seed):
    """Every bit depth and colour type, PLTE (also shorter than the indices
    used) and tRNS, Adam7 and each row filter."""
    color, depth = kind
    rng = np.random.RandomState(seed)
    c = timg._PNG_CHANNELS[color]
    samples = rng.randint(0, 1 << depth, (h, w, c))
    palette = rng.randint(0, 256, (rng.randint(1, 1 + (1 << depth)), 3)) if color == 3 else None
    t = None
    if trns:
        t = (bytes(rng.randint(0, 256, len(palette)).astype(np.uint8)) if color == 3
             else struct.pack(">3H", *rng.randint(0, 1 << depth, 3)) if color == 2
             else struct.pack(">H", rng.randint(0, 1 << depth)) if color == 0 else None)
    data = encode_png(samples, depth, color, palette=palette, trns=t, interlace=interlace,
                      filters=filters)
    assert_like_pillow(_write(tmp_path, "x.png", data))


def test_paeth_and_average_rows_are_vectorised_bit_equal(tmp_path):
    """A 256^2 RGBA PNG of Average and Paeth rows, interlaced and not."""
    img = np.random.RandomState(5).randint(0, 256, (256, 256, 4))
    for interlace in (0, 1):
        path = _write(tmp_path, f"p{interlace}.png",
                      encode_png(img, 8, 6, interlace=interlace, filters=(4, 3, 4, 1)))
        np.testing.assert_array_equal(read_image(path), img)
        assert_like_pillow(path)


def _bmp(w, h, bits, rows, compression=0, palette=b"", masks=None, header=40, colors=0,
         topdown=False):
    """A BMP with the given header size, bit depth, palette and bitfields."""
    stride = ((w * bits + 31) >> 3) & ~3
    pix = b"".join(r.ljust(stride, b"\0") for r in rows)
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        hdr = struct.pack("<IiiHHIIiiII", header, w, -h if topdown else h, 1, bits, compression,
                          len(pix), 2835, 2835, colors, 0)
        extra = b""
        if masks is not None and header == 40:
            extra = struct.pack("<3I", *masks[:3])
        elif masks is not None:
            hdr += struct.pack("<4I", *masks)
        hdr = hdr.ljust(header, b"\0")
    off = 14 + len(hdr) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pix), 0, 0, off) + hdr + extra + palette
            + pix)


def _bmp_cases():
    rng = np.random.RandomState(7)
    h, w = 7, 11
    idx4 = rng.randint(0, 16, (h, w))
    rows4 = [bytes(((idx4[y, 0::2] << 4) | np.pad(idx4[y, 1::2], (0, w % 2))).astype(np.uint8))
             for y in range(h)]
    words16 = rng.randint(0, 1 << 16, (h, w)).astype("<u2")
    words32 = rng.randint(0, 1 << 32, (h, w), dtype=np.uint64).astype("<u4")
    rgb = photo(3, h, w)
    yield "1bit_colour", _bmp(w, h, 1, [bytes(r) for r in np.packbits(
        rng.randint(0, 2, (h, w)).astype(np.uint8), axis=1)],
        palette=bytes([10, 20, 30, 0, 200, 100, 50, 0]), colors=2)
    yield "4bit_palette", _bmp(w, h, 4, rows4, palette=bytes(rng.randint(0, 256, 64)
                                                              .astype(np.uint8)))
    yield "8bit_gray_ramp", _bmp(w, h, 8, [bytes(rng.randint(0, 40, w).astype(np.uint8))
                                         for _ in range(h)],
                                 palette=b"".join(bytes([i, i, i, 0]) for i in range(40)),
                                 colors=40)
    yield "8bit_short_palette", _bmp(w, h, 8, [bytes(rng.randint(0, 60, w).astype(np.uint8))
                                             for _ in range(h)],
                                     palette=bytes(rng.randint(0, 256, 160).astype(np.uint8)),
                                     colors=40)
    for name, masks, comp in (("16bit_rgb", None, 0), ("16bit_565", (0xF800, 0x7E0, 0x1F), 3),
                              ("16bit_555", (0x7C00, 0x3E0, 0x1F), 3)):
        yield name, _bmp(w, h, 16, [words16[y].tobytes() for y in range(h)], compression=comp,
                         masks=masks)
    yield "24bit_topdown", _bmp(w, h, 24, [rgb[y, :, ::-1].tobytes() for y in range(h)],
                                topdown=True)
    yield "24bit_os2", _bmp(w, h, 24, [rgb[y, :, ::-1].tobytes() for y in range(h)][::-1],
                            header=12)
    yield "32bit_rgb", _bmp(w, h, 32, [words32[y].tobytes() for y in range(h)])
    for header, masks in ((56, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                          (108, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
                          (124, (0xFF000000, 0xFF0000, 0xFF00, 0x0)),
                          (40, (0xFF0000, 0xFF00, 0xFF, 0x0))):
        yield f"32bit_bitfields_{header}", _bmp(w, h, 32, [words32[y].tobytes() for y in range(h)],
                                                compression=3, masks=masks, header=header)
    g = rng.randint(0, 256, (h, w))
    for maxval in (1, 7, 100, 255):
        gm, cm = g % (maxval + 1), rng.randint(0, maxval + 1, (h, w, 3))
        yield f"p5_{maxval}", (f"P5\n# a comment\n{w} {h}\n{maxval}\n".encode()
                               + gm.astype(np.uint8).tobytes())
        yield f"p6_{maxval}", f"P6 {w} {h} {maxval} ".encode() + cm.astype(np.uint8).tobytes()
        yield f"p2_{maxval}", (f"P2\n{w} {h}\n{maxval}\n".encode()
                               + " ".join(map(str, gm.ravel())).encode() + b"\n# end\n")
        yield f"p3_{maxval}", (f"P3 {w} {h} # x\n {maxval}\n".encode()
                               + "\n".join(map(str, cm.ravel())).encode())
    bits = rng.randint(0, 2, (h, w))
    yield "p1", f"P1\n{w} {h}\n".encode() + "".join(map(str, bits.ravel())).encode()
    yield "p4", f"P4\n{w} {h}\n".encode() + np.packbits(bits.astype(np.uint8), axis=1).tobytes()
    yield "pillow_bmp_L", _pillow_bytes(Image.fromarray(rgb[..., 0]), "BMP")
    yield "pillow_bmp_1", _pillow_bytes(Image.fromarray(rgb[..., 0] > 120), "BMP")
    yield "pillow_bmp_P", _pillow_bytes(Image.fromarray(rgb).quantize(colors=9), "BMP")
    yield "pillow_pbm", _pillow_bytes(Image.fromarray(rgb[..., 1] > 100), "PPM")


BMP_PNM = dict(_bmp_cases())


@pytest.mark.parametrize("name", sorted(BMP_PNM))
def test_bmp_and_netpbm_variants_match_pillow(tmp_path, name):
    assert_like_pillow(_write(tmp_path, "x.img", BMP_PNM[name]))


@pytest.mark.parametrize("fmt", ["JPEG", "BMP", "PPM"])
def test_load_target_matches_jax(tmp_path, fmt):
    """A 30 x 37 photo, Lanczos-resized and centre-cropped to 24^2: the
    port's target equals JAX's to the bit."""
    path = str(tmp_path / f"face.{fmt.lower()}")
    Image.fromarray(photo(11, 30, 37)).save(path, format=fmt, **(
        dict(quality=90, subsampling="4:2:0") if fmt == "JPEG" else {}))
    np.testing.assert_array_equal(load_target(path, size=24), jload_target(path, size=24))


def _jpeg(progressive=False):
    return _pillow_bytes(Image.fromarray(photo(2, 16, 16)), "JPEG", quality=80,
                         progressive=progressive)


def _patched_jpeg(marker_from, marker_to=None, offset=None, value=None):
    data = bytearray(_jpeg())
    i = data.index(bytes([0xFF, marker_from]))
    if marker_to is not None:
        data[i + 1] = marker_to
    if offset is not None:
        data[i + 4 + offset:i + 4 + offset + len(value)] = value
    return bytes(data)


def _truncated_progressive():
    """A progressive JPEG cut after its first two scans: its AC
    coefficients are left unrefined."""
    data = _jpeg(progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[2]] + b"\xff\xd9"


def _refused():
    bmp = _pillow_bytes(Image.fromarray(photo(1, 8, 8)), "BMP")
    yield "arithmetic", _patched_jpeg(0xC0, 0xC9), "arithmetic-coded JPEG \\(SOF9\\)"
    yield "lossless", _patched_jpeg(0xC0, 0xC3), "lossless JPEG \\(SOF3\\)"
    yield "hierarchical", _patched_jpeg(0xC0, 0xC5), "hierarchical JPEG \\(SOF5\\)"
    yield "12bit", _patched_jpeg(0xC0, offset=0, value=b"\x0c"), "12-bit JPEG"
    yield "dnl", _patched_jpeg(0xC0, offset=1, value=b"\x00\x00"), "DNL"
    yield ("cmyk", _pillow_bytes(Image.fromarray(photo(1, 8, 8)).convert("CMYK"), "JPEG"),
           "4-component \\(CMYK or YCCK\\) JPEG")
    yield ("unrefined", _truncated_progressive(),
           "progressive JPEG whose scans leave coefficients unrefined")
    for code, name in ((1, "RLE8"), (2, "RLE4")):
        data = bytearray(bmp)
        data[30:34] = code.to_bytes(4, "little")
        yield name.lower(), bytes(data), f"{name}-compressed BMP"
    yield ("pgm16", _pillow_bytes(Image.fromarray(np.full((4, 4), 40000, np.uint16)), "PPM"),
           "maxval 65535")
    yield "ppm16", b"P6 2 2 1000\n" + bytes(24), "maxval 1000"
    yield ("webp", _pillow_bytes(Image.fromarray(photo(1, 8, 8)), "WEBP"),
           "WebP image is not read by the port.*VP8.*item 8")
    yield "gif", _pillow_bytes(Image.fromarray(photo(1, 8, 8)), "GIF"), "a GIF image"
    yield "tiff", _pillow_bytes(Image.fromarray(photo(1, 8, 8)), "TIFF"), "a TIFF image"
    yield "empty", b"", "an empty file"


REFUSED = {name: rest for name, *rest in _refused()}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_formats_raise_with_their_name(tmp_path, name):
    data, pattern = REFUSED[name]
    path = _write(tmp_path, f"refused_{name}.img", data)
    with pytest.raises(ImageFormatError, match=f"refused_{name}.img: .*{pattern}"):
        read_image(path)
    with pytest.raises(ImageFormatError, match=pattern):
        load_target(path, size=8)
    with pytest.raises(ImageFormatError, match=pattern):
        check_image(path)


def test_a_jpeg_header_cut_short_raises_value_error(tmp_path):
    """A SOF whose length leaves its body short: ValueError naming the
    stage, from the decoder and from the header check alike."""
    data = bytearray(_jpeg())
    i = data.index(b"\xff\xc0")
    data[i + 2:i + 4] = (7).to_bytes(2, "big")     # a 5-byte body: no component count
    path = _write(tmp_path, "short_sof.jpg", bytes(data))
    for fn in (read_image, check_image):
        with pytest.raises(ValueError, match="short_sof.jpg: JPEG markers: "):
            fn(path)


def test_read_png_keeps_its_contract(tmp_path):
    """read_png reads the 8-bit non-interlaced PNGs it read before, and
    refuses the rest, which read_image reads."""
    img = photo(4, 9, 7)
    path = _write(tmp_path, "a.png", encode_png(img, 8, 2))
    np.testing.assert_array_equal(read_png(path), img)
    for name, data in (("b.png", encode_png(img, 8, 2, interlace=1)),
                       ("c.png", encode_png(img.astype(np.uint16) * 257, 16, 2))):
        path = _write(tmp_path, name, data)
        with pytest.raises(NotImplementedError, match="read_image reads every PNG"):
            read_png(path)
        assert_like_pillow(path)
    path = _write(tmp_path, "d.jpg", _jpeg())
    with pytest.raises(ValueError, match="a JPEG image, not a PNG"):
        read_png(path)


def _sources(root):
    """Photos of several formats and sizes, as JAX's dataset tool takes
    them."""
    os.makedirs(root, exist_ok=True)
    for i, (fmt, ext, h, w) in enumerate((("JPEG", "jpg", 40, 52), ("JPEG", "jpeg", 37, 33),
                                          ("BMP", "bmp", 30, 41), ("PNG", "png", 36, 36))):
        Image.fromarray(photo(20 + i, h, w)).save(os.path.join(root, f"img{i}.{ext}"),
                                                  format=fmt)
    return str(root)


def test_dataset_tool_takes_jpeg_and_bmp_as_jax(tmp_path):
    src = _sources(tmp_path / "src")
    tdt.create_from_images(str(tmp_path / "port"), src, 16, lods=2)
    jdt.create_from_images(str(tmp_path / "jax"), src, 16, lods=2)
    for res in (16, 8):
        names = sorted(os.listdir(tmp_path / "jax" / str(res)))
        assert names == sorted(os.listdir(tmp_path / "port" / str(res))) and len(names) == 4
        for n in names:
            np.testing.assert_array_equal(read_image(str(tmp_path / "port" / str(res) / n)),
                                          np.asarray(Image.open(tmp_path / "jax" / str(res) / n)))


def test_warp_loader_video_and_fingerprint_take_jpeg(tmp_path):
    """warp_morphs' loader equals JAX's `_load_img`; make_video's GIF of
    JPEG frames holds the frames as JAX's does; extract_features lists the
    folder's JPEGs."""
    src = _sources(tmp_path / "src")
    for f in sorted(os.listdir(src)):
        p = os.path.join(src, f)
        np.testing.assert_array_equal(read_image_rgb(p).astype(np.float32),
                                      jwarp_morphs._load_img(p))
    frames = tmp_path / "frames"
    os.makedirs(frames)
    for i in range(2):
        Image.fromarray(photo(30 + i, 24, 20)).save(frames / f"f{i}.jpg", quality=90)
    cli.main(["make_video", "--images", str(frames), "--out", str(tmp_path / "port.gif")])
    jmake_video.write_video(jmake_video.collect_frames(images=str(frames)),
                            str(tmp_path / "jax.gif"), 24)
    port, jax = Image.open(tmp_path / "port.gif"), Image.open(tmp_path / "jax.gif")
    assert port.n_frames == jax.n_frames == 2
    for k in range(2):
        port.seek(k)
        jax.seek(k)
        ref = np.asarray(Image.open(frames / f"f{k}.jpg")).astype(int)
        err = np.abs(np.asarray(port.convert("RGB")).astype(int) - ref).mean()
        jerr = np.abs(np.asarray(jax.convert("RGB")).astype(int) - ref).mean()
        assert err <= 1.5 * jerr, (k, err, jerr)
    listed = fingerprint.image_files(src)
    assert [os.path.basename(f) for f in listed] == ["img0.jpg", "img3.png"]


def test_morph_qa_size_probe_matches_jax(tmp_path):
    """calc_metrics' --morph-qa on interlaced and 16-bit PNGs, whose width
    the port reads through read_image."""
    rng = np.random.RandomState(3)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        for i in range(2):
            img = photo(rng.randint(1 << 16), 20, 18)
            data = (encode_png(img, 8, 2, interlace=1) if i == 0
                    else encode_png(img.astype(np.uint16) * 257, 16, 2))
            _write(tmp_path / d, f"{i}.png", data)
    got = cli.morph_qa(str(tmp_path / "a"), str(tmp_path / "b"), device="cpu")
    want = jcalc.morph_qa(str(tmp_path / "a"), str(tmp_path / "b"))
    assert got["num_pairs"] == want["num_pairs"] == 2
    for k in ("psnr_mean", "ssim_mean"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])


def test_training_feed_reads_every_png_as_jax(tmp_path, monkeypatch):
    """ImageFolderDataset's items equal JAX's `np.asarray(Image.open())` on
    16-bit, palette, interlaced and gray + alpha PNGs; the raw cache's
    Python decoder equals JAX's `convert("RGB")`."""
    res = 8
    folder = tmp_path / str(res)
    os.makedirs(folder)
    rng = np.random.RandomState(9)
    kinds = ((2, 16, 0), (3, 4, 0), (2, 8, 1), (4, 8, 1), (0, 1, 0))
    for i, (color, depth, interlace) in enumerate(kinds):
        c = timg._PNG_CHANNELS[color]
        pal = rng.randint(0, 256, (16, 3)) if color == 3 else None
        _write(folder, f"{i}.png", encode_png(rng.randint(0, 1 << depth, (res, res, c)), depth,
                                              color, palette=pal, interlace=interlace))
    td, jd = tds.ImageFolderDataset(str(tmp_path), res), jds.ImageFolderDataset(str(tmp_path), res)
    for i in range(len(kinds)):
        got, want = td[i][0], jd[i][0]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr("morphganformer_tpu_torch.data.native_loader.native_available",
                        lambda: False)
    decode = traw._decoder(res)
    for i in range(len(kinds)):
        p = str(folder / f"{i}.png")
        np.testing.assert_array_equal(decode(p), np.asarray(Image.open(p).convert("RGB")))


def test_face_jpeg_target_equals_its_png_and_jax(tmp_path):
    """The committed face JPEG as project loads its target: load_target of
    the JPEG equals load_target of its pixels written as a PNG, and JAX's."""
    face = os.path.join(OUT, "face.jpg")
    png = str(tmp_path / "face.png")
    timg.write_png(png, read_image_rgb(face))
    got = load_target(face, size=64)
    assert got.shape == (1, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, load_target(png, size=64))
    np.testing.assert_array_equal(got, jload_target(face, size=64))
