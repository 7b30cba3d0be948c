"""Image conversion and photo input/output (port of morphganformer_tpu/utils/image.py).

Generator output is NHWC float in [-1, 1]. Photos are read as Pillow's
`Image.open` reads them, picked by their first bytes: PNG here (every bit
depth, colour type and interlace), JPEG in `utils/jpeg.py`, BMP and Netpbm
in `utils/formats.py`. PNGs are written with the standard library's zlib
and struct, and projection targets are resized by a numpy copy of Pillow's
Lanczos resampling, so the port needs no imaging package.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import NamedTuple

import numpy as np


def adjust_range(x, from_range=(-1.0, 1.0), to_range=(0.0, 255.0)):
    """Linear range remap."""
    x = np.asarray(x, dtype=np.float32)
    lo_f, hi_f = from_range
    lo_t, hi_t = to_range
    scale = (hi_t - lo_t) / (hi_f - lo_f)
    return x * scale + (lo_t - lo_f * scale)


def to_uint8(img_hwc, drange=(-1.0, 1.0)):
    """HWC (or 1HWC) float image in drange -> HWC uint8."""
    img = np.asarray(img_hwc)
    if img.ndim == 4:
        img = img[0]
    if img.ndim != 3:
        raise ValueError(f"expected an HWC image, got shape {img.shape}")
    return np.rint(adjust_range(img, drange, (0, 255))).clip(0, 255).astype(np.uint8)


def crop_max_rectangle(img_hwc, ratio=1.0):
    """Crop the largest centred rectangle with width/height = ratio."""
    if ratio is None or ratio == 1.0:
        return img_hwc
    h, w = img_hwc.shape[:2]
    s = min(w, h * ratio)
    cw, ch = int(s), int(s / ratio)
    left, top = (w - cw) // 2, (h - ch) // 2
    return img_hwc[top:top + ch, left:left + cw]


def create_img_grid(imgs_nhwc, rows=None, cols=None, drange=(-1.0, 1.0)):
    """Tile a batch of NHWC float images into one HWC uint8 grid, empty
    cells at drange's low end (JAX `utils/image.py:73-86`, which returns
    the same pixels as a PIL image); write it with `write_png`."""
    imgs = np.asarray(imgs_nhwc)
    n, h, w, c = imgs.shape
    if cols is None:
        cols = int(np.ceil(np.sqrt(n)))
    if rows is None:
        rows = int(np.ceil(n / cols))
    grid = np.full((rows * h, cols * w, c), drange[0], dtype=np.float32)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = imgs[i]
    return to_uint8(grid, drange)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img_hwc_uint8):
    """8-bit grayscale (C = 1) or RGB (C = 3) PNG, filter type 0 on every row."""
    img = np.ascontiguousarray(img_hwc_uint8, dtype=np.uint8)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_REFUSED_SIGNATURES = ((b"GIF8", "GIF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                       (b"II+\x00", "BigTIFF"), (b"MM\x00+", "BigTIFF"))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # gray, RGB, palette, gray + alpha, RGBA
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
READ_FORMATS = "PNG, JPEG, BMP and Netpbm (PPM, PGM, PBM)"


class ImageFormatError(ValueError):
    """A file the port does not decode: another format, or a variant of a
    read format that is refused by name."""


class Decoded(NamedTuple):
    """A decoded image as Pillow opens it: `array` is
    `np.asarray(Image.open(path))`, `mode` is Pillow's mode, `palette` the
    [n, 3] uint8 colours of a "P" image (else None)."""

    array: np.ndarray
    mode: str
    palette: np.ndarray | None = None


def refuse(path, what, reason=""):
    """Raise ImageFormatError naming the file, what it is, and why."""
    raise ImageFormatError(f"{path}: {what} is not read by the port"
                           + (f" ({reason})" if reason else "")
                           + "; see ROADMAP.md queue 1, item 8")


def _unfilter(raw, stride, bpp):
    """Undo the PNG row filters of `raw` [rows, 1 + stride] uint8 (filter
    byte first: 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth); `stride` is a
    multiple of `bpp`. Rows of None, Sub and Up are undone a row at a time;
    where Average or Paeth occur, every pixel on one anti-diagonal (its
    left, upper and upper-left neighbours done) is undone at once."""
    rows = raw.shape[0]
    ft = raw[:, 0].astype(np.int16)
    if rows and int(ft.max()) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ft.max())}")
    line = raw[:, 1:]
    if not rows or int(ft.max()) <= 2:
        out = np.empty((rows, stride), np.uint8)
        prev = np.zeros(stride, np.uint8)
        for y in range(rows):
            f, cur = int(ft[y]), line[y]
            if f == 1:
                cur = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
            elif f == 2:
                cur = cur + prev
            prev = out[y] = cur
        return out
    npx = stride // bpp
    filt = line.astype(np.int16).reshape(rows, npx, bpp)
    # cur[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zeros
    # PNG assumes outside the image.
    cur = np.zeros((rows + 1, npx + 1, bpp), np.int16)
    for d in range(rows + npx - 1):
        ys = np.arange(max(0, d - npx + 1), min(rows, d + 1))
        xs = d - ys
        a, b, c = cur[ys + 1, xs], cur[ys, xs + 1], cur[ys, xs]
        f = ft[ys][:, None]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], 0)
        cur[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return cur[1:, 1:].reshape(rows, stride).astype(np.uint8)


def _png_samples(rows, width, channels, depth):
    """Unfiltered rows [h, stride] uint8 -> samples [h, width, channels]
    (uint16 at depth 16, else uint8)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 8:
        return rows[:, :n].reshape(h, width, channels)
    if depth == 16:
        pairs = rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16)
        return ((pairs[..., 0] << 8) | pairs[..., 1]).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8).reshape(h, width, channels)


def _png_chunks(path, data):
    if data[:8] != _PNG_SIGNATURE:
        raise ImageFormatError(f"{path}: not a PNG")
    pos, idat, chunks = 8, [], {}
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        else:
            chunks.setdefault(tag, body)
        pos += 12 + length
    if b"IHDR" not in chunks:
        raise ValueError(f"{path}: PNG without IHDR")
    return chunks, b"".join(idat)


def decode_png(path, data=None):
    """Every PNG as Pillow 12 opens it, bit for bit: each bit depth and
    colour type, PLTE and tRNS, Adam7 interlacing. The modes (and what
    `convert("RGB")` then gives, `to_rgb`):

    ====================  ========  ===================================
    colour type, depth    mode      array; RGB
    ====================  ========  ===================================
    gray 1                "1"       bool [h, w]; 0 or 255
    gray 2, 4             "L"       scaled to 0-255 (x 85, x 17)
    gray 8                "L"       uint8 [h, w]; replicated
    gray 16               "I;16"    uint16 [h, w]; clipped to 255, not
                                    scaled
    RGB 8, 16             "RGB"     uint8 [h, w, 3]; 16: the high byte
    palette 1, 2, 4, 8    "P"       the indices uint8 [h, w]; PLTE's
                                    colours, black past its end
    gray + alpha 8        "LA"      uint8 [h, w, 2]; gray replicated
    gray + alpha 16       "RGBA"    gray's high byte three times, then
                                    alpha's
    RGBA 8, 16            "RGBA"    uint8 [h, w, 4]; 16: high bytes
    ====================  ========  ===================================

    tRNS changes no pixel of either (Pillow keeps it in `info`)."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    chunks, idat = _png_chunks(path, data)
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"][:13])
    if color not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[color] or interlace > 1:
        raise ValueError(f"{path}: invalid PNG header (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace})")
    c = _PNG_CHANNELS[color]
    bpp = max(1, c * depth // 8)
    raw = np.frombuffer(zlib.decompressobj().decompress(idat), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * c * depth // 8)
        size = ph * (1 + stride)
        if pos + size > len(raw):
            raise ValueError(f"{path}: PNG image data ends early")
        rows = _unfilter(raw[pos:pos + size].reshape(ph, 1 + stride), stride, bpp)
        samples[y0::dy, x0::dx] = _png_samples(rows, pw, c, depth)
        pos += size
    if color == 3:
        plte = chunks.get(b"PLTE")
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        pal = np.frombuffer(plte[:len(plte) // 3 * 3], np.uint8).reshape(-1, 3)
        return Decoded(samples[..., 0], "P", pal)
    if color == 0:
        g = samples[..., 0]
        if depth == 1:
            return Decoded(g.astype(bool), "1")
        if depth == 16:
            return Decoded(g, "I;16")
        return Decoded(g * np.uint8(255 // ((1 << depth) - 1)), "L")
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if color == 4:
            return Decoded(samples[..., [0, 0, 0, 1]], "RGBA")
    return Decoded(samples, {2: "RGB", 4: "LA", 6: "RGBA"}[color])


def to_rgb(img):
    """A Decoded image as Pillow's `convert("RGB")` gives it: HWC uint8."""
    a, mode = img.array, img.mode
    if mode == "RGB":
        return a
    if mode == "RGBA":
        return a[..., :3]
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(256, len(img.palette))] = img.palette[:256]
        return pal[a]
    if mode == "1":
        gray = np.where(a, np.uint8(255), np.uint8(0))
    elif mode == "I;16":
        gray = np.minimum(a, 255).astype(np.uint8)
    elif mode == "LA":
        gray = a[..., 0]
    elif mode == "L":
        gray = a
    else:
        raise ValueError(f"no RGB conversion of mode {mode}")
    return np.repeat(gray[..., None], 3, axis=2)


def image_format(data):
    """The format of a file from its first bytes: "PNG", "JPEG", "BMP",
    "PNM", or None (with a description for the refusal) for others."""
    if data.startswith(_PNG_SIGNATURE):
        return "PNG", "a PNG image"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG", "a JPEG image"
    if data.startswith(b"BM"):
        return "BMP", "a BMP image"
    if len(data) >= 2 and data[0:1] == b"P" and data[1:2] in b"123456":
        return "PNM", "a Netpbm image"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return None, "a WebP image"
    for magic, name in _REFUSED_SIGNATURES:
        if data.startswith(magic):
            return None, f"a {name} image"
    if data[:2] in (b"P7", b"PF", b"Pf"):
        return None, "a PAM or PFM image"
    if not data:
        return None, "an empty file"
    return None, "a file of unknown format"


def _refuse_format(path, what):
    if what == "a WebP image":
        refuse(path, what, "the VP8 and VP8L decoders are not ported yet; convert it to PNG")
    raise ImageFormatError(f"{path}: {what}; the port reads {READ_FORMATS} images only, so "
                           "convert it to PNG first (ROADMAP.md queue 1, item 8)")


def _codec(fmt):
    """(decode, check from the headers alone or None) of a read format."""
    from morphganformer_tpu_torch.utils import formats, jpeg

    return {"PNG": (decode_png, None), "JPEG": (jpeg.decode_jpeg, jpeg.check_jpeg),
            "BMP": (formats.decode_bmp, formats.check_bmp),
            "PNM": (formats.decode_pnm, formats.check_pnm)}[fmt]


def _read_known(path):
    """(the file's bytes, its format), refusing a format the port does not
    read."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, what = image_format(data)
    if fmt is None:
        _refuse_format(path, what)
    return data, fmt


def open_image(path):
    """Decode a PNG, JPEG, BMP or Netpbm file as Pillow's `Image.open`
    does, picked by the file's first bytes (never its extension). Other
    formats, and the variants of these that the port refuses, raise
    ImageFormatError with their name."""
    data, fmt = _read_known(path)
    return _codec(fmt)[0](path, data)


def check_image(path):
    """Raise as `open_image` would on a format or variant the port refuses,
    from the headers alone (no pixel is decoded)."""
    data, fmt = _read_known(path)
    check = _codec(fmt)[1]
    if check is not None:
        check(path, data)


def read_image(path):
    """`np.asarray(Image.open(path))`: see `open_image`."""
    return open_image(path).array


def read_image_rgb(path):
    """`np.asarray(Image.open(path).convert("RGB"))`: HWC uint8."""
    return to_rgb(open_image(path))


def read_png(path):
    """Decode an 8-bit, non-interlaced gray, RGB, gray + alpha or RGBA PNG
    to HWC uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: {image_format(data)[1]}, not a PNG; read_png reads PNG "
                         "only (read_image reads the other formats)")
    chunks, _ = _png_chunks(path, data)
    _, _, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"][:13])
    if depth != 8 or color == 3 or color not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(f"{path}: read_png reads 8-bit non-interlaced gray, RGB, "
                                  f"gray + alpha and RGBA PNGs only (depth {depth}, color "
                                  f"type {color}, interlace {interlace}); read_image reads "
                                  "every PNG")
    img = decode_png(path, data).array
    return img[..., None] if img.ndim == 2 else img


def read_png_rgb(path):
    """A PNG as HWC uint8 RGB, as Pillow's `convert("RGB")` gives it: gray
    replicated to the three channels, alpha dropped."""
    img = read_png(path)
    return np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] <= 2 else img[:, :, :3]


# Pillow's Resample.c for 8-bit images: the Lanczos filter (a = 3) in
# double, widened by the downscale factor, each output's coefficients
# normalised to sum 1, then to fixed point with 22 fraction bits; each pass
# sums from 2^21, shifts right by 22 and clips to uint8.
_PRECISION_BITS = 22


def _sinc(x):
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x):
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _lanczos_coeffs(in_size, out_size):
    """(first input index [out], integer coefficients [out, ksize] as
    float64) of one axis, as Pillow's precompute_coeffs and
    normalize_coeffs_8bpc compute them."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(n)]
        ww = 0.0
        for v in k:
            ww += v
        kk[xx, :n] = [v / ww for v in k] if ww != 0.0 else k
        xmins[xx] = xmin
    one = float(1 << _PRECISION_BITS)
    return xmins, np.where(kk < 0, np.trunc(kk * one - 0.5), np.trunc(kk * one + 0.5))


def _resample_axis(img, axis, out_size):
    """One Lanczos pass of a uint8 HWC image along `axis`. Integer
    coefficients times uint8 values sum exactly in float64."""
    src = np.moveaxis(img, axis, 0)
    xmins, kk = _lanczos_coeffs(src.shape[0], out_size)
    acc = np.full((out_size,) + src.shape[1:], float(1 << (_PRECISION_BITS - 1)))
    bcast = (-1,) + (1,) * (src.ndim - 1)
    for t in range(kk.shape[1]):
        idx = np.minimum(xmins + t, src.shape[0] - 1)   # past its window a tap's weight is 0
        acc += kk[:, t].reshape(bcast) * src[idx]
    out = np.clip(np.floor(acc / (1 << _PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def lanczos_resize(img, height, width):
    """HWC uint8 -> [height, width, C] uint8, equal to Pillow's
    `Image.resize((width, height), Image.LANCZOS)` (no reducing gap): the
    horizontal pass, then the vertical, each skipped where that side keeps
    its size."""
    if img.shape[1] != width:
        img = _resample_axis(img, 1, width)
    if img.shape[0] != height:
        img = _resample_axis(img, 0, height)
    return img


def load_target(path, size=1024, drange=(-1.0, 1.0)):
    """A projection target [1, size, size, 3] float32 in `drange` from a
    photo of any size, as the JAX package's load_target makes it: the
    shorter side Lanczos-resized to `size` (the longer to max(size,
    round(side * scale))), then the centre crop. The file is read by
    `read_image_rgb` (PNG, JPEG, BMP or Netpbm), converted to RGB as
    Pillow converts it, before the resize. Other formats raise."""
    img = read_image_rgb(path)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    w, h = max(size, round(w * scale)), max(size, round(h * scale))
    img = lanczos_resize(img, h, w)
    left, top = (w - size) // 2, (h - size) // 2
    img = img[top:top + size, left:left + size]
    return adjust_range(img.astype(np.float32), (0, 255), drange)[None]
