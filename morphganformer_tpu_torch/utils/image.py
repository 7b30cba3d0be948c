"""Image conversion and PNG input/output (port of morphganformer_tpu/utils/image.py).

Generator output is NHWC float in [-1, 1]. PNGs are read and written with
the standard library's zlib and struct, and projection targets are resized
by a numpy copy of Pillow's Lanczos resampling, so the port needs no imaging
package.
"""

from __future__ import annotations

import math
import struct
import zlib

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
_SIGNATURES = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
               (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # gray, RGB, gray + alpha, RGBA


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter_row(ft, line, prev, bpp):
    """Undo one row's PNG filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if ft == 0:
        return line.copy()
    if ft == 1:
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ft == 2:
        return line + prev
    if ft not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {ft}")
    cur, up = bytearray(line.tobytes()), prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        if ft == 3:
            cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
        else:
            cur[i] = (cur[i] + _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path):
    """Decode an 8-bit, non-interlaced gray, RGB, gray + alpha or RGBA PNG
    to HWC uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: {_format_of(data)}, not a PNG; only PNG images are read, "
                         "so convert it to PNG first")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(f"{path}: only 8-bit non-interlaced gray, RGB, gray + "
                                  f"alpha and RGBA "
                                  f"PNGs are read (depth {depth}, color type {color}, "
                                  f"interlace {interlace})")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, c)
    return out.reshape(h, w, c)


def read_png_rgb(path):
    """A PNG as HWC uint8 RGB, as Pillow's `convert("RGB")` gives it: gray
    replicated to the three channels, alpha dropped."""
    img = read_png(path)
    return np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] <= 2 else img[:, :, :3]


def _format_of(data):
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "a WebP image"
    for magic, name in _SIGNATURES:
        if data.startswith(magic):
            return f"a {name} image"
    return "a file of unknown format"


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
    """A projection target [1, size, size, 3] float32 in `drange` from a PNG
    of any size, as the JAX package's load_target makes it: the shorter side
    Lanczos-resized to `size` (the longer to max(size, round(side *
    scale))), then the centre crop. Gray is replicated to RGB and alpha
    dropped before the resize. Other formats raise."""
    img = read_png_rgb(path)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    w, h = max(size, round(w * scale)), max(size, round(h * scale))
    img = lanczos_resize(img, h, w)
    left, top = (w - size) // 2, (h - size) // 2
    img = img[top:top + size, left:left + size]
    return adjust_range(img.astype(np.float32), (0, 255), drange)[None]
