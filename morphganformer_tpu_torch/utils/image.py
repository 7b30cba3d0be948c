"""Image conversion and PNG input/output (port of morphganformer_tpu/utils/image.py).

Generator output is NHWC float in [-1, 1]. PNGs are read and written with
the standard library's zlib and struct, so the port needs no imaging package.
"""

from __future__ import annotations

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
        raise ValueError(f"{path}: not a PNG file")
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


def load_target(path, size=1024, drange=(-1.0, 1.0)):
    """A projection target [1, size, size, 3] float32 in `drange` from a PNG
    whose shorter side is `size`: centre crop, as the JAX package's
    load_target does after its resize. Gray is replicated to RGB and alpha
    dropped. Other sizes need the Lanczos resize, which is not ported yet."""
    img = read_png(path)
    h, w = img.shape[:2]
    if min(h, w) != size:
        raise NotImplementedError(f"{path}: shorter side {min(h, w)} != {size}; the Lanczos "
                                  "resize of load_target is not ported yet")
    img = np.repeat(img[:, :, :1], 3, axis=2) if img.shape[2] <= 2 else img[:, :, :3]
    left, top = (w - size) // 2, (h - size) // 2
    img = img[top:top + size, left:left + size]
    return adjust_range(img.astype(np.float32), (0, 255), drange)[None]
