"""Image conversion and PNG output (port of morphganformer_tpu/utils/image.py).

Generator output is NHWC float in [-1, 1]. PNGs are written with the
standard library's zlib and struct, so the port needs no imaging package.
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
