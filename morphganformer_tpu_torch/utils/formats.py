"""BMP and Netpbm decoding in numpy, as Pillow 12 opens them.

BMP (`decode_bmp`): the OS/2 core header and the Windows v3 to v5 headers;
BI_RGB at 1, 4, 8, 16 (5-5-5), 24 and 32 bits (the fourth byte ignored, as
Pillow ignores it), BI_BITFIELDS at 16 (5-6-5 or 5-5-5), 24 and 32 bits
with Pillow's mask layouts (RGBA where the layout has alpha), bottom-up
and top-down rows. A palette image is mode "P" with its BGR(X) palette,
unless every entry is gray (v, v, v) in order: then "1" for two entries
(black, white) or "L". 5- and 6-bit fields scale as floor(v * 255 / 31)
and floor(v * 255 / 63). Refused by name: RLE4 and RLE8, and JPEG or PNG
inside a BMP.

Netpbm (`decode_pnm`): P1 and P4 (mode "1"), P2 and P5 (mode "L"), P3
and P6 (mode "RGB") at a maxval of 255 or less, `#` comments in the header
(and in a plain file's data); a maxval below 255 scales each value to
round(v / maxval * 255) with Python's rounding, as Pillow's decoder does.
Refused by name: a maxval above 255 (16-bit samples).
"""

from __future__ import annotations

import re
import struct

import numpy as np

from morphganformer_tpu_torch.utils.image import Decoded, refuse

_BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)
# (bits, (r, g, b, a) masks) -> (channel order of the stored words, mode), as
# Pillow's MASK_MODES; 24- and 16-bit layouts keyed without alpha.
_BITFIELDS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "RGB",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "RGB",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "RGB",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "RGBA",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "RGBA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "RGBA",
    (32, (0x0, 0x0, 0x0, 0x0)): "RGBA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "RGB",
    (16, (0xF800, 0x7E0, 0x1F)): "RGB",
    (16, (0x7C00, 0x3E0, 0x1F)): "RGB",
}


def _bmp_header(path, data):
    """The fields of a BMP's headers that decoding needs."""
    if len(data) < 18:
        raise ValueError(f"{path}: BMP header cut short")
    offset = struct.unpack("<I", data[10:14])[0]
    size = struct.unpack("<I", data[14:18])[0]
    if size not in _BMP_HEADERS:
        raise ValueError(f"{path}: BMP header of {size} bytes (Pillow refuses it too)")
    hdr = data[18:14 + size]
    if len(hdr) < size - 4:
        raise ValueError(f"{path}: BMP header cut short")
    info = {"size": size}
    if size == 12:
        info.update(width=struct.unpack("<H", hdr[0:2])[0],
                    height=struct.unpack("<H", hdr[2:4])[0],
                    bits=struct.unpack("<H", hdr[6:8])[0], compression=0, colors=0,
                    padding=3, topdown=False)
    else:
        topdown = hdr[7] == 0xFF
        h = struct.unpack("<I", hdr[4:8])[0]
        info.update(width=struct.unpack("<i", hdr[0:4])[0],
                    height=2 ** 32 - h if topdown else h,
                    bits=struct.unpack("<H", hdr[10:12])[0],
                    compression=struct.unpack("<I", hdr[12:16])[0],
                    colors=struct.unpack("<I", hdr[28:32])[0], padding=4, topdown=topdown)
        if info["compression"] == 3:
            if len(hdr) >= 48:
                n = 4 if len(hdr) >= 52 else 3
                masks = struct.unpack(f"<{n}I", hdr[36:36 + 4 * n]) + (0,) * (4 - n)
            else:
                masks = struct.unpack("<3I", data[14 + size:26 + size]) + (0,)
            info["masks"] = masks
    info["colors"] = info["colors"] or (1 << info["bits"])
    if offset == 14 + size and info["bits"] <= 8:      # Pillow's correction of a bad offset
        offset += 4 * info["colors"]
    info["offset"] = offset
    comp, bits = info["compression"], info["bits"]
    if comp in (1, 2):
        refuse(path, f"an {'RLE8' if comp == 1 else 'RLE4'}-compressed BMP",
               "run-length coding is not implemented")
    if comp in (4, 5):
        refuse(path, f"a BMP holding a {'JPEG' if comp == 4 else 'PNG'}",
               "Pillow refuses it too")
    if comp not in (0, 3):
        raise ValueError(f"{path}: BMP compression {comp} (Pillow refuses it too)")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: BMP of {bits} bits a pixel (Pillow refuses it too)")
    if comp == 3:
        masks = info["masks"]
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in _BITFIELDS:
            raise ValueError(f"{path}: BMP bitfields layout {tuple(hex(m) for m in masks)} "
                             f"at {bits} bits (Pillow refuses it too)")
    return info


def check_bmp(path, data):
    """Raise on a BMP the decoder refuses, from its headers alone."""
    _bmp_header(path, data)


def _fields(words, mask):
    """The field of `mask` in each word, as an integer."""
    shift = (mask & -mask).bit_length() - 1 if mask else 0
    return (words >> shift) & (mask >> shift) if mask else np.zeros_like(words)


def decode_bmp(path, data=None):
    """A BMP as Pillow opens it: Decoded(array, mode, palette)."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    info = _bmp_header(path, data)
    w, h, bits = info["width"], info["height"], info["bits"]
    stride = ((w * bits + 31) >> 3) & ~3
    if len(data) < info["offset"] + h * stride:
        raise ValueError(f"{path}: BMP pixel data cut short")
    rows = np.frombuffer(data, np.uint8, count=h * stride, offset=info["offset"]).reshape(h, stride)
    if not info["topdown"]:
        rows = rows[::-1]
    if bits <= 8:
        if bits == 8:
            idx = rows[:, :w]
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
        pad = info["padding"]
        colors = info["colors"]
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP palette of {colors} entries (Pillow refuses it too)")
        start = 14 + info["size"]
        pal = np.frombuffer(data[start:start + pad * colors], np.uint8)
        pal = pal[:len(pal) // pad * pad].reshape(-1, pad)[:, 2::-1]       # BGR(X) -> RGB
        gray = (0, 255) if colors == 2 else range(colors)
        if len(pal) >= len(gray) and all((pal[i] == v).all() for i, v in enumerate(gray)):
            if colors == 2:                  # Pillow reads the rows as 1-bit, whatever `bits`
                return Decoded(np.unpackbits(rows, axis=1)[:, :w].astype(bool), "1")
            if bits != 8:
                raise ValueError(f"{path}: a {bits}-bit BMP whose palette is a gray ramp "
                                 "(Pillow cannot read it either)")
            return Decoded(np.ascontiguousarray(idx), "L")
        return Decoded(np.ascontiguousarray(idx), "P", np.ascontiguousarray(pal))
    if bits == 24:
        return Decoded(np.ascontiguousarray(rows[:, :3 * w].reshape(h, w, 3)[..., ::-1]), "RGB")
    if bits == 32:
        words = rows[:, :4 * w].reshape(h, w, 4)
        if info["compression"] == 0:
            return Decoded(np.ascontiguousarray(words[..., 2::-1]), "RGB")
        words = words.view("<u4")[..., 0].astype(np.uint32)
        masks = info["masks"]
        mode = _BITFIELDS[(32, masks)]
        if masks == (0, 0, 0, 0):                                     # Pillow takes it as BGRA
            masks = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        chans = [_fields(words, m) for m in masks[:len(mode)]]
        return Decoded(np.stack(chans, axis=2).astype(np.uint8), mode)
    words = rows[:, :2 * w].reshape(h, w, 2).view("<u2")[..., 0].astype(np.int64)
    masks = info.get("masks", (0x7C00, 0x3E0, 0x1F, 0))[:3]
    chans = [_fields(words, m) * 255 // (m >> ((m & -m).bit_length() - 1)) for m in masks]
    return Decoded(np.stack(chans, axis=2).astype(np.uint8), "RGB")


_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}
_WHITESPACE = b" \t\n\x0b\x0c\r"
_COMMENT = re.compile(rb"#[^\r\n]*(\r|\n|$)")


def _pnm_header(path, data):
    """(magic, width, height, maxval or None, offset of the pixel data), as
    Pillow's PpmImageFile reads them."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6 and data[pos] not in _WHITESPACE:
        magic += data[pos:pos + 1]
        pos += 1
    pos += 1
    if magic not in _PNM_MODES:
        raise ValueError(f"{path}: not a Netpbm image the port reads (magic {magic!r})")

    def token(pos):
        tok = b""
        while len(tok) <= 10:
            if pos >= len(data):
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in (b"\r", b"\n"):
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise ValueError(f"{path}: Netpbm header cut short or malformed")
        return int(tok), pos

    w, pos = token(pos)
    h, pos = token(pos)
    maxval = None
    if _PNM_MODES[magic] != "1":
        maxval, pos = token(pos)
        if not 0 < maxval < 65536:
            raise ValueError(f"{path}: Netpbm maxval {maxval}")
        if maxval > 255:
            refuse(path, f"a Netpbm image of maxval {maxval} (16-bit samples)",
                   "only maxval 255 or less is read")
    return magic, w, h, maxval, pos


def check_pnm(path, data):
    """Raise on a Netpbm file the decoder refuses, from its header alone."""
    _pnm_header(path, data)


def decode_pnm(path, data=None):
    """A PBM, PGM or PPM as Pillow opens it: Decoded(array, mode)."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    magic, w, h, maxval, pos = _pnm_header(path, data)
    mode = _PNM_MODES[magic]
    bands = 3 if mode == "RGB" else 1
    body = data[pos:]
    if magic == b"P4":
        stride = -(-w // 8)
        if len(body) < h * stride:
            raise ValueError(f"{path}: PBM pixel data cut short")
        bits = np.unpackbits(np.frombuffer(body, np.uint8, count=h * stride).reshape(h, stride),
                             axis=1)[:, :w]
        return Decoded(bits == 0, "1")
    if magic == b"P1":
        digits = b"".join(_COMMENT.sub(b"", body).split())[:w * h]
        if any(c not in b"01" for c in set(digits)) or len(digits) < w * h:
            raise ValueError(f"{path}: PBM data malformed or cut short")
        return Decoded((np.frombuffer(digits, np.uint8) == ord("0")).reshape(h, w), mode)
    n = w * h * bands
    if magic in (b"P5", b"P6"):
        if len(body) < n:
            raise ValueError(f"{path}: Netpbm pixel data cut short")
        vals = np.frombuffer(body, np.uint8, count=n)
        if maxval != 255:
            vals = np.minimum(255, np.round(vals / maxval * 255)).astype(np.uint8)
    else:
        toks = _COMMENT.sub(b"", body).split()[:n]
        if len(toks) < n or any(len(t) > 10 for t in toks):
            raise ValueError(f"{path}: Netpbm data malformed or cut short")
        ints = np.array([int(t) for t in toks], np.int64)
        if ints.min() < 0 or ints.max() > maxval:
            raise ValueError(f"{path}: Netpbm value outside 0-{maxval}")
        vals = np.round(ints / maxval * 255).astype(np.uint8)
    return Decoded(vals.reshape((h, w, 3) if bands == 3 else (h, w)), mode)
