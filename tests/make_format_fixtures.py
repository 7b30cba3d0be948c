"""Write the photo-format fixtures of tests/data/formats/ and their hashes.

    python tests/make_format_fixtures.py [out_dir]

Each fixture is a small file in a format the port decodes without Pillow
(`morphganformer_tpu_torch.utils.image.read_image`). Pillow writes the
JPEGs, BMPs and PPMs; the PNG variants Pillow cannot write (16-bit RGB,
Adam7, 2-bit gray, every filter type) are written by `encode_png` below.
`formats.json` records, for each file, Pillow's mode, the shape and
SHA-256 of `np.asarray(Image.open(path))` and of `.convert("RGB")`, so
that a machine without Pillow can hold the port's decoders to Pillow's
arrays. Pillow is needed only to run this script; the face JPEG is drawn
by the port's `losses/synthetic_faces.py` from a fixed seed.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "data", "formats")
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """[h, n] sample values -> [h, stride] bytes, big-endian, MSB first."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.zeros((h, -(-n // per) * per), np.uint8)
    s[:, :n] = samples
    s = s.reshape(h, -1, per)
    out = np.zeros(s.shape[:2], np.uint8)
    for i in range(per):
        out |= s[:, :, i] << (8 - depth * (i + 1))
    return out


def _filter_rows(rows, bpp, filters):
    """Apply PNG filter filters[y % len(filters)] to each row."""
    h, stride = rows.shape
    out = np.zeros((h, 1 + stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:stride]
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[:stride]
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out[y, 0] = f
        out[y, 1:] = (cur - pred) & 0xFF
        prev = cur
    return out


def encode_png(samples, depth, color, palette=None, trns=None, interlace=0,
               filters=(0, 1, 2, 3, 4)):
    """A PNG of `samples` [h, w, channels] (values below 2^depth) at any
    bit depth and colour type, optionally Adam7-interlaced, its rows
    filtered by turns with `filters`."""
    samples = np.asarray(samples)
    h, w, c = samples.shape
    assert c == PNG_CHANNELS[color], (c, color)
    bpp = max(1, c * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = []
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        raw.append(_filter_rows(rows, bpp, filters).tobytes())
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)))
    if palette is not None:
        data += _chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).reshape(-1)))
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    idat = zlib.compress(b"".join(raw), 9)
    half = len(idat) // 2                    # two IDAT chunks
    return (data + _chunk(b"IDAT", idat[:half]) + _chunk(b"IDAT", idat[half:])
            + _chunk(b"IEND", b""))


_LUMA_Q = (16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40,
           57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35,
           55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112,
           100, 103, 99)
_CHROMA_Q = (17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99,
             99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99) + (99,) * 32
_ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
           27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
           44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)


def _quant_table(base, quality):
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((np.asarray(base) * scale + 50) // 100, 1, 255).reshape(8, 8)


def _huffman_table(freqs):
    """(counts of codes by length 1-16, symbols in code order, {symbol:
    (code, length)}) of an optimal length-limited code, by JPEG's Annex K.2
    procedure (one reserved code point, so no code is all ones)."""
    import heapq

    lengths = {s: 0 for s in freqs}
    lengths[-1] = 0
    heap = [(f, i, [s]) for i, (s, f) in enumerate(sorted(freqs.items()))] + [(0, -1, [-1])]
    heapq.heapify(heap)
    n = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            lengths[s] += 1
        heapq.heappush(heap, (f1 + f2, n, a + b))
        n += 1
    bits = [0] * 40
    for s, ln in lengths.items():
        bits[max(ln, 1)] += 1
    for i in range(39, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1                                    # the reserved code point
    order = sorted(freqs, key=lambda s: (lengths[s], -freqs[s], s))
    codes, code, k = {}, 0, 0
    for ln in range(1, 17):
        for _ in range(bits[ln]):
            codes[order[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return bits[1:17], order, codes


def _magnitude(v):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode_jpeg(img, sampling=((2, 2), (1, 1), (1, 1)), quality=75, restart=0,
                interleaved=True, marker="jfif", sof=0xC0):
    """A sequential Huffman JPEG of `img` ([h, w, 3] RGB or [h, w] gray) with
    any integral sampling factors `sampling` ((h, v) per component),
    optimal Huffman tables, a restart interval of `restart` MCUs, the
    components in one interleaved scan or one scan each, and a JFIF marker
    ("jfif"), an Adobe marker with transform 0 (RGB stored as is,
    "adobe_rgb") or 1 ("adobe"), or none ("ids_rgb": component ids 'R',
    'G', 'B' and RGB stored). Pillow cannot write 4:1:1, 4:4:0 or these
    markers; its decoder is the reference the port is held to."""
    img = np.asarray(img, np.float64)
    h, w = img.shape[:2]
    if img.ndim == 2:
        planes, sampling = [img], sampling[:1]
    elif marker in ("adobe_rgb", "ids_rgb"):
        planes = [img[..., i] for i in range(3)]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    k = np.arange(8)
    dct = np.sqrt(np.where(k == 0, 1, 2) / 8)[:, None] * np.cos((2 * k[None] + 1) * k[:, None]
                                                              * np.pi / 16)
    quants = [_quant_table(_LUMA_Q, quality), _quant_table(_CHROMA_Q, quality)]
    comps = []
    for i, (plane, (sh, sv)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // sh, vmax // sv
        p = np.pad(plane, ((0, -h % fy), (0, -w % fx)), mode="edge")
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean(axis=(1, 3))
        bw, bh = mcux * sh, mcuy * sv
        p = np.pad(p, ((0, 8 * bh - p.shape[0]), (0, 8 * bw - p.shape[1])), mode="edge")
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        q = quants[min(i, 1)]
        coef = np.rint(dct @ blocks @ dct.T / q).astype(np.int64)
        comps.append(dict(h=sh, v=sv, bw=bw, bh=bh, tq=min(i, 1),
                          cw=-(-w * sh // hmax), ch=-(-h * sv // vmax),
                          coef=coef.reshape(bh, bw, 64)[..., list(_ZIGZAG)]))
    scans = [list(range(len(comps)))] if interleaved else [[i] for i in range(len(comps))]
    ids = (82, 71, 66) if marker == "ids_rgb" else (1, 2, 3)
    out = [b"\xff\xd8"]
    if marker == "jfif":
        out.append(b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker in ("adobe", "adobe_rgb"):
        out.append(b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64\x00\x00\x00\x00"
                   + bytes([marker == "adobe"]))
    for t, q in enumerate(quants[:min(2, len(comps))]):
        out.append(b"\xff\xdb" + struct.pack(">HB", 67, t)
                   + bytes(int(v) for v in q.reshape(-1)[list(_ZIGZAG)]))
    out.append(bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * len(comps), 8, h, w, len(comps))
               + b"".join(bytes([ids[i], (c["h"] << 4) | c["v"], c["tq"]])
                          for i, c in enumerate(comps)))
    if restart:
        out.append(b"\xff\xdd" + struct.pack(">HH", 4, restart))
    for scan in scans:
        units = []                                  # (component, block row, block column) per MCU
        if len(scan) == 1:
            c = comps[scan[0]]
            units = [[(scan[0], by, bx)] for by in range(-(-c["ch"] // 8))
                     for bx in range(-(-c["cw"] // 8))]
        else:
            for my in range(mcuy):
                for mx in range(mcux):
                    units.append([(i, my * comps[i]["v"] + v, mx * comps[i]["h"] + u)
                                  for i in scan for v in range(comps[i]["v"])
                                  for u in range(comps[i]["h"])])
        syms = []                                   # (table, symbol, bits, nbits) or a restart
        pred = {i: 0 for i in scan}
        for m, mcu in enumerate(units):
            if restart and m and m % restart == 0:
                syms.append(("RST", (m // restart - 1) % 8))
                pred = {i: 0 for i in scan}
            for i, by, bx in mcu:
                zz = comps[i]["coef"][by, bx]
                t = min(i, 1)
                s, bits = _magnitude(int(zz[0]) - pred[i])
                pred[i] = int(zz[0])
                syms.append((("dc", t), s, bits, s))
                run = 0
                for kk in range(1, 64):
                    v = int(zz[kk])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        syms.append((("ac", t), 0xF0, 0, 0))
                        run -= 16
                    s, bits = _magnitude(v)
                    syms.append((("ac", t), (run << 4) | s, bits, s))
                    run = 0
                if run:
                    syms.append((("ac", t), 0x00, 0, 0))
        freqs = {}
        for sym in syms:
            if sym[0] != "RST":
                freqs.setdefault(sym[0], {}).setdefault(sym[1], 0)
                freqs[sym[0]][sym[1]] += 1
        tables = {}
        for key in sorted(freqs):
            counts, order, codes = _huffman_table(freqs[key])
            tables[key] = codes
            out.append(b"\xff\xc4" + struct.pack(">HB", 19 + len(order),
                                                 (key[0] == "ac") << 4 | key[1])
                       + bytes(counts) + bytes(order))
        out.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(scan), len(scan))
                   + b"".join(bytes([ids[i], (min(i, 1) << 4) | min(i, 1)]) for i in scan)
                   + b"\x00\x3f\x00")
        acc, nacc, data = 0, 0, bytearray()

        def flush_bytes():
            nonlocal acc, nacc
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 0xFF
                data.append(byte)
                if byte == 0xFF:
                    data.append(0)
                nacc -= 8
            acc &= (1 << nacc) - 1

        for sym in syms:
            if sym[0] == "RST":
                if nacc % 8:
                    pad = 8 - nacc % 8
                    acc, nacc = (acc << pad) | ((1 << pad) - 1), nacc + pad
                flush_bytes()
                data += bytes([0xFF, 0xD0 + sym[1]])
                continue
            code, ln = tables[sym[0]][sym[1]]
            acc, nacc = (acc << ln) | code, nacc + ln
            acc, nacc = (acc << sym[3]) | sym[2], nacc + sym[3]
            flush_bytes()
        if nacc % 8:
            pad = 8 - nacc % 8
            acc, nacc = (acc << pad) | ((1 << pad) - 1), nacc + pad
        flush_bytes()
        out.append(bytes(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


def pillow_arrays(path):
    """(mode, np.asarray(Image.open(path)), np.asarray(.convert("RGB")))."""
    import warnings

    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rgb = np.asarray(im.convert("RGB"))
        return im.mode, arr, rgb


def digest(arr):
    """SHA-256 of an array's C-order bytes beside its dtype and shape (a
    bool array as 0 and 1: Pillow's "1" arrays hold 0 and 255)."""
    arr = np.ascontiguousarray(arr != 0 if arr.dtype == bool else arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def photo(seed, h, w):
    """A smooth colour image with edges: what a camera's JPEG holds."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / (3 + 5 * rng.rand()) + y / 7),
                    128 + 90 * np.cos(y / (4 + 4 * rng.rand()) - x / 11),
                    (x * 255 / max(w - 1, 1) + 60 * (((x // 6) + (y // 6)) % 2))], axis=2)
    img += rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


def face_rgb(h=800, w=640, seed=3):
    """The face photo: a synthetic face (the port's synthetic_faces, seed
    3) at 640 x 640, its rows extended by reflection to 800 x 640."""
    from morphganformer_tpu_torch.losses.synthetic_faces import sample_face

    img, _ = sample_face(np.random.RandomState(seed), size=w)
    face = np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return np.pad(face, (((h - w) // 2, h - w - (h - w) // 2), (0, 0), (0, 0)), mode="reflect")


def fixtures():
    """{file name: bytes} of every fixture."""
    from PIL import Image

    def save(arr, fmt, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt, **kw)
        return buf.getvalue()

    rng = np.random.RandomState(0)
    out = {}
    img = photo(1, 48, 64)
    for name, kw in (("baseline_420", dict(quality=85, subsampling="4:2:0")),
                     ("baseline_422", dict(quality=85, subsampling="4:2:2")),
                     ("baseline_444", dict(quality=85, subsampling="4:4:4")),
                     ("progressive_optimize", dict(quality=80, progressive=True, optimize=True)),
                     ("restart", dict(quality=75, restart_marker_blocks=3)),
                     ("restart_progressive", dict(quality=75, progressive=True,
                                                  restart_marker_rows=1))):
        out[f"{name}.jpg"] = save(img, "JPEG", **kw)
    out["baseline_411.jpg"] = encode_jpeg(img, ((4, 1), (1, 1), (1, 1)), quality=85)
    out["baseline_440_noninterleaved.jpg"] = encode_jpeg(img, ((1, 2), (1, 1), (1, 1)),
                                                         quality=85, interleaved=False)
    out["adobe_rgb_restart.jpg"] = encode_jpeg(img, ((1, 1),) * 3, quality=90, restart=5,
                                               marker="adobe_rgb", sof=0xC1)
    out["gray.jpg"] = save(photo(2, 40, 33)[..., 1], "JPEG", quality=90)
    out["odd_37x53.jpg"] = save(photo(3, 53, 37), "JPEG", quality=70, subsampling="4:2:0")
    out["odd_37x53_progressive.jpg"] = save(photo(4, 53, 37), "JPEG", quality=95,
                                            progressive=True, subsampling="4:2:2")
    out["face.jpg"] = save(face_rgb(), "JPEG", quality=90)

    pal = rng.randint(0, 256, (16, 3))
    out["palette_trns.png"] = encode_png(rng.randint(0, 16, (21, 19, 1)), 4, 3, palette=pal,
                                         trns=bytes(rng.randint(0, 256, 16).astype(np.uint8)))
    out["gray_1bit.png"] = encode_png(rng.randint(0, 2, (17, 23, 1)), 1, 0)
    out["gray_2bit_adam7.png"] = encode_png(rng.randint(0, 4, (13, 11, 1)), 2, 0, interlace=1)
    out["rgb_adam7.png"] = encode_png(photo(5, 19, 22), 8, 2, interlace=1)
    out["gray_16bit.png"] = encode_png(rng.randint(0, 65536, (9, 14, 1)), 16, 0)
    out["rgb_16bit.png"] = encode_png(rng.randint(0, 65536, (12, 10, 3)), 16, 2)
    out["rgba_16bit_adam7.png"] = encode_png(rng.randint(0, 65536, (10, 9, 4)), 16, 6,
                                             interlace=1)
    out["gray_alpha_16bit.png"] = encode_png(rng.randint(0, 65536, (7, 8, 2)), 16, 4)

    out["rgb_24bit.bmp"] = save(photo(6, 21, 30), "BMP")
    out["palette_8bit.bmp"] = _save_p(Image, photo(7, 17, 19), "BMP")
    out["rgba_32bit.bmp"] = save(np.dstack([photo(8, 13, 15), rng.randint(0, 256, (13, 15))])
                                 .astype(np.uint8), "BMP")
    out["gray_p5.pgm"] = save(photo(9, 15, 12)[..., 0], "PPM")
    out["rgb_p6.ppm"] = save(photo(10, 11, 16), "PPM")
    return out


def _save_p(Image, rgb, fmt):
    buf = io.BytesIO()
    Image.fromarray(rgb).quantize(colors=40).save(buf, format=fmt)
    return buf.getvalue()


def main(out_dir=OUT):
    os.makedirs(out_dir, exist_ok=True)
    table = {}
    for name, data in sorted(fixtures().items()):
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        mode, arr, rgb = pillow_arrays(path)
        table[name] = {"mode": mode, "bytes": len(data), "image": digest(arr),
                       "rgb": digest(rgb)}
        print(f"{name}: {mode} {arr.shape} {len(data)} bytes")
    with open(os.path.join(out_dir, "formats.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    main(*sys.argv[1:])
