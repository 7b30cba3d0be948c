"""Image sequences into an animated GIF (port of cli/make_video.py).

JAX's make_video writes a GIF through Pillow, or an mp4 through imageio
when an ffmpeg backend is present. The port needs neither: it encodes
GIF89a itself. Each frame gets its own palette of at most 256 colours by
median cut (no dither), as Pillow's adaptive conversion makes it, and is
LZW-coded; every frame shows for int(1000 / fps) ms, and the NETSCAPE
extension loops the sequence forever. Other containers fall back to a GIF
beside them, as JAX does without an mp4 backend.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

from morphganformer_tpu_torch.utils.image import read_image_rgb

_MAP_CHUNK = 1 << 15   # colours mapped to the palette at once (a [chunk, 256] distance table)


def collect_frames(images=None, list_file=None):
    """The frame paths: the lines of `list_file`, else the sorted PNG and
    JPEG files of the folder `images` (JAX's patterns), each read by
    `read_image_rgb`."""
    if list_file:
        with open(list_file) as f:
            return [line.strip() for line in f if line.strip()]
    files = []
    for e in ("*.png", "*.jpg", "*.jpeg"):
        files += glob.glob(os.path.join(images, e))
    return sorted(files)


def median_cut(img, colors=256):
    """An adaptive palette of at most `colors` entries for an HWC uint8 RGB
    image and each pixel's index into it: the colour cube's box with the
    largest pixels x side is split at its median along its longest side
    until there are `colors` boxes; each entry is its box's mean colour,
    and each pixel takes its nearest entry (no dither)."""
    flat = img.reshape(-1, 3)
    packed = (flat[:, 0].astype(np.int64) << 16) | (flat[:, 1].astype(np.int64) << 8) | flat[:, 2]
    uniq, inverse, counts = np.unique(packed, return_inverse=True, return_counts=True)
    rgb = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)

    def score(box):
        return int(counts[box].sum()) * int(np.ptp(rgb[box], axis=0).max())

    boxes = [np.arange(len(uniq))]
    scores = [score(boxes[0])]
    while len(boxes) < colors and max(scores) > 0:
        i = int(np.argmax(scores))
        box = boxes.pop(i)
        scores.pop(i)
        axis = int(np.argmax(np.ptp(rgb[box], axis=0)))
        box = box[np.argsort(rgb[box, axis], kind="stable")]
        cum = np.cumsum(counts[box])
        cut = int(np.clip(np.searchsorted(cum, cum[-1] / 2), 0, len(box) - 2)) + 1
        boxes += [box[:cut], box[cut:]]
        scores += [score(box[:cut]), score(box[cut:])]
    palette = np.stack([np.rint((rgb[b] * counts[b, None]).sum(0) / counts[b].sum())
                        for b in boxes]).astype(np.uint8)
    pal = palette.astype(np.float32)
    lut = np.empty(len(uniq), np.int64)
    for s in range(0, len(uniq), _MAP_CHUNK):
        c = rgb[s:s + _MAP_CHUNK].astype(np.float32)
        d = (c * c).sum(1)[:, None] - 2 * c @ pal.T + (pal * pal).sum(1)[None]
        lut[s:s + _MAP_CHUNK] = d.argmin(1)
    return palette, lut[inverse].reshape(img.shape[:2]).astype(np.uint8)


def lzw_encode(indices, min_code_size=8):
    """GIF's variable-width LZW of a flat sequence of palette indices: a
    clear code first, codes of 9 to 12 bits packed from the low bit, a clear
    code when the table is full, the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    size, next_code, table = min_code_size + 1, end + 1, {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    emit(clear)
    data = bytes(indices)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            if next_code > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            size, next_code = min_code_size + 1, end + 1
        prefix = k
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data):
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path, frames, duration_ms, loop=0):
    """An animated GIF89a of HWC uint8 RGB frames of one size, each shown
    for `duration_ms` (stored in hundredths of a second, as Pillow stores
    it), looping `loop` times (0: forever)."""
    h, w = frames[0].shape[:2]
    parts = [b"GIF89a", struct.pack("<HHBBB", w, h, 0, 0, 0),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for frame in frames:
        if frame.shape != (h, w, 3):
            raise ValueError(f"frames must all be {h}x{w} RGB, got {frame.shape}")
        palette, idx = median_cut(frame)
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        parts += [b"\x21\xf9\x04\x00" + struct.pack("<H", duration_ms // 10) + b"\x00\x00",
                  b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87), table.tobytes(),
                  b"\x08", _sub_blocks(lzw_encode(idx.reshape(-1)))]
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def write_video(frames, out, fps=24):
    """Frames (PNG or JPEG paths) into `out` at `fps`; returns the path written. A
    name that is not .gif gets JAX's fallback line and a GIF beside it."""
    if not frames:
        raise ValueError("no frames")
    if not out.lower().endswith(".gif"):
        alt = os.path.splitext(out)[0] + ".gif"
        print(f"mp4 backend unavailable (the port encodes GIF only); writing {alt}")
        return write_video(frames, alt, fps)
    write_gif(out, [read_image_rgb(f) for f in frames], int(1000 / fps))
    return out
