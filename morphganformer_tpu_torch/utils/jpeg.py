"""JPEG decoding in numpy, equal to Pillow's (libjpeg-turbo's) to the bit.

Pillow opens a JPEG through libjpeg-turbo with its defaults, and this module
computes what those stages compute:

- the entropy decode (Huffman only): baseline and extended sequential
  (SOF0, SOF1) and progressive (SOF2: spectral selection and successive
  approximation, DC and AC, first and refining scans, EOB runs), with
  restart intervals (DRI, RST0-7), byte stuffing and fill bytes. It runs on
  the host, one table lookup per symbol over a 16-bit peek;
- dequantisation and the "islow" integer IDCT (`jidctint.c`
  `jpeg_idct_islow`: CONST_BITS 13, PASS1_BITS 2), each output clamped to
  0-255 as the SIMD build clamps it;
- "fancy" upsampling (`jdsample.c`: `h2v1_fancy_upsample`,
  `h1v2_fancy_upsample` and `h2v2_fancy_upsample`, with their alternating
  rounding biases and the edge rows and columns replicated; plain
  replication for the other integral ratios and for rows two samples wide
  or less);
- `jdcolor.c`'s fixed-point YCbCr-to-RGB tables (SCALEBITS 16); a
  3-component image is taken as RGB where libjpeg takes it so (an Adobe
  APP14 marker with transform 0, or component ids 'R', 'G', 'B' with no JFIF
  or Adobe marker).

Dequantisation, the IDCT, upsampling and colour conversion are vectorised
over all blocks in numpy (the IDCT's sums in int64, as libjpeg's JLONG).
A 1-component image opens as mode "L" [h, w], a 3-component one as "RGB"
[h, w, 3].

libjpeg smooths the blocks of a progressive image (`decompress_smooth_data`)
only while some of the first AC coefficients are still unrefined, which a
complete scan script leaves none of; a file whose script leaves them
unrefined is refused. Refused by name: arithmetic coding (SOF9-SOF11,
SOF13-SOF15), lossless (SOF3), hierarchical (SOF5-SOF7, DHP, EXP), 12-bit
precision, 2 or 4 components (CMYK, YCCK), non-integral sampling ratios
and a height given by DNL. A corrupt file raises ValueError naming the
stage it was in.
"""

from __future__ import annotations

import re
import struct

import numpy as np

from morphganformer_tpu_torch.utils.image import Decoded, ImageFormatError, refuse

# Zig-zag position -> natural (row-major) index, with libjpeg's 16 extra
# entries so that a corrupt run past the block's end stays in it.
ZIGZAG = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41,
          34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
          37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63) + (63,) * 16
_HALF = [0] + [1 << (s - 1) for s in range(1, 17)]     # extend(): v < half[s] is negative
_SPAN = [0] + [(1 << s) - 1 for s in range(1, 17)]
_MARKER = re.compile(rb"\xff+([^\x00\xff])")
_STUFFED = re.compile(rb"\xff+\x00")
_SMOOTHING_COEFS = 10          # libjpeg-turbo's SAVED_COEFS: DC and the first 9 AC
_ARITHMETIC = "arithmetic coding is not implemented"
_HIERARCHICAL = "hierarchical coding is not implemented"
_REFUSED_SOF = {0xC3: ("a lossless JPEG (SOF3)", "lossless coding is not implemented"),
                0xC5: ("a hierarchical JPEG (SOF5)", _HIERARCHICAL),
                0xC6: ("a hierarchical JPEG (SOF6)", _HIERARCHICAL),
                0xC7: ("a hierarchical JPEG (SOF7)", _HIERARCHICAL),
                0xC9: ("an arithmetic-coded JPEG (SOF9)", _ARITHMETIC),
                0xCA: ("an arithmetic-coded JPEG (SOF10)", _ARITHMETIC),
                0xCB: ("an arithmetic-coded JPEG (SOF11)", _ARITHMETIC),
                0xCC: ("an arithmetic-coded JPEG (DAC)", _ARITHMETIC),
                0xCD: ("an arithmetic-coded hierarchical JPEG (SOF13)",
                       "arithmetic and hierarchical coding are not implemented"),
                0xCE: ("an arithmetic-coded hierarchical JPEG (SOF14)",
                       "arithmetic and hierarchical coding are not implemented"),
                0xCF: ("an arithmetic-coded hierarchical JPEG (SOF15)",
                       "arithmetic and hierarchical coding are not implemented"),
                0xDC: ("a JPEG whose height is given by DNL", "a DNL marker is not implemented"),
                0xDE: ("a hierarchical JPEG (DHP)", _HIERARCHICAL),
                0xDF: ("a hierarchical JPEG (EXP)", _HIERARCHICAL)}


class _Fail(Exception):
    """A corrupt file: (stage, message)."""


class _Component:
    __slots__ = ("id", "h", "v", "tq", "bw", "bh", "cw", "ch", "coef", "quant", "coef_bits",
                 "pred")

    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant = None
        self.coef_bits = [-1] * 64


class _Frame:
    def __init__(self, path):
        self.path = path
        self.sof = None
        self.width = self.height = 0
        self.comps = []
        self.qt = {}
        self.dc = {}
        self.ac = {}
        self.restart = 0
        self.jfif = False
        self.adobe = None
        self.scans = 0
        self.mcux = self.mcuy = self.hmax = self.vmax = 0


def _huffman_lut(counts, symbols):
    """The 16-bit peek table of one Huffman table: entry (length << 8) |
    symbol for every 16-bit string that starts with a code; 0 where none."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise _Fail("Huffman table", "code lengths overflow")
            shift = 16 - length
            lut[code << shift:(code + 1) << shift] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data, pos):
    """The entropy-coded data of a scan from `pos`: a list of 32-bit
    big-endian windows, one per byte, for each restart interval (the bytes
    unstuffed), and the offset of the marker that ends the scan."""
    segs = []
    start = pos
    while True:
        m = _MARKER.search(data, pos)
        end = m.start() if m else len(data)
        code = m.group(1)[0] if m else 0xD9
        segs.append(_windows(_STUFFED.sub(b"\xff", data[start:end])))
        if m is None:
            return segs, len(data)
        if 0xD0 <= code <= 0xD7:
            start = pos = m.end()
            continue
        return segs, end


def _windows(seg):
    b = np.frombuffer(seg + b"\x00" * 8, np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _parse(path, data, headers_only=False):
    """Walk the markers; decode every scan unless `headers_only`. Then a
    sequential frame stops at its first SOS, after the refusals are
    checked, and a progressive one reads every scan's header and skips its
    data, so that the coefficients its script leaves unrefined are known."""
    fr = _Frame(path)
    if data[:2] != b"\xff\xd8":
        raise _Fail("markers", "no SOI")
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                       # garbage before a marker (libjpeg warns, skips)
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            if fr.scans:
                return fr                  # no EOI: libjpeg warns and ends the image
            raise _Fail("markers", "the file ends before the first scan")
        code = data[pos]
        pos += 1
        if code == 0xD9:
            return fr
        if code == 0x01 or 0xD0 <= code <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise _Fail("markers", f"marker 0xFF{code:02X} cut short")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            raise _Fail("markers", f"marker 0xFF{code:02X} cut short")
        pos += length
        if code in _REFUSED_SOF:
            refuse(path, *_REFUSED_SOF[code])
        if code in (0xC0, 0xC1, 0xC2):
            _sof(fr, code, body)
        elif code == 0xC4:
            _dht(fr, body)
        elif code == 0xDB:
            _dqt(fr, body)
        elif code == 0xDD:
            fr.restart = struct.unpack(">H", body[:2])[0]
        elif code == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            fr.jfif = True
        elif code == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            fr.adobe = body[11]
        elif code == 0xDA:
            if fr.sof is None:
                raise _Fail("markers", "SOS before SOF")
            if headers_only and fr.sof != 0xC2:
                return fr
            if headers_only:
                _scan_header(fr, body)
                pos = _scan_end(data, pos)
            else:
                pos = _scan(fr, data, pos, body)
            fr.scans += 1


def _sof(fr, code, body):
    if fr.sof is not None:
        raise _Fail("markers", "a second SOF")
    precision, height, width, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        refuse(fr.path, f"a {precision}-bit JPEG", "only 8-bit samples are read")
    if height == 0:
        refuse(fr.path, *_REFUSED_SOF[0xDC])
    if n == 4:
        refuse(fr.path, "a 4-component (CMYK or YCCK) JPEG",
               "CMYK and YCCK are not implemented")
    if n not in (1, 3):
        refuse(fr.path, f"a {n}-component JPEG", "only 1 or 3 components are read")
    fr.sof, fr.height, fr.width = code, height, width
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise _Fail("frame header", f"sampling factors {hv >> 4}x{hv & 15}")
        fr.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    hmax = max(c.h for c in fr.comps)
    vmax = max(c.v for c in fr.comps)
    if any(hmax % c.h or vmax % c.v for c in fr.comps):
        refuse(fr.path, "a JPEG with non-integral sampling ratios "
               + "/".join(f"{c.h}x{c.v}" for c in fr.comps),
               "libjpeg does not implement fractional upsampling either")
    mx = -(-width // (8 * hmax))
    my = -(-height // (8 * vmax))
    for c in fr.comps:
        c.bw, c.bh = mx * c.h, my * c.v
        c.cw = -(-width * c.h // hmax)
        c.ch = -(-height * c.v // vmax)
        c.coef = [0] * (c.bw * c.bh * 64)
    fr.mcux, fr.mcuy, fr.hmax, fr.vmax = mx, my, hmax, vmax


def _dht(fr, body):
    pos = 0
    while pos < len(body):
        tc_th = body[pos]
        counts = body[pos + 1:pos + 17]
        n = sum(counts)
        symbols = body[pos + 17:pos + 17 + n]
        if len(counts) != 16 or len(symbols) != n:
            raise _Fail("Huffman table", "DHT cut short")
        (fr.ac if tc_th >> 4 else fr.dc)[tc_th & 15] = _huffman_lut(counts, symbols)
        pos += 17 + n


def _dqt(fr, body):
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        if pq:
            vals = struct.unpack(">64H", body[pos + 1:pos + 129])
            pos += 129
        else:
            vals = tuple(body[pos + 1:pos + 65])
            pos += 65
        natural = [0] * 64
        for k, v in enumerate(vals):
            natural[ZIGZAG[k]] = v
        fr.qt[tq] = natural


def _scan_header(fr, body):
    """Check one scan's header, latch its components' quantisation tables
    and mark in their `coef_bits` the coefficients it codes; returns
    (components, (DC, AC) table ids, Ss, Se, Ah, Al)."""
    n = body[0]
    comps, tables = [], []
    for i in range(n):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        c = next((c for c in fr.comps if c.id == cid), None)
        if c is None:
            raise _Fail("scan header", f"component id {cid} is not in the frame")
        comps.append(c)
        tables.append((t >> 4, t & 15))
    if n > 1 and sum(c.h * c.v for c in comps) > 10:
        raise _Fail("scan header", "more than 10 blocks in an MCU (libjpeg refuses it too)")
    ss, se, a = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n]
    ah, al = a >> 4, a & 15
    progressive = fr.sof == 0xC2
    if not progressive and (ss, se, ah, al) != (0, 63, 0, 0):
        raise _Fail("scan header", f"sequential scan with Ss={ss} Se={se} Ah={ah} Al={al}")
    if progressive and ((ss == 0) != (se == 0) or se > 63 or ss > se or (ss and n != 1)):
        raise _Fail("scan header", f"progressive scan with Ss={ss} Se={se} over {n} components")
    for c in comps:                           # libjpeg latches the table at a first scan
        if c.quant is None:
            if c.tq not in fr.qt:
                raise _Fail("scan header", f"quantisation table {c.tq} is not defined")
            c.quant = fr.qt[c.tq]
        for k in range(ss, se + 1):
            c.coef_bits[k] = al
    return comps, tables, ss, se, ah, al


def _scan_end(data, pos):
    """The offset of the marker that ends the scan whose data starts at
    `pos` (a restart marker does not)."""
    while (m := _MARKER.search(data, pos)) is not None:
        if not 0xD0 <= m.group(1)[0] <= 0xD7:
            return m.start()
        pos = m.end()
    return len(data)


def _scan(fr, data, pos, body):
    """Decode one scan into the components' coefficients; returns the
    offset of the marker after it."""
    comps, tables, ss, se, ah, al = _scan_header(fr, body)
    progressive = fr.sof == 0xC2
    try:
        dcs = [fr.dc[td] if (ss == 0 and ah == 0) else None for td, _ in tables]
        acs = [fr.ac[ta] if se else None for _, ta in tables]
    except KeyError as e:
        raise _Fail("scan header", f"Huffman table {e.args[0]} is not defined") from None
    segs, end = _segments(data, pos)
    mcus = _mcus(fr, comps, dcs, acs)
    try:
        if not progressive:
            _decode_sequential(fr, mcus, segs)
        elif ss == 0:
            _decode_dc(fr, mcus, segs, ah, al)
        elif ah == 0:
            _decode_ac_first(fr, mcus, segs, ss, se, al)
        else:
            _decode_ac_refine(fr, mcus, segs, ss, se, al)
    except IndexError:
        raise _Fail("entropy decode", "the scan's data ends early") from None
    return end


def _mcus(fr, comps, dcs, acs):
    """The blocks of each MCU of a scan, in order: (component, DC table,
    AC table, offset of the block's first coefficient)."""
    if len(comps) == 1:
        c, dc, ac = comps[0], dcs[0], acs[0]
        return [[(c, dc, ac, (by * c.bw + bx) * 64)]
                for by in range(-(-c.ch // 8)) for bx in range(-(-c.cw // 8))]
    out = []
    for my in range(fr.mcuy):
        for mx in range(fr.mcux):
            mcu = []
            for c, dc, ac in zip(comps, dcs, acs):
                for v in range(c.v):
                    row = (my * c.v + v) * c.bw + mx * c.h
                    mcu += [(c, dc, ac, (row + h) * 64) for h in range(c.h)]
            out.append(mcu)
    return out


def _restart_parts(fr, mcus, segs):
    """(windows, the MCUs read from them) for each restart interval."""
    ri = fr.restart
    if not ri:
        return [(segs[0], mcus)]
    parts = []
    for i in range(0, len(mcus), ri):
        j = i // ri
        parts.append((segs[j] if j < len(segs) else _windows(b""), mcus[i:i + ri]))
    return parts


def _decode_sequential(fr, mcus, segs):
    zz, half, span = ZIGZAG, _HALF, _SPAN
    for win, part in _restart_parts(fr, mcus, segs):
        p = 0
        for c in fr.comps:
            c.pred = 0
        for mcu in part:
            for c, dc, ac, off in mcu:
                coef = c.coef
                t = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += t >> 8
                s = t & 255
                if s:
                    v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                    p += s
                    if v < half[s]:
                        v -= span[s]
                    c.pred += v
                coef[off] = c.pred
                k = 1
                while k < 64:
                    t = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += t >> 8
                    rs = t & 255
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                        p += s
                        if v < half[s]:
                            v -= span[s]
                        coef[off + zz[k]] = v
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break


def _decode_dc(fr, mcus, segs, ah, al):
    half, span = _HALF, _SPAN
    bit = 1 << al
    for win, part in _restart_parts(fr, mcus, segs):
        p = 0
        for c in fr.comps:
            c.pred = 0
        for mcu in part:
            for c, dc, _, off in mcu:
                if ah:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1:
                        c.coef[off] |= bit
                    p += 1
                    continue
                t = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += t >> 8
                s = t & 255
                if s:
                    v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                    p += s
                    if v < half[s]:
                        v -= span[s]
                    c.pred += v
                c.coef[off] = c.pred << al


def _decode_ac_first(fr, mcus, segs, ss, se, al):
    zz, half, span = ZIGZAG, _HALF, _SPAN
    for win, part in _restart_parts(fr, mcus, segs):
        p = 0
        eobrun = 0
        for mcu in part:
            c, _, ac, off = mcu[0]
            if eobrun:
                eobrun -= 1
                continue
            coef = c.coef
            k = ss
            while k <= se:
                t = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += t >> 8
                rs = t & 255
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                    p += s
                    if v < half[s]:
                        v -= span[s]
                    coef[off + zz[k]] = v << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - r)
                        p += r
                    eobrun -= 1
                    break


def _decode_ac_refine(fr, mcus, segs, ss, se, al):
    zz = ZIGZAG
    p1, m1 = 1 << al, -1 << al
    for win, part in _restart_parts(fr, mcus, segs):
        p = 0
        eobrun = 0
        for mcu in part:
            c, _, ac, off = mcu[0]
            coef = c.coef
            k = ss
            if not eobrun:
                while k <= se:
                    t = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += t >> 8
                    rs = t & 255
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                        p += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - r)
                            p += r
                        break
                    while k <= se:
                        i = off + zz[k]
                        cv = coef[i]
                        if cv:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1:
                                if not cv & p1:
                                    coef[i] = cv + (p1 if cv >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        coef[off + zz[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    i = off + zz[k]
                    cv = coef[i]
                    if cv:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1:
                            if not cv & p1:
                                coef[i] = cv + (p1 if cv >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1


def _islow_pass(d, shift):
    """One pass of jpeg_idct_islow on the 8 inputs `d` (arrays): the 8
    outputs descaled by `shift` bits."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * 4433                       # FIX_0_541196100
    tmp2 = z1 + z3 * -15137                     # FIX_1_847759065
    tmp3 = z1 + z2 * 6270                       # FIX_0_765366865
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                       # FIX_1_175875602
    t0 = t0 * 2446                              # FIX_0_298631336
    t1 = t1 * 16819                             # FIX_2_053119869
    t2 = t2 * 25172                             # FIX_3_072711026
    t3 = t3 * 12299                             # FIX_1_501321110
    z1 = z1 * -7373                             # FIX_0_899976223
    z2 = z2 * -20995                            # FIX_2_562915447
    z3 = z3 * -16069 + z5                       # FIX_1_961570560
    z4 = z4 * -3196 + z5                        # FIX_0_390180644
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    return [(x + r) >> shift for x in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                       tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow(coef, quant):
    """Dequantise and inverse-transform blocks [N, 64] (natural order) with
    the quantisation table `quant` [64]: samples [N, 8, 8] uint8."""
    blk = (np.asarray(coef, np.int64).reshape(-1, 8, 8)
           * np.asarray(quant, np.int64).reshape(8, 8))
    ws = np.stack(_islow_pass([blk[:, k, :] for k in range(8)], 11), axis=1)   # columns
    out = np.stack(_islow_pass([ws[:, :, k] for k in range(8)], 18), axis=2)   # rows
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(plane, fh, fv):
    """A component's samples [ch, cw] uint8 upsampled by (fh, fv) as
    libjpeg-turbo's jdsample.c does with fancy upsampling on."""
    ch, cw = plane.shape
    x = plane.astype(np.int32)
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (2, 1) and cw > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((ch, 2 * cw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (1, 2):
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * ch, cw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if (fh, fv) == (2, 2) and cw > 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * ch, 2 * cw), np.int32)
        for v, near in ((0, up), (1, down)):
            cs = 3 * x + near
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * cs + left + 8) >> 4
            out[v::2, 1::2] = (3 * cs + right + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


def _tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(f):
        return int(f * 65536 + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


_CR_R, _CB_B, _CR_G, _CB_G = _tables()


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert on uint8 planes: [h, w, 3] uint8."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def _is_rgb(fr):
    """libjpeg's guess of a 3-component image's colour space: RGB or YCbCr."""
    if fr.jfif:
        return False
    if fr.adobe is not None:
        return fr.adobe == 0
    return tuple(c.id for c in fr.comps) == (82, 71, 66)


def _check_smoothing(fr):
    if fr.sof != 0xC2:
        return
    for c in fr.comps:
        if c.coef_bits[0] < 0:
            raise _Fail("progressive scans", f"component {c.id}'s DC is never coded")
        if any(b != 0 for b in c.coef_bits[1:_SMOOTHING_COEFS]):
            refuse(fr.path, "a progressive JPEG whose scans leave coefficients unrefined",
                   "libjpeg's interblock smoothing of such files is not implemented")


def check_jpeg(path, data):
    """Raise on a JPEG the decoder refuses, from its headers alone (every
    scan's of a progressive one, so a script that leaves coefficients
    unrefined is refused here too), as `decode_jpeg` raises."""
    try:
        _check_smoothing(_parse(path, data, headers_only=True))
    except _Fail as e:
        raise ValueError(f"{path}: JPEG {e.args[0]}: {e.args[1]}") from None
    except ImageFormatError:
        raise
    except (IndexError, ValueError, struct.error) as e:
        raise ValueError(f"{path}: JPEG markers: {e}") from None


def decode_jpeg(path, data=None):
    """A JPEG as Pillow opens it: Decoded(array, "L" or "RGB")."""
    if data is None:
        with open(path, "rb") as f:
            data = f.read()
    stage = "markers"
    try:
        fr = _parse(path, data)
        if not fr.scans:
            raise _Fail("markers", "no scan")
        _check_smoothing(fr)
        stage = "IDCT"
        planes = []
        for c in fr.comps:
            # A component that no scan reached holds zeros (and no latched table).
            blocks = idct_islow(c.coef, c.quant or [1] * 64)
            plane = blocks.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(
                8 * c.bh, 8 * c.bw)[:c.ch, :c.cw]
            planes.append(plane)
        stage = "upsampling"
        planes = [_upsample(p, fr.hmax // c.h, fr.vmax // c.v)[:fr.height, :fr.width]
                  for p, c in zip(planes, fr.comps)]
    except _Fail as e:
        raise ValueError(f"{path}: JPEG {e.args[0]}: {e.args[1]}") from None
    except ImageFormatError:
        raise
    except (IndexError, ValueError, struct.error) as e:
        raise ValueError(f"{path}: JPEG {stage}: {e}") from None
    if len(planes) == 1:
        return Decoded(planes[0], "L")
    if _is_rgb(fr):
        return Decoded(np.stack(planes, axis=2), "RGB")
    return Decoded(ycc_to_rgb(*planes), "RGB")
