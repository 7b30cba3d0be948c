"""msgpack in the form `flax.serialization` writes, in pure Python.

A checkpoint of the JAX package is `flax.serialization.to_bytes(tree)`: one
msgpack map whose leaves are arrays. This module reads and writes the subset
of msgpack that such a file holds:

    maps with str keys, str, bin, int, float, bool, nil, arrays,
    ext 1  an ndarray: a nested msgpack of (shape, dtype name, C-order bytes)
    ext 3  a numpy scalar, with the same body (read back as a numpy scalar)

An array of more than 2**30 bytes is split, as flax splits it, into
{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
"chunks": {"0": flat0, ...}} and read back as one array. ext 2 (a Python
complex) is refused. A `bfloat16` leaf is read back as a torch.bfloat16
tensor built from its raw 16-bit words (numpy has no such dtype); every
other array comes back as a numpy array.

    msgpack_serialize(tree) -> bytes      (flax `msgpack_serialize`)
    msgpack_restore(data)   -> tree       (flax `msgpack_restore`)
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writer

def _pack_int(n, out):
    if 0 <= n < 128:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"int {n} does not fit msgpack")


def _pack_len(n, fix, fix_top, codes, out):
    """A header of a str, bin, array or map of length n: the fix form below
    `fix_top` (when the type has one), else the 8-, 16- or 32-bit form."""
    if fix is not None and n < fix_top:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(s, out):
    b = s.encode("utf-8")
    _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
    out.append(b)


def _pack_bin(b, out):
    _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
    out.append(b)


def _pack_ext(code, data, out):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]) + struct.pack("b", code))
    else:
        _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(struct.pack("b", code))
    out.append(data)


def _array_body(arr) -> bytes:
    """The nested msgpack (shape, dtype name, C-order bytes) of an array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialised")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = []
    _pack_len(3, 0x90, 16, (None, 0xDC, 0xDD), out)
    _pack_len(len(shape), 0x90, 16, (None, 0xDC, 0xDD), out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(name, out)
    _pack_bin(raw, out)
    return b"".join(out)


def _nbytes(x):
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(arr):
    """flax `_chunk`: the canonical dict of a large array's flat chunks."""
    flat = arr.reshape(-1)
    itemsize = flat.element_size() if isinstance(flat, torch.Tensor) else flat.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(x, out):
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(_chunk(x), out)
        else:
            _pack_ext(EXT_NDARRAY, _array_body(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_body(np.asarray(x)), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        _pack_str(x, out)
    elif isinstance(x, (bytes, bytearray)):
        _pack_bin(bytes(x), out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack_str(k, out)
            _pack(v, out)
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, complex):
        raise TypeError("complex leaves (flax ext 2) are not serialised")
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """`tree` (dicts with str keys, lists, Python scalars, numpy arrays and
    scalars, torch tensors) as flax's msgpack bytes."""
    out = []
    _pack(tree, out)
    return b"".join(out)


# ------------------------------------------------------------------ reader

class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[c])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[c])
            return self.ext(self.unpack("b"), n)
        if c in (0xCA, 0xCB):
            return self.unpack(">f" if c == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[c]
            return self.ext(self.unpack("b"), n)
        if c in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[c]))
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{c:02x} is not used by flax checkpoints")

    def str(self, n):
        return str(self.take(n), "utf-8")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code, n):
        body = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_body(body)
        if code == EXT_NPSCALAR:
            arr = _array_from_body(body)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            raise ValueError("complex leaves (flax ext 2) are not read")
        raise ValueError(f"unknown msgpack ext type {code}")


def _array_from_body(body):
    r = _Reader(body)
    shape, name, raw = r.obj()
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree of flax msgpack bytes: dicts, lists, Python scalars, numpy
    arrays (read-only views of `data`) and torch.bfloat16 tensors."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)
