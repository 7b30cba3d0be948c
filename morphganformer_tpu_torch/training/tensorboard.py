"""TensorBoard event files without TensorFlow (port of
morphganformer_tpu/training/tensorboard.py).

The reference mirrors its per-tick stats into tfevents via
torch.utils.tensorboard (training_loop.py:266-273,295-302); that needs the
tensorboard package, so this writer hand-encodes the two protos involved:

  Event      (tensorflow/core/util/event.proto):
      1: double wall_time   2: int64 step   3: string file_version
      5: Summary summary
  Summary / Summary.Value (tensorflow/core/framework/summary.proto):
      Summary.value = repeated field 1; Value.tag = field 1 (string),
      Value.simple_value = field 2 (float)

framed as TFRecords: <len:uint64le> <masked_crc32c(len)> <data>
<masked_crc32c(data)>. The bytes are those of the JAX package's writer.
"""

from __future__ import annotations

import os
import struct
import time

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(step: int, scalars, wall_time=None) -> bytes:
    values = b"".join(
        _bytes(1, _bytes(1, tag.encode()) + _float(2, float(v)))
        for tag, v in scalars.items())
    return (_double(1, wall_time if wall_time is not None else time.time())
            + _int64(2, step) + _bytes(5, values))


# ---------------------------------------------------------------- writer

class EventWriter:
    """Append-only tfevents writer: add_scalars(step, {tag: value})."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}{suffix}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._record(_double(1, time.time()) + _bytes(3, b"brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, step: int, scalars):
        if scalars:
            self._record(_scalar_event(step, scalars))
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
