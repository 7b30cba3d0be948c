"""The native C++ PNG batch loader: ctypes bindings and its build (port of
morphganformer_tpu/data/native_loader.py).

`data/native/png_loader.cpp` (the port's own copy) decodes PNGs with zlib
and assembles shuffled NHWC uint8 batches in worker threads. It is built at
first use with one `g++` call into the port's build directory
(`ops/_build.py`'s BUILD_DIR, gitignored), under a name keyed by a digest of
the source, and loaded with ctypes. It needs `g++` and `zlib.h`; when the
build fails, `native_available()` is False, `build_error()` says why, and
the training loop prints that it reads through another feed. A file that
fails to decode inside a batch is an error here, never a blank image.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from morphganformer_tpu_torch.data.dataset import dataset_files
from morphganformer_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(__file__), "native", "png_loader.cpp")
BUILD_TIMEOUT_S = 300
_lib = None
_build_error: Optional[str] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.md5(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libpngloader-{digest}.so")


def build_command(out_path):
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-lz", "-lpthread",
            "-o", str(out_path)]


def build_library() -> Optional[str]:
    """Compile the shared library unless it is built. Returns its path, or
    None when the build fails (the reason in `build_error()`)."""
    global _build_error
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(build_command(tmp), check=True, capture_output=True, text=True,
                       timeout=BUILD_TIMEOUT_S)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        _build_error = (getattr(e, "stderr", None) or str(e)).strip()
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    os.replace(tmp, out)
    return out


def build_error() -> Optional[str]:
    return _build_error


def get_library():
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte)]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_error_count.restype = ctypes.c_int
    lib.loader_error_count.argtypes = [ctypes.c_void_p]
    lib.png_decode_file.restype = ctypes.c_int
    lib.png_decode_file.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    return get_library() is not None


def decode_png(path, height, width, channels=3) -> np.ndarray:
    """One file through the native decoder, as HWC uint8 with `channels`
    (gray is replicated, alpha dropped, as the batch loader does)."""
    lib = get_library()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    out = np.empty((height, width, channels), dtype=np.uint8)
    rc = lib.png_decode_file(str(path).encode(),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                             height, width, channels)
    if rc != 0:
        raise IOError(f"png_decode_file({path}) failed with {rc}")
    return out


class NativeBatchLoader:
    """Infinite shuffled NHWC uint8 batches decoded by C++ worker threads.
    With more than one thread the order of batches depends on which thread
    finishes first."""

    def __init__(self, files, height, width, channels=3, batch_size=8,
                 num_threads=4, queue_depth=4, seed=0, shard_index=0, num_shards=1):
        self._lib = get_library()
        if self._lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        if not files:
            raise FileNotFoundError("NativeBatchLoader: empty file list (wrong dataset path?)")
        self.shape = (batch_size, height, width, channels)
        arr = (ctypes.c_char_p * len(files))(*[str(f).encode() for f in files])
        self._handle = self._lib.loader_create(
            arr, len(files), height, width, channels, batch_size,
            num_threads, queue_depth, seed, shard_index, num_shards)
        if not self._handle:
            raise ValueError("loader_create rejected the configuration")

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        buf = np.empty(self.shape, dtype=np.uint8)
        rc = self._lib.loader_next(self._handle,
                                   buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if rc != 0:
            raise StopIteration
        errors = self._lib.loader_error_count(self._handle)
        if errors:
            raise IOError(f"the native loader failed to decode {errors} file(s) of the "
                          f"expected size {self.shape[1]}x{self.shape[2]}")
        return buf

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def native_infinite_batches(dataset_path, resolution, batch_size, shard_index=0,
                            num_shards=1, seed=0, drange=(-1.0, 1.0), num_threads=4):
    """`infinite_batches` backed by the C++ loader: NHWC float32 RGB batches
    and empty labels. The file list and the loader are made here, so a wrong
    path or a missing library raises at the call."""
    files = dataset_files(dataset_path, resolution)
    loader = NativeBatchLoader(files, resolution, resolution, 3, batch_size,
                               num_threads=num_threads, seed=seed,
                               shard_index=shard_index, num_shards=num_shards)
    lo, hi = drange
    scale = (hi - lo) / 255.0
    labels = np.zeros((batch_size, 0), dtype=np.float32)

    def _gen():
        try:
            for batch in loader:
                yield batch.astype(np.float32) * scale + lo, labels
        finally:
            loader.close()

    return _gen()
