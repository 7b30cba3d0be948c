"""Decode-once raw memmap cache of a PNG dataset (port of
morphganformer_tpu/data/raw_cache.py).

One pass writes every decoded image of `<dataset>/<res>/*.png` to the
contiguous uint8 [N, H, W, 3] `.npy` file `<dataset>/<res>.rawcache` with
its meta JSON beside it; training then gathers batches from it through
np.memmap, with no decode. The file, the meta and the source digest are
those of the JAX package, so a cache written by one package is read by the
other. The cache is the uncompressed dataset (3 MB a 1024^2 image), so it is
opt-in: `--raw-cache` or MGT_RAW_CACHE=1. A changed file list, size or mtime
rebuilds it.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from morphganformer_tpu_torch.data.dataset import dataset_files
from morphganformer_tpu_torch.utils.image import read_png


def _source_digest(files) -> str:
    h = hashlib.sha256()
    for f in files:
        st = os.stat(f)
        h.update(f.encode())
        h.update(str((st.st_size, int(st.st_mtime))).encode())
    return h.hexdigest()[:16]


def _paths(dataset_path: str, resolution: int):
    base = os.path.join(dataset_path, f"{resolution}.rawcache")
    return base, base + ".json"


def _decoder(resolution):
    """The native decoder when its library builds, else `read_png` with
    gray replicated and alpha dropped: the same RGB bytes either way."""
    from morphganformer_tpu_torch.data.native_loader import decode_png, native_available

    if native_available():
        return lambda p: decode_png(p, resolution, resolution)

    def decode(p):
        img = read_png(p)
        img = np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img[:, :, :3]
        if img.shape != (resolution, resolution, 3):
            raise ValueError(f"{p}: shape {img.shape}, expected {(resolution, resolution, 3)}")
        return img

    return decode


def build_raw_cache(dataset_path: str, resolution: int, force: bool = False) -> str:
    """Decode every PNG under <dataset>/<resolution>/ into one uint8
    [N, H, W, 3] file, reused while the source digest matches. Returns the
    raw file's path."""
    files = dataset_files(dataset_path, resolution)
    raw_path, meta_path = _paths(dataset_path, resolution)
    digest = _source_digest(files)
    if not force and os.path.exists(raw_path) and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("digest") == digest:
            return raw_path

    decode = _decoder(resolution)
    shape = (len(files), resolution, resolution, 3)
    tmp = raw_path + ".tmp"
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8, shape=shape)
    for i, f in enumerate(files):
        out[i] = decode(f)
    out.flush()
    del out
    os.replace(tmp, raw_path)
    with open(meta_path, "w") as f:
        json.dump({"digest": digest, "count": len(files), "resolution": resolution,
                   "files": [os.path.basename(p) for p in files]}, f)
    return raw_path


class RawBatchLoader:
    """Infinite shuffled uint8 batches out of the memmap, gathered by one
    background thread ahead of the step. Each shard permutes its slice of
    the index space anew every epoch, from RandomState(seed + shard_index)."""

    def __init__(self, raw_path: str, batch_size: int, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, prefetch: int = 2):
        self.data = np.load(raw_path, mmap_mode="r")
        n = self.data.shape[0]
        self.indices = np.arange(shard_index, n, num_shards)
        if len(self.indices) == 0:
            raise ValueError(f"shard {shard_index}/{num_shards} is empty for {n} items")
        self.batch_size = batch_size
        self.rng = np.random.RandomState(seed + shard_index)
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self._error: Optional[BaseException] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _next_indices(self):
        out = []
        while len(out) < self.batch_size:
            if self._order is None or self._pos >= len(self._order):
                self._order = self.rng.permutation(self.indices)
                self._pos = 0
            take = min(self.batch_size - len(out), len(self._order) - self._pos)
            out.extend(self._order[self._pos:self._pos + take])
            self._pos += take
        return np.asarray(out)

    def _fill(self):
        try:
            while not self._stop.is_set():
                batch = np.ascontiguousarray(self.data[self._next_indices()])
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:      # handed to the consumer by __next__
            self._error = e
            self._stop.set()

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if self._error is not None:
                    raise self._error
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()        # unblock a filler parked in put
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def raw_infinite_batches(dataset_path: str, resolution: int, batch_size: int,
                         shard_index: int = 0, num_shards: int = 1, seed: int = 0,
                         drange=(-1.0, 1.0)):
    """`infinite_batches` backed by the raw cache (built at the first call):
    NHWC float32 batches and empty labels. The cache and the loader are made
    here, so a failure raises at the call."""
    raw_path = build_raw_cache(dataset_path, resolution)
    loader = RawBatchLoader(raw_path, batch_size, seed=seed, shard_index=shard_index,
                            num_shards=num_shards)
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
