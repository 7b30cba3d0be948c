"""Image-folder datasets and the infinite shuffled feed (port of
morphganformer_tpu/data/dataset.py).

`ImageFolderDataset` reads `path/{resolution}/*.png` (the per-LoD folder
layout of the dataset tool) with optional `labels.npy`, `max_items` and
mirror augmentation by index doubling; `infinite_batches` yields NHWC float
batches of an endless reshuffled, process-sharded stream. The shuffles use
`np.random.RandomState` exactly as JAX's do, so the same seed gives the same
batches in both packages. PNGs are decoded by the port's `read_png`.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator

import numpy as np

from morphganformer_tpu_torch.utils.image import read_png


def dataset_files(path, resolution):
    """The sorted PNGs under `path/{resolution}/`; raises when there are none."""
    folder = os.path.join(path, str(resolution))
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"Dataset folder {folder} doesn't exist.")
    files = sorted(glob.glob(os.path.join(folder, "*.png")))
    if not files:
        raise FileNotFoundError(f"No .png files in {folder}")
    return files


class ImageFolderDataset:
    """Images under `path/{resolution}/*.png`, NHWC uint8."""

    def __init__(self, path, resolution, max_items=None, use_labels=False,
                 mirror_augment=False, seed=0):
        self.path = path
        self.resolution = resolution
        self.img_files = dataset_files(path, resolution)
        self.name = os.path.splitext(os.path.basename(os.path.normpath(path)))[0]
        self.use_labels = use_labels

        self.idx = np.arange(len(self.img_files), dtype=np.int64)
        if max_items is not None and self.idx.size > max_items:
            rnd = np.random.RandomState(seed)
            rnd.shuffle(self.idx)
            self.idx = np.sort(self.idx[:max_items])

        # Mirror augment doubles the index space (reference dataset.py:35-38).
        self.mirror = np.zeros(self.idx.size, dtype=np.uint8)
        if mirror_augment:
            self.idx = np.tile(self.idx, 2)
            self.mirror = np.concatenate([self.mirror, np.ones_like(self.mirror)])

        self.labels = self._load_labels()

    def _load_labels(self):
        if not self.use_labels:
            return np.zeros([len(self.img_files), 0], dtype=np.float32)
        labels = np.load(os.path.join(self.path, "labels.npy"))
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])

    def __len__(self):
        return self.idx.size

    @property
    def label_shape(self):
        if self.labels.dtype == np.int64:
            return [int(np.max(self.labels)) + 1]
        return list(self.labels.shape[1:])

    @property
    def label_dim(self):
        return self.label_shape[0] if self.label_shape else 0

    def get_label(self, i):
        label = self.labels[self.idx[i]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            return onehot
        return label.copy()

    def __getitem__(self, i):
        img = read_png(self.img_files[self.idx[i]])
        if self.mirror[i]:
            img = img[:, ::-1, :]
        return img.copy(), self.get_label(i)


def infinite_batches(dataset, batch_size, shard_index=0, num_shards=1,
                     seed=0, drange=(-1.0, 1.0)) -> Iterator:
    """Infinite shuffled NHWC float32 batches (and labels), sharded across
    processes: each shard sees indices shard_index::num_shards of an endless
    reshuffled stream (reference InfiniteSampler, torch_utils/misc.py:95-126)."""
    rnd = np.random.RandomState(seed)
    n = len(dataset)
    lo, hi = drange
    scale = (hi - lo) / 255.0
    while True:
        order = rnd.permutation(n)[shard_index::num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            imgs, labels = zip(*(dataset[j] for j in order[i:i + batch_size]))
            x = np.stack(imgs).astype(np.float32) * scale + lo
            yield x, np.stack(labels)
