"""Feature statistics of the evaluation metrics (port of
morphganformer_tpu/metrics/feature_stats.py).

Reference metrics/metric_utils.py: `FeatureStats` (:47-123), the raw
features and/or the running mean and covariance, accumulated on the host in
float64 numpy; the dataset-stats cache keyed by md5 (:176-195). The cache is
a pickle of the object's `__dict__` (plain numpy arrays, lists and ints), so
a cache written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Optional

import numpy as np


class FeatureStats:
    """Accumulate raw features and/or the running mean and covariance."""

    def __init__(self, capture_all=False, capture_mean_cov=False,
                 max_items: Optional[int] = None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features: int):
        if self.num_features is not None:
            assert num_features == self.num_features
        else:
            self.num_features = num_features
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self) -> bool:
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        """Add a batch of features [N, F] (numpy, or anything `np.asarray`
        reads) as float32; past `max_items` the rest is dropped."""
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self) -> np.ndarray:
        assert self.capture_all
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        assert self.capture_mean_cov
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path):
        """Pickle the state, written atomically (metric_utils.py:213-217)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(self.__dict__, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


def stats_cache_key(dataset_tag: str, detector_tag: str, max_items) -> str:
    """The stats cache's file name, keyed by md5 (metric_utils.py:176-186)."""
    h = hashlib.md5(f"{dataset_tag}|{detector_tag}|{max_items}".encode()).hexdigest()
    return f"{dataset_tag.split('/')[-1]}-{detector_tag}-{h[:16]}.pkl"
