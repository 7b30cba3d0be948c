"""Training statistics (port of morphganformer_tpu/training/stats.py).

Per-name moment triples [n, sum(x), sum(x^2)] in float64 on the host, read
as mean and std, and written as one stats.jsonl line per tick (reference
torch_utils/training_stats.py). `report_dict` takes the step's stats as
device tensors and copies them to the host in one transfer, so an
iteration's stats cost one synchronisation, not one per stat.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


class Collector:
    """Accumulate [n, sum, sum_sq] per name; query mean/std; jsonl export."""

    def __init__(self):
        self._moments = defaultdict(lambda: np.zeros(3, np.float64))

    def report(self, name: str, value):
        value = np.asarray(value, dtype=np.float64).ravel()
        m = self._moments[name]
        m[0] += value.size
        m[1] += value.sum()
        m[2] += np.square(value).sum()

    def report_dict(self, d: Dict):
        """Report every entry; the tensors among them reach the host in one
        copy (concatenated on their device, then `.cpu()`)."""
        tensors = {k: v for k, v in d.items() if isinstance(v, torch.Tensor)}
        if tensors:
            flat = [v.detach().reshape(-1).to(torch.float64) for v in tensors.values()]
            host = torch.cat(flat).cpu().numpy()
            parts = np.split(host, np.cumsum([f.numel() for f in flat])[:-1])
            d = {**d, **dict(zip(tensors, parts))}
        for k, v in d.items():
            self.report(k, v)

    def mean(self, name: str) -> float:
        m = self._moments[name]
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        m = self._moments[name]
        if m[0] < 1:
            return float("nan")
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean * mean, 0)))

    def names(self):
        return sorted(self._moments)

    def as_dict(self):
        return {name: {"num": float(self._moments[name][0]),
                       "mean": self.mean(name), "std": self.std(name)}
                for name in self.names()}

    def reset(self):
        self._moments.clear()

    def write_jsonl(self, path, **extra):
        """stats.jsonl line per tick (reference training_loop.py:289-294)."""
        entry = dict(self.as_dict(), timestamp=time.time(), **extra)
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
