"""Training statistics (port of morphganformer_tpu/training/stats.py).

Per-name moment triples [n, sum(x), sum(x^2)] in float64 on the host, read
as mean and std, and written as one stats.jsonl line per tick (reference
torch_utils/training_stats.py). `report_dict` takes the step's stats as
device tensors and copies them to the host in one transfer, so an
iteration's stats cost one synchronisation, not one per stat.

JAX's stats are global already. Under a data mesh each rank here reports
its own rows' stats, so `sync()` (called by every rank, once a tick)
all-reduces the triples over the mesh's data axis (its `group`), as the
reference's training_stats.py:222-226 did; `mean`, `std`, `as_dict` and
`write_jsonl` then read the global triples until the next `report` or
`reset`.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from morphganformer_tpu_torch.parallel.mesh import DataMesh


class Collector:
    """Accumulate [n, sum, sum_sq] per name; query mean/std; jsonl export."""

    def __init__(self, mesh: Optional[DataMesh] = None):
        self.mesh = mesh
        self._moments = defaultdict(lambda: np.zeros(3, np.float64))
        self._synced = None

    def report(self, name: str, value):
        self._synced = None
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

    def sync(self):
        """All-reduce the triples over the mesh's ranks (a collective: every
        rank calls it, with the same names reported). No-op without a
        group."""
        if self.mesh is None or not self.mesh.has_group:
            return
        names = self.names()
        every = [None] * self.mesh.world
        dist.all_gather_object(every, names, group=self.mesh.group)
        if any(n != names for n in every):
            raise RuntimeError(f"the ranks reported different stats: {every}")
        device = self.mesh.device if dist.get_backend() == "nccl" else "cpu"
        flat = torch.tensor(np.stack([self._moments[n] for n in names]) if names
                            else np.zeros((0, 3)), dtype=torch.float64, device=device)
        dist.all_reduce(flat, group=self.mesh.group)
        self._synced = dict(zip(names, flat.cpu().numpy()))

    def _get(self, name):
        if self._synced is not None:
            return self._synced.get(name, np.zeros(3))
        return self._moments[name]

    def mean(self, name: str) -> float:
        m = self._get(name)
        return float(m[1] / m[0]) if m[0] > 0 else float("nan")

    def std(self, name: str) -> float:
        m = self._get(name)
        if m[0] < 1:
            return float("nan")
        mean = m[1] / m[0]
        return float(np.sqrt(max(m[2] / m[0] - mean * mean, 0)))

    def names(self):
        return sorted(self._moments)

    def as_dict(self):
        return {name: {"num": float(self._get(name)[0]),
                       "mean": self.mean(name), "std": self.std(name)}
                for name in self.names()}

    def reset(self):
        self._moments.clear()
        self._synced = None

    def write_jsonl(self, path, **extra):
        """stats.jsonl line per tick (reference training_loop.py:289-294)."""
        entry = dict(self.as_dict(), timestamp=time.time(), **extra)
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
