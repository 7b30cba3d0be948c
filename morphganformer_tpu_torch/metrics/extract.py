"""Feature extraction of the metrics (port of
morphganformer_tpu/metrics/extract.py).

Reference metrics/metric_utils.py: the dataset side with its stats cache
(:166-208) and the generator side (:222-263: z ~ N(0, 1), G at psi 1,
[-1, 1] -> the uint8 grid before the detector). `detector` is any callable
NHWC images in [0, 255] -> features; `dataset` any iterable of NHWC batches;
`G` the port's Generator (z drawn from an explicit torch.Generator, G on
its own device with const noise) or a callable (gen, batch) -> images.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np
import torch

from morphganformer_tpu_torch.metrics.feature_stats import FeatureStats


def _to_detector_range(imgs):
    """[-1, 1] -> the reference's uint8 grid as float, to the bit
    (metric_utils.py:250-252: `(img * 127.5 + 128).clamp(0, 255).to(uint8)`:
    +128, not +127.5, and the truncation of the cast). Inputs already in the
    uint8 range (dataset images) are only clamped. A tensor stays a tensor
    on its device, a numpy array stays numpy."""
    if isinstance(imgs, torch.Tensor):
        x = imgs.float()
        if x.max().item() <= 1.5:                      # assume [-1, 1]
            return torch.clamp(x * 127.5 + 128.0, 0, 255).to(torch.uint8).float()
        return torch.clamp(x, 0, 255)
    x = np.asarray(imgs, dtype=np.float32)
    if x.max() <= 1.5:
        return np.clip(x * 127.5 + 128.0, 0, 255).astype(np.uint8).astype(np.float32)
    return np.clip(x, 0, 255)


def _host(feats):
    """Detector output as a host float32 array."""
    if isinstance(feats, torch.Tensor):
        return feats.detach().float().cpu().numpy()
    return np.asarray(feats, dtype=np.float32)


def features_for_dataset(detector, dataset: Iterable, max_items=None, capture_all=False,
                         capture_mean_cov=False, cache_path: Optional[str] = None, **_kw):
    """Detector features over a dataset iterable, with an optional stats
    cache (metric_utils.py:176-195)."""
    if cache_path is not None and os.path.exists(cache_path):
        return FeatureStats.load(cache_path)
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    for batch in dataset:
        if stats.is_full():
            break
        stats.append(_host(detector(_to_detector_range(batch))))
    if cache_path is not None:
        stats.save(cache_path)
    return stats


def make_sampler(G, batch):
    """gen -> NHWC images in [-1, 1]: the Generator at psi 1 with const
    noise, z [batch, k, z_dim] drawn from the CPU torch.Generator `gen`; or
    a callable G(gen, batch)."""
    if not isinstance(G, torch.nn.Module):
        return lambda gen: G(gen, batch)
    dev, cfg = next(G.parameters()).device, G.cfg

    @torch.no_grad()
    def sample(gen):
        z = torch.randn((batch, cfg.k, cfg.z_dim), generator=gen).to(dev)
        return G(z=z, truncation_psi=1.0, noise_mode="const")

    return sample


def features_for_generator(detector, G, max_items=50000, batch=16, capture_all=False,
                           capture_mean_cov=False, seed=0, **_kw):
    """Sample z -> G -> detector until `max_items` (metric_utils.py:222-263);
    z from a torch.Generator seeded with `seed`."""
    sample = make_sampler(G, batch)
    stats = FeatureStats(capture_all=capture_all, capture_mean_cov=capture_mean_cov,
                         max_items=max_items)
    gen = torch.Generator().manual_seed(seed)
    while not stats.is_full():
        stats.append(_host(detector(_to_detector_range(sample(gen)))))
    return stats


def probs_for_generator(detector, G, max_items=50000, batch=16, seed=0, **_kw):
    """Class probabilities of generated images, for IS."""
    stats = features_for_generator(detector, G, max_items=max_items, batch=batch,
                                   capture_all=True, seed=seed)
    return stats.get_all()
