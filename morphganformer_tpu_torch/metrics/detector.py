"""The feature detector of FID, KID, IS and P&R (port of
morphganformer_tpu/metrics/detector.py).

The converted InceptionV3 (.npz of `python -m
morphganformer_tpu_torch.tools.convert_inception`) is the
default whenever one is found, through $MGT_INCEPTION_NPZ or
<$MGT_CACHE_DIR or ~/.cache/morphganformer_tpu>/inception.npz; without one
the raw-pixel fallback runs, and says that its values are not comparable to
published ones."""

from __future__ import annotations

import os
from typing import Callable, Union

import numpy as np
import torch


def raw_pixel_detector(max_dim=256) -> Callable:
    """The weight-free fallback: every step-th pixel value of the flattened
    image, at most `max_dim` of them (relative comparisons and smoke runs
    only). Takes numpy arrays or tensors and returns the same kind."""

    def detector(imgs):
        x = imgs.float() if isinstance(imgs, torch.Tensor) else np.asarray(imgs, np.float32)
        flat = x.reshape(x.shape[0], -1)
        step = max(1, flat.shape[1] // max_dim)
        return flat[:, ::step][:, :max_dim]

    return detector


def detector_kind(metric) -> str:
    """The detector output a metric reads: class probabilities for IS,
    features for the others."""
    return "probs" if metric.startswith("is") else "features"


def default_inception_path() -> Union[str, None]:
    """$MGT_INCEPTION_NPZ, else <cache>/inception.npz, else None."""
    env = os.environ.get("MGT_INCEPTION_NPZ")
    if env:
        return env if os.path.exists(env) else None
    cache_root = os.environ.get(
        "MGT_CACHE_DIR", os.path.join(os.path.expanduser("~"), ".cache", "morphganformer_tpu"))
    path = os.path.join(cache_root, "inception.npz")
    return path if os.path.exists(path) else None


def resolve_detector(spec="auto", kind="features", verbose=True, device="cuda") -> Callable:
    """A detector for `spec`: a callable (returned as it is), "raw" (the
    pixel fallback), "auto" or None (the converted InceptionV3 if one is
    found, else raw), or the path of an .npz. InceptionV3 runs on
    `device`."""
    if callable(spec):
        return spec
    if spec == "raw":
        return raw_pixel_detector()
    path = default_inception_path() if spec in (None, "auto") else spec
    if path:
        from morphganformer_tpu_torch.metrics.inception import (load_inception_npz,
                                                                 make_detector)
        params = load_inception_npz(path)
        if verbose:
            print(f"detector: converted InceptionV3 ({path})")
        return make_detector(params, kind=kind, device=device)
    if verbose:
        print("detector: raw-pixel fallback (no converted InceptionV3 found; set "
              "MGT_INCEPTION_NPZ; FID/KID values are NOT comparable to published numbers)")
    return raw_pixel_detector()
