"""The metric registry and its report (port of
morphganformer_tpu/metrics/registry.py).

Reference metrics/metric_main.py: the @register_metric registry (:19-29),
`compute_metric` returning a results dict (:32-77) and the
metric-<name>.jsonl line (:79-91). The registered metrics and their sample
counts are JAX's (metric_main.py:95-135): fid50k_full, fid2k_full,
kid50k_full, pr50k3_full, is50k and the ppl_* family. `G` is the port's
Generator; `device` is where P&R's distances run (the card by default).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict

from morphganformer_tpu_torch.metrics import core
from morphganformer_tpu_torch.metrics.extract import (
    features_for_dataset,
    features_for_generator,
    probs_for_generator,
)

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn):
    assert fn.__name__ not in _metric_dict
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(name):
    return name in _metric_dict


def list_valid_metrics():
    return sorted(_metric_dict)


def compute_metric(metric: str, **kwargs):
    """Run a registered metric: its results, name and time (metric_main.py
    :32-77)."""
    assert is_valid_metric(metric), f"unknown metric {metric}; valid: {list_valid_metrics()}"
    start = time.time()
    results = _metric_dict[metric](**kwargs)
    total_time = time.time() - start
    return dict(results=results, metric=metric, total_time=total_time,
                total_time_str=f"{int(total_time)}s", num_gpus=kwargs.get("num_devices", 1))


def report_metric(result_dict, run_dir=None, snapshot_pkl=None):
    """Print the result's JSON line and append it to
    <run_dir>/metric-<name>.jsonl (metric_main.py:79-91)."""
    metric = result_dict["metric"]
    jsonl_line = json.dumps(dict(result_dict, snapshot_pkl=snapshot_pkl, timestamp=time.time()))
    print(jsonl_line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{metric}.jsonl"), "a") as f:
            f.write(jsonl_line + "\n")


# ------------------------------------------------------------ the metrics
# detector: a callable NHWC images in [0, 255] -> features (detector.py).

def _fid(name, detector, dataset, G, max_items, kw):
    real = features_for_dataset(detector, dataset, max_items=max_items, capture_mean_cov=True,
                                **kw)
    gen = features_for_generator(detector, G, max_items=max_items, capture_mean_cov=True, **kw)
    return {name: core.compute_fid_from_stats(real, gen)}


@register_metric
def fid50k_full(detector=None, dataset=None, G=None, max_items=50000, **kw):
    return _fid("fid50k_full", detector, dataset, G, max_items, kw)


@register_metric
def fid2k_full(detector=None, dataset=None, G=None, max_items=2000, **kw):
    return _fid("fid2k_full", detector, dataset, G, max_items, kw)


@register_metric
def kid50k_full(detector=None, dataset=None, G=None, max_items=50000, **kw):
    real = features_for_dataset(detector, dataset, max_items=max_items, capture_all=True, **kw)
    gen = features_for_generator(detector, G, max_items=max_items, capture_all=True, **kw)
    kid = core.compute_kid_from_features(real.get_all(), gen.get_all(), num_subsets=100,
                                         max_subset_size=1000)
    return {"kid50k_full": kid}


@register_metric
def pr50k3_full(detector=None, dataset=None, G=None, max_items=50000, device="cuda", **kw):
    real = features_for_dataset(detector, dataset, max_items=max_items, capture_all=True, **kw)
    gen = features_for_generator(detector, G, max_items=max_items, capture_all=True, **kw)
    p, r = core.compute_pr_from_features(real.get_all(), gen.get_all(), nhood_size=3,
                                         device=device)
    return {"pr50k3_full_precision": p, "pr50k3_full_recall": r}


@register_metric
def is50k(detector=None, G=None, max_items=50000, **kw):
    probs = probs_for_generator(detector, G, max_items=max_items, **kw)
    mean, std = core.compute_is_from_probs(probs, num_splits=10)
    return {"is50k_mean": mean, "is50k_std": std}


def _ppl(name, space, sampling, G=None, feature_fn=None, max_items=50000, batch=2, **kw):
    """The PPL family (metric_main.py ppl_{z,w}{full,end}, batch 2). JAX's
    registry passes no feature net and fails inside; the port raises a
    ValueError that says so."""
    from morphganformer_tpu_torch.metrics.ppl import compute_ppl

    return {name: compute_ppl(G, feature_fn, num_samples=max_items, batch=batch, space=space,
                              sampling=sampling, crop=kw.get("crop", True),
                              plain=kw.get("plain", False))}


@register_metric
def ppl_zfull(**kw):
    return _ppl("ppl_zfull", "z", "full", **kw)


@register_metric
def ppl_wfull(**kw):
    return _ppl("ppl_wfull", "w", "full", **kw)


@register_metric
def ppl_zend(**kw):
    return _ppl("ppl_zend", "z", "end", **kw)


@register_metric
def ppl_wend(**kw):
    return _ppl("ppl_wend", "w", "end", **kw)


@register_metric
def ppl2_wend(**kw):
    """StyleGAN2-ADA's default PPL (w space, endpoints, crop)."""
    return _ppl("ppl2_wend", "w", "end", **kw)
