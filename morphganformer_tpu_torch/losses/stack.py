"""Composable projection loss stack (port of morphganformer_tpu/losses/stack.py).

A weight table over registered terms, e.g. "mse" -> {"mse": 1.0} or
"lpips+0.01*wing+1*mse" -> {"lpips": 1.0, "wing": 0.01, "mse": 1.0}. Terms
are callables (img, target) -> scalar: the built-in pixel terms, and the
perceptual and biometric ones (lpips, wing, facenet, ...) that the caller
passes as `extra_terms`, closures over their networks (cli.make_extra_terms).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from morphganformer_tpu_torch.losses import pixel

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_BUILTIN: Dict[str, LossFn] = {
    "mse": pixel.mse_loss,
    "l1": pixel.l1_loss,
    "psnr": pixel.psnr_loss,
    "ssim": pixel.dssim_loss,
}
BUILTIN_TERMS = tuple(_BUILTIN)


def build_loss_stack(weights: Dict[str, float], extra_terms: Dict[str, LossFn] = None):
    """loss_fn(img, target) -> (per-image totals [B], {term: per-image [B]}).

    `weights` maps a term's name to its weight; `extra_terms` adds terms to
    the built-in ones. Each term is applied to every batch row on its own
    (img[i:i+1], target[i:i+1]), as the JAX engine vmaps it, so a batched
    projection tracks each image's best independently."""
    terms = {**_BUILTIN, **(extra_terms or {})}
    active = {name: w for name, w in weights.items() if w != 0.0}
    unknown = set(active) - set(terms)
    if unknown:
        raise KeyError(f"unknown loss terms: {sorted(unknown)}; available: {sorted(terms)}")

    def loss_fn(img, target):
        comps = {name: torch.stack([terms[name](img[i:i + 1], target[i:i + 1])
                                    for i in range(img.shape[0])])
                 for name in active}
        total = torch.zeros(img.shape[0], dtype=torch.float32, device=img.device)
        for name, w in active.items():
            total = total + w * comps[name]
        return total, comps

    return loss_fn


def parse_loss_spec(spec: str) -> Dict[str, float]:
    """"mse", "lpips+mse", "lpips+0.01*wing+1*mse" -> a weight dict."""
    weights: Dict[str, float] = {}
    for part in spec.split("+"):
        part = part.strip()
        if not part:
            continue
        if "*" in part:
            w, name = part.split("*", 1)
            weights[name.strip()] = float(w)
        else:
            weights[part] = weights.get(part, 0.0) + 1.0
    return weights
