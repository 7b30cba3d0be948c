"""Fused bias + activation + gain + clamp (port of morphganformer_tpu/ops/bias_act.py).

Plain PyTorch elementwise composition; NHWC, so the bias maps onto the last
dimension by default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class _ActSpec:
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    "linear": _ActSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": _ActSpec(lambda x, alpha: F.relu(x), 0.0, math.sqrt(2)),
    "lrelu": _ActSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, math.sqrt(2)),
    "tanh": _ActSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": _ActSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": _ActSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": _ActSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": _ActSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": _ActSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, math.sqrt(2)),
}


def bias_act(x, b=None, dim=-1, act="linear", alpha=None, gain=None, clamp=None):
    """y = clamp(gain * act(x + b), [-clamp, clamp]); `None` arguments take
    the activation's defaults (e.g. gain sqrt(2) for lrelu)."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if b is not None:
        dim = dim % x.ndim
        if b.ndim != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias {tuple(b.shape)} does not match dim {dim} of {tuple(x.shape)}")
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
