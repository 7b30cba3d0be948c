"""The nets' compute type."""

from __future__ import annotations

import torch


def at_least_f32(x):
    """x as float32, or unchanged when it is float64: the nets compute in
    float32 (JAX's casts), and a net cast with `.double()` runs wholly in
    float64, the reference that `chip_smoke.py` holds the reg stages to."""
    return x if x.dtype == torch.float64 else x.float()
