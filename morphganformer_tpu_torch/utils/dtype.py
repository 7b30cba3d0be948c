"""The nets' compute types."""

from __future__ import annotations

import functools

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def at_least_f32(x):
    """x as float32, or unchanged when it is float64: the nets compute in
    float32 (JAX's casts), and a net cast with `.double()` runs wholly in
    float64, the reference that `chip_smoke.py` holds the reg stages to."""
    return x if x.dtype == torch.float64 else x.float()


def compute_dtype(cfg):
    """The synthesis activations' type, `cfg.dtype` ("float32" or
    "bfloat16"), as JAX's SynthesisBlock reads it. The parameters stay
    float32 whatever it says; the islands that `at_least_f32` marks (the
    affine styles, the attention softmax, torgb) stay float32 too."""
    if cfg.dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}, got {cfg.dtype!r}")
    return COMPUTE_DTYPES[cfg.dtype]


def to_compute(x, cfg):
    """x in the synthesis' compute type; a float64 net (`.double()`) stays
    float64 when the type is float32."""
    dtype = compute_dtype(cfg)
    return x if dtype == torch.float32 and x.dtype == torch.float64 else x.to(dtype)


@functools.lru_cache(maxsize=None)
def scalar(v, dtype):
    """The Python number `v` rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the array it multiplies (`x * 0.2` of a bfloat16 x is x times
    bfloat16(0.2)); torch would keep it in float32. Exact for float32 and
    float64 tensors."""
    return float(v) if dtype == torch.float64 else torch.tensor(float(v), dtype=dtype).item()
