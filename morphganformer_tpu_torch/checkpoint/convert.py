"""Carry a flax variables tree of the JAX generator or discriminator over to
the port.

The port's modules mirror the flax module tree name for name and keep the
JAX layouts ([in, out] dense weights, HWIO conv weights), so each leaf maps
onto the state_dict key that joins its path with dots:

    params/synthesis/b1024/conv1/weight          -> synthesis.b1024.conv1.weight
    buffers/synthesis/b1024/conv1/noise_const    -> synthesis.b1024.conv1.noise_const
    moving_stats/mapping/w_avg                   -> mapping.w_avg
    params/b1024/conv1/biasAct/bias (D)          -> b1024.conv1.biasAct.bias

The `skip` and `orig` layouts carry the same way: a `skip` G's ToRGB of
every block (params/synthesis/b512/torgb/... -> synthesis.b512.torgb...),
a `skip` D's fromrgb of every block and of the epilogue
(params/b512/fromrgb/... -> b512.fromrgb..., params/b4/fromrgb/... ->
b4.fromrgb...).

Reading `.msgpack` checkpoints is not ported yet; callers pass the variables
as nested dicts of numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "buffers", "moving_stats")


def _flatten(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def from_flax(variables) -> dict:
    """Nested {collection: {module: ... {leaf: array}}} -> state_dict of
    float32 CPU tensors. Raises on a collection it does not know."""
    state = {}
    for path, leaf in _flatten(variables):
        if path[0] not in COLLECTIONS or len(path) < 2:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        state[".".join(path[1:])] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return state


def load_flax(model: torch.nn.Module, variables) -> torch.nn.Module:
    """Load a flax variables tree into `model`. Raises if a leaf has no
    counterpart, a parameter or buffer is left without a leaf, or a shape
    differs."""
    state = from_flax(variables)
    expected = model.state_dict()
    unmapped = sorted(set(state) - set(expected))
    missing = sorted(set(expected) - set(state))
    if unmapped or missing:
        raise KeyError(f"flax leaves without a port counterpart: {unmapped}; "
                       f"port state without a flax leaf: {missing}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(expected[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != port shape "
                             f"{tuple(expected[k].shape)}")
    model.load_state_dict(state, strict=True)
    return model
