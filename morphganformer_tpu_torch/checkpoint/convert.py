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

`to_flax` is the inverse: every parameter goes to `params`, and each
persistent buffer to the collection that the flax module keeps it in
(`noise_const` in `buffers`, `w_avg` in `moving_stats`). The trees are what
`checkpoint/io.py` reads and writes as msgpack.
"""

from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "buffers", "moving_stats")
# The flax collection of each persistent buffer, by the buffer's name.
BUFFER_COLLECTIONS = {"noise_const": "buffers", "w_avg": "moving_stats"}


def flatten(tree, prefix=()):
    """(path tuple, leaf) of every leaf of a nested dict."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from flatten(v, prefix + (str(k),))
    else:
        yield prefix, tree


def from_flax(variables) -> dict:
    """Nested {collection: {module: ... {leaf: array}}} -> state_dict of
    float32 CPU tensors. Raises on a collection it does not know."""
    state = {}
    for path, leaf in flatten(variables):
        if path[0] not in COLLECTIONS or len(path) < 2:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        if isinstance(leaf, torch.Tensor):
            state[".".join(path[1:])] = leaf.detach().to("cpu", torch.float32)
        else:
            state[".".join(path[1:])] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return state


def set_leaf(tree, path, leaf):
    """Put `leaf` at `path` of a nested dict, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def to_flax(model: torch.nn.Module) -> dict:
    """A model's state as the nested {params, buffers, moving_stats} tree of
    its flax counterpart, leaves float32 numpy arrays on the host, copies
    that later updates of the model leave as they are (the inverse of
    `from_flax`). Collections that would be empty are left out,
    as flax leaves them out. Raises on a persistent buffer that has no flax
    collection."""
    params = dict(model.named_parameters())
    tree = {}
    for key, value in model.state_dict().items():
        name = key.rsplit(".", 1)[-1]
        if key in params:
            collection = "params"
        elif name in BUFFER_COLLECTIONS:
            collection = BUFFER_COLLECTIONS[name]
        else:
            raise KeyError(f"buffer {key} has no flax collection")
        leaf = value.detach().to("cpu", torch.float32, copy=True).numpy()
        set_leaf(tree, (collection, *key.split(".")), leaf)
    return tree


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
