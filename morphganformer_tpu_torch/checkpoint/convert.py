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

`from_jax_train_state` reads the JAX package's train_state.msgpack tree
(its loop.py `save_train_state`: g, d, gs_params, gs_stats, g_opt, d_opt,
pl_mean, cur_nimg) as the port's train-state tree (training/loop.py
`train_state_tree`: G, D, G_ema, g_opt, d_opt, pl_mean, cur_nimg), and
`to_jax_train_state` writes it back. JAX's EMA generator is gs_params with
gs_stats (w_avg) and g's const-noise buffers, as its loop builds Gs; each
optimizer is optax's adam chain, serialised as {"0": {"count", "mu",
"nu"}, "1": {}}, whose mu and nu are torch Adam's exp_avg and exp_avg_sq
and whose one count is every parameter's step.
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


def is_jax_train_state(tree) -> bool:
    """Whether a train-state tree is the JAX package's layout."""
    return "gs_params" in tree and "g" in tree


def _adam_from_jax(chain, params):
    """optax's adam state -> the port's {exp_avg, exp_avg_sq, step} trees
    keyed ("params", ...); empty (a fresh Adam) where its count is 0."""
    state = chain["0"]
    count = int(np.asarray(state["count"]))
    out = {"exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    if count == 0:
        return out
    for key, moments in (("exp_avg", state["mu"]), ("exp_avg_sq", state["nu"])):
        for path, leaf in flatten(moments):
            set_leaf(out[key], ("params", *path), np.asarray(leaf, np.float32))
    for path, _ in flatten(params):
        set_leaf(out["step"], ("params", *path), np.asarray(count, np.float32))
    return out


def _adam_to_jax(opt, params):
    """The port's Adam trees -> optax's adam state over the `params` tree
    (zeros and count 0 for a fresh Adam)."""
    steps = {float(np.asarray(leaf)) for _, leaf in flatten(opt["step"])}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ ({sorted(steps)}); optax keeps one")
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for key, tree in moments.items():
        have = {path[1:]: leaf for path, leaf in flatten(opt[key])}
        for path, p in flatten(params):
            if steps and path not in have:
                raise KeyError(f"Adam state of {'/'.join(path)} is missing")
            set_leaf(tree, path, np.asarray(have.get(path, np.zeros(np.shape(p))),
                                            np.float32))
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    return {"0": {"count": count, "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"]},
            "1": {}}


def from_jax_train_state(tree) -> dict:
    """The JAX package's train-state tree as the port's."""
    g = dict(tree["g"])
    g_ema = {"params": tree["gs_params"]}
    if tree.get("gs_stats"):
        g_ema["moving_stats"] = tree["gs_stats"]
    if "buffers" in g:
        g_ema["buffers"] = g["buffers"]
    return {"G": g, "D": dict(tree["d"]), "G_ema": g_ema,
            "g_opt": _adam_from_jax(tree["g_opt"], g["params"]),
            "d_opt": _adam_from_jax(tree["d_opt"], tree["d"]["params"]),
            "pl_mean": np.asarray(tree["pl_mean"], np.float32),
            "cur_nimg": int(np.asarray(tree["cur_nimg"]))}


def to_jax_train_state(tree) -> dict:
    """The port's train-state tree as the JAX package's, which its
    `load_train_state` reads."""
    return {"g": dict(tree["G"]), "d": dict(tree["D"]),
            "gs_params": tree["G_ema"]["params"],
            "gs_stats": tree["G_ema"].get("moving_stats", {}),
            "g_opt": _adam_to_jax(tree["g_opt"], tree["G"]["params"]),
            "d_opt": _adam_to_jax(tree["d_opt"], tree["D"]["params"]),
            "pl_mean": np.asarray(tree["pl_mean"], np.float32),
            "cur_nimg": np.asarray(tree["cur_nimg"], np.int32)}
