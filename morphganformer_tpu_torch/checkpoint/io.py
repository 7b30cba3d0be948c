"""Checkpoints in the JAX package's form: arch.json + <role>.msgpack (port of
morphganformer_tpu/checkpoint/io.py).

A checkpoint directory holds `arch.json`, one config per role ("G", "Gs",
"D"), merged across saves, and one `<role>.msgpack` per role: the flax
variables tree of that net (`checkpoint/convert.py`) as flax's msgpack
(`checkpoint/msgpack_codec.py`). The JAX package and the port read each
other's directories. Loading builds the net from arch.json and fills every
parameter and persistent buffer from the file: nothing is drawn at random.
"""

from __future__ import annotations

import json
import os

import torch

from morphganformer_tpu_torch.checkpoint.convert import load_flax, to_flax
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore, msgpack_serialize
from morphganformer_tpu_torch.models.config import DiscriminatorConfig, GANformerConfig
from morphganformer_tpu_torch.utils.device import resolve_device

ARCH_FILE = "arch.json"
PARAMS_FILE = "{role}.msgpack"


def _key_sorted(tree):
    """The tree with every dict's keys in sorted order: JAX's save passes
    the tree through `jax.device_get`, which rebuilds each dict so, and
    msgpack keeps the order, so the port writes JAX's bytes."""
    if isinstance(tree, dict):
        return {k: _key_sorted(tree[k]) for k in sorted(tree)}
    return tree


def _save(path, role, cfg, net):
    os.makedirs(path, exist_ok=True)
    arch_path = os.path.join(path, ARCH_FILE)
    arch = {}
    if os.path.exists(arch_path):
        with open(arch_path) as f:
            arch = json.load(f)
    arch[role] = json.loads(cfg.to_json())
    with open(arch_path, "w") as f:
        json.dump(arch, f, indent=2)
    with open(os.path.join(path, PARAMS_FILE.format(role=role)), "wb") as f:
        f.write(msgpack_serialize(_key_sorted(
            to_flax(net) if isinstance(net, torch.nn.Module) else net)))


def _load(path, role):
    with open(os.path.join(path, ARCH_FILE)) as f:
        arch = json.load(f)
    if role not in arch:
        raise KeyError(f"role {role!r} not in checkpoint {path}; has {sorted(arch)}")
    with open(os.path.join(path, PARAMS_FILE.format(role=role)), "rb") as f:
        return json.dumps(arch[role]), msgpack_restore(f.read())


def save_generator(path: str, cfg: GANformerConfig, net, role: str = "Gs") -> None:
    """Write arch.json (merged) + <role>.msgpack under directory `path`.
    `net` is a Generator or its flax variables tree."""
    _save(path, role, cfg, net)


def load_generator(path: str, role: str = "Gs", device="cuda"):
    """Return (cfg, generator in eval mode on `device`) for the stored role."""
    from morphganformer_tpu_torch.models.generator import Generator

    text, variables = _load(path, role)
    cfg = GANformerConfig.from_json(text)
    G = load_flax(Generator(cfg), variables)
    return cfg, G.to(resolve_device(device)).eval()


def save_discriminator(path: str, cfg: DiscriminatorConfig, net) -> None:
    """Write arch.json (merged) + D.msgpack under directory `path`."""
    _save(path, "D", cfg, net)


def load_discriminator(path: str, device="cuda"):
    """Return (cfg, discriminator on `device`) stored under role "D"."""
    from morphganformer_tpu_torch.models.discriminator import Discriminator

    text, variables = _load(path, "D")
    cfg = DiscriminatorConfig.from_json(text)
    D = load_flax(Discriminator(cfg), variables)
    return cfg, D.to(resolve_device(device))


def load_network(path: str, role: str = "Gs", device="cuda"):
    """Load a generator from a checkpoint directory; a reference .pkl is
    refused with the command of the port's converter."""
    if path.endswith(".pkl"):
        raise ValueError(
            f"{path} is a torch/TF pickle. Convert it once with:\n"
            f"  python -m morphganformer_tpu_torch.tools.convert_checkpoint {path} <out_dir>\n"
            f"then pass <out_dir>.")
    return load_generator(path, role=role, device=device)
