"""Tensor parallelism over a ('data', 'model') mesh (port of
morphganformer_tpu/parallel/tp.py).

JAX shards by annotation only: every parameter named `weight` or `bias`
whose last axis (its output channels) divides the 'model' axis is placed
`P(..., 'model')`, and GSPMD inserts the collectives. torch has no
partitioner, so here each rank is a process that holds its slice of those
output channels and each sharded layer places its collectives itself, as
Megatron's column-parallel layers do:

    y = from_model(op(to_model(x), W_local, b_local))

`to_model` is the identity forward and sums the cotangent over the model
group backward (a rank's slice of the output channels gives a partial dx,
and a partial ds for modulated convolutions); `from_model` all-gathers the
slices along the last axis (activations are NHWC, weights HWIO or [in,
out]: the last axis is the output channels everywhere) and takes this
rank's slice of the cotangent backward. Both are differentiable to any
order (the reg stages differentiate through them twice): the backward of
each is one of two more Functions, `_Reduce` (all-reduce forward, identity
backward) and `_Split` (slice forward, all-gather backward), whose
backwards are `to_model` and `from_model` again.

    make_mesh(devices, model_parallel, device)  a DataMesh, or a DataModelMesh
    shard_params(module, mesh)    slice each sharded parameter in place
    unshard_params(module, mesh)  gather them whole again
    to_model(x, axis), from_model(x, axis)

A module that holds sharded parameters carries the model axis as its `tp`
attribute (None otherwise); the layers read it (models/layers.py,
models/synthesis.py). The rule is JAX's `_leaf_spec` letter for letter:
consts, noise, w_avg, centroids, att_weight, the positional encodings,
torgb's 3-channel weight and D's 1-wide output stay replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from morphganformer_tpu_torch.parallel.mesh import DataMesh, make_data_mesh

SHARDED_NAMES = ("weight", "bias")


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """The model axis of this rank: its size, this rank's index along it and
    the process group of the ranks that share this rank's data index. A
    module copy (`copy.deepcopy`, as the EMA generator is made) keeps the
    same axis."""
    size: int
    rank: int
    group: Any = dataclasses.field(default=None, repr=False)

    def __deepcopy__(self, memo):
        return self


@dataclasses.dataclass(frozen=True)
class DataModelMesh(DataMesh):
    """A ('data', 'model') mesh: rank r has data index r // m and model index
    r % m (JAX's `devices.reshape(n // m, m)`). `world`, `rank`, `devices`
    and `group` are the data axis's (the ranks with this rank's model
    index), so everything that splits or averages over the batch reads them
    as on a data-only mesh; `model` is the model axis."""
    model: Optional[ModelAxis] = None

    @property
    def replica_group(self):
        """Every rank holds the nets before sharding: the default group."""
        return None

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": self.model.size}


def make_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1,
              device="cuda") -> DataMesh:
    """The data mesh over every rank when `model_parallel <= 1` (JAX returns
    a ('data',) mesh); else a DataModelMesh of the process group's ranks
    (`devices`, if given, names every rank's device, one a rank). Every rank
    calls it and makes every group, in the same order."""
    if model_parallel <= 1:
        return make_data_mesh(devices, device)
    every = make_data_mesh(devices, device)
    n, m = len(every.devices), model_parallel
    if n % m:
        raise ValueError(f"{n} devices not divisible by model_parallel={m}")
    rank = dist.get_rank()
    d, mi = divmod(rank, m)
    data_group = model_group = None
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(n // m)])
        if j == mi:
            data_group = g
    for i in range(n // m):
        g = dist.new_group([i * m + j for j in range(m)])
        if i == d:
            model_group = g
    return DataModelMesh(devices=tuple(every.devices[i * m + mi] for i in range(n // m)),
                         world=n // m, rank=d, group=data_group,
                         model=ModelAxis(m, mi, model_group))


def model_axis(mesh) -> Optional[ModelAxis]:
    """The mesh's model axis, None for a data mesh or no mesh."""
    return getattr(mesh, "model", None)


def check_float32(mesh, *cfgs):
    """Refuse a model axis with a bfloat16 config: this slice shards float32
    training only."""
    axis = model_axis(mesh)
    bad = [type(c).__name__ for c in cfgs if getattr(c, "dtype", "float32") != "float32"]
    if axis is not None and bad:
        raise ValueError(f"a ('data', 'model') mesh (model axis {axis.size}) trains in "
                         f"float32 only; {', '.join(bad)} has dtype bfloat16")


# ---------------------------------------------------------------------------
# The rule and the slicing.
# ---------------------------------------------------------------------------


def leaf_sharded(name: str, shape, model_size: int) -> bool:
    """JAX's `_leaf_spec`: a leaf named weight or bias whose last axis is at
    least the model size and divisible by it."""
    return (name in SHARDED_NAMES and len(shape) >= 1 and shape[-1] % model_size == 0
            and shape[-1] >= model_size)


def sharded_names(module: nn.Module, model_size: int) -> set:
    """The dotted names of the parameters the rule shards (on an unsharded
    module)."""
    return {name for name, p in module.named_parameters()
            if leaf_sharded(name.rsplit(".", 1)[-1], tuple(p.shape), model_size)}


def _slice_last(x, axis: ModelAxis):
    c = x.shape[-1] // axis.size
    return x[..., axis.rank * c:(axis.rank + 1) * c].contiguous()


def _gather_last(x, axis: ModelAxis):
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=-1)


@torch.no_grad()
def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Replace each parameter that the rule shards by this rank's slice of
    its last axis, in place, and give its module the model axis (`tp`). On a
    mesh without a model axis nothing changes (the parameters stay as
    `replicated` broadcast them). Build optimizers after this."""
    axis = model_axis(mesh)
    if axis is None:
        return module
    for sub in module.modules():
        names = [n for n, p in sub.named_parameters(recurse=False)
                 if leaf_sharded(n, tuple(p.shape), axis.size)]
        if not names:
            continue
        if not hasattr(type(sub), "tp"):
            raise TypeError(f"{type(sub).__name__} holds sharded parameters {names} but "
                            f"computes no slice of its output channels")
        for n in names:
            p = getattr(sub, n)
            setattr(sub, n, nn.Parameter(_slice_last(p.detach(), axis),
                                         requires_grad=p.requires_grad))
        sub.tp = axis
        sub.tp_names = tuple(names)
    return module


def _sharded_modules(module):
    return [(prefix, sub) for prefix, sub in module.named_modules()
            if getattr(sub, "tp_names", None)]


@torch.no_grad()
def unshard_params(module: nn.Module, mesh=None) -> nn.Module:
    """Gather every sharded parameter whole again (a collective over the
    model group: every rank calls it), in place, and take the model axis off
    its module: the inverse of `shard_params`."""
    for _, sub in _sharded_modules(module):
        for n in sub.tp_names:
            p = getattr(sub, n)
            setattr(sub, n, nn.Parameter(_gather_last(p.detach(), sub.tp),
                                         requires_grad=p.requires_grad))
        del sub.tp, sub.tp_names
    return module


@torch.no_grad()
def unshard_like(module: nn.Module, tensors):
    """Tensors shaped like `module`'s parameters, in `module.parameters()`'s
    order (gradients, Adam moments), each sharded one gathered whole; None
    stays None. A collective over the model group."""
    sharded = {id(getattr(sub, n)): sub.tp for _, sub in _sharded_modules(module)
               for n in sub.tp_names}
    return [t if t is None or id(p) not in sharded else _gather_last(t, sharded[id(p)])
            for p, t in zip(module.parameters(), tensors)]


def replicated_mask(module: nn.Module):
    """For each of `module.parameters()`, whether it is whole on every rank
    (not sharded)."""
    sharded = {id(getattr(sub, n)) for _, sub in _sharded_modules(module)
               for n in sub.tp_names}
    return [id(p) not in sharded for p in module.parameters()]


@torch.no_grad()
def model_mean_(tensors, axis: Optional[ModelAxis]):
    """Each tensor replaced, in place, by its mean over the model group: one
    all-reduce of their concatenation, so every rank holds the same values
    even where its own ops summed in another order (cuDNN's default
    algorithms do not sum alike twice). A no-op without a model axis."""
    if axis is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


# ---------------------------------------------------------------------------
# The collectives, differentiable to any order.
# ---------------------------------------------------------------------------


class _Copy(torch.autograd.Function):
    """to_model: identity forward; the cotangent summed over the model group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    """The sum of every model rank's partial value: all-reduce forward, the
    replicated cotangent handed to each partial backward (through `_Copy`,
    so that a further derivative sums again)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    """from_model: every rank's slice concatenated along the last axis; the
    cotangent's slice of this rank backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.axis), None


class _Split(torch.autograd.Function):
    """This rank's slice of the last axis; every rank's cotangent slice
    gathered backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _slice_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.axis), None


def to_model(x, axis: Optional[ModelAxis]):
    """x entering a layer that computes this rank's output channels (x
    itself without a model axis, or for None)."""
    return x if axis is None or x is None else _Copy.apply(x, axis)


def from_model(x, axis: Optional[ModelAxis]):
    """The whole of a layer's output (or a sharded parameter) from every
    rank's slice of its last axis."""
    return x if axis is None or x is None else _Gather.apply(x, axis)
