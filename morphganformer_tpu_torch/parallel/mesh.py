"""The data axis on torch.distributed (port of
morphganformer_tpu/parallel/mesh.py).

JAX lays one program over a `Mesh(('data',))` and shards the batch with
`P('data')`; its partitioner inserts the collectives. Here each rank is a
process that holds a contiguous block of the batch's rows and a replica of
the nets, and the few places where rows meet call a collective themselves:
the trainer's gradient mean (training/train_step.py), the minibatch-std
layer (models/discriminator.py), the w_avg update (models/mapping.py), the
path-length rows and mean (training/loss.py) and the stats
(training/stats.py). The trainer hands its mesh to each of them as an
argument: a call without one runs no collective.

    make_data_mesh(devices)     DataMesh(devices, world, rank)
    data_sharding(mesh, x)      this rank's block of x's rows
    replicated(module, mesh)    parameters and buffers broadcast from rank 0

Every collective here runs over the mesh's `group`: the default group of
a data mesh, or the data axis of a ('data', 'model') mesh
(parallel/tp.py), whose `world` and `rank` are that axis's too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from morphganformer_tpu_torch.parallel.launch import local_device


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data axis: every rank's device, the world size and this rank.
    Collectives run over `group` (None: the default process group), which
    must exist when `world > 1` (a mesh of one rank without a group runs
    none)."""
    devices: tuple
    world: int
    rank: int
    group: Optional[object] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def has_group(self) -> bool:
        return dist.is_initialized()

    @property
    def replica_group(self):
        """The ranks that start from one copy of the nets: the data axis."""
        return self.group

    @property
    def shape(self) -> dict:
        return {"data": self.world}


def make_data_mesh(devices: Optional[Sequence] = None, device="cuda") -> DataMesh:
    """The data axis over every rank of the process group (one rank and no
    group when there is none). Each rank's device is `cuda:<local rank>`
    (or the CPU for `device="cpu"`) unless `devices` names them all, one a
    rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        mine = str(local_device(device))
        if world > 1:
            gathered = [None] * world
            dist.all_gather_object(gathered, mine)
        else:
            gathered = [mine]
        devices = gathered
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != world:
        raise ValueError(f"a data mesh over {len(devices)} devices needs as many processes "
                         f"(spawn_local or initialize_distributed); this group has {world}")
    return DataMesh(devices, world, rank)


def data_sharding(mesh: Optional[DataMesh], x):
    """This rank's contiguous block of the leading axis of `x` (JAX's
    P('data')); x itself without a mesh."""
    if mesh is None or mesh.world == 1:
        return x
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} rows do not divide the data mesh ({mesh.world} ranks)")
    per = n // mesh.world
    return x[mesh.rank * per:(mesh.rank + 1) * per]


@torch.no_grad()
def replicated(module: torch.nn.Module, mesh: Optional[DataMesh]) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from the first rank of
    the mesh's `replica_group` (every rank of a ('data', 'model') mesh), in
    place, so every rank starts from the same values (JAX's P() placement)."""
    if mesh is not None and mesh.has_group:
        group = mesh.replica_group
        src = 0 if group is None else dist.get_global_rank(group, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


@torch.no_grad()
def all_mean_(flat, mesh: Optional[DataMesh]):
    """`flat` replaced, in place, by its mean over the ranks: one all-reduce
    and one scale (the trainer keeps a stage's gradients as views of one
    such buffer). Returns `flat`."""
    if mesh is not None and mesh.has_group:
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
    return flat


@torch.no_grad()
def sum_over_ranks(x, mesh: Optional[DataMesh]):
    """The sum of `x` over the ranks, without a gradient (a copy of `x`
    itself without a group)."""
    y = x.detach().clone()
    if mesh is not None and mesh.has_group:
        dist.all_reduce(y, group=mesh.group)
    return y


def mean_over_ranks(x, mesh: Optional[DataMesh]):
    """The mean of `x` over the ranks (equal-sized shards: the global mean of
    per-rank means), without a gradient."""
    return sum_over_ranks(x, mesh) / (mesh.world if mesh is not None else 1)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable to any order: the cotangent of
    each rank's input is the sum of every rank's cotangent of the output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def gather_rows(x, mesh: Optional[DataMesh]):
    """Every rank's `x` stacked along the leading axis in rank order (the
    global rows), differentiable to any order: each rank's block sits in
    zeros and one all-reduce sums them, so the backward sums every rank's
    cotangent of this rank's block, which is the gradient of the sum of
    all ranks' losses."""
    if mesh is None or mesh.world == 1:
        return x
    blocks = [torch.zeros_like(x)] * mesh.world
    blocks[mesh.rank] = x
    return _AllReduceSum.apply(torch.cat(blocks), mesh.group)

