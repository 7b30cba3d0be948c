"""Multi-process launch on torch.distributed (port of
morphganformer_tpu/parallel/launch.py).

The JAX package runs one program over every device of every host, wired by
`jax.distributed.initialize`. Here each device has a process of its own,
as in the reference's per-GPU spawn and torch.distributed rendezvous
(run_network.py:372-402): the processes meet at a coordinator's
`host:port` (or through torchrun's environment), NCCL carries the
collectives on the card and gloo on the CPU, and each process takes
`cuda:<local rank>`. A rendezvous or a collective that fails raises.

    initialize_distributed(coordinator, num_processes, process_id, requested)
    is_main_process()           the logging and snapshot gate (rank 0)
    spawn_local(fn, nprocs)     one process per local device, met at a free
                                localhost port; fn(rank, *args) in each
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from morphganformer_tpu_torch.utils.device import resolve_device


def _backend(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index among those of its host: LOCAL_RANK where a
    launcher sets it, else the rank modulo the host's CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if not dist.is_initialized():
        return 0
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def local_device(device="cuda") -> torch.device:
    """The device of this process: `cuda:<local rank>` for a CUDA device
    under a process group, else `device` itself."""
    device = resolve_device(device)
    if device.type == "cuda" and dist.is_initialized():
        return torch.device("cuda", local_rank())
    return device


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           requested: bool = False, device="cuda",
                           timeout_s: Optional[float] = None) -> int:
    """Join the process group and return this process's rank.

    The group is made when `requested` (train --multihost), a coordinator
    or a `num_processes` other than 1 is given, or MGT_MULTIHOST=1, as in
    JAX; otherwise, and when a group exists already, this only returns the
    rank. With a coordinator `host:port` the rendezvous is a TCP store
    there, and `num_processes` and `process_id` are required; without one
    it reads torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE). NCCL on the card (each process on `cuda:<local rank>`),
    gloo on the CPU."""
    if dist.is_initialized():
        return dist.get_rank()
    if not (requested or coordinator or num_processes not in (None, 1)
            or os.environ.get("MGT_MULTIHOST") == "1"):
        return 0
    backend = _backend(device)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError(f"a rendezvous at {coordinator} needs num_processes and "
                             f"process_id (got {num_processes}, {process_id})")
        init_method = f"tcp://{coordinator}"
        world, rank = num_processes, process_id
    else:
        init_method = "env://"
        world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
        rank = process_id if process_id is not None else int(os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside a world of {world}")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank % torch.cuda.device_count())))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kw)
    return dist.get_rank()


def is_main_process() -> bool:
    """The logging and snapshot gate (the reference's rank == 0 checks)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, nprocs, port, device, timeout_s, args):
    initialize_distributed(f"localhost:{port}", nprocs, rank, device=device,
                           timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn, nprocs: int, backend: str = "nccl", args=(),
                timeout_s: Optional[float] = None) -> None:
    """Run `fn(rank, *args)` in `nprocs` new processes, one per local device,
    in one process group at a free localhost port (NCCL on `cuda:<rank>`,
    or gloo on the CPU). `fn` must be importable by name (the processes are
    spawned). Returns when all have ended; when one raises, the others are
    ended and its error is raised here."""
    import torch.multiprocessing as mp

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    device = "cuda" if backend == "nccl" else "cpu"
    mp.spawn(_spawned, args=(fn, nprocs, free_port(), device, timeout_s, tuple(args)),
             nprocs=nprocs, join=True)
