"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel*.py).

    python -m tests.torch_parallel_workers <case> <rank> <world> <port> <dir>

joins a gloo group of `world` processes at localhost:<port> through
`initialize_distributed`, runs `case` and writes its results under <dir>
(rank<r>.npz or rank<r>.json). The tests start the ranks as subprocesses,
each with its own timeout, and compare the files. Imports torch, numpy and
the port only, so a rank starts quickly; the cases that the tests also run
in one process (world 1) are plain functions here.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys

import numpy as np
import torch

from morphganformer_tpu_torch.checkpoint.convert import flatten, load_flax, to_flax
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.parallel import (
    data_sharding,
    initialize_distributed,
    is_main_process,
    make_data_mesh,
)
from morphganformer_tpu_torch.parallel.tp import (
    make_mesh,
    shard_params,
    sharded_names,
    unshard_like,
    unshard_params,
)
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts
from morphganformer_tpu_torch.training.loop import train_state_tree
from morphganformer_tpu_torch.training.stats import Collector

TIMEOUT_S = 90          # each collective's limit: a rank that never arrives fails the rest


def small_cfgs(mod):
    """The small pair of tests/test_torch_train_step.py with randomness off
    (no local noise, no attention or component dropout)."""
    g = mod.GANformerConfig(img_resolution=16, z_dim=8, w_dim=8, k=3, channel_base=256,
                            channel_max=32, end_res=3, local_noise=False,
                            mapping=mod.MappingConfig(num_layers=2),
                            attention=mod.AttentionConfig(dropout=0.0))
    d = mod.DiscriminatorConfig(img_resolution=16, channel_base=256, channel_max=32,
                                mbstd_group_size=2)
    return g, d


@contextlib.contextmanager
def patched(work):
    """D's b16 (16 -> 32 channels) on the fused ops, as b1024/b512 at 1024^2,
    and the path-length noise of JAX's rows of the global microbatch read
    from <work>/batch.npz ("pl_noise"; each rank takes the rows it holds),
    so that it does not depend on which rank draws it: the only random
    draw left once the config's randomness is off. Both undone after the
    block."""
    noise = torch.from_numpy(np.load(os.path.join(work, "batch.npz"))["pl_noise"])

    def g_pl_loss(G, z, cfg, gen, pl_mean, mesh=None, c=None, pl_noise=None):
        rows, _ = tloss.pl_rows(z.shape[0], cfg.pl_batch_shrink, mesh)
        start = mesh.rank * z.shape[0] if mesh is not None else 0
        return tloss.g_pl_loss(G, z, cfg, gen, pl_mean, mesh, c=c,
                               pl_noise=noise[start:start + rows])

    saved = tdisc.packed_d_block_eligible, tts.g_pl_loss
    tdisc.packed_d_block_eligible = (
        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))
    tts.g_pl_loss = g_pl_loss
    try:
        yield
    finally:
        tdisc.packed_d_block_eligible, tts.g_pl_loss = saved


def train_config(world, pl_batch_shrink):
    """Batch 4 in one round of the global microbatch (batch_gpu * world = 4),
    R1 and path length due at step 0, path length on the first
    max(4 // pl_batch_shrink, 1) rows."""
    return tts.TrainConfig(batch_size=4, batch_gpu=4 // world, g_reg_interval=4,
                           d_reg_interval=16,
                           loss=tloss.LossConfig(style_mixing=0.0,
                                                 pl_batch_shrink=pl_batch_shrink))


def load_pair(path):
    """G and D with the weights of a msgpack of {"g": flax G, "d": flax D}."""
    tree = msgpack_restore(open(path, "rb").read())
    g_cfg, d_cfg = small_cfgs(tcfg)
    G = load_flax(init_generator(g_cfg, seed=1, device="cpu"), tree["g"])
    D = load_flax(tdisc.init_discriminator(d_cfg, seed=1, device="cpu"), tree["d"])
    return G, D


def run_iterations(work, mesh):
    """Train the iterations at <work>/batch.npz's "steps" on
    <work>/pair.msgpack's nets with its global z and reals, on this rank's
    rows, at its "pl_batch_shrink"; returns the flattened train state (nets,
    EMA, Adam moments, pl_mean) and the last iteration's stats."""
    world = mesh.world if mesh is not None else 1
    G, D = load_pair(os.path.join(work, "pair.msgpack"))
    g_cfg, d_cfg = small_cfgs(tcfg)
    batch = np.load(os.path.join(work, "batch.npz"))
    trainer = tts.GANTrainer(g_cfg, d_cfg, train_config(world, int(batch["pl_batch_shrink"])),
                             device="cpu", mesh=mesh)
    state = trainer.make_state(G, D, seed=0)
    stats = {}
    with patched(work):
        for i, step in enumerate(batch["steps"].tolist()):
            z = data_sharding(mesh, torch.from_numpy(batch["z"][i]))
            real = data_sharding(mesh, torch.from_numpy(batch["real"][i]))
            stats = {k: float(v)
                     for k, v in trainer.train_iteration(state, real, step, z=z).items()}
    tree = train_state_tree(state)
    flat = {"/".join(p): np.asarray(v) for p, v in flatten(tree) if p[0] != "cur_nimg"}
    return flat, stats


def case_rendezvous(rank, world, work):
    total = torch.tensor([float(rank + 1)])
    torch.distributed.all_reduce(total)
    mesh = make_data_mesh(device="cpu")
    return {"rank": rank, "main": is_main_process(), "sum": float(total),
            "world": mesh.world, "mesh_rank": mesh.rank,
            "devices": [str(d) for d in mesh.devices]}


def case_train(rank, world, work):
    flat, stats = run_iterations(work, make_data_mesh(device="cpu"))
    np.savez(os.path.join(work, f"rank{rank}.npz"), **flat)
    return stats


def case_mbstd(rank, world, work):
    """The minibatch-std layer on this rank's block of <work>/mbstd.npz's x,
    and the gradient of sum(y * cot) w.r.t. the block."""
    data = np.load(os.path.join(work, "mbstd.npz"))
    mesh = make_data_mesh(device="cpu")
    x = data_sharding(mesh, torch.from_numpy(data["x"])).clone().requires_grad_(True)
    cot = data_sharding(mesh, torch.from_numpy(data["cot"]))
    y = tdisc.minibatch_std(x, int(data["group"]), int(data["channels"]), mesh)
    grad, = torch.autograd.grad((y * cot).sum(), x)
    np.savez(os.path.join(work, f"rank{rank}.npz"), y=y.detach().numpy(), grad=grad.numpy())
    return {}


def case_collector(rank, world, work):
    """Rank r reports loss = r + i / 10 for i < r + 2 (ranks report unequal
    counts) and a second stat; the synced moments are the union's."""
    c = Collector(make_data_mesh(device="cpu"))
    for i in range(rank + 2):
        c.report_dict({"Loss/G/loss": torch.tensor(rank + i / 10),
                       "Loss/D/loss": torch.tensor(float(rank * i))})
    c.sync()
    out = {name: {"mean": c.mean(name), "std": c.std(name), "num": c.as_dict()[name]["num"]}
           for name in c.names()}
    if is_main_process():
        c.write_jsonl(os.path.join(work, "stats.jsonl"), tick=1)
    return out


def spawned(rank, work):
    """spawn_local's function in the tests: the group's sum and gate."""
    json.dump(case_rendezvous(rank, torch.distributed.get_world_size(), work),
              open(os.path.join(work, f"spawn{rank}.json"), "w"))


def spawned_failing(rank, work):
    """Rank 1 raises before the collective that rank 0 waits in."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))


def case_tp_loss(rank, world, work):
    """JAX's tensor-parallel test (tests/test_parallel.py:253-304) on a 1 x
    world mesh: <work>/g.msgpack's G (the dry run's tiny config), sharded,
    at <work>/tp_loss.npz's z; the loss mean(img^2) + mean(|img|) of
    G(z, truncation_psi 0.8, const noise) and every parameter's gradient,
    gathered whole; then `unshard_params` gives back the loaded tree to the
    bit."""
    mesh = make_mesh(model_parallel=world, device="cpu")
    g_cfg, _ = tts.dryrun_configs()
    tree = msgpack_restore(open(os.path.join(work, "g.msgpack"), "rb").read())
    G = load_flax(init_generator(g_cfg, seed=1, device="cpu"), tree)
    sharded = sharded_names(G, world)
    shard_params(G, mesh)
    z = torch.from_numpy(np.load(os.path.join(work, "tp_loss.npz"))["z"])
    img = G(z=z, truncation_psi=0.8, noise_mode="const")
    loss = img.square().mean() + img.abs().mean()
    params = list(G.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = unshard_like(G, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)])
    np.savez(os.path.join(work, f"rank{rank}.npz"), loss=loss.detach().numpy(),
             **{f"grad/{n}": g.numpy() for (n, _), g in zip(G.named_parameters(), grads)})
    local_shapes = {n: list(p.shape) for n, p in G.named_parameters()}
    back = dict(flatten(to_flax(unshard_params(G, mesh))))
    round_trip = all(np.array_equal(back[path], np.asarray(leaf))
                     for path, leaf in flatten(tree)) and len(back) == len(dict(flatten(tree)))
    return {"sharded": sorted(sharded), "local_shapes": local_shapes,
            "round_trip": round_trip, "tp_left": any(m.tp for m in G.modules()
                                                     if hasattr(m, "tp"))}


def stage_grads_one_state(work, mesh):
    """Each stage's gradient (G_main, G_reg, D_main, D_reg, from one state,
    no Adam step between them) on this rank's rows of <work>/batch.npz's
    first step, gathered whole: {stage/parameter: gradient}."""
    G, D = load_pair(os.path.join(work, "pair.msgpack"))
    g_cfg, d_cfg = small_cfgs(tcfg)
    batch = np.load(os.path.join(work, "batch.npz"))
    trainer = tts.GANTrainer(g_cfg, d_cfg, train_config(mesh.world, int(batch["pl_batch_shrink"])),
                             device="cpu", mesh=mesh)
    state = trainer.make_state(G, D, seed=0)
    z = data_sharding(mesh, torch.from_numpy(batch["z"][0]))[None]
    real = data_sharding(mesh, torch.from_numpy(batch["real"][0]))[None]
    with patched(work):
        grads = {"g_main": trainer.g_main_grads(state, z)[0],
                 "g_reg": trainer.g_reg_grads(state, z)[0],
                 "d_main": trainer.d_main_grads(state, real, z)[0],
                 "d_reg": trainer.d_reg_grads(state, real)[0]}
    out = {}
    for stage, gs in grads.items():
        net = state.G if stage.startswith("g") else state.D
        for (name, _), g in zip(net.named_parameters(), unshard_like(net, gs)):
            out[f"{stage}/{name}"] = g.numpy()
    return out


def case_tp_train(rank, world, work):
    """On a ('data', 'model') mesh (a 2-way model axis at world 4, a data
    mesh at world 2: `dryrun_model_parallel`): the iterations of
    `run_iterations` (this rank's leaves, sliced where sharded, under
    "state/") and each stage's gradient from one state, gathered whole
    (`stage_grads_one_state`, under "grads/"); returns the last iteration's
    stats of this rank's rows."""
    mesh = make_mesh(model_parallel=tts.dryrun_model_parallel(world), device="cpu")
    flat, stats = run_iterations(work, mesh)
    grads = stage_grads_one_state(work, mesh)
    np.savez(os.path.join(work, f"rank{rank}.npz"), **{f"state/{k}": v for k, v in flat.items()},
             **{f"grads/{k}": v for k, v in grads.items()})
    return stats


CASES = {"rendezvous": case_rendezvous, "train": case_train, "mbstd": case_mbstd,
         "collector": case_collector, "tp_loss": case_tp_loss, "tp_train": case_tp_train}


def main(argv):
    case, rank, world, port, work = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    got = initialize_distributed(f"localhost:{port}", world, rank, device="cpu",
                                 timeout_s=TIMEOUT_S)
    assert got == rank, (got, rank)
    try:
        out = CASES[case](rank, world, work)
        json.dump(out, open(os.path.join(work, f"rank{rank}.json"), "w"),
                  default=lambda v: v if math.isfinite(v) else str(v))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
