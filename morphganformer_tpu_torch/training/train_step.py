"""The lazily regularised adversarial training step (port of
morphganformer_tpu/training/train_step.py:53-391).

One iteration runs G_main, G_reg (path length) when `step % g_reg_interval
== 0`, D_main with the EMA tail, then D_reg (R1) when `step %
d_reg_interval == 0`, in JAX's order, on one batch split into
`batch_size // batch_gpu` accumulation rounds. Each stage's gradient is the
MEAN of its rounds' gradients (the JAX form, which keeps accumulation
exact), NaN-scrubbed, then one Adam step with the lazy-regularisation
rescale of lr and betas by r/(r+1) (reference training_loop.py:162-174);
the reg stages scale their loss by the interval and share their net's
Adam state with its main stage. w_avg is a buffer that each G_main round's
mapping moves in place, and pl_mean a tensor of the state that each G_reg
round moves, so the rounds see both in sequence as the JAX scan threads
them. optax's `adam` and torch's Adam compute the same bias-corrected step.
One `torch.Generator` on the device, seeded by `init_state`, makes every
random draw of the step. The reg stages run on the fused kernels'
second-order route by default, on the unpacked route under
MGT_PACKED_SECOND_ORDER=0 (training/loss.py).

Data-parallel training (`GANTrainer(..., mesh=make_data_mesh())`,
parallel/mesh.py) runs each accumulation round on this rank's rows of the
global microbatch and, as JAX counts its data axis, makes `n_accum =
batch_size // (batch_gpu * world)`. Each stage's round-mean gradients are
averaged over the ranks in one all-reduce before the NaN scrub and Adam;
inside a stage the minibatch-std layer, the w_avg update and the path
length (JAX's rows of the global microbatch, and their mean) see every
rank's rows, through the mesh that the stages hand them. The
nets start equal on every rank (broadcast from rank 0 by `make_state`),
and each rank's generator is seeded `seed + data rank`, as JAX's loop
seeds each process. The kernels' Functions are unchanged: only gradients
and those few activations cross ranks.

Tensor parallelism (`GANTrainer(..., mesh=make_mesh(model_parallel=m))`,
parallel/tp.py) adds a model axis: after the broadcast, `make_state`
slices every parameter that JAX shards to this rank's output channels
(`shard_params`; the EMA copy is made from the sliced G, and the
optimizers are built on the slices, so the Adam moments are sliced too),
and each sharded layer computes its slice and gathers it. The batch
divides the data axis alone: the ranks of one model group hold the same
rows and draw the same z, noise and dropout (their generators share the
data rank's seed), and the stages average over the data axis as before;
each stage then averages the replicated parameters' gradients over the
model group, so that the replicas stay bit-equal where the ranks' own ops
do not sum alike (cuDNN's default algorithms). A model
axis trains float32 only. `dryrun_train_step` is JAX's multi-device dry
run: one step-0 iteration of a tiny pair over `spawn_local` processes on
a ('data', 'model') mesh, then a sharded projection.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch

from morphganformer_tpu_torch.models.config import DiscriminatorConfig, GANformerConfig
from morphganformer_tpu_torch.models.discriminator import Discriminator, init_discriminator
from morphganformer_tpu_torch.models.generator import Generator, init_generator
from morphganformer_tpu_torch.parallel.mesh import DataMesh, all_mean_, replicated
from morphganformer_tpu_torch.parallel.tp import (
    check_float32,
    model_axis,
    model_mean_,
    replicated_mask,
    shard_params,
)
from morphganformer_tpu_torch.training.loss import (
    LossConfig,
    d_main_loss,
    d_r1_loss,
    g_main_loss,
    g_pl_loss,
)
from morphganformer_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference training defaults (run_network.py:463-468, :37)."""
    batch_size: int = 32           # global batch
    batch_gpu: int = 4             # microbatch per accumulation round
    g_lr: float = 0.002
    d_lr: float = 0.002
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8
    g_reg_interval: Optional[int] = 4
    d_reg_interval: Optional[int] = 16
    ema_kimg: float = 10.0
    ema_rampup: Optional[float] = None
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)


@dataclasses.dataclass
class TrainState:
    """The nets, the EMA generator, the two optimizers, the generator of
    random draws and the path-length mean (a 0-d tensor). The modules are
    updated in place."""
    G: Generator
    D: Discriminator
    G_ema: Generator
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam
    gen: torch.Generator
    pl_mean: torch.Tensor
    cur_nimg: int = 0


def _nan_scrub(g):
    """nan -> 0, +-inf -> +-1e5 on grads (reference training_loop.py:203-205)."""
    return torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5)


def make_optimizer(params, lr, beta1, beta2, eps, reg_interval):
    """Adam with the lazy-regularisation rescale (training_loop.py:166-170)."""
    if reg_interval is not None:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        beta1, beta2 = beta1 ** mb_ratio, beta2 ** mb_ratio
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=eps)


def ema_beta(batch_size, cur_nimg, ema_kimg, ema_rampup):
    """Reference update_ema_network beta (training_loop.py:212-224)."""
    ema_nimg = ema_kimg * 1000
    if ema_rampup is not None:
        ema_nimg = min(ema_nimg, cur_nimg * ema_rampup)
    return 0.5 ** (batch_size / max(ema_nimg, 1e-8))


@torch.no_grad()
def ema_update(G_ema, G, beta):
    """p_ema <- p + beta (p_ema - p) for every parameter, in place."""
    for e, p in zip(G_ema.parameters(), G.parameters()):
        e.copy_(p + beta * (e - p))


def stage_grads(params, rounds, mesh: Optional[DataMesh] = None):
    """The mean over accumulation rounds of each round's gradient of its
    loss w.r.t. `params` (zeros for a parameter a round does not reach),
    averaged over the ranks of `mesh`, NaN-scrubbed, and this rank's
    rounds' mean stats as 0-d tensors on the device (read on the host once
    per iteration: `training/stats.py`). `rounds` yields (loss, stats) one
    round at a time; a loss without a graph (a rank that holds none of the
    path-length rows) adds zeros."""
    # One buffer holds every gradient, so the mean over ranks is one
    # all-reduce of it, with no copy in or out.
    sizes = [p.numel() for p in params]
    flat = torch.zeros(sum(sizes), dtype=params[0].dtype, device=params[0].device)
    acc = [a.view_as(p) for a, p in zip(flat.split(sizes), params)]
    stats, n = {}, 0
    for loss, aux in rounds:
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
        for k, v in aux.items():
            stats[k] = stats.get(k, 0.0) + v
        n += 1
    flat = _nan_scrub(all_mean_(flat.div_(n), mesh))
    return ([g.view_as(p) for g, p in zip(flat.split(sizes), params)],
            {k: v / n for k, v in stats.items()})


def _rounds(c, n):
    """The labels of each of n rounds: the rows of c [n, micro, c_dim], or
    None n times for an unconditional pair."""
    return [None] * n if c is None else c


def _apply(opt, params, grads):
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


class GANTrainer:
    """The G_main, G_reg, D_main and D_reg stages and the EMA for one (G, D)
    pair, on `device`: the card unless the caller asks for the CPU (under a
    `mesh`, this rank's device of it). A ('data', 'model') mesh
    (parallel/tp.py `make_mesh`) shards the nets over its model axis and the
    batch over its data axis; it refuses a bfloat16 pair."""

    def __init__(self, g_cfg: GANformerConfig, d_cfg: DiscriminatorConfig, cfg: TrainConfig,
                 device="cuda", mesh: Optional[DataMesh] = None):
        check_float32(mesh, g_cfg, d_cfg)
        self.g_cfg, self.d_cfg, self.cfg = g_cfg, d_cfg, cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        world = mesh.world if mesh is not None else 1
        if cfg.batch_size % world:
            raise ValueError(f"batch_size {cfg.batch_size} does not divide the data mesh "
                             f"({world} ranks)")
        per_step = (cfg.batch_gpu or 0) * world
        self.n_accum = max(1, cfg.batch_size // per_step) if per_step else 1
        if cfg.batch_size % self.n_accum:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible into "
                             f"{self.n_accum} accumulation rounds")

    # -------------- state --------------

    def init_state(self, seed=0):
        """G from `seed`, D from `seed + 4` (as JAX keys them), the EMA copy
        of G, the optimizers, and the step's generator seeded with `seed`."""
        G = init_generator(self.g_cfg, seed=seed, device=self.device)
        D = init_discriminator(self.d_cfg, seed=seed + 4, device=self.device)
        return self.make_state(G, D, seed)

    def make_state(self, G, D, seed=0):
        """A state around existing nets (e.g. carried from JAX), broadcast
        from rank 0 under a mesh and then, on a model axis, sliced in place
        (`shard_params`); the generator is seeded `seed + data rank`."""
        cfg = self.cfg
        for net in (G, D):
            replicated(net, self.mesh)
            shard_params(net, self.mesh)
        G_ema = copy.deepcopy(G).requires_grad_(False)
        return TrainState(
            G=G, D=D, G_ema=G_ema,
            g_opt=make_optimizer(G.parameters(), cfg.g_lr, cfg.beta1, cfg.beta2, cfg.eps,
                                 cfg.g_reg_interval),
            d_opt=make_optimizer(D.parameters(), cfg.d_lr, cfg.beta1, cfg.beta2, cfg.eps,
                                 cfg.d_reg_interval),
            gen=torch.Generator(device=self.device).manual_seed(seed + self.rank),
            pl_mean=torch.zeros((), device=self.device))

    @property
    def rank(self) -> int:
        """This rank's index on the data axis."""
        return self.mesh.rank if self.mesh is not None else 0

    # -------------- stages --------------

    def g_main_grads(self, state, z, gen=None, plain=False, c=None):
        """G_main's round-mean gradients w.r.t. G's parameters (D frozen, so
        its weight cotangents are never formed) and its stats. z: [n_accum,
        micro, k, z_dim], c: [n_accum, micro, c_dim] or None. `gen`
        replaces the state's generator and `plain=True` runs the fused
        blocks on the plain versions of the kernels (both to check the
        kernels on the same draws)."""
        gen = state.gen if gen is None else gen
        params = list(state.G.parameters())
        state.D.requires_grad_(False)
        try:
            return self._replicas_agree(state.G, stage_grads(params, (
                g_main_loss(state.G, state.D, z_r, self.cfg.loss, gen, plain, self.mesh, c_r)
                for z_r, c_r in zip(z, _rounds(c, len(z)))), self.mesh))
        finally:
            state.D.requires_grad_(True)

    def d_main_grads(self, state, real_img, z, gen=None, plain=False, c=None):
        """D_main's round-mean gradients w.r.t. D's parameters and its stats,
        as `g_main_grads`. real_img: [n_accum, micro, R, R, C]."""
        gen = state.gen if gen is None else gen
        params = list(state.D.parameters())
        return self._replicas_agree(state.D, stage_grads(params, (
            d_main_loss(state.G, state.D, real_r, z_r, self.cfg.loss, gen, plain, self.mesh,
                        c_r)
            for real_r, z_r, c_r in zip(real_img, z, _rounds(c, len(z)))), self.mesh))

    def g_reg_grads(self, state, z, gen=None, c=None):
        """G_reg's round-mean gradients w.r.t. G's parameters, its stats and
        the pl_mean after the rounds (JAX `g_reg_step`): each round's
        path-length loss times `g_reg_interval`, pl_mean carried from round
        to round. z: [n_accum, micro, k, z_dim]."""
        gen = state.gen if gen is None else gen
        gain = float(self.cfg.g_reg_interval or 1)
        pl_mean = state.pl_mean

        def rounds():
            nonlocal pl_mean
            for z_r, c_r in zip(z, _rounds(c, len(z))):
                loss, aux = g_pl_loss(state.G, z_r, self.cfg.loss, gen, pl_mean, self.mesh,
                                      c_r)
                pl_mean = aux.pop("pl_mean")
                yield loss * gain, aux

        grads, stats = self._replicas_agree(
            state.G, stage_grads(list(state.G.parameters()), rounds(), self.mesh))
        return grads, stats, pl_mean

    def d_reg_grads(self, state, real_img, c=None):
        """D_reg's round-mean gradients w.r.t. D's parameters and its stats
        (JAX `d_reg_step`): each round's R1 loss times `d_reg_interval`.
        real_img: [n_accum, micro, R, R, C]."""
        gain = float(self.cfg.d_reg_interval or 1)

        def rounds():
            for real_r, c_r in zip(real_img, _rounds(c, len(real_img))):
                loss, aux = d_r1_loss(state.D, real_r, self.cfg.loss, self.mesh, c_r)
                yield loss * gain, aux

        return self._replicas_agree(
            state.D, stage_grads(list(state.D.parameters()), rounds(), self.mesh))

    def _replicas_agree(self, net, out):
        """stage_grads' (grads, stats) with, on a model axis, the replicated
        parameters' gradients averaged over the model group in place."""
        axis = model_axis(self.mesh)
        if axis is not None:
            model_mean_([g for g, whole in zip(out[0], replicated_mask(net)) if whole], axis)
        return out

    def g_main_step(self, state, z, c=None):
        """One G_main update; returns its stats."""
        grads, stats = self.g_main_grads(state, z, c=c)
        _apply(state.g_opt, list(state.G.parameters()), grads)
        return stats

    def g_reg_step(self, state, z, c=None):
        """One G_reg update and the new pl_mean; returns its stats."""
        grads, stats, state.pl_mean = self.g_reg_grads(state, z, c=c)
        _apply(state.g_opt, list(state.G.parameters()), grads)
        return stats

    def d_reg_step(self, state, real_img, c=None):
        """One D_reg update; returns its stats."""
        grads, stats = self.d_reg_grads(state, real_img, c)
        _apply(state.d_opt, list(state.D.parameters()), grads)
        return stats

    def d_main_step(self, state, real_img, z, c=None):
        """One D_main update, then the end-of-iteration EMA (JAX folds it
        into this stage's tail; G changes only in the G stages, which ran
        before); returns its stats."""
        grads, stats = self.d_main_grads(state, real_img, z, c=c)
        _apply(state.d_opt, list(state.D.parameters()), grads)
        self._ema_tail(state)
        return stats

    def _ema_tail(self, state):
        cfg = self.cfg
        beta = ema_beta(cfg.batch_size, state.cur_nimg, cfg.ema_kimg, cfg.ema_rampup)
        ema_update(state.G_ema, state.G, beta)
        with torch.no_grad():
            state.G_ema.mapping.w_avg.copy_(state.G.mapping.w_avg)
        state.cur_nimg += cfg.batch_size

    # -------------- one full iteration --------------

    def train_iteration(self, state, real_img, step: int, z=None, c=None):
        """The stages due at `step` on one batch of real images [B, R, R, C]
        (under a mesh, this rank's B / world rows of the global batch),
        split into the accumulation rounds (reference training_loop.py:186-209,
        JAX `train_iteration`): G_main, G_reg every `g_reg_interval` steps,
        D_main with the EMA, D_reg every `d_reg_interval` steps. z [B, k,
        z_dim], the iteration's latents, is drawn from the state's generator
        unless given. c [B, c_dim], the reals' labels of a conditional pair,
        is split into the same rounds as the reals and z (JAX
        `train_step.py:359-392`)."""
        cfg = self.cfg
        batch = real_img.shape[0]
        n = self.n_accum if batch % self.n_accum == 0 else 1
        real = real_img.reshape((n, batch // n) + tuple(real_img.shape[1:]))
        if z is None:
            z = torch.randn((batch, self.g_cfg.k, self.g_cfg.z_dim), generator=state.gen,
                            device=real_img.device)
        z = z.reshape((n, batch // n) + tuple(z.shape[1:]))
        if c is not None:
            c = c.reshape((n, batch // n) + tuple(c.shape[1:]))
        stats = self.g_main_step(state, z, c)
        if cfg.g_reg_interval and step % cfg.g_reg_interval == 0:
            stats.update(self.g_reg_step(state, z, c))
        stats.update(self.d_main_step(state, real, z, c))
        if cfg.d_reg_interval and step % cfg.d_reg_interval == 0:
            stats.update(self.d_reg_step(state, real, c))
        return stats


def dryrun_configs():
    """JAX's dry-run pair: a 16^2 GANformer (k 3, channel_max 32) and a 16^2 D
    with minibatch-std groups of 2 (JAX `train_step.py:413-420`)."""
    from morphganformer_tpu_torch.models.config import AttentionConfig, MappingConfig
    g_cfg = GANformerConfig(img_resolution=16, z_dim=8, w_dim=8, k=3, channel_base=256,
                            channel_max=32, end_res=3, mapping=MappingConfig(num_layers=2),
                            attention=AttentionConfig())
    d_cfg = DiscriminatorConfig(img_resolution=16, channel_base=256, channel_max=32,
                                mbstd_group_size=2)
    return g_cfg, d_cfg


def dryrun_model_parallel(n_devices: int) -> int:
    """JAX's choice: a 2-way model axis at 4 or more devices divisible by 4
    (the data axis stays even, for the minibatch-std groups of 2), else none."""
    return 2 if n_devices >= 4 and n_devices % 4 == 0 else 1


def _dryrun_rank(rank, n_devices, device):
    """One rank of `dryrun_train_step`: a step-0 iteration (all four stages)
    on the mesh; prints JAX's first line on rank 0."""
    import torch.distributed as dist

    from morphganformer_tpu_torch.parallel.mesh import data_sharding, mean_over_ranks
    from morphganformer_tpu_torch.parallel.tp import make_mesh, model_axis

    m = dryrun_model_parallel(n_devices)
    mesh = make_mesh(model_parallel=m, device=device)
    g_cfg, d_cfg = dryrun_configs()
    data = n_devices // m
    # batch_gpu 1: two accumulation rounds, as JAX's dry run.
    trainer = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=2 * data, batch_gpu=1),
                         mesh=mesh)
    state = trainer.init_state(seed=0)
    axis = model_axis(mesh)
    if axis is not None:
        assert any(getattr(sub, "tp_names", None) for sub in state.G.modules()), \
            "no parameter sharded over the model axis"
    real = torch.randn((2 * data, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    stats = trainer.train_iteration(state, data_sharding(mesh, real.to(mesh.device)), step=0)
    stats = {k: float(mean_over_ranks(v, mesh)) for k, v in stats.items()}
    for k, v in stats.items():
        assert math.isfinite(v), f"non-finite stat {k}"
    if axis is not None:
        # The replicated leaves are bit-equal across the model group.
        flat = torch.cat([p.detach().reshape(-1) for net in (state.G, state.D, state.G_ema)
                          for sub in net.modules()
                          for n, p in sub.named_parameters(recurse=False)
                          if n not in getattr(sub, "tp_names", ())])
        every = [torch.empty_like(flat) for _ in range(axis.size)]
        dist.all_gather(every, flat, group=axis.group)
        assert all(torch.equal(every[0], e) for e in every), \
            "replicated parameters differ across the model group"
    if rank == 0:
        print(f"dryrun_multichip ok on {n_devices} devices (mesh {mesh.shape}); "
              f"stats: { {k: round(v, 4) for k, v in stats.items()} }", flush=True)


def dryrun_train_step(n_devices: int, device="cuda") -> None:
    """The port of JAX's multi-device dry run (`train_step.py:394-470`):
    `n_devices` processes (`spawn_local`; NCCL on the cards, gloo for
    `device="cpu"`) on a ('data', 'model') mesh with a 2-way model axis at 4
    or more devices divisible by 4 (else a data mesh), JAX's tiny pair,
    one `train_iteration` at step 0 (all four stages; at least one
    parameter sharded, every stat finite, the replicated parameters
    bit-equal across each model group); then, in this process, a batch of
    `n_devices` rows projected for 2 steps over every rank's device
    (`project(mesh=...)`, what `morph --shard` runs). Prints JAX's two
    "dryrun ... ok" lines."""
    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.parallel.launch import spawn_local
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, project

    cpu = resolve_device(device).type == "cpu"
    if not cpu and torch.cuda.device_count() < n_devices:
        raise ValueError(f"need {n_devices} devices, have {torch.cuda.device_count()}")
    spawn_local(_dryrun_rank, n_devices, "gloo" if cpu else "nccl",
                args=(n_devices, device), timeout_s=600)

    g_cfg, _ = dryrun_configs()
    devices = ["cpu"] * n_devices if cpu else [f"cuda:{i}" for i in range(n_devices)]
    G = init_generator(g_cfg, seed=0, device=devices[0])
    z = torch.randn((n_devices, g_cfg.k, g_cfg.z_dim), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        targets = G(z=z.to(devices[0]))
    mean, std = latent_stats(g_cfg, torch.Generator().manual_seed(4), n_mean_latent=64)
    res = project(G, targets, build_loss_stack({"mse": 1.0}),
                  ProjectionConfig(steps=2, chunk=2, n_mean_latent=64), mean, std,
                  generator=torch.Generator().manual_seed(5), mesh=devices)
    assert torch.isfinite(res.per_image_loss).all()
    print(f"dryrun sharded projection ok: batch {n_devices} over ('data',) x{n_devices}, "
          f"per-image loss {[round(float(v), 4) for v in res.per_image_loss]}", flush=True)
