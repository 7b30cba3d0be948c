"""Data parallelism of the PyTorch port across the cards of one host: what a
group of one rank (chip_smoke.py's phase dist) cannot show.

    python3 dist_probe.py [--cards N] [--steps S] [--out result.json]
    python3 dist_probe.py --cpu          # the same checks at a small size, on gloo
    python3 dist_probe.py --parts tp     # tensor parallelism alone

spawn_local starts one rank a card (N: every visible card, at least 2) on
NCCL. Each rank runs, on its own block of the rows:
  1. mbstd:   the minibatch-std layer of a 1024^2 D's epilogue
              ([4N, 4, 4, 512], groups of 4 that span the ranks) and its input
              gradient, against one card on the whole batch;
  2. stages: each stage's gradient of a 64^2 pair with its randomness off
              (G_main, G_reg at the default pl_batch_shrink, whose rows lie
              on the first ranks only, D_main, D_reg; from one state, no
              Adam step between them) at batch 2N, against one card on the
              same global batch: the ranks' gradients bit-equal, each
              within the train-step tests' gradient tolerance, pl_mean
              within 1e-5 (after an Adam step, whose first steps are
              lr * sign(g), reordered sums part the runs by +-lr where a
              gradient element is near 0, so states are not compared);
  3. allreduce: the gradient all-reduce of FFHQ-1024's G and a 1024^2 D
              (their parameter counts in float32, one buffer each, as the
              trainer keeps them) in CUDA events;
  4. iter:    1024^2 iterations at batch 4 a card (global 4N) against one
              card at batch 4: the reg iteration (step 0) and main-only ones
              (cuDNN in its default mode here).
Then, in this process, a 1024^2 projection of 2N rows over every card
(`project(mesh=...)`, what `morph --shard` runs) against the same blocks
of 2 rows on one card (equal latents and losses) and unsharded on one
card. Last, part
  tp:         tensor parallelism, in a group of its own: 2 * (N // 2) ranks on
              a ('data', 'model') mesh with a 2-way model axis (2 x 2 on 4
              cards, 1 x 2 on 2 or 3). Each stage's gradient of FFHQ-1024
              and a 1024^2 D with their randomness off at a global batch of
              4, from one state, gathered whole, on the mesh and, as a
              control, on a data mesh of the same ranks, each against one
              card's float32 and float64 on the same batch (`judge`: the
              gradient tolerance, the float64 rule where a leaf misses it,
              the path length as phase reg holds it), bit-equal on every
              rank; then 1024^2 iterations at batch 4 a data rank (steps
              0..S-1, the randomness on) on either mesh and on one card,
              and one traced main-only iteration of each mesh; each rank's
              parameter and Adam-moment bytes against one card's; the
              collectives' CUDA-event ms a main-only iteration (the model
              axis's all-gathers and all-reduces, the data axis's
              all-reduces); the replicated leaves bit-equal across each
              model group after the iterations; and `dryrun_train_step(N)`.
`--parts` picks some of dp (parts 1-4), project and tp (all by
default). Prints the card's name and power limit, each part's result,
and last one JSON object of every number; writes that to --out when
given. Exits 1 when fewer than 2 cards are visible or a check failed
(after printing every part). Every process runs float32 without TF32
and, but for the timed iterations, cuDNN in deterministic mode.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GRAD_TOL = 1e-4     # the train-step tests' gradient tolerance


def small_cfgs(size):
    """A pair with its randomness off (no local noise, no dropout), as the
    CPU tests' (tests/torch_parallel_workers.py) at `size`."""
    from morphganformer_tpu_torch.models import config as tcfg
    base, top = (1024, 64) if size >= 64 else (256, 32)
    g = tcfg.GANformerConfig(img_resolution=size, z_dim=8, w_dim=8, k=3, channel_base=base,
                             channel_max=top, end_res=3, local_noise=False,
                             mapping=tcfg.MappingConfig(num_layers=2),
                             attention=tcfg.AttentionConfig(dropout=0.0))
    d = tcfg.DiscriminatorConfig(img_resolution=size, channel_base=base, channel_max=top,
                                 mbstd_group_size=2)
    return g, d


def big_cfgs(cpu):
    """FFHQ-1024's G and a 1024^2 D (the small pair under --cpu)."""
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    return small_cfgs(16) if cpu else (ffhq1024_config(), DiscriminatorConfig())


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t) * 1e3


def mbstd_part(work, mesh, device):
    """The layer on this rank's rows of <work>/inputs.npz's x (all of it
    without a mesh) and the gradient of sum(y * cot)."""
    from morphganformer_tpu_torch.models.discriminator import minibatch_std
    from morphganformer_tpu_torch.parallel import data_sharding
    data = np.load(os.path.join(work, "inputs.npz"))
    x = data_sharding(mesh, torch.from_numpy(data["x"]).to(device)).requires_grad_(True)
    cot = data_sharding(mesh, torch.from_numpy(data["cot"]).to(device))
    y = minibatch_std(x, 4, 1, mesh)
    grad, = torch.autograd.grad((y * cot).sum(), x)
    return {"y": y.detach().cpu().numpy(), "grad": grad.cpu().numpy()}


STAGES = ("g_main", "g_reg", "d_main", "d_reg")


def exact_cfgs(cpu):
    """FFHQ-1024 and a 1024^2 D (the small pair under --cpu) with their
    randomness off: no local noise, no attention dropout."""
    g, d = big_cfgs(cpu)
    return dataclasses.replace(g, local_noise=False,
                               attention=dataclasses.replace(g.attention, dropout=0.0)), d


def train_part(work, mesh, device, prefix="", cfgs=None, dtype=torch.float32):
    """Each stage's gradient (G_main, G_reg at the default pl_batch_shrink,
    D_main, D_reg, in the iteration's order and from one state, no Adam
    step between them) on this rank's rows of <work>/inputs.npz's global
    batch (its `prefix`ed arrays), the path-length noise given for JAX's
    rows of the global microbatch; {stage/parameter: gradient}, gathered
    whole on a model axis, and pl_mean. `cfgs` default to the small pair
    at the batch's size; `dtype` float64 runs the nets in float64 on the
    plain and unpacked routes (the float64 rule's reference)."""
    from morphganformer_tpu_torch.models import init_generator
    from morphganformer_tpu_torch.models.discriminator import init_discriminator
    from morphganformer_tpu_torch.parallel import data_sharding
    from morphganformer_tpu_torch.parallel.tp import unshard_like
    from morphganformer_tpu_torch.training import loss as tloss
    from morphganformer_tpu_torch.training import train_step as tts
    data = {k[len(prefix):]: v for k, v in np.load(os.path.join(work, "inputs.npz")).items()
            if k.startswith(prefix)}
    world = mesh.world if mesh is not None else 1
    batch = data["z"].shape[0]
    g_cfg, d_cfg = cfgs or small_cfgs(int(data["real"].shape[1]))
    cfg = tts.TrainConfig(batch_size=batch, batch_gpu=batch // world,
                          loss=tloss.LossConfig(style_mixing=0.0))
    trainer = tts.GANTrainer(g_cfg, d_cfg, cfg, device=device, mesh=mesh)
    state = trainer.make_state(init_generator(g_cfg, seed=3, device=device).to(dtype),
                               init_discriminator(d_cfg, seed=4, device=device).to(dtype),
                               seed=0)
    state.pl_mean = state.pl_mean.to(dtype)
    plain = dtype == torch.float64
    noise = torch.from_numpy(data["pl_noise"]).to(device, dtype)
    real_pl = tts.g_pl_loss

    def g_pl_loss(G, z, cfg, gen, pl_mean, mesh=None, c=None, pl_noise=None):
        rows, _ = tloss.pl_rows(z.shape[0], cfg.pl_batch_shrink, mesh)
        start = mesh.rank * z.shape[0] if mesh is not None else 0
        return real_pl(G, z, cfg, gen, pl_mean, mesh, c=c, pl_noise=noise[start:start + rows])

    z = data_sharding(mesh, torch.from_numpy(data["z"]).to(device, dtype))[None]
    real = data_sharding(mesh, torch.from_numpy(data["real"]).to(device, dtype))[None]
    tts.g_pl_loss = g_pl_loss
    saved_env = os.environ.get("MGT_PACKED_SECOND_ORDER")
    if plain:
        os.environ["MGT_PACKED_SECOND_ORDER"] = "0"
    try:
        grads = {"g_main": trainer.g_main_grads(state, z, plain=plain)[0]}
        grads["g_reg"], _, pl_mean = trainer.g_reg_grads(state, z)
        grads["d_main"] = trainer.d_main_grads(state, real, z, plain=plain)[0]
        grads["d_reg"] = trainer.d_reg_grads(state, real)[0]
    finally:
        tts.g_pl_loss = real_pl
        if plain:
            os.environ.pop("MGT_PACKED_SECOND_ORDER")
            if saved_env is not None:
                os.environ["MGT_PACKED_SECOND_ORDER"] = saved_env
    nets = {"g": state.G, "d": state.D}
    out = {f"{stage}/{name}": g.cpu().numpy() for stage, gs in grads.items()
           for (name, _), g in zip(nets[stage[0]].named_parameters(),
                                   unshard_like(nets[stage[0]], gs))}
    out["pl_mean"] = pl_mean.cpu().numpy()
    return out


def leaf_ratios(got, want, tol=GRAD_TOL):
    """Each leaf's error over its tolerance: tol of its largest entry,
    floored at a share of its stage's largest, as the train-step tests hold
    gradients: 1e-3, and 1.0 for R1 (its bias gradients are sums that
    cancel, and float32 moves them by up to 2e-3 of themselves:
    tests/test_torch_reg.py). {leaf: ratio}."""
    out = {}
    for stage in STAGES:
        keys = [k for k in want if k.startswith(stage + "/")]
        top = max(float(np.abs(want[k]).max()) for k in keys)
        floor = 1.0 if stage == "d_reg" else 1e-3
        for k in keys:
            bound = tol * max(float(np.abs(want[k]).max()), floor * top)
            err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
            out[k] = err / bound if bound > 0 else float(err > 0)
    return out


def stages_close(got, want):
    """The worst leaf's error over its gradient tolerance (`leaf_ratios`)
    and the leaf."""
    return max(((r, k) for k, r in leaf_ratios(got, want).items()), default=(0.0, None))


def allreduce_part(mesh, device, cpu):
    """ms of one all-reduce of G's and one of D's gradient buffer."""
    from morphganformer_tpu_torch.models.discriminator import Discriminator
    from morphganformer_tpu_torch.models.generator import Generator
    from morphganformer_tpu_torch.parallel.mesh import all_mean_
    g_cfg, d_cfg = big_cfgs(cpu)
    with torch.device("meta"):
        counts = [sum(p.numel() for p in net.parameters())
                  for net in (Generator(g_cfg), Discriminator(d_cfg))]
    flats = [torch.ones(n, device=device) for n in counts]
    for _ in range(3):
        for f in flats:
            all_mean_(f, mesh)
    reps = 20
    _, ms = timed(lambda: [all_mean_(f, mesh) for _ in range(reps) for f in flats], device)
    assert all(bool((f == 1).all()) for f in flats)
    return {"params": counts, "ms": ms / reps}


def iter_part(mesh, device, cpu, steps):
    """ms of 1024^2 iterations at batch 4 on this rank (steps 0..steps-1;
    step 0 has G_reg and D_reg), cuDNN in its default mode, as chip_smoke
    times the main-only iteration."""
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    torch.backends.cudnn.deterministic = False
    g_cfg, d_cfg = big_cfgs(cpu)
    world = mesh.world if mesh is not None else 1
    trainer = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=4 * world, batch_gpu=4),
                         device=device, mesh=mesh)
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device=device).manual_seed(7 + (mesh.rank if mesh else 0))
    res = d_cfg.img_resolution
    real = torch.rand((4, res, res, 3), generator=gen, device=device) * 2 - 1
    ms = []
    for step in range(steps):
        stats, t = timed(lambda: trainer.train_iteration(state, real, step), device)
        assert all(math.isfinite(float(v)) for v in stats.values()), stats
        ms.append(t)
    torch.backends.cudnn.deterministic = True
    return ms


F64_RATIO = 2     # the float64 rule: no further from float64 than twice one card's float32


@contextlib.contextmanager
def collective_events(device):
    """Every all-gather and all-reduce issued inside the block, timed: CUDA
    events recorded on the current stream around the call (the call
    returns once the stream waits for the collective), or the host clock
    on the CPU. Yields a list of (kind, group, ms thunk)."""
    import torch.distributed as dist
    saved = dist.all_gather, dist.all_reduce
    events = []

    def wrap(kind, fn):
        def call(*args, **kw):
            if device.type == "cuda":
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = fn(*args, **kw)
                e1.record()
                events.append((kind, kw.get("group"), lambda: e0.elapsed_time(e1)))
            else:
                t = time.perf_counter()
                out = fn(*args, **kw)
                ms = (time.perf_counter() - t) * 1e3
                events.append((kind, kw.get("group"), lambda: ms))
            return out
        return call

    dist.all_gather, dist.all_reduce = wrap("all_gather", saved[0]), wrap("all_reduce",
                                                                          saved[1])
    try:
        yield events
    finally:
        dist.all_gather, dist.all_reduce = saved


def net_bytes(state):
    """float32 bytes of the parameters (G, D, G_ema) and of the Adam moments
    (exp_avg and exp_avg_sq of G's and D's) that this process holds."""
    params = sum(4 * p.numel() for net in (state.G, state.D, state.G_ema)
                 for p in net.parameters())
    moments = sum(4 * st[k].numel() for opt in (state.g_opt, state.d_opt)
                  for st in opt.state.values() for k in ("exp_avg", "exp_avg_sq"))
    return {"params": params, "moments": moments}


def traced_iteration(fn):
    """One call of `fn` (an iteration) under torch.profiler
    (`bench_dw.traced_run`): the host window, the device's busy ms, its
    collectives' device ms (NCCL kernels), the 12 device ops that take the
    most time, and the 6 convolution calls (by input shapes) that take the
    most device time with their kernels."""
    from morphganformer_tpu_torch.bench_dw import traced_run
    prof, averages, r = traced_run(fn, ("nccl",), shapes=True)
    ops = sorted(((e.key, (getattr(e, "self_device_time_total", None)
                           or e.self_cuda_time_total) / 1e3, e.count)
                  for e in averages if e.device_type.name == "CUDA"), key=lambda t: -t[1])
    convs = sorted(((e.key, str(e.input_shapes), (getattr(e, "device_time_total", None)
                                                  or e.cuda_time_total) / 1e3, e.count)
                    for e in prof.key_averages(group_by_input_shape=True)
                    if "convolution" in e.key), key=lambda t: -t[2])
    return {"window_ms": r["window_ms"], "busy_ms": r["busy_ms"], "device_ops": r["launches"],
            "nccl_ms": r["kernels"].get("nccl", (0.0, 0))[0], "top": ops[:12],
            "convolutions": convs[:6]}


def tp_iterations(mesh, device, cpu, steps):
    """ms of 1024^2 iterations at batch 4 a data rank on `mesh` (steps
    0..steps-1, randomness on, cuDNN in its default mode), the collectives'
    ms in the last one (a main-only iteration when steps > 1) by axis and
    kind, this rank's bytes, and whether the replicated parameters and
    moments are bit-equal across the model group afterwards."""
    import torch.distributed as dist

    from morphganformer_tpu_torch.parallel.tp import model_axis
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    torch.backends.cudnn.deterministic = False
    g_cfg, d_cfg = big_cfgs(cpu)
    world = mesh.world if mesh is not None else 1
    trainer = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=4 * world, batch_gpu=4),
                         device=device, mesh=mesh)
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device=device).manual_seed(7 + (mesh.rank if mesh else 0))
    res = d_cfg.img_resolution
    real = torch.rand((4, res, res, 3), generator=gen, device=device) * 2 - 1
    ms, coll = [], {}
    axis = model_axis(mesh)
    for step in range(steps):
        with collective_events(device) as events:
            stats, t = timed(lambda: trainer.train_iteration(state, real, step), device)
        assert all(math.isfinite(float(v)) for v in stats.values()), stats
        ms.append(t)
        coll = {}
        for kind, group, elapsed in events:
            name = ("model_" if axis is not None and group is axis.group else "data_") + kind
            n, total = coll.get(name, (0, 0.0))
            coll[name] = (n + 1, total + elapsed())
    out = {"iter_ms": ms, "collectives": {k: {"calls": n, "ms": v} for k, (n, v) in coll.items()},
           "bytes": net_bytes(state)}
    if device.type == "cuda":
        out["traced"] = traced_iteration(lambda: trainer.train_iteration(state, real, steps))
    torch.backends.cudnn.deterministic = True
    if axis is not None:
        rep = [p.detach().reshape(-1) for net in (state.G, state.D, state.G_ema)
               for sub in net.modules() for n, p in sub.named_parameters(recurse=False)
               if n not in getattr(sub, "tp_names", ())]
        for opt, net in ((state.g_opt, state.G), (state.d_opt, state.D)):
            rep += [opt.state[p][k].reshape(-1) for sub in net.modules()
                    for n, p in sub.named_parameters(recurse=False)
                    if n not in getattr(sub, "tp_names", ()) and p in opt.state
                    for k in ("exp_avg", "exp_avg_sq")]
        flat = torch.cat(rep)
        every = [torch.empty_like(flat) for _ in range(axis.size)]
        dist.all_gather(every, flat, group=axis.group)
        out["replicated_equal"] = all(torch.equal(every[0], e) for e in every)
        out["replicated_numel"] = flat.numel()
    del state, trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def tp_rank(rank, work, cpu, steps):
    """Part tp on one rank: the stage gradients on the ('data', 'model') mesh
    and, the control, on a data mesh of the same ranks (written to
    <work>/tp_grads<rank>.npz, dp_grads<rank>.npz), then the timed
    iterations on each (<work>/tp<rank>.json)."""
    from morphganformer_tpu_torch.parallel import make_data_mesh
    from morphganformer_tpu_torch.parallel.tp import make_mesh
    exact_mode()
    device_kind = "cpu" if cpu else "cuda"
    mesh = make_mesh(model_parallel=2, device=device_kind)
    data_mesh = make_data_mesh(device=device_kind)
    device = mesh.device
    for name, m in (("tp", mesh), ("dp", data_mesh)):
        np.savez(os.path.join(work, f"{name}_grads{rank}.npz"),
                 **train_part(work, m, device, prefix="tp_", cfgs=exact_cfgs(cpu)))
    out = {"mesh": mesh.shape, "tp": tp_iterations(mesh, device, cpu, steps),
           "dp": tp_iterations(data_mesh, device, cpu, steps)}
    json.dump(out, open(os.path.join(work, f"tp{rank}.json"), "w"))


MAIN_TOL = 1e-3      # phase train's bound of kernels against plain: each leaf, floored
PL_OF_STAGE = 5e-2   # phase reg's bound of the path length: of the stage's largest entry


def judge(got, want, want64):
    """Each stage's gradients `got` against one card's float32 `want` and
    float64 `want64`, by two rules. Per leaf (printed): within the
    gradient tolerance (`leaf_ratios`), and where a leaf misses it, within
    it of float64 or no further from float64 than F64_RATIO times one
    card's float32. By stage (the check): every leaf within MAIN_TOL, as
    phase train holds kernels against plain (R1 of the stage's largest
    entry), the path length within PL_OF_STAGE of the stage's largest
    entry, as phase reg holds it (PR 15: a nudge of 1e-7 to float64's
    weights moves its single leaves by up to a third); and the stage's
    worst leaf no further from float64 than F64_RATIO times one card's
    float32 worst leaf. Two float32 routes that split the batch otherwise
    (cuDNN picks other algorithms at another batch) part on leaves whose
    gradient sums terms that cancel, so at FFHQ-1024 the per-leaf rule
    fails a data mesh too. Returns ({stage: numbers}, whether every stage
    passed the check)."""
    ratios = leaf_ratios(got, want)
    wide = leaf_ratios(got, want, tol=MAIN_TOL)
    to64 = leaf_ratios(got, want64, tol=1.0)
    one64 = leaf_ratios(want, want64, tol=1.0)
    out, ok = {}, True
    for stage in STAGES:
        keys = [k for k in want if k.startswith(stage + "/")]
        top = max(float(np.abs(want[k]).max()) for k in keys)
        over = [k for k in keys if ratios[k] > 1.0]
        failed = [k for k in over
                  if not (to64[k] <= GRAD_TOL or to64[k] <= F64_RATIO * one64[k])]
        of_stage = max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
                       for k in keys) / top
        mesh64 = max((to64[k], k) for k in keys)
        ref64 = max((one64[k], k) for k in keys)
        bound_ok = of_stage <= PL_OF_STAGE if stage == "g_reg" else max(
            wide[k] for k in keys) <= 1.0
        out[stage] = {"worst": max((ratios[k], k) for k in keys), "leaves": len(keys),
                      "over": len(over), "over_f64_rule": len(failed),
                      "worst_f64_rule": max(((to64[k] / max(one64[k], 1e-30), k)
                                             for k in failed), default=None),
                      "of_stage": of_stage, "worst_of_main_tol": max(wide[k] for k in keys),
                      "to_f64_worst": mesh64, "one_to_f64_worst": ref64,
                      "passed": bool(bound_ok and mesh64[0] <= F64_RATIO * ref64[0])}
        ok &= out[stage]["passed"]
    return out, ok


def tp_part(n, cpu, steps, one, card, check):
    """Part tp: its own group of 2 * (n // 2) ranks (`tp_rank`), checked and
    printed here against one card; then `dryrun_train_step(n)`. Returns
    its numbers."""
    from morphganformer_tpu_torch.parallel import spawn_local
    from morphganformer_tpu_torch.training.train_step import dryrun_train_step
    nt = 2 * (n // 2)
    rng = np.random.RandomState(5)
    g_cfg, d_cfg = exact_cfgs(cpu)
    res = d_cfg.img_resolution
    pair = f"G at {g_cfg.img_resolution}^2, k {g_cfg.k}, and a {res}^2 D"
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "inputs.npz"),
                 tp_z=rng.randn(4, g_cfg.k, g_cfg.z_dim).astype(np.float32),
                 tp_real=rng.randn(4, res, res, 3).astype(np.float32),
                 tp_pl_noise=(rng.randn(2, res, res, 3) / res).astype(np.float32))
        _, spawn_ms = timed(lambda: spawn_local(tp_rank, nt, "gloo" if cpu else "nccl",
                                                args=(work, cpu, steps), timeout_s=900), one)
        ranks = [json.load(open(os.path.join(work, f"tp{r}.json"))) for r in range(nt)]
        runs = {name: [dict(np.load(os.path.join(work, f"{name}_grads{r}.npz")))
                       for r in range(nt)] for name in ("tp", "dp")}
        for name, what in (("tp", "the mesh"), ("dp", "the data mesh")):
            check(f"tp: every rank's gathered gradients on {what} bit-equal",
                  all(np.array_equal(runs[name][0][k], runs[name][r][k])
                      for r in range(1, nt) for k in runs[name][0]))
        want = train_part(work, None, one, prefix="tp_", cfgs=exact_cfgs(cpu))
        want64 = train_part(work, None, one, prefix="tp_", cfgs=exact_cfgs(cpu),
                            dtype=torch.float64)
        judged, pl = {}, {"one": float(want["pl_mean"]), "one_f64": float(want64["pl_mean"])}
        for name in ("tp", "dp"):
            judged[name], ok = judge(runs[name][0], want, want64)
            pl[name] = float(runs[name][0]["pl_mean"])
            for stage, j in judged[name].items():
                print(f"tp: {name} {stage} vs one card ({pair}, randomness off, batch 4): "
                      f"per leaf, worst {j['worst'][0]:.3f} of the gradient tolerance "
                      f"({j['worst'][1]}), {j['over']} of {j['leaves']} leaves past it, "
                      f"{j['over_f64_rule']} past the float64 rule too (worst "
                      f"{j['worst_f64_rule']}); by stage, worst {j['worst_of_main_tol']:.3f} "
                      f"of {MAIN_TOL}, {j['of_stage']:.3e} of the stage's largest entry; to "
                      f"float64 worst {j['to_f64_worst'][0]:.3e} ({j['to_f64_worst'][1]}), "
                      f"one card's {j['one_to_f64_worst'][0]:.3e}: "
                      f"{'passes' if j['passed'] else 'misses'} the stage rule", flush=True)
            if name == "tp":
                check("tp: each stage's gradients on the mesh within the stage rule against "
                      "one card (`judge`)", ok)
                check("tp: the mesh's pl_mean within 1e-3 of one card's",
                      abs(pl[name] - pl["one"]) <= 1e-3 * abs(pl["one"]) and pl["one"] != 0)
        print(f"tp: pl_mean {pl}", flush=True)
        check("tp: replicated leaves bit-equal across each model group after the iterations",
              all(r["tp"]["replicated_equal"] for r in ranks))
    solo = tp_iterations(None, one, cpu, steps)
    whole = solo["bytes"]
    for r, out in enumerate(ranks):
        b = out["tp"]["bytes"]
        print(f"tp: rank {r} holds {b['params']} parameter and {b['moments']} Adam-moment bytes; "
              f"one card {whole['params']} and {whole['moments']}", flush=True)
    check("tp: every rank's parameter and moment bytes below one card's",
          all(out["tp"]["bytes"]["params"] < whole["params"]
              and out["tp"]["bytes"]["moments"] < whole["moments"] for out in ranks))
    tp_ms, dp_ms = ranks[0]["tp"]["iter_ms"], ranks[0]["dp"]["iter_ms"]
    coll = ranks[0]["tp"]["collectives"]
    share = sum(v["ms"] for v in coll.values()) / tp_ms[-1]
    print(f"tp: {res}^2 iterations at batch 4 a data rank, steps 0..{steps - 1}: "
          f"{ranks[0]['mesh']} rank 0 {tp_ms} ms; a data mesh of the same {nt} ranks {dp_ms} ms; "
          f"one card {solo['iter_ms']} ms; {card}", flush=True)
    for name in ("tp", "dp"):
        t = ranks[0][name].get("traced")
        if t:
            print(f"tp: {name} rank 0, one traced main-only iteration: window "
                  f"{t['window_ms']:.1f} ms, device busy {t['busy_ms']:.1f} ms in "
                  f"{t['device_ops']} ops, NCCL kernels {t['nccl_ms']:.1f} ms; top: "
                  + "; ".join(f"{k[:60]} {ms:.1f} ms ({n})" for k, ms, n in t["top"]),
                  flush=True)
            print(f"tp: {name} rank 0, the convolutions that take the most device time: "
                  + "; ".join(f"{k} {shapes} {ms:.1f} ms ({n})"
                              for k, shapes, ms, n in t["convolutions"]), flush=True)
    print(f"tp: collectives of rank 0's last iteration "
          f"({'host clock' if cpu else 'CUDA events'}): "
          + ", ".join(f"{k} {v['calls']} calls {v['ms']:.3f} ms" for k, v in coll.items())
          + f"; {100 * share:.2f} % of it; {card}", flush=True)
    _, dry_ms = timed(lambda: dryrun_train_step(n, device="cpu" if cpu else "cuda"), one)
    return {"ranks": nt, "mesh": ranks[0]["mesh"], "spawn_ms": spawn_ms,
            "grads": judged, "pl_mean": pl, "bytes": {"ranks": [r["tp"]["bytes"] for r in ranks], "one": whole},
            "iter_ms": {"tp": [r["tp"]["iter_ms"] for r in ranks],
                        "dp": [r["dp"]["iter_ms"] for r in ranks], "one": solo["iter_ms"]},
            "collectives": [r["tp"]["collectives"] for r in ranks],
            "dp_collectives": [r["dp"]["collectives"] for r in ranks],
            "collective_share": share, "dryrun_ms": dry_ms}


def exact_mode():
    """float32 without TF32, and cuDNN in deterministic mode."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def rank_main(rank, work, cpu, steps):
    from morphganformer_tpu_torch.parallel import make_data_mesh
    exact_mode()
    mesh = make_data_mesh(device="cpu" if cpu else "cuda")
    device = mesh.device
    np.savez(os.path.join(work, f"mbstd{rank}.npz"), **mbstd_part(work, mesh, device))
    np.savez(os.path.join(work, f"train{rank}.npz"), **train_part(work, mesh, device))
    out = {"allreduce": allreduce_part(mesh, device, cpu),
           "iter_ms": iter_part(mesh, device, cpu, steps)}
    json.dump(out, open(os.path.join(work, f"rank{rank}.json"), "w"))


def project_part(n, cpu, steps):
    """A projection of 2n rows three ways, in turns: over n devices
    ("cards"), in the same n blocks of 2 rows on the first device
    ("blocks"), and unsharded on the first device ("plain"). The first two
    run the same shapes, so their latents and losses must be equal; the
    third runs other batch shapes, which round otherwise."""
    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.models import init_generator
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, project
    g_cfg, _ = big_cfgs(cpu)
    devices = ["cpu"] * n if cpu else [f"cuda:{i}" for i in range(n)]
    dev = torch.device(devices[0])
    G = init_generator(g_cfg, seed=0, device=dev)
    z = torch.randn((2 * n, g_cfg.k, g_cfg.z_dim), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        target = G(z=z.to(dev), truncation_psi=0.7)
    mean, std = latent_stats(g_cfg, torch.Generator().manual_seed(1), 1000)
    pcfg = ProjectionConfig(steps=steps, chunk=steps)
    meshes = {"cards": devices, "blocks": [devices[0]] * n, "plain": None}
    runs = {name: [] for name in meshes}
    for name in ("cards", "blocks", "plain", "cards", "blocks", "plain"):
        r, ms = timed(lambda: project(G, target, build_loss_stack({"mse": 1.0}), pcfg, mean,
                                      std, generator=torch.Generator().manual_seed(2),
                                      mesh=meshes[name]), dev)
        runs[name].append((r, ms))
    a, b, c = (runs[name][-1][0] for name in ("cards", "blocks", "plain"))
    return {"rows": 2 * n, "steps": steps,
            "ms": {name: [ms for _, ms in rs] for name, rs in runs.items()},
            "cards_equal_blocks": bool(torch.equal(a.latent.cpu(), b.latent.cpu())
                                       and torch.equal(a.loss_history, b.loss_history)),
            "finite": bool(torch.isfinite(a.loss_history).all()),
            "loss_vs_plain": float(((a.loss_history - c.loss_history).abs()
                                    / c.loss_history.abs()).max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--steps", type=int, default=4, help="1024^2 iterations a run")
    ap.add_argument("--project-steps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="gloo, small shapes, 4 processes")
    ap.add_argument("--parts", default="dp,project,tp", help="comma list of dp, project, tp")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    parts = set(args.parts.split(","))
    if parts - {"dp", "project", "tp"}:
        ap.error(f"unknown parts {sorted(parts - {'dp', 'project', 'tp'})}")
    cpu = args.cpu
    if cpu:
        n, card = args.cards or 4, "cpu"
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("dist_probe: needs 2 or more CUDA devices", file=sys.stderr)
            return 1
        n = args.cards or torch.cuda.device_count()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
        from morphganformer_tpu_torch.ops import _build
        _build.build()
        _build.library()
    print(f"{card}; {n} ranks; torch {torch.__version__}", flush=True)
    failed = []

    def check(what, ok):
        print(f"check {what}: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(what)

    one = torch.device("cpu" if cpu else "cuda:0")
    exact_mode()
    result = {"card": card, "ranks": n, "failed": failed}
    if "dp" in parts:
        result.update(dp_parts(n, cpu, args.steps, one, card, check))
    if "project" in parts:
        proj = project_part(n, cpu, args.project_steps)
        check("projection over the devices equal to its blocks on one device",
              proj["finite"] and proj["cards_equal_blocks"])
        print(f"projection of {proj['rows']} rows, {proj['steps']} steps, ms in turns: over {n} "
              f"devices {proj['ms']['cards']}, the same blocks on one {proj['ms']['blocks']}, "
              f"unsharded on one {proj['ms']['plain']}; loss history against unsharded, worst "
              f"relative {proj['loss_vs_plain']}; {card}", flush=True)
        result["projection"] = proj
    if "tp" in parts:
        result["tp"] = tp_part(n, cpu, args.steps, one, card, check)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        json.dump(result, open(args.out, "w"), indent=1)
    print(json.dumps(result), flush=True)
    return 1 if failed else 0


def dp_parts(n, cpu, steps, one, card, check):
    """Parts 1-4 in one group of n ranks (`rank_main`), checked and printed
    here against one card. Returns their numbers."""
    from morphganformer_tpu_torch.parallel import spawn_local
    rng = np.random.RandomState(0)
    size = 16 if cpu else 64
    with tempfile.TemporaryDirectory() as work:
        np.savez(os.path.join(work, "inputs.npz"),
                 x=rng.randn(4 * n, 4, 4, 512 if not cpu else 32).astype(np.float32),
                 cot=rng.randn(4 * n, 4, 4, 513 if not cpu else 33).astype(np.float32),
                 z=rng.randn(2 * n, 3, 8).astype(np.float32),
                 real=rng.randn(2 * n, size, size, 3).astype(np.float32),
                 pl_noise=(rng.randn(n, size, size, 3) / size).astype(np.float32))
        _, spawn_ms = timed(lambda: spawn_local(rank_main, n, "gloo" if cpu else "nccl",
                                                args=(work, cpu, steps), timeout_s=600),
                            one)
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(n)]
        want = mbstd_part(work, None, one)
        got = [np.load(os.path.join(work, f"mbstd{r}.npz")) for r in range(n)]
        mbstd = {key: float(np.abs(np.concatenate([g[key] for g in got]) - want[key]).max())
                 for key in ("y", "grad")}
        check("mbstd within 1e-5 of one card", max(mbstd.values()) < 1e-5)
        print(f"mbstd across {n} ranks vs one card: max |diff| {mbstd}", flush=True)
        trains = [dict(np.load(os.path.join(work, f"train{r}.npz"))) for r in range(n)]
        check("ranks' gradients bit-equal", all(np.array_equal(trains[0][k], trains[r][k])
                                                for r in range(1, n) for k in trains[0]))
        want = train_part(work, None, one)
        worst = stages_close(trains[0], want)
        pl = (float(trains[0]["pl_mean"]), float(want["pl_mean"]))
        check("each stage's gradients within the gradient tolerance", worst[0] <= 1.0)
        check("pl_mean within 1e-5", abs(pl[0] - pl[1]) <= 1e-5 * abs(pl[1]) and pl[1] != 0)
        print(f"stage gradients at world {n} vs 1 ({size}^2, batch {2 * n}): worst error "
              f"over tolerance {worst}; pl_mean {pl}", flush=True)
        ar = [r["allreduce"]["ms"] for r in ranks]
        iters = [r["iter_ms"] for r in ranks]
        print(f"all-reduce of G + D gradients ({ranks[0]['allreduce']['params']} float32) "
              f"at world {n}: {ar} ms by rank; {card}", flush=True)
        solo = iter_part(None, one, cpu, steps)
        print(f"1024^2 iterations at batch 4 a card, steps 0..{steps - 1}: world {n} "
              f"rank 0 {iters[0]} ms; one card {solo} ms; {card}", flush=True)
    return {"spawn_ms": spawn_ms, "mbstd_max_diff": mbstd,
            "stages": {"worst": worst, "pl_mean": pl},
            "allreduce_ms": ar, "allreduce_params": ranks[0]["allreduce"]["params"],
            "iter_ms": {"world": iters, "one": solo}}


if __name__ == "__main__":
    sys.exit(main())
