"""Data parallelism of the PyTorch port across the cards of one host: what a
group of one rank (chip_smoke.py's phase dist) cannot show.

    python3 dist_probe.py [--cards N] [--steps S] [--out result.json]
    python3 dist_probe.py --cpu          # the same checks at a small size, on gloo

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
card. Prints the card's name and power limit, each part's result, and last
one JSON object of every number; writes that to --out when given. Exits 1 when
fewer than 2 cards are visible or a check failed (after printing every
part). Every process runs float32 without TF32 and, but for part 4,
cuDNN in deterministic mode.
"""

from __future__ import annotations

import argparse
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


def train_part(work, mesh, device):
    """Each stage's gradient (G_main, G_reg at the default pl_batch_shrink,
    D_main, D_reg, in the iteration's order and from one state, no Adam
    step between them) on this rank's rows of <work>/inputs.npz's global
    batch, the path-length noise given for JAX's rows of the global
    microbatch; {stage/parameter: gradient} and pl_mean."""
    from morphganformer_tpu_torch.models import init_generator
    from morphganformer_tpu_torch.models.discriminator import init_discriminator
    from morphganformer_tpu_torch.parallel import data_sharding
    from morphganformer_tpu_torch.training import loss as tloss
    from morphganformer_tpu_torch.training import train_step as tts
    data = np.load(os.path.join(work, "inputs.npz"))
    world = mesh.world if mesh is not None else 1
    batch = data["z"].shape[0]
    g_cfg, d_cfg = small_cfgs(int(data["real"].shape[1]))
    cfg = tts.TrainConfig(batch_size=batch, batch_gpu=batch // world,
                          loss=tloss.LossConfig(style_mixing=0.0))
    trainer = tts.GANTrainer(g_cfg, d_cfg, cfg, device=device, mesh=mesh)
    state = trainer.make_state(init_generator(g_cfg, seed=3, device=device),
                               init_discriminator(d_cfg, seed=4, device=device), seed=0)
    noise = torch.from_numpy(data["pl_noise"]).to(device)
    real_pl = tts.g_pl_loss

    def g_pl_loss(G, z, cfg, gen, pl_mean, mesh=None, c=None, pl_noise=None):
        rows, _ = tloss.pl_rows(z.shape[0], cfg.pl_batch_shrink, mesh)
        start = mesh.rank * z.shape[0] if mesh is not None else 0
        return real_pl(G, z, cfg, gen, pl_mean, mesh, c=c, pl_noise=noise[start:start + rows])

    z = data_sharding(mesh, torch.from_numpy(data["z"]).to(device))[None]
    real = data_sharding(mesh, torch.from_numpy(data["real"]).to(device))[None]
    tts.g_pl_loss = g_pl_loss
    try:
        grads = {"g_main": trainer.g_main_grads(state, z)[0]}
        grads["g_reg"], _, pl_mean = trainer.g_reg_grads(state, z)
        grads["d_main"] = trainer.d_main_grads(state, real, z)[0]
        grads["d_reg"] = trainer.d_reg_grads(state, real)[0]
    finally:
        tts.g_pl_loss = real_pl
    names = {"g": [n for n, _ in state.G.named_parameters()],
             "d": [n for n, _ in state.D.named_parameters()]}
    out = {f"{stage}/{name}": g.cpu().numpy() for stage, gs in grads.items()
           for name, g in zip(names[stage[0]], gs)}
    out["pl_mean"] = pl_mean.cpu().numpy()
    return out


def stages_close(got, want):
    """Each stage's gradients within GRAD_TOL of their leaf's largest entry,
    floored at a share of the stage's largest, as the train-step tests hold
    gradients: 1e-3, and 1.0 for R1 (its bias gradients are sums that
    cancel, and float32 moves them by up to 2e-3 of themselves:
    tests/test_torch_reg.py). Returns the worst error over tolerance."""
    worst = (0.0, None)
    for stage in STAGES:
        keys = [k for k in want if k.startswith(stage + "/")]
        top = max(float(np.abs(want[k]).max()) for k in keys)
        floor = 1.0 if stage == "d_reg" else 1e-3
        for k in keys:
            bound = GRAD_TOL * max(float(np.abs(want[k]).max()), floor * top)
            err = float(np.abs(got[k].astype(np.float64) - want[k]).max())
            worst = max(worst, (err / bound if bound > 0 else float(err > 0), k))
    return worst


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
    ap.add_argument("--cpu", action="store_true", help="gloo, small shapes, 2 processes")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    from morphganformer_tpu_torch.parallel import spawn_local
    cpu = args.cpu
    if cpu:
        n, card = args.cards or 2, "cpu"
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
                                                args=(work, cpu, args.steps), timeout_s=600),
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
        solo = iter_part(None, one, cpu, args.steps)
        print(f"1024^2 iterations at batch 4 a card, steps 0..{args.steps - 1}: world {n} "
              f"rank 0 {iters[0]} ms; one card {solo} ms; {card}", flush=True)
    proj = project_part(n, cpu, args.project_steps)
    check("projection over the devices equal to its blocks on one device",
          proj["finite"] and proj["cards_equal_blocks"])
    print(f"projection of {proj['rows']} rows, {proj['steps']} steps, ms in turns: over {n} "
          f"devices {proj['ms']['cards']}, the same blocks on one {proj['ms']['blocks']}, "
          f"unsharded on one {proj['ms']['plain']}; loss history against unsharded, worst "
          f"relative {proj['loss_vs_plain']}; {card}", flush=True)
    result = {"card": card, "ranks": n, "failed": failed, "spawn_ms": spawn_ms,
              "mbstd_max_diff": mbstd,
              "stages": {"worst": worst, "pl_mean": pl},
              "allreduce_ms": ar, "allreduce_params": ranks[0]["allreduce"]["params"],
              "iter_ms": {"world": iters, "one": solo}, "projection": proj}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        json.dump(result, open(args.out, "w"), indent=1)
    print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
