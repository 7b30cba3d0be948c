"""Latent projection: optimize a latent so that G(latent) matches a target
(port of morphganformer_tpu/projection/engine.py).

Each step: the cosine-ramped lr, latent noise that decays to zero at
`noise_ramp`, G(latent + noise) through the fused blocks, per-image losses
from the loss stack, the latent gradient by autograd (the fused blocks'
backward runs the K1-adjoint and K3 kernels), Adam with coupled weight
decay, and per-image best tracking. The generator's weights are frozen.
The best image is regenerated from the best noised latent after the loop.

Not ported yet: `noise_regularize > 0` (needs noise cotangents through the
kernels) and `mesh` sharding; both raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProjectionConfig:
    """Defaults of the JAX engine (the reference's 1024_example_MSE.py)."""
    steps: int = 5000
    lr: float = 0.1
    lr_rampup: float = 0.05
    lr_rampdown: float = 0.25
    noise: float = 0.05
    noise_ramp: float = 0.75
    truncation_psi: float = 0.7
    weight_decay: float = 1e-4
    n_mean_latent: int = 10000
    # Size of the windows the per-step latent noise is drawn in, and the
    # cadence of the progress callback.
    chunk: int = 250
    w_plus: bool = False          # optimize ws [B, k, num_ws, w_dim] instead of z
    noise_regularize: float = 0.0  # > 0 is not ported yet


def cosine_ramp_lr(t, initial_lr, rampdown=0.25, rampup=0.05):
    """lr at progress t in [0, 1]: a cosine ramp down over the last
    `rampdown` and a linear ramp up over the first `rampup`."""
    ramp = min(1.0, (1.0 - t) / rampdown)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    return initial_lr * ramp * min(1.0, t / rampup)


def latent_stats(cfg, generator: Optional[torch.Generator] = None, n_mean_latent=10000,
                 batch=2048):
    """Mean [k, z_dim] and the global scalar std of `n_mean_latent` z drawn
    from `generator`, streamed in batches: sum(z) and sum(z^2), then
    sum((z - mean)^2) = sum(z^2) - n * sum(mean^2)."""
    k, z_dim = cfg.k, cfg.z_dim
    total = torch.zeros(k, z_dim)
    total_sq = torch.zeros(())
    done = 0
    while done < n_mean_latent:
        b = min(batch, n_mean_latent - done)
        z = torch.randn((b, k, z_dim), generator=generator)
        total = total + z.sum(0)
        total_sq = total_sq + z.square().sum()
        done += b
    mean = total / n_mean_latent
    sq = total_sq - n_mean_latent * mean.square().sum()
    return mean, torch.sqrt(sq / n_mean_latent)


@dataclasses.dataclass
class ProjectionResult:
    latent: torch.Tensor              # best latents [B, k, z_dim] (or ws)
    best_img: torch.Tensor            # G(best latents), NHWC in [-1, 1]
    best_loss: float                  # mean of the per-image bests
    best_step: int                    # last step at which any image improved
    loss_history: torch.Tensor        # [steps] per-step mean loss
    components_history: Dict[str, torch.Tensor]  # term -> [steps, B]
    per_image_loss: torch.Tensor = None   # [B] per-image best losses
    per_image_step: torch.Tensor = None   # [B] step of each image's best


def synthesize_latent(G, latent, cfg: ProjectionConfig, plain=False):
    """G(latent) in the projection's mode: z with truncation, or ws (w_plus)."""
    if cfg.w_plus:
        return G.run_synthesis(latent, noise_mode="const", plain=plain)
    return G(z=latent, truncation_psi=cfg.truncation_psi, noise_mode="const", plain=plain)


def loss_and_grad(G, latent_n, target, loss_fn, cfg: ProjectionConfig, plain=False):
    """One step's forward and backward at the noised latent: (per-image
    losses [B], {term: [B]}, d mean(loss) / d latent_n)."""
    latent_n = latent_n.detach().requires_grad_(True)
    with torch.enable_grad():
        per_img, comps = loss_fn(synthesize_latent(G, latent_n, cfg, plain), target)
        grad, = torch.autograd.grad(per_img.mean(), latent_n)
    return per_img.detach(), {k: v.detach() for k, v in comps.items()}, grad


def _noise_windows(cfg: ProjectionConfig, shape, generator):
    """Unit-normal latent noise, one [steps of the window, *shape] draw per
    `chunk`-sized window in order, so the sequence depends only on the
    generator's seed."""
    for lo in range(0, cfg.steps, cfg.chunk):
        yield torch.randn((min(cfg.steps, lo + cfg.chunk) - lo, *shape), generator=generator)


def project(G, target, loss_fn, cfg: ProjectionConfig, latent_mean, latent_std,
            generator: Optional[torch.Generator] = None,
            progress: Optional[Callable[[int, float, float], None]] = None,
            init_latent=None, mesh=None, noise_seq=None) -> ProjectionResult:
    """Run the projection. target [B,H,W,3] NHWC in [-1, 1] on G's device;
    `loss_fn` from `build_loss_stack`. The per-step noise comes from
    `generator` (a CPU torch.Generator), or from `noise_seq` [steps,
    *latent.shape] when given. W+ mode (cfg.w_plus) maps a z-shaped init
    through the mapping network with the configured truncation first.
    Freezes G's weights (G.requires_grad_(False))."""
    if cfg.noise_regularize > 0.0:
        raise NotImplementedError("noise_regularize > 0 needs noise cotangents through the "
                                  "kernels; not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh sharding of the projection is not ported yet")
    dev = next(G.parameters()).device
    G.requires_grad_(False)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    batch = target.shape[0]
    k, z_dim = latent_mean.shape
    if init_latent is not None:
        latent = torch.as_tensor(init_latent, dtype=torch.float32)
        is_z = tuple(latent.shape[-2:]) == (k, z_dim)
        if latent.ndim == (2 if is_z else 3):
            latent = latent[None]
    else:
        latent = latent_mean[None].expand(batch, -1, -1)
        is_z = True
    latent = latent.to(dev)
    if cfg.w_plus and is_z:
        with torch.no_grad():
            latent = G.run_mapping(latent, truncation_psi=cfg.truncation_psi)
    if latent.shape[0] != batch:
        latent = latent.expand(batch, *latent.shape[1:])
    latent = latent.contiguous().clone().requires_grad_(True)
    std = torch.as_tensor(latent_std, dtype=torch.float32, device=dev)

    opt = torch.optim.Adam([latent], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    best_loss = torch.full((batch,), 1e30, device=dev)
    best_latent = latent.detach().clone()
    best_step = torch.zeros(batch, dtype=torch.int64, device=dev)
    expand = (slice(None),) + (None,) * (latent.ndim - 1)

    if noise_seq is not None:
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32)
        if tuple(noise_seq.shape) != (cfg.steps, *latent.shape):
            raise ValueError(f"noise_seq must be {(cfg.steps, *latent.shape)}, "
                             f"got {tuple(noise_seq.shape)}")
        windows = iter(noise_seq.split(cfg.chunk))
    else:
        windows = _noise_windows(cfg, tuple(latent.shape), generator)

    losses, comps_hist = [], []
    window = None
    for step in range(cfg.steps):
        if step % cfg.chunk == 0:
            window = next(windows).to(dev)
        t = step / cfg.steps
        lr = cosine_ramp_lr(t, cfg.lr, cfg.lr_rampdown, cfg.lr_rampup)
        strength = std * cfg.noise * max(0.0, 1.0 - t / cfg.noise_ramp) ** 2
        latent_n = latent.detach() + window[step % cfg.chunk] * strength
        per_img, comps, grad = loss_and_grad(G, latent_n, target, loss_fn, cfg)
        latent.grad = grad
        opt.param_groups[0]["lr"] = lr
        opt.step()

        improved = per_img < best_loss
        best_loss = torch.where(improved, per_img, best_loss)
        best_latent = torch.where(improved[expand], latent_n, best_latent)
        best_step = torch.where(improved, step, best_step)
        losses.append(per_img.mean())
        comps_hist.append(comps)
        if progress is not None and ((step + 1) % cfg.chunk == 0 or step + 1 == cfg.steps):
            progress(step + 1, float(losses[-1]), float(best_loss.mean()))

    with torch.no_grad():
        best_img = synthesize_latent(G, best_latent, cfg)
    return ProjectionResult(
        latent=best_latent,
        best_img=best_img,
        best_loss=float(best_loss.mean()),
        best_step=int(best_step.max()),
        loss_history=torch.stack(losses).cpu(),
        components_history={k: torch.stack([c[k] for c in comps_hist]).cpu()
                            for k in (comps_hist[0] if comps_hist else {})},
        per_image_loss=best_loss,
        per_image_step=best_step,
    )
