"""Latent projection: optimize a latent so that G(latent) matches a target
(port of morphganformer_tpu/projection/engine.py).

Each step: the cosine-ramped lr, latent noise that decays to zero at
`noise_ramp`, G(latent + noise) through the fused blocks, per-image losses
from the loss stack, the latent gradient by autograd (the fused blocks'
backward runs the K1-adjoint and K3 kernels), Adam with coupled weight
decay, and per-image best tracking. The generator's weights are frozen.
The best image is regenerated from the best noised latent after the loop.

With `noise_regularize > 0` the generator's const-noise maps are optimized
with the latent (batch 1 only, as in JAX): each map becomes a leaf tensor
that the forward reads in place of its buffer (`noise_buffers`), the loss
gains the weighted multi-scale autocorrelation penalty
(`noise_regularize_loss`), the same Adam updates the latent and the maps,
and each map is renormalised after every update (`normalize_noises`). The
maps are keyed by the JAX package's flattened path
('synthesis/b1024/conv1/noise_const'), so a `.noises.npz` crosses between
the packages. The fused blocks give the maps' cotangent as a reduction of
the pre-activation cotangent (ops/fused_conv.py `_noise_grad`).

`mesh` (a list of devices) splits the batch's rows over the devices, one
replica of G each (JAX engine.py:281-345); see `project`.
"""

from __future__ import annotations

import contextlib
import copy
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
    # > 0: optimize the const-noise maps with the latent under this weight
    # of the autocorrelation penalty (batch 1 only).
    noise_regularize: float = 0.0


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


NOISE_BUFFER = "noise_const"


def split_noise_buffers(G) -> Dict[str, torch.Tensor]:
    """G's const-noise buffers [H, W], keyed by the JAX package's flattened
    path of the buffer ('synthesis/b1024/conv1/noise_const')."""
    return {name.replace(".", "/"): buf for name, buf in G.named_buffers()
            if name.rsplit(".", 1)[-1] == NOISE_BUFFER}


def _noise_slot(G, key):
    """(module, buffer name) of a noise key; raises on a key G lacks."""
    *path, name = key.split("/")
    mod = G.get_submodule(".".join(path))
    if name != NOISE_BUFFER or name not in mod._buffers:
        raise KeyError(f"the generator has no noise buffer {key!r}")
    return mod, name


@contextlib.contextmanager
def noise_buffers(G, noises):
    """Within the block, G's forward reads `noises` (keyed as
    `split_noise_buffers`, tensors on G's device, leaves that take gradients
    among them) in place of those buffers; the buffers come back after."""
    slots = [(*_noise_slot(G, key), t) for key, t in noises.items()]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in slots]
    try:
        for mod, name, t in slots:
            setattr(mod, name, t)
        yield
    finally:
        for mod, name, buf in saved:
            setattr(mod, name, buf)


@torch.no_grad()
def merge_noise_buffers(G, noises):
    """Copy noise maps (numpy arrays or tensors, keyed as
    `split_noise_buffers`) into G's buffers; returns G."""
    for key, v in noises.items():
        mod, name = _noise_slot(G, key)
        buf = getattr(mod, name)
        v = torch.as_tensor(v, dtype=buf.dtype)
        if tuple(v.shape) != tuple(buf.shape):
            raise ValueError(f"{key}: noise map {tuple(v.shape)} != buffer {tuple(buf.shape)}")
        buf.copy_(v)
    return G


def noise_regularize_loss(noises):
    """The multi-scale autocorrelation penalty of the noise maps (reference
    1024_example_MSE.py:31-51, JAX engine.py:91-107): at each level of a
    pyramid the squared mean of the map times its 1-pixel roll along each
    axis, then a 2x2 mean while the size is above 8."""
    total = None
    for n in noises.values():
        n = n.float()
        size = n.shape[-1]
        while True:
            term = (torch.mean(n * torch.roll(n, 1, dims=-1)) ** 2
                    + torch.mean(n * torch.roll(n, 1, dims=-2)) ** 2)
            total = term if total is None else total + term
            if size <= 8:
                break
            h, w = n.shape[-2], n.shape[-1]
            n = n.reshape(*n.shape[:-2], h // 2, 2, w // 2, 2).mean(dim=(-3, -1))
            size //= 2
    return total


@torch.no_grad()
def normalize_noises(noises):
    """Each map to zero mean and unit (population) std, in place
    (1024_example_MSE.py:54-59); eps 1e-8 guards a constant map."""
    for n in noises.values():
        mean, std = n.mean(), n.std(correction=0)
        n.copy_((n - mean) / (std + 1e-8))


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
    noises: Optional[Dict[str, torch.Tensor]] = None  # best noise maps (noise_regularize)


def synthesize_latent(G, latent, cfg: ProjectionConfig, plain=False):
    """G(latent) in the projection's mode: z with truncation, or ws (w_plus)."""
    if cfg.w_plus:
        return G.run_synthesis(latent, noise_mode="const", plain=plain)
    return G(z=latent, truncation_psi=cfg.truncation_psi, noise_mode="const", plain=plain)


def loss_and_grad(G, latent_n, target, loss_fn, cfg: ProjectionConfig, plain=False, denom=None):
    """One step's forward and backward at the noised latent: (per-image
    losses [B], {term: [B]}, d mean(loss) / d latent_n). With `denom` the
    gradient is that of sum(loss) / denom: a shard's rows of the whole
    batch's mean (the same 1 / denom reaches each row as the batch's mean
    gives it)."""
    latent_n = latent_n.detach().requires_grad_(True)
    with torch.enable_grad():
        per_img, comps = loss_fn(synthesize_latent(G, latent_n, cfg, plain), target)
        total = per_img.mean() if denom is None else per_img.sum() / denom
        grad, = torch.autograd.grad(total, latent_n)
    return per_img.detach(), {k: v.detach() for k, v in comps.items()}, grad


def loss_and_grads_with_noise(G, latent_n, noises, target, loss_fn, cfg: ProjectionConfig,
                              plain=False):
    """One step of the noise_regularize projection: G reads `noises` in place
    of its noise buffers, the loss is mean(per-image losses) plus
    cfg.noise_regularize times `noise_regularize_loss`; returns (per-image
    losses [B], {term: [B]}, the total loss, d loss / d latent_n,
    {key: d loss / d noise map})."""
    latent_n = latent_n.detach().requires_grad_(True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in noises.items()}
    with torch.enable_grad():
        with noise_buffers(G, leaves):
            per_img, comps = loss_fn(synthesize_latent(G, latent_n, cfg, plain), target)
        loss = per_img.mean() + cfg.noise_regularize * noise_regularize_loss(leaves)
        grads = torch.autograd.grad(loss, [latent_n, *leaves.values()])
    return (per_img.detach(), {k: v.detach() for k, v in comps.items()}, loss.detach(),
            grads[0], dict(zip(leaves, grads[1:])))


def _noise_windows(cfg: ProjectionConfig, shape, generator):
    """Unit-normal latent noise, one [steps of the window, *shape] draw per
    `chunk`-sized window in order, so the sequence depends only on the
    generator's seed."""
    for lo in range(0, cfg.steps, cfg.chunk):
        yield torch.randn((min(cfg.steps, lo + cfg.chunk) - lo, *shape), generator=generator)


@dataclasses.dataclass
class _Shard:
    """One device's block of the projection's rows: its replica of G, its
    rows' targets, latents, Adam and best trackers."""
    G: torch.nn.Module
    rows: slice
    target: torch.Tensor
    latent: torch.Tensor
    std: torch.Tensor
    opt: torch.optim.Adam
    best_loss: torch.Tensor
    best_latent: torch.Tensor
    best_step: torch.Tensor


def _mesh_devices(mesh, batch, opt_noise):
    """The devices of a projection mesh, with JAX's refusals."""
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("the projection mesh is empty")
    if opt_noise:
        raise ValueError("noise_regularize is batch-1; sharding needs a batch")
    if batch % len(devices):
        raise ValueError(f"projection batch {batch} must divide the mesh ({len(devices)} "
                         f"devices)")
    return devices


def project(G, target, loss_fn, cfg: ProjectionConfig, latent_mean, latent_std,
            generator: Optional[torch.Generator] = None,
            progress: Optional[Callable[[int, float, float], None]] = None,
            init_latent=None, mesh=None, noise_seq=None) -> ProjectionResult:
    """Run the projection. target [B,H,W,3] NHWC in [-1, 1] on G's device;
    `loss_fn` from `build_loss_stack`. The per-step noise comes from
    `generator` (a CPU torch.Generator), or from `noise_seq` [steps,
    *latent.shape] when given. W+ mode (cfg.w_plus) maps a z-shaped init
    through the mapping network with the configured truncation first.
    With cfg.noise_regularize > 0 (batch 1) the noise maps are optimized too
    and come back, the best ones, in `ProjectionResult.noises`; G's buffers
    are left as they were. Freezes G's weights (G.requires_grad_(False)).

    `mesh`, a list of devices (JAX's 'data' mesh), splits the rows, which
    are independent, into one contiguous block a device, each with its own
    replica of G (G itself on G's device), targets, latents, Adam and best
    trackers; each step issues the blocks in turn from this thread, each
    block's gradient that of the whole batch's mean loss, and the per-step
    noise is drawn for the whole batch and sliced, so the result equals the
    unsharded one. It is gathered in row order on G's device. JAX's
    refusals hold: no noise_regularize, and the batch must divide the
    mesh."""
    dev = next(G.parameters()).device
    G.requires_grad_(False)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    batch = target.shape[0]
    opt_noise = cfg.noise_regularize > 0.0
    if opt_noise and batch != 1:
        raise ValueError(f"noise_regularize optimizes batch-shared noise maps: batch 1 only, "
                         f"got {batch}")
    devices = _mesh_devices(mesh, batch, opt_noise) if mesh is not None else [dev]
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
    std = torch.as_tensor(latent_std, dtype=torch.float32, device=dev)

    noises = best_noises = None
    if opt_noise:
        noises = {k: v.detach().clone() for k, v in split_noise_buffers(G).items()}
        if not noises:
            raise ValueError("noise_regularize: the generator has no const-noise buffers")
        best_noises = {k: v.clone() for k, v in noises.items()}
    replicas = {dev: G}
    per = batch // len(devices)
    shards = []
    for i, d in enumerate(devices):
        if d not in replicas:
            replicas[d] = copy.deepcopy(G).to(d)
        rows = slice(i * per, (i + 1) * per)
        lat = latent[rows].to(d).contiguous().clone().requires_grad_(True)
        # One Adam over the latent and the noise maps: JAX's optax chain
        # decays and updates the whole tree.
        opt = torch.optim.Adam([lat, *(noises or {}).values()], lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8, weight_decay=cfg.weight_decay)
        shards.append(_Shard(G=replicas[d], rows=rows, target=target[rows].to(d), latent=lat,
                             std=std.to(d), opt=opt,
                             best_loss=torch.full((per,), 1e30, device=d),
                             best_latent=lat.detach().clone(),
                             best_step=torch.zeros(per, dtype=torch.int64, device=d)))
    denom = batch if mesh is not None else None
    expand = (slice(None),) + (None,) * (latent.ndim - 1)

    if noise_seq is not None:
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32)
        if tuple(noise_seq.shape) != (cfg.steps, *latent.shape):
            raise ValueError(f"noise_seq must be {(cfg.steps, *latent.shape)}, "
                             f"got {tuple(noise_seq.shape)}")
        windows = iter(noise_seq.split(cfg.chunk))
    else:
        windows = _noise_windows(cfg, tuple(latent.shape), generator)

    def on_dev(parts):
        return parts[0] if len(parts) == 1 else torch.cat([p.to(dev) for p in parts])

    losses, comps_hist = [], []
    shard_windows = None
    for step in range(cfg.steps):
        if step % cfg.chunk == 0:
            window = next(windows)
            shard_windows = [window[:, sh.rows].to(sh.latent.device) for sh in shards]
        t = step / cfg.steps
        lr = cosine_ramp_lr(t, cfg.lr, cfg.lr_rampdown, cfg.lr_rampup)
        step_imgs, step_comps = [], []
        for sh, win in zip(shards, shard_windows):
            strength = sh.std * cfg.noise * max(0.0, 1.0 - t / cfg.noise_ramp) ** 2
            latent_n = sh.latent.detach() + win[step % cfg.chunk] * strength
            if opt_noise:
                used = {k: v.clone() for k, v in noises.items()}
                per_img, comps, loss, grad, dnoise = loss_and_grads_with_noise(
                    sh.G, latent_n, used, sh.target, loss_fn, cfg)
                for k, n in noises.items():
                    n.grad = dnoise[k]
            else:
                per_img, comps, grad = loss_and_grad(sh.G, latent_n, sh.target, loss_fn, cfg,
                                                     denom=denom)
            sh.latent.grad = grad
            sh.opt.param_groups[0]["lr"] = lr
            sh.opt.step()
            if opt_noise:
                normalize_noises(noises)

            improved = per_img < sh.best_loss
            if opt_noise:    # batch-shared maps: kept when any image improved
                best_noises = {k: torch.where(improved.any(), used[k], best_noises[k])
                               for k in used}
            sh.best_loss = torch.where(improved, per_img, sh.best_loss)
            sh.best_latent = torch.where(improved[expand], latent_n, sh.best_latent)
            sh.best_step = torch.where(improved, step, sh.best_step)
            step_imgs.append(per_img)
            step_comps.append(comps)
        if not opt_noise:
            loss = on_dev(step_imgs).mean()
        losses.append(loss)
        comps_hist.append({k: on_dev([c[k] for c in step_comps]) for k in step_comps[0]})
        if progress is not None and ((step + 1) % cfg.chunk == 0 or step + 1 == cfg.steps):
            progress(step + 1, float(losses[-1]),
                     float(on_dev([sh.best_loss for sh in shards]).mean()))

    with torch.no_grad(), noise_buffers(G, best_noises or {}):
        best_img = on_dev([synthesize_latent(sh.G, sh.best_latent, cfg) for sh in shards])
    best_loss = on_dev([sh.best_loss for sh in shards])
    best_step = on_dev([sh.best_step for sh in shards])
    return ProjectionResult(
        latent=on_dev([sh.best_latent for sh in shards]),
        best_img=best_img,
        best_loss=float(best_loss.mean()),
        best_step=int(best_step.max()),
        loss_history=torch.stack(losses).cpu(),
        components_history={k: torch.stack([c[k] for c in comps_hist]).cpu()
                            for k in (comps_hist[0] if comps_hist else {})},
        per_image_loss=best_loss,
        per_image_step=best_step,
        noises=best_noises,
    )
