"""StyleGAN2/GANformer adversarial losses and regularisers (port of
morphganformer_tpu/training/loss.py).

`run_G` maps z (with style and component mixing through a second mapping
run) and synthesises with random noise under `train`; `g_main_loss` and
`d_main_loss` are the G_main and D_main stages, `g_pl_loss` (path length)
and `d_r1_loss` (R1) the G_reg and D_reg stages. Every random draw (mixing
cutoffs, the second z, the component mask, attention dropout, noise, the
path-length noise) comes from one explicit `torch.Generator`, in an order
that does not depend on whether the fused blocks run on the kernels or on
their plain versions.

The regularisers take a second derivative. By default they run, as in
JAX, inside `second_order_scope()` (ops/second_order.py): the fused blocks
keep their kernels through the second derivative, K4 is off, and the inner
gradient takes only the cotangents it reaches (path length: x, styles and
resid; R1: x and resid). Under MGT_PACKED_SECOND_ORDER=0 (JAX's fallback)
they run on the unpacked route (`force_unpacked()`,
ops/packed_override.py): every block unfused, K4 off, all plain autograd.
`reg_stage_second_order` reads the choice. JAX's `_reg_remat` is an XLA
memory policy with no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.ops.packed_override import force_unpacked
from morphganformer_tpu_torch.ops.second_order import reg_stage_second_order, second_order_scope


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The mixing probabilities and the regularisers' settings of the
    reference loss (training/loss.py:20-27). The adversarial losses are the
    reference defaults, non-saturating logistic for G and logistic for D."""
    style_mixing: float = 0.9
    component_mixing: float = 0.0
    r1_gamma: float = 10.0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    pl_weight: float = 2.0


def draw_cutoff(n, prob, gen, device):
    """The mixing cutoff of JAX `_mix_axis`: uniform in [1, n) with
    probability `prob`, else n (no mixing). A 0-d tensor on `device`."""
    cutoff = torch.randint(1, n, (), generator=gen, device=device)
    keep = torch.rand((), generator=gen, device=device) < prob
    return torch.where(keep, cutoff, torch.full_like(cutoff, n))


def _mix_axis(ws, ws2, cutoff, axis):
    """ws with its entries from `cutoff` on along `axis` taken from ws2
    (reference loss.py:44-53)."""
    shape = [1] * ws.dim()
    shape[axis] = ws.shape[axis]
    idx = torch.arange(ws.shape[axis], device=ws.device).reshape(shape)
    return torch.where(idx < cutoff, ws, ws2)


def _mixed_ws(G, z, cfg: LossConfig, gen, mask, train, update_w_avg):
    """The mapping of z with style and component mixing (reference
    loss.py:41-53)."""
    ws = G.run_mapping(z, train=train, skip_w_avg_update=not update_w_avg, gen=gen, mask=mask)
    if cfg.style_mixing > 0 or cfg.component_mixing > 0:
        z2 = torch.randn(z.shape, generator=gen, device=z.device)
        ws2 = G.run_mapping(z2, train=train, skip_w_avg_update=True, gen=gen, mask=mask)
        if cfg.style_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[2], cfg.style_mixing, gen, z.device), 2)
        if cfg.component_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[1], cfg.component_mixing, gen,
                                                z.device), 1)
    return ws


def run_G(G, z, cfg: LossConfig, gen, train=True, update_w_avg=False, plain=False):
    """Mapping (with mixing) and synthesis (reference loss.py:41-56). One
    component mask serves the mapping runs and the synthesis, as one JAX
    key does. Returns (img, ws)."""
    mask = G.component_mask(z.shape[0], z.device, train, gen)
    ws = _mixed_ws(G, z, cfg, gen, mask, train, update_w_avg)
    img = G.run_synthesis(ws, noise_mode="random", plain=plain, train=train, gen=gen, mask=mask)
    return img, ws


def g_adv_loss(logits):
    """Generator loss, non-saturating logistic (reference loss.py:78-88)."""
    return F.softplus(-logits)


def d_adv_loss_gen(logits):
    """Discriminator loss on fakes, logistic (reference loss.py:113-121)."""
    return F.softplus(logits)


def d_adv_loss_real(logits):
    """Discriminator loss on reals, logistic (reference loss.py:141-148)."""
    return F.softplus(-logits)


def g_main_loss(G, D, z, cfg: LossConfig, gen, plain=False):
    """G_main stage (reference loss.py:70-90): the mapping moves w_avg.
    Returns (scalar, stats)."""
    img, _ = run_G(G, z, cfg, gen, update_w_avg=True, plain=plain)
    logits = D(img, plain=plain)
    loss = g_adv_loss(logits).mean()
    return loss, {"Loss/G/loss": loss.detach(), "Loss/scores/fake": logits.detach().mean()}


def d_main_loss(G, D, real_img, z, cfg: LossConfig, gen, plain=False):
    """D_main stage (reference loss.py:110-148): the fakes are made without
    a graph (JAX stops their gradient). Returns (scalar, stats)."""
    with torch.no_grad():
        img, _ = run_G(G, z, cfg, gen, plain=plain)
    gen_logits = D(img, plain=plain)
    real_logits = D(real_img, plain=plain)
    loss = d_adv_loss_gen(gen_logits).mean() + d_adv_loss_real(real_logits).mean()
    return loss, {"Loss/D/loss": loss.detach(), "Loss/scores/fake": gen_logits.detach().mean(),
                  "Loss/scores/real": real_logits.detach().mean()}


# The fused Functions' inputs that each stage's inner gradient reaches
# (`second_order_scope(reaches)`): path length differentiates by ws, which
# enter G's fused blocks through styles and, chained, through x and resid;
# R1 by the reals, which enter D's through x and resid.
PL_REACHES = ("x", "styles", "resid")
R1_REACHES = ("x", "resid")


def _reg_route(stage, reaches):
    """The reg stage's route (JAX loss.py:141-148, :236-243):
    `second_order_scope(reaches)`, or `force_unpacked()` under
    MGT_PACKED_SECOND_ORDER=0."""
    return second_order_scope(reaches) if reg_stage_second_order(stage) else force_unpacked()


def g_pl_loss(G, z, cfg: LossConfig, gen, pl_mean, pl_noise=None):
    """Path-length regularisation (reference loss.py:92-107; JAX
    `_g_pl_loss`), on `_reg_route("pl")`. On the first
    max(B // pl_batch_shrink, 1) latents: ws from the mapping with mixing
    (w_avg not moved), the image G(ws) with fresh noise, dropout and
    component mask (JAX re-synthesises under new keys), the gradient of
    sum(img * pl_noise) w.r.t. ws with its graph kept, and per sample
    sqrt(mean over k of the sum over num_ws of g^2). `pl_noise`
    [b, R, R, C] is N(0, 1) / sqrt(R * R) from `gen` unless given. The
    pl_mean EMA enters the penalty undetached, as in JAX. Returns (scalar,
    stats with the new pl_mean, detached)."""
    cfg_g = G.cfg
    batch = max(z.shape[0] // cfg.pl_batch_shrink, 1)
    z = z[:batch]
    with _reg_route("pl", PL_REACHES):
        mask = G.component_mask(batch, z.device, True, gen)
        ws = _mixed_ws(G, z, cfg, gen, mask, train=True, update_w_avg=False)
        if pl_noise is None:
            shape = (batch, cfg_g.img_resolution, cfg_g.img_resolution, cfg_g.img_channels)
            pl_noise = torch.randn(shape, generator=gen, device=z.device)
            pl_noise = pl_noise / math.sqrt(shape[1] * shape[2])
        img = G.run_synthesis(ws, noise_mode="random", train=True, gen=gen)
        pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws, create_graph=True)
    pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    new_pl_mean = pl_mean + cfg.pl_decay * (pl_lengths.mean() - pl_mean)
    pl_penalty = (pl_lengths - new_pl_mean).square()
    loss = pl_penalty.mean() * cfg.pl_weight
    return loss, {"Loss/pl_penalty": pl_penalty.detach().mean(), "Loss/G/reg": loss.detach(),
                  "pl_mean": new_pl_mean.detach()}


def d_r1_loss(D, real_img, cfg: LossConfig):
    """R1 gradient penalty (reference loss.py:149-159; JAX `_d_r1_loss`), on
    `_reg_route("r1")`: the gradient of sum(D(real)) w.r.t. the reals with
    its graph kept; r1_gamma / 2 times the batch mean of its squared norm.
    Returns (scalar, stats)."""
    real = real_img.detach().requires_grad_(True)
    with _reg_route("r1", R1_REACHES):
        r1_grads, = torch.autograd.grad(D(real).sum(), real, create_graph=True)
    r1_penalty = r1_grads.square().sum(dim=(1, 2, 3))
    loss = r1_penalty.mean() * (cfg.r1_gamma / 2)
    return loss, {"Loss/r1_penalty": r1_penalty.detach().mean(), "Loss/D/reg": loss.detach()}
