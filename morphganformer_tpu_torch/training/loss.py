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
from morphganformer_tpu_torch.parallel.mesh import sum_over_ranks


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


def _mixed_ws(G, z, cfg: LossConfig, gen, mask, train, update_w_avg, mesh=None):
    """The mapping of z with style and component mixing (reference
    loss.py:41-53); w_avg moves by the mean over `mesh`'s ranks."""
    ws = G.run_mapping(z, train=train, skip_w_avg_update=not update_w_avg, gen=gen, mask=mask,
                       mesh=mesh)
    if cfg.style_mixing > 0 or cfg.component_mixing > 0:
        z2 = torch.randn(z.shape, generator=gen, device=z.device)
        ws2 = G.run_mapping(z2, train=train, skip_w_avg_update=True, gen=gen, mask=mask)
        if cfg.style_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[2], cfg.style_mixing, gen, z.device), 2)
        if cfg.component_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[1], cfg.component_mixing, gen,
                                                z.device), 1)
    return ws


def run_G(G, z, cfg: LossConfig, gen, train=True, update_w_avg=False, plain=False, mesh=None):
    """Mapping (with mixing) and synthesis (reference loss.py:41-56). One
    component mask serves the mapping runs and the synthesis, as one JAX
    key does. Returns (img, ws)."""
    mask = G.component_mask(z.shape[0], z.device, train, gen)
    ws = _mixed_ws(G, z, cfg, gen, mask, train, update_w_avg, mesh)
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


def g_main_loss(G, D, z, cfg: LossConfig, gen, plain=False, mesh=None):
    """G_main stage (reference loss.py:70-90): the mapping moves w_avg.
    Under a data `mesh`, z is this rank's rows. Returns (scalar, stats)."""
    img, _ = run_G(G, z, cfg, gen, update_w_avg=True, plain=plain, mesh=mesh)
    logits = D(img, plain=plain, mesh=mesh)
    loss = g_adv_loss(logits).mean()
    return loss, {"Loss/G/loss": loss.detach(), "Loss/scores/fake": logits.detach().mean()}


def d_main_loss(G, D, real_img, z, cfg: LossConfig, gen, plain=False, mesh=None):
    """D_main stage (reference loss.py:110-148): the fakes are made without
    a graph (JAX stops their gradient). Under a data `mesh`, real_img and
    z are this rank's rows. Returns (scalar, stats)."""
    with torch.no_grad():
        img, _ = run_G(G, z, cfg, gen, plain=plain)
    gen_logits = D(img, plain=plain, mesh=mesh)
    real_logits = D(real_img, plain=plain, mesh=mesh)
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


def pl_rows(n, shrink, mesh=None):
    """JAX's path-length rows, the first max(B // shrink, 1) rows of the
    microbatch, when each rank of `mesh` holds `n` of its B rows in rank
    order: (this rank's count of them, their count over every rank). A rank
    past them has none."""
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)
    total = max(n * world // shrink, 1)
    return min(max(total - rank * n, 0), n), total


def g_pl_loss(G, z, cfg: LossConfig, gen, pl_mean, mesh=None, pl_noise=None):
    """Path-length regularisation (reference loss.py:92-107; JAX
    `_g_pl_loss`), on `_reg_route("pl")`. On the rows of `pl_rows`: ws from
    the mapping with mixing (w_avg not moved), the image G(ws) with fresh
    noise, dropout and component mask (JAX re-synthesises under new keys),
    the gradient of sum(img * pl_noise) w.r.t. ws with its graph kept, and
    per row the w_dim lengths sqrt(mean over k of the sum over num_ws of
    g^2). `pl_noise` [rows, R, R, C] is N(0, 1) / sqrt(R * R) from `gen`
    unless given. pl_mean moves by the mean of the N lengths (rows times
    w_dim), and the penalty is the mean over them of
    (length - new pl_mean)^2.

    Under a data `mesh`, z is this rank's block of the global microbatch
    and the rows are JAX's rows of the global microbatch, of which a rank
    holds some, all or none. Only the forward crosses the ranks (the
    lengths' sum): the new pl_mean enters the penalty detached, and its
    share of the gradient, which JAX keeps (for l_j,
    -2 (pl_decay / N) * sum_i (l_i - new pl_mean)), comes back through a
    term linear in this rank's lengths whose value is 0. The loss is
    `world` times this rank's share of the penalty, so the trainer's mean
    of the ranks' gradients is the gradient of the whole penalty; a rank
    without rows returns a loss without a graph. Returns (scalar, stats:
    the penalty over every rank's rows and the new pl_mean, detached)."""
    cfg_g = G.cfg
    world = mesh.world if mesh is not None else 1
    rows, total = pl_rows(z.shape[0], cfg.pl_batch_shrink, mesh)
    count = total * cfg_g.w_dim
    z = z[:rows]
    if rows:
        with _reg_route("pl", PL_REACHES):
            mask = G.component_mask(rows, z.device, True, gen)
            ws = _mixed_ws(G, z, cfg, gen, mask, train=True, update_w_avg=False)
            if pl_noise is None:
                shape = (rows, cfg_g.img_resolution, cfg_g.img_resolution, cfg_g.img_channels)
                pl_noise = torch.randn(shape, generator=gen, device=z.device)
                pl_noise = pl_noise / math.sqrt(shape[1] * shape[2])
            img = G.run_synthesis(ws, noise_mode="random", train=True, gen=gen)
            pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws, create_graph=True)
        pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    else:
        pl_lengths = z.new_zeros((0, cfg_g.w_dim))
    lengths_sum = sum_over_ranks(pl_lengths.sum(), mesh)
    new_pl_mean = pl_mean + cfg.pl_decay * (lengths_sum / count - pl_mean)
    pl_penalty = (pl_lengths - new_pl_mean).square()
    spread = lengths_sum - count * new_pl_mean
    via_mean = -2 * cfg.pl_decay / count * spread * (pl_lengths - pl_lengths.detach()).sum()
    loss = (pl_penalty.sum() + via_mean) * (cfg.pl_weight * world / count)
    penalty = sum_over_ranks(pl_penalty.sum(), mesh) / count
    return loss, {"Loss/pl_penalty": penalty, "Loss/G/reg": penalty * cfg.pl_weight,
                  "pl_mean": new_pl_mean}


def d_r1_loss(D, real_img, cfg: LossConfig, mesh=None):
    """R1 gradient penalty (reference loss.py:149-159; JAX `_d_r1_loss`), on
    `_reg_route("r1")`: the gradient of sum(D(real)) w.r.t. the reals with
    its graph kept; r1_gamma / 2 times the batch mean of its squared norm.
    Under a data `mesh`, real_img is this rank's rows. Returns (scalar,
    stats)."""
    real = real_img.detach().requires_grad_(True)
    with _reg_route("r1", R1_REACHES):
        r1_grads, = torch.autograd.grad(D(real, mesh=mesh).sum(), real, create_graph=True)
    r1_penalty = r1_grads.square().sum(dim=(1, 2, 3))
    loss = r1_penalty.mean() * (cfg.r1_gamma / 2)
    return loss, {"Loss/r1_penalty": r1_penalty.detach().mean(), "Loss/D/reg": loss.detach()}
