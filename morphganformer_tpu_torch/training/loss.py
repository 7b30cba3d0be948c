"""StyleGAN2/GANformer adversarial losses (port of
morphganformer_tpu/training/loss.py, first-order stages).

`run_G` maps z (with style and component mixing through a second mapping
run) and synthesises with random noise under `train`; `g_main_loss` and
`d_main_loss` are the G_main and D_main stages. Every random draw (mixing
cutoffs, the second z, the component mask, attention dropout, noise) comes
from one explicit `torch.Generator`, in an order that does not depend on
whether the fused blocks run on the kernels or on their plain versions.
The regularisation stages (path length, R1) belong to the next training
slice and raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The mixing probabilities of the reference loss (training/loss.py:20-27).
    The adversarial losses are the reference defaults, non-saturating
    logistic for G and logistic for D; the R1 and path-length settings come
    with the regularisation stages."""
    style_mixing: float = 0.9
    component_mixing: float = 0.0


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


def run_G(G, z, cfg: LossConfig, gen, train=True, update_w_avg=False, plain=False):
    """Mapping (with mixing) and synthesis (reference loss.py:41-56). One
    component mask serves the mapping runs and the synthesis, as one JAX
    key does. Returns (img, ws)."""
    mask = G.component_mask(z.shape[0], z.device, train, gen)
    ws = G.run_mapping(z, train=train, skip_w_avg_update=not update_w_avg, gen=gen, mask=mask)
    if cfg.style_mixing > 0 or cfg.component_mixing > 0:
        z2 = torch.randn(z.shape, generator=gen, device=z.device)
        ws2 = G.run_mapping(z2, train=train, skip_w_avg_update=True, gen=gen, mask=mask)
        if cfg.style_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[2], cfg.style_mixing, gen, z.device), 2)
        if cfg.component_mixing > 0:
            ws = _mix_axis(ws, ws2, draw_cutoff(ws.shape[1], cfg.component_mixing, gen,
                                                z.device), 1)
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


def g_pl_loss(*args, **kwargs):
    """Path-length regularisation (reference loss.py:92-107): not ported."""
    raise NotImplementedError("the path-length stage (G_reg) is not ported yet: it is the "
                              "next training slice (R1/PL on the plain route)")


def d_r1_loss(*args, **kwargs):
    """R1 gradient penalty (reference loss.py:149-159): not ported."""
    raise NotImplementedError("the R1 stage (D_reg) is not ported yet: it is the next "
                              "training slice (R1/PL on the plain route)")
