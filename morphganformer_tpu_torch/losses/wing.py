"""Wing and adaptive wing landmark losses (port of
morphganformer_tpu/losses/wing.py).

wing_loss: omega 10, epsilon 2, piecewise log/linear over landmark
coordinate residuals. adaptive_wing_loss: omega 14, theta 0.5, epsilon 1,
alpha 2.1 over heatmaps, normalising the small-residual branch by omega as
the reference implementation does. The terms take a differentiable
landmark function (losses/landmarks.py), so the gradient reaches the
latent.
"""

from __future__ import annotations

import math

import torch


def wing_loss(pred, target, omega=10.0, epsilon=2.0):
    delta = torch.abs(target - pred)
    c = omega - omega * math.log(1.0 + omega / epsilon)
    losses = torch.where(delta < omega, omega * torch.log(1.0 + delta / epsilon), delta - c)
    return torch.mean(losses)


def adaptive_wing_loss(pred, target, omega=14.0, theta=0.5, epsilon=1.0, alpha=2.1):
    """The exponent p = alpha - y adapts to the target heatmap value y."""
    y = target
    delta = torch.abs(y - pred)
    p = alpha - y
    ratio = theta / epsilon
    a = omega * (1.0 / (1.0 + ratio ** p)) * p * (ratio ** (p - 1.0)) / epsilon
    c = theta * a - omega * torch.log(1.0 + ratio ** p)
    losses = torch.where(delta < theta, omega * torch.log(1.0 + (delta / omega) ** p),
                         a * delta - c)
    return torch.mean(losses)


def make_adaptive_wing_loss_term(heatmap_fn, omega=14.0, theta=0.5, epsilon=1.0, alpha=2.1):
    """Loss-stack term: adaptive wing between the landmark heatmaps of the
    image and of the target. heatmap_fn: NHWC image -> heatmaps in [0, 1]
    (landmarks.landmark_heatmaps_01: p = alpha - y needs y in [0, 1])."""
    def loss(img, target):
        return adaptive_wing_loss(heatmap_fn(img), heatmap_fn(target), omega, theta, epsilon,
                                  alpha)
    return loss


def make_wing_loss_term(landmark_fn, target_landmarks=None, omega=10.0, epsilon=2.0):
    """Loss-stack term: wing loss between the landmarks of the image and of
    the target (recomputed each call), or fixed `target_landmarks`.
    landmark_fn: NHWC image -> [B, 68, 2]."""
    def loss(img, target):
        pred = landmark_fn(img)
        tgt = target_landmarks if target_landmarks is not None else landmark_fn(target)
        return wing_loss(pred, tgt, omega, epsilon)
    return loss
