"""Pixel-space losses (port of morphganformer_tpu/losses/pixel.py): MSE, L1,
PSNR and DSSIM, differentiable functions of NHWC images in [-1, 1]."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def mse_loss(img, target):
    return torch.mean(torch.square(img - target))


def l1_loss(img, target):
    return torch.mean(torch.abs(img - target))


def psnr(img, target, data_range=2.0):
    """Peak signal-to-noise ratio in dB (higher is better)."""
    mse = torch.mean(torch.square(img - target))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def psnr_loss(img, target, data_range=2.0):
    """Negated PSNR, for minimization."""
    return -psnr(img, target, data_range)


def _gaussian_kernel(size=11, sigma=1.5):
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def ssim(img, target, data_range=2.0, size=11, sigma=1.5):
    """Structural similarity (Wang et al. 2004) with an 11-tap sigma-1.5
    Gaussian window over VALID positions, mean over pixels and channels
    (skimage's gaussian_weights=True, use_sample_covariance=False)."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    channels = img.shape[-1]
    k = _gaussian_kernel(size, sigma).to(device=img.device, dtype=img.dtype)
    k = k[None, None].expand(channels, 1, size, size)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), k, groups=channels).permute(0, 2, 3, 1)

    mu_x, mu_y = filt(img), filt(target)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = filt(img * img) - mu_xx
    sigma_y = filt(target * target) - mu_yy
    sigma_xy = filt(img * target) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2))
    return torch.mean(s)


def dssim_loss(img, target, data_range=2.0):
    """(1 - SSIM) / 2, the minimization form."""
    return (1.0 - ssim(img, target, data_range)) / 2.0
