"""Bilinear grid sampling, NHWC, differentiable to any order (port of
morphganformer_tpu/ops/grid_sample.py).

Bilinear, align_corners=True, zero padding: the reference's
grid_sample_gradfix (torch_utils/ops/grid_sample_gradfix.py), which it kept
for a second-order gradient. `F.grid_sample` has no double backward with
respect to the grid, so this is written as four gathers and their bilinear
weights, which autograd differentiates as often as asked, as JAX does.
"""

from __future__ import annotations

import torch


def grid_sample(x, grid):
    """x: [N, H, W, C]; grid: [N, Ho, Wo, 2] with (x, y) in [-1, 1]
    (align_corners=True). Samples outside the image read zeros."""
    n, h, w, _ = x.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None].to(x.dtype)
    fy = (gy - y0)[..., None].to(x.dtype)
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = x[batch, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return vals * valid[..., None].to(x.dtype)

    return (gather(y0, x0) * (1 - fx) * (1 - fy) + gather(y0, x0 + 1) * fx * (1 - fy)
            + gather(y0 + 1, x0) * (1 - fx) * fy + gather(y0 + 1, x0 + 1) * fx * fy)
