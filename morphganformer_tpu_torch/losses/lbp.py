"""Local binary pattern texture features (port of
morphganformer_tpu/losses/lbp.py).

`local_binary_pattern`, `lbp_histogram` and `lbp_distance` are the exact
8-neighbour codes (P = 8, R = 1, skimage's 'default' method) and their
histogram distance, in numpy: a hard threshold has no gradient.
`soft_lbp_loss` is the differentiable relaxation the projection's loss
stack uses: sigmoid((neighbour - centre) / T) per direction, averaged over
the image.
"""

from __future__ import annotations

import numpy as np
import torch

# (dy, dx) of the 8 neighbours in skimage's order: right, up-right, up,
# up-left, left, down-left, down, down-right.
_OFFSETS = [(0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1)]
_GRAY = (0.2125, 0.7154, 0.0721)


def _to_gray(img):
    x = np.asarray(img, dtype=np.float64)
    if x.ndim == 3 and x.shape[-1] == 3:
        x = _GRAY[0] * x[..., 0] + _GRAY[1] * x[..., 1] + _GRAY[2] * x[..., 2]
    elif x.ndim == 3:
        x = x[..., 0]
    return x


def local_binary_pattern(img, P=8, R=1):
    """Default-method LBP codes for P = 8, R = 1 of a 2-D (or HWC) image."""
    if (P, R) != (8, 1):
        raise ValueError("only P = 8, R = 1 is implemented")
    g = _to_gray(img)
    h, w = g.shape
    padded = np.pad(g, 1, mode="edge")
    code = np.zeros((h, w), dtype=np.uint8)
    for bit, (dy, dx) in enumerate(_OFFSETS):
        neighbor = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        code |= (neighbor >= g).astype(np.uint8) << bit
    return code


def lbp_histogram(img, P=8, R=1, bins=256):
    code = local_binary_pattern(img, P, R)
    hist, _ = np.histogram(code, bins=bins, range=(0, bins))
    return hist.astype(np.float64) / code.size


def lbp_distance(img_a, img_b):
    """L2 distance between the two images' LBP histograms."""
    return float(np.sqrt(np.sum((lbp_histogram(img_a) - lbp_histogram(img_b)) ** 2)))


def soft_lbp_features(img, temperature=0.1):
    """NHWC image -> [B, 8]: the mean over the image of
    sigmoid((neighbour - centre) / T) for each direction (wrapping at the
    borders, as jnp.roll does)."""
    x = img
    if x.shape[-1] == 3:
        x = torch.sum(x * x.new_tensor(_GRAY), dim=-1, keepdim=True)
    feats = [torch.mean(torch.sigmoid((torch.roll(x, shifts=(dy, dx), dims=(1, 2)) - x)
                                      / temperature), dim=(1, 2, 3))
             for dy, dx in _OFFSETS]
    return torch.stack(feats, dim=-1)


def soft_lbp_loss(img, target, temperature=0.1):
    return torch.mean(torch.square(soft_lbp_features(img, temperature)
                                   - soft_lbp_features(target, temperature)))
