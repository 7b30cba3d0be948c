"""Pieces shared by the loss networks (LPIPS, the landmark net, FaceNet,
ArcFace's iresnet, MDF): their parameters as tensors, NHWC <-> NCHW and
the bilinear resize of the JAX package's losses, in plain PyTorch (JAX
leaves these ops, and the nets' convolutions and max pools, to XLA:
`F.conv2d` with explicit symmetric padding is `lax.conv_general_dilated`,
`F.max_pool2d` without padding is its VALID `reduce_window` max).

Parameter trees keep the JAX package's structure (dicts and lists of
arrays); `to_torch_params` turns one, as its `random_*_params` and loaders
build it (numpy, conv weights HWIO), into tensors on a device with conv
weights OIHW. Images enter the nets NHWC in [-1, 1], as the loss stack
passes them, and run NCHW inside.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def to_torch_params(tree, device="cuda"):
    """A parameter tree of arrays (numpy, or anything `np.asarray` reads)
    -> the same tree of float32 tensors on `device`; 4-D arrays are conv
    weights, HWIO -> OIHW. Leaves that are not arrays (a string tag) pass
    through."""
    if isinstance(tree, dict):
        return {k: to_torch_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch_params(v, device) for v in tree]
    if not hasattr(tree, "shape"):
        return tree
    a = np.asarray(tree, dtype=np.float32)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.tensor(np.ascontiguousarray(a), device=device)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def channel(v):
    """A per-channel vector broadcast over NCHW."""
    return v[None, :, None, None]


def resize_bilinear(img, height, width=None):
    """`jax.image.resize(img, (B, height, width, C), "bilinear")` of an NHWC
    image: the triangle kernel at half-pixel centres, widened by the scale
    when it shrinks (antialiased), renormalised where it meets a border;
    PyTorch's antialiased bilinear resize computes the same weights."""
    width = height if width is None else width
    if tuple(img.shape[1:3]) == (height, width):
        return img
    out = F.interpolate(nchw(img), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=True)
    return nhwc(out)
