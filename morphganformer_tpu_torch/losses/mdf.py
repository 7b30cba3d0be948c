"""MDF (multi-scale discriminative feature) loss (port of
morphganformer_tpu/losses/mdf.py).

A stack of SinGAN WDiscriminators (conv, batch norm folded into scale and
shift, leaky ReLU 0.2; a body of shrinking widths; a one-channel tail). The
loss sums, over at most 8 scales and the three taps [head, body, tail], the
per-sample mean squared difference of the two images' activations, then
averages over the batch. The reference's Ds_*.pth stacks load from the
.npz of `python -m morphganformer_tpu_torch.tools.convert_mdf`, with the conv
padding recorded there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.losses.nets import channel, nchw, to_torch_params


def _conv_block(x, p, padding):
    """conv -> folded BN -> leaky ReLU 0.2 (slope 1 at 0, as jax.nn.leaky_relu)."""
    x = F.conv2d(x, p["w"], p["b"], padding=padding)
    x = x * channel(p["bn_scale"]) + channel(p["bn_shift"])
    return torch.where(x >= 0, x, 0.2 * x)


def wdiscriminator_taps(params: Dict, x, padding=0) -> List:
    """[head, body, tail] activations of one discriminator, NCHW x."""
    x1 = _conv_block(x, params["head"], padding)
    x2 = x1
    for blk in params["body"]:
        x2 = _conv_block(x2, blk, padding)
    return [x1, x2, F.conv2d(x2, params["tail_w"], params["tail_b"], padding=padding)]


def mdf_loss(ds_params: List[Dict], x, y, num_scales=8, is_ascending=True, padding=0):
    """The reference MDFLoss.forward on NHWC x, y."""
    x, y = nchw(x), nchw(y)
    loss = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    num_discs = len(ds_params)
    for scale_idx in range(min(num_scales, num_discs)):
        d = ds_params[scale_idx if is_ascending else num_discs - 1 - scale_idx]
        for px, py in zip(wdiscriminator_taps(d, x, padding), wdiscriminator_taps(d, y, padding)):
            loss = loss + torch.mean(torch.square(px - py), dim=(1, 2, 3))
    return torch.mean(loss)


def make_mdf_loss(ds_params: List[Dict], num_scales=8, padding=0):
    def loss(img, target):
        return mdf_loss(ds_params, img, target, num_scales=num_scales, padding=padding)
    return loss


def random_mdf_params(num_discs=8, nfc=32, min_nfc=32, num_layer=5, nc_im=3, ker_size=3, seed=0,
                      device="cuda") -> List[Dict]:
    """The JAX package's random_mdf_params (SinGAN's default widths, the same
    draws), as tensors."""
    rng = np.random.RandomState(seed)

    def conv_p(cin, cout, k):
        return {"w": rng.randn(k, k, cin, cout).astype(np.float32) / np.sqrt(cin * k * k),
                "b": np.zeros(cout, np.float32)}

    def block_p(cin, cout, k):
        return {**conv_p(cin, cout, k), "bn_scale": np.ones(cout, np.float32),
                "bn_shift": np.zeros(cout, np.float32)}

    ds = []
    for _ in range(num_discs):
        n = nfc
        d = {"head": block_p(nc_im, n, ker_size), "body": []}
        for i in range(num_layer - 2):
            n_out = int(nfc / 2 ** (i + 1))
            d["body"].append(block_p(max(2 * n_out, min_nfc), max(n_out, min_nfc), ker_size))
            n = max(n_out, min_nfc)
        tail = conv_p(n, 1, ker_size)
        d["tail_w"], d["tail_b"] = tail["w"], tail["b"]
        ds.append(d)
    return to_torch_params(ds, device)


def load_mdf_params(path, with_padding=False, device="cuda"):
    """The .npz of morphganformer_tpu_torch.tools.convert_mdf (d<i>_head_*,
    d<i>_body<j>_*, d<i>_tail_*) as tensors, as the JAX package's
    load_mdf_params reads it; with `with_padding`, also the conv padding
    recorded there (0 when absent, SinGAN's default)."""
    def block(data, pre):
        return {leaf: data[f"{pre}_{leaf}"] for leaf in ("w", "b", "bn_scale", "bn_shift")}

    ds = []
    with np.load(path) as data:
        i = 0
        while f"d{i}_head_w" in data:
            d = {"head": block(data, f"d{i}_head"), "body": []}
            j = 0
            while f"d{i}_body{j}_w" in data:
                d["body"].append(block(data, f"d{i}_body{j}"))
                j += 1
            d["tail_w"], d["tail_b"] = data[f"d{i}_tail_w"], data[f"d{i}_tail_b"]
            ds.append(d)
            i += 1
        padding = int(data["padding"]) if "padding" in data else 0
    ds = to_torch_params(ds, device)
    return (ds, padding) if with_padding else ds
