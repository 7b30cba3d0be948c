"""ArcFace iresnet identity loss (port of
morphganformer_tpu/losses/face_embedding.py).

The reference's backbones/iresnet.py family, batch norms folded into scale
and shift. Input NHWC in [-1, 1], resized to 112 x 112 (ArcFace's input);
the loss is the mean squared difference of the two images' embeddings.
Weights load from the .npz of tools/convert_iresnet.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.losses.nets import (channel, nchw, nhwc, resize_bilinear,
                                                  to_torch_params)

IRESNET_LAYERS = {
    "iresnet18": [2, 2, 2, 2],
    "iresnet34": [3, 4, 6, 3],
    "iresnet50": [3, 4, 14, 3],
    "iresnet100": [3, 13, 30, 3],
    "iresnet200": [6, 26, 60, 6],
}


def _bn(x, p):
    return x * channel(p["scale"]) + channel(p["shift"])


def _prelu(x, alpha):
    return torch.where(x >= 0, x, x * channel(alpha))


def _basic_block(x, p, stride):
    """IBasicBlock: bn1, conv1, bn2, prelu, conv2 (strided), bn3, plus the
    identity or its 1x1 projection."""
    out = _bn(x, p["bn1"])
    out = F.conv2d(out, p["conv1"], padding=1)
    out = _prelu(_bn(out, p["bn2"]), p["prelu"])
    out = _bn(F.conv2d(out, p["conv2"], stride=stride, padding=1), p["bn3"])
    identity = x
    if "down_w" in p:
        identity = _bn(F.conv2d(x, p["down_w"], stride=stride), p["down_bn"])
    return out + identity


def iresnet_embed(params: Dict, x):
    """x: NHWC 112 x 112 in [-1, 1] -> [B, 512] embeddings."""
    x = _prelu(_bn(F.conv2d(nchw(x), params["conv1_w"], padding=1), params["bn1"]),
               params["prelu"])
    for layer in ("layer1", "layer2", "layer3", "layer4"):
        for i, blk in enumerate(params[layer]):
            x = _basic_block(x, blk, stride=2 if i == 0 else 1)
    x = _bn(x, params["bn2"])
    x = nhwc(x).reshape(x.shape[0], -1)          # fc_w's rows are in HWC order
    x = x @ params["fc_w"] + params["fc_b"]
    return x * params["feat_scale"] + params["feat_shift"]


def make_identity_loss(params: Dict, input_size=112):
    """Loss-stack term: the mean squared difference of the embeddings."""
    def loss(img, target):
        e1 = iresnet_embed(params, resize_bilinear(img, input_size))
        e2 = iresnet_embed(params, resize_bilinear(target, input_size))
        return torch.mean(torch.square(e1 - e2))
    return loss


def cosine_similarity(params: Dict, img_a, img_b, input_size=112):
    """Identity similarity of two NHWC images, per batch element."""
    e1 = iresnet_embed(params, resize_bilinear(img_a, input_size))
    e2 = iresnet_embed(params, resize_bilinear(img_b, input_size))
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = e2 / torch.linalg.norm(e2, dim=-1, keepdim=True)
    return torch.sum(e1 * e2, dim=-1)


def random_iresnet_params(name="iresnet18", num_features=512, seed=0, device="cuda") -> Dict:
    """The JAX package's random_iresnet_params (the same draws), as tensors."""
    rng = np.random.RandomState(seed)

    def conv_p(cin, cout, k):
        return rng.randn(k, k, cin, cout).astype(np.float32) / np.sqrt(cin * k * k)

    def bn_p(c):
        return {"scale": np.ones(c, np.float32), "shift": np.zeros(c, np.float32)}

    params = {"conv1_w": conv_p(3, 64, 3), "bn1": bn_p(64),
              "prelu": np.full((64,), 0.25, np.float32)}
    inplanes = 64
    for li, (planes, blocks) in enumerate(zip([64, 128, 256, 512], IRESNET_LAYERS[name])):
        layer = []
        for bi in range(blocks):
            cin = inplanes if bi == 0 else planes
            blk = {"bn1": bn_p(cin), "conv1": conv_p(cin, planes, 3), "bn2": bn_p(planes),
                   "prelu": np.full((planes,), 0.25, np.float32),
                   "conv2": conv_p(planes, planes, 3), "bn3": bn_p(planes)}
            if bi == 0:  # the strided entry block always projects
                blk["down_w"] = conv_p(cin, planes, 1)
                blk["down_bn"] = bn_p(planes)
            layer.append(blk)
        params[f"layer{li + 1}"] = layer
        inplanes = planes
    params["bn2"] = bn_p(512)
    params["fc_w"] = rng.randn(512 * 7 * 7, num_features).astype(np.float32) * 0.01
    params["fc_b"] = np.zeros(num_features, np.float32)
    params["feat_scale"] = np.ones(num_features, np.float32)
    params["feat_shift"] = np.zeros(num_features, np.float32)
    return to_torch_params(params, device)


def load_iresnet_npz(path, name="iresnet18", device="cuda") -> Dict:
    """The flat .npz of tools/convert_iresnet.py as tensors, read as that
    tool's load_iresnet_npz reads it."""
    with np.load(path) as data:
        def bn(pre):
            return {"scale": data[f"{pre}_scale"], "shift": data[f"{pre}_shift"]}

        p = {"conv1_w": data["conv1_w"], "bn1": bn("bn1"), "prelu": data["prelu"]}
        for li, blocks in enumerate(IRESNET_LAYERS[name], start=1):
            layer = []
            for bi in range(blocks):
                tag = f"layer{li}_{bi}"
                blk = {"conv1": data[f"{tag}_conv1"], "conv2": data[f"{tag}_conv2"],
                       "prelu": data[f"{tag}_prelu"]}
                for bnn in ("bn1", "bn2", "bn3"):
                    blk[bnn] = bn(f"{tag}_{bnn}")
                if f"{tag}_down_w" in data:
                    blk["down_w"] = data[f"{tag}_down_w"]
                    blk["down_bn"] = bn(f"{tag}_down")
                layer.append(blk)
            p[f"layer{li}"] = layer
        p["bn2"] = bn("bn2")
        for key in ("fc_w", "fc_b", "feat_scale", "feat_shift"):
            p[key] = data[key]
    return to_torch_params(p, device)
