"""FaceNet InceptionResnetV1 embedding loss (port of
morphganformer_tpu/losses/facenet.py).

facenet_pytorch's architecture (stem, 5 Block35, Mixed_6a, 10 Block17,
Mixed_7a, 5 Block8, Block8 without ReLU, average pool, linear 1792 -> 512,
batch norm), batch norms folded into scale and shift. Input NHWC in
[-1, 1], resized to 160 x 160; the embedding is L2-normalised. Weights
load from the .npz of `python -m morphganformer_tpu_torch.tools.convert_facenet`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.losses.nets import channel, nchw, resize_bilinear, to_torch_params


def _conv_bn(x, p, stride=1, padding=0, relu=True):
    y = F.conv2d(x, p["w"], stride=stride, padding=padding) * channel(p["scale"]) \
        + channel(p["shift"])
    return F.relu(y) if relu else y


def _conv(x, p):
    return F.conv2d(x, p["w"], p["b"])


def _block35(x, p, scale=0.17):
    b0 = _conv_bn(x, p["b0"])
    b1 = _conv_bn(_conv_bn(x, p["b1_0"]), p["b1_1"], padding=1)
    b2 = _conv_bn(_conv_bn(_conv_bn(x, p["b2_0"]), p["b2_1"], padding=1), p["b2_2"], padding=1)
    return F.relu(x + _conv(torch.cat([b0, b1, b2], dim=1), p["conv2d"]) * scale)


def _block17(x, p, scale=0.10):
    b0 = _conv_bn(x, p["b0"])
    b1 = _conv_bn(x, p["b1_0"])
    b1 = _conv_bn(b1, p["b1_1"], padding=(0, 3))   # 1x7
    b1 = _conv_bn(b1, p["b1_2"], padding=(3, 0))   # 7x1
    return F.relu(x + _conv(torch.cat([b0, b1], dim=1), p["conv2d"]) * scale)


def _block8(x, p, scale=0.20, relu=True):
    b0 = _conv_bn(x, p["b0"])
    b1 = _conv_bn(x, p["b1_0"])
    b1 = _conv_bn(b1, p["b1_1"], padding=(0, 1))   # 1x3
    b1 = _conv_bn(b1, p["b1_2"], padding=(1, 0))   # 3x1
    out = x + _conv(torch.cat([b0, b1], dim=1), p["conv2d"]) * scale
    return F.relu(out) if relu else out


def facenet_embed(params: Dict, x):
    """x: NHWC 160 x 160 in [-1, 1] -> L2-normalised [B, 512] embeddings."""
    x = nchw(x)
    x = _conv_bn(x, params["conv2d_1a"], stride=2)
    x = _conv_bn(x, params["conv2d_2a"])
    x = _conv_bn(x, params["conv2d_2b"], padding=1)
    x = F.max_pool2d(x, 3, 2)
    x = _conv_bn(x, params["conv2d_3b"])
    x = _conv_bn(x, params["conv2d_4a"])
    x = _conv_bn(x, params["conv2d_4b"], stride=2)
    for p in params["repeat_1"]:
        x = _block35(x, p)
    m = params["mixed_6a"]
    x = torch.cat([
        _conv_bn(x, m["b0"], stride=2),
        _conv_bn(_conv_bn(_conv_bn(x, m["b1_0"]), m["b1_1"], padding=1), m["b1_2"], stride=2),
        F.max_pool2d(x, 3, 2),
    ], dim=1)
    for p in params["repeat_2"]:
        x = _block17(x, p)
    m = params["mixed_7a"]
    x = torch.cat([
        _conv_bn(_conv_bn(x, m["b0_0"]), m["b0_1"], stride=2),
        _conv_bn(_conv_bn(x, m["b1_0"]), m["b1_1"], stride=2),
        _conv_bn(_conv_bn(_conv_bn(x, m["b2_0"]), m["b2_1"], padding=1), m["b2_2"], stride=2),
        F.max_pool2d(x, 3, 2),
    ], dim=1)
    for p in params["repeat_3"]:
        x = _block8(x, p)
    x = _block8(x, params["block8"], scale=1.0, relu=False)
    x = torch.mean(x, dim=(2, 3))
    x = (x @ params["last_w"]) * params["last_bn_scale"] + params["last_bn_shift"]
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def make_facenet_loss(params: Dict, input_size=160):
    """Loss-stack term: the mean squared difference of the embeddings."""
    def loss(img, target):
        e1 = facenet_embed(params, resize_bilinear(img, input_size))
        e2 = facenet_embed(params, resize_bilinear(target, input_size))
        return torch.mean(torch.square(e1 - e2))
    return loss


def random_facenet_params(seed=0, device="cuda") -> Dict:
    """The JAX package's random_facenet_params (the same draws), as tensors."""
    rng = np.random.RandomState(seed)

    def cb(cin, cout, kh, kw=None):
        kw = kw if kw is not None else kh
        return {"w": rng.randn(kh, kw, cin, cout).astype(np.float32) / np.sqrt(cin * kh * kw),
                "scale": np.ones(cout, np.float32), "shift": np.zeros(cout, np.float32)}

    def cv(cin, cout, k=1):
        return {"w": rng.randn(k, k, cin, cout).astype(np.float32) / np.sqrt(cin * k * k),
                "b": np.zeros(cout, np.float32)}

    p = {"conv2d_1a": cb(3, 32, 3), "conv2d_2a": cb(32, 32, 3), "conv2d_2b": cb(32, 64, 3),
         "conv2d_3b": cb(64, 80, 1), "conv2d_4a": cb(80, 192, 3), "conv2d_4b": cb(192, 256, 3)}
    p["repeat_1"] = [{"b0": cb(256, 32, 1), "b1_0": cb(256, 32, 1), "b1_1": cb(32, 32, 3),
                      "b2_0": cb(256, 32, 1), "b2_1": cb(32, 32, 3), "b2_2": cb(32, 32, 3),
                      "conv2d": cv(96, 256)} for _ in range(5)]
    p["mixed_6a"] = {"b0": cb(256, 384, 3), "b1_0": cb(256, 192, 1), "b1_1": cb(192, 192, 3),
                     "b1_2": cb(192, 256, 3)}
    c17 = 896
    p["repeat_2"] = [{"b0": cb(c17, 128, 1), "b1_0": cb(c17, 128, 1),
                      "b1_1": cb(128, 128, 1, 7), "b1_2": cb(128, 128, 7, 1),
                      "conv2d": cv(256, c17)} for _ in range(10)]
    p["mixed_7a"] = {"b0_0": cb(c17, 256, 1), "b0_1": cb(256, 384, 3), "b1_0": cb(c17, 256, 1),
                     "b1_1": cb(256, 256, 3), "b2_0": cb(c17, 256, 1), "b2_1": cb(256, 256, 3),
                     "b2_2": cb(256, 256, 3)}
    c8 = 1792

    def block8():
        return {"b0": cb(c8, 192, 1), "b1_0": cb(c8, 192, 1), "b1_1": cb(192, 192, 1, 3),
                "b1_2": cb(192, 192, 3, 1), "conv2d": cv(384, c8)}
    p["repeat_3"] = [block8() for _ in range(5)]
    p["block8"] = block8()
    p["last_w"] = rng.randn(c8, 512).astype(np.float32) * 0.02
    p["last_bn_scale"] = np.ones(512, np.float32)
    p["last_bn_shift"] = np.zeros(512, np.float32)
    return to_torch_params(p, device)


def load_facenet_npz(path, device="cuda") -> Dict:
    """The .npz of morphganformer_tpu_torch.tools.convert_facenet as
    tensors, read as the JAX package's load_facenet_npz reads it."""
    p = {"repeat_1": [{} for _ in range(5)], "repeat_2": [{} for _ in range(10)],
         "repeat_3": [{} for _ in range(5)], "mixed_6a": {}, "mixed_7a": {}, "block8": {}}
    with np.load(path) as data:
        for key in data.files:
            val = data[key]
            if key in ("last_w", "last_bn_scale", "last_bn_shift"):
                p[key] = val
                continue
            name, leaf = key.rsplit("_", 1)
            parts = name.split(".")
            if parts[0].startswith("repeat"):
                node = p[parts[0]][int(parts[1])].setdefault(parts[2], {})
            elif parts[0] in ("mixed_6a", "mixed_7a", "block8"):
                node = p[parts[0]].setdefault(parts[1], {})
            else:
                node = p.setdefault(parts[0], {})
            node[leaf] = val
    return to_torch_params(p, device)
