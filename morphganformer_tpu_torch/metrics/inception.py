"""InceptionV3 feature extractor of FID, KID and IS (port of
morphganformer_tpu/metrics/inception.py).

The standard torchvision InceptionV3, as the JAX package runs it: NHWC
images in [0, 255] of any size, resized to 299 (`jax.image.resize`'s
antialiased bilinear, `losses/nets.py::resize_bilinear`), the torchvision
normalisation, then the stem, the A/B/C/D/E blocks and the global average
pool: 2048 features; `fc_w`, `fc_b` give the 1000 logits of IS. Every
convolution is followed by its batch norm folded into a scale and a shift
and a ReLU. The parameters are the JAX package's tree (conv weights HWIO,
"scale", "shift"; the FC [2048, 1000]): `random_inception_params(seed)`
draws the same numbers as JAX's, `load_inception_npz` reads the .npz of
tools/convert_inception.py (`save_inception_npz` writes one). The module
holds them NCHW/OIHW and runs plain cuDNN convolutions, work that JAX
leaves to XLA.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from morphganformer_tpu_torch.losses.nets import nchw, resize_bilinear

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class ConvBN(nn.Module):
    """relu(conv(x, w) * scale + shift), NCHW; `padding` (ph, pw)."""

    def __init__(self, p, stride=1, padding=(0, 0)):
        super().__init__()
        w = np.asarray(p["w"], dtype=np.float32).transpose(3, 2, 0, 1)   # HWIO -> OIHW
        self.register_buffer("w", torch.tensor(np.ascontiguousarray(w)))
        self.register_buffer("scale", torch.tensor(np.asarray(p["scale"], np.float32)))
        self.register_buffer("shift", torch.tensor(np.asarray(p["shift"], np.float32)))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        y = F.conv2d(x, self.w, stride=self.stride, padding=self.padding)
        return F.relu(y * self.scale[None, :, None, None] + self.shift[None, :, None, None])


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool(x):
    """3x3, stride 1, SAME, averaged over the pixels inside the image."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class BlockA(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.b1x1, self.b5_1 = ConvBN(p["b1x1"]), ConvBN(p["b5_1"])
        self.b5_2 = ConvBN(p["b5_2"], padding=(2, 2))
        self.b3_1 = ConvBN(p["b3_1"])
        self.b3_2, self.b3_3 = ConvBN(p["b3_2"], padding=(1, 1)), ConvBN(p["b3_3"], padding=(1, 1))
        self.bpool = ConvBN(p["bpool"])

    def forward(self, x):
        return torch.cat([self.b1x1(x), self.b5_2(self.b5_1(x)),
                          self.b3_3(self.b3_2(self.b3_1(x))), self.bpool(_avgpool(x))], 1)


class BlockB(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.b3 = ConvBN(p["b3"], stride=2)
        self.bd_1, self.bd_2 = ConvBN(p["bd_1"]), ConvBN(p["bd_2"], padding=(1, 1))
        self.bd_3 = ConvBN(p["bd_3"], stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.bd_3(self.bd_2(self.bd_1(x))), _maxpool(x)], 1)


class BlockC(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.b1x1, self.b7_1 = ConvBN(p["b1x1"]), ConvBN(p["b7_1"])
        self.b7_2, self.b7_3 = ConvBN(p["b7_2"], padding=(0, 3)), ConvBN(p["b7_3"], padding=(3, 0))
        self.bd_1 = ConvBN(p["bd_1"])
        self.bd_2, self.bd_3 = ConvBN(p["bd_2"], padding=(3, 0)), ConvBN(p["bd_3"], padding=(0, 3))
        self.bd_4, self.bd_5 = ConvBN(p["bd_4"], padding=(3, 0)), ConvBN(p["bd_5"], padding=(0, 3))
        self.bpool = ConvBN(p["bpool"])

    def forward(self, x):
        b7 = self.b7_3(self.b7_2(self.b7_1(x)))
        bd = self.bd_5(self.bd_4(self.bd_3(self.bd_2(self.bd_1(x)))))
        return torch.cat([self.b1x1(x), b7, bd, self.bpool(_avgpool(x))], 1)


class BlockD(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.b3_1, self.b3_2 = ConvBN(p["b3_1"]), ConvBN(p["b3_2"], stride=2)
        self.b7_1 = ConvBN(p["b7_1"])
        self.b7_2, self.b7_3 = ConvBN(p["b7_2"], padding=(0, 3)), ConvBN(p["b7_3"], padding=(3, 0))
        self.b7_4 = ConvBN(p["b7_4"], stride=2)

    def forward(self, x):
        b7 = self.b7_4(self.b7_3(self.b7_2(self.b7_1(x))))
        return torch.cat([self.b3_2(self.b3_1(x)), b7, _maxpool(x)], 1)


class BlockE(nn.Module):
    def __init__(self, p):
        super().__init__()
        self.b1x1, self.b3_1 = ConvBN(p["b1x1"]), ConvBN(p["b3_1"])
        self.b3_2a, self.b3_2b = ConvBN(p["b3_2a"], padding=(0, 1)), ConvBN(p["b3_2b"],
                                                                           padding=(1, 0))
        self.bd_1, self.bd_2 = ConvBN(p["bd_1"]), ConvBN(p["bd_2"], padding=(1, 1))
        self.bd_3a, self.bd_3b = ConvBN(p["bd_3a"], padding=(0, 1)), ConvBN(p["bd_3b"],
                                                                           padding=(1, 0))
        self.bpool = ConvBN(p["bpool"])

    def forward(self, x):
        b3 = self.b3_1(x)
        bd = self.bd_2(self.bd_1(x))
        return torch.cat([self.b1x1(x), self.b3_2a(b3), self.b3_2b(b3), self.bd_3a(bd),
                          self.bd_3b(bd), self.bpool(_avgpool(x))], 1)


class InceptionV3(nn.Module):
    """NHWC images in [0, 255] -> 2048 pool features (`forward`), the 1000
    logits (`logits`) or their softmax (`probs`)."""

    def __init__(self, params: Dict):
        super().__init__()
        self.c1a = ConvBN(params["c1a"], stride=2)
        self.c2a = ConvBN(params["c2a"])
        self.c2b = ConvBN(params["c2b"], padding=(1, 1))
        self.c3b, self.c4a = ConvBN(params["c3b"]), ConvBN(params["c4a"])
        for tag, block in (("m5b", BlockA), ("m5c", BlockA), ("m5d", BlockA), ("m6a", BlockB),
                           ("m6b", BlockC), ("m6c", BlockC), ("m6d", BlockC), ("m6e", BlockC),
                           ("m7a", BlockD), ("m7b", BlockE), ("m7c", BlockE)):
            setattr(self, tag, block(params[tag]))
        self.register_buffer("fc_w", torch.tensor(np.asarray(params["fc_w"], np.float32)))
        self.register_buffer("fc_b", torch.tensor(np.asarray(params["fc_b"], np.float32)))
        self.register_buffer("mean", torch.tensor(_MEAN, dtype=torch.float32))
        self.register_buffer("std", torch.tensor(_STD, dtype=torch.float32))

    def forward(self, x):
        x = resize_bilinear(x.float(), 299)
        x = nchw((x / 255.0 - self.mean) / self.std)
        x = self.c2b(self.c2a(self.c1a(x)))
        x = self.c4a(self.c3b(_maxpool(x)))
        x = _maxpool(x)
        for tag in ("m5b", "m5c", "m5d", "m6a", "m6b", "m6c", "m6d", "m6e", "m7a", "m7b", "m7c"):
            x = getattr(self, tag)(x)
        return torch.mean(x, dim=(2, 3))

    def logits(self, x):
        return self(x) @ self.fc_w + self.fc_b

    def probs(self, x):
        return torch.softmax(self.logits(x), dim=-1)


def make_detector(params: Dict, kind="features", device="cuda"):
    """The metrics' detector: NHWC images in [0, 255] (numpy or a tensor)
    -> features [N, 2048] or probs [N, 1000], a tensor on `device`."""
    net = InceptionV3(params).to(device).eval()
    fn = {"features": net, "probs": net.probs}[kind]

    @torch.no_grad()
    def detector(imgs):
        return fn(torch.as_tensor(imgs, dtype=torch.float32, device=device))

    return detector


def random_inception_params(seed=0) -> Dict:
    """Random weights of JAX's `random_inception_params(seed)`, bit for bit:
    the same np.random.RandomState draws in the same order; shapes as
    torchvision's inception_v3."""
    rng = np.random.RandomState(seed)

    def cb(cin, cout, kh, kw=None):
        kw = kw if kw is not None else kh
        # JAX's expression, then float32 as jnp.asarray makes it.
        w = rng.randn(kh, kw, cin, cout).astype(np.float32) / np.sqrt(cin * kh * kw)
        return {"w": w.astype(np.float32),
                "scale": np.ones(cout, np.float32),
                "shift": np.zeros(cout, np.float32)}

    p = {"c1a": cb(3, 32, 3), "c2a": cb(32, 32, 3), "c2b": cb(32, 64, 3),
         "c3b": cb(64, 80, 1), "c4a": cb(80, 192, 3)}

    def block_a(cin, pool):
        return {"b1x1": cb(cin, 64, 1), "b5_1": cb(cin, 48, 1), "b5_2": cb(48, 64, 5),
                "b3_1": cb(cin, 64, 1), "b3_2": cb(64, 96, 3), "b3_3": cb(96, 96, 3),
                "bpool": cb(cin, pool, 1)}

    p["m5b"] = block_a(192, 32)
    p["m5c"] = block_a(256, 64)
    p["m5d"] = block_a(288, 64)
    p["m6a"] = {"b3": cb(288, 384, 3), "bd_1": cb(288, 64, 1), "bd_2": cb(64, 96, 3),
                "bd_3": cb(96, 96, 3)}

    def block_c(cin, c7):
        return {"b1x1": cb(cin, 192, 1), "b7_1": cb(cin, c7, 1), "b7_2": cb(c7, c7, 1, 7),
                "b7_3": cb(c7, 192, 7, 1), "bd_1": cb(cin, c7, 1), "bd_2": cb(c7, c7, 7, 1),
                "bd_3": cb(c7, c7, 1, 7), "bd_4": cb(c7, c7, 7, 1), "bd_5": cb(c7, 192, 1, 7),
                "bpool": cb(cin, 192, 1)}

    p["m6b"] = block_c(768, 128)
    p["m6c"] = block_c(768, 160)
    p["m6d"] = block_c(768, 160)
    p["m6e"] = block_c(768, 192)
    p["m7a"] = {"b3_1": cb(768, 192, 1), "b3_2": cb(192, 320, 3), "b7_1": cb(768, 192, 1),
                "b7_2": cb(192, 192, 1, 7), "b7_3": cb(192, 192, 7, 1), "b7_4": cb(192, 192, 3)}

    def block_e(cin):
        return {"b1x1": cb(cin, 320, 1), "b3_1": cb(cin, 384, 1), "b3_2a": cb(384, 384, 1, 3),
                "b3_2b": cb(384, 384, 3, 1), "bd_1": cb(cin, 448, 1), "bd_2": cb(448, 384, 3),
                "bd_3a": cb(384, 384, 1, 3), "bd_3b": cb(384, 384, 3, 1),
                "bpool": cb(cin, 192, 1)}

    p["m7b"] = block_e(1280)
    p["m7c"] = block_e(2048)
    p["fc_w"] = (rng.randn(2048, 1000).astype(np.float32) * 0.01).astype(np.float32)
    p["fc_b"] = np.zeros(1000, np.float32)
    return p


def save_inception_npz(params: Dict, path) -> None:
    """Write a parameter tree as the .npz that tools/convert_inception.py
    writes (the inverse of `load_inception_npz`)."""
    flat = {}
    for name, node in params.items():
        if name in ("fc_w", "fc_b"):
            flat[name] = node
        elif "w" in node:                                  # a conv of the stem
            flat.update({f"{name}_{leaf}": a for leaf, a in node.items()})
        else:                                              # a block of branches
            flat.update({f"{name}.{branch}_{leaf}": a for branch, p in node.items()
                         for leaf, a in p.items()})
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})


def load_inception_npz(path) -> Dict:
    """The parameter tree of a converted .npz (JAX's key layout, written by
    tools/convert_inception.py): "c1a_w", "m5b.b1x1_scale", "fc_w", ..."""
    params = {}
    with np.load(path) as data:
        for key in data.files:
            if key in ("fc_w", "fc_b"):
                params[key] = data[key]
                continue
            name, leaf = key.rsplit("_", 1)
            if leaf not in ("w", "scale", "shift"):
                raise KeyError(f"unknown leaf {key!r} in {path}")
            if "." in name:
                block, branch = name.split(".", 1)
                params.setdefault(block, {}).setdefault(branch, {})[leaf] = data[key]
            else:
                params.setdefault(name, {})[leaf] = data[key]
    return params
