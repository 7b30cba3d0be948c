"""LPIPS perceptual loss (port of morphganformer_tpu/losses/lpips.py).

The reference's PerceptualLoss(model='net-lin', net in {alex, vgg,
squeeze}): a scaling layer, a feature tower, each slice unit-normalised
over channels, the squared difference weighted by learned 1x1 heads,
averaged over space, summed over slices. Slice boundaries as
lpips/pretrained_networks.py:
  vgg16:   relu1_2, relu2_2, relu3_3, relu4_3, relu5_3 (64, 128, 256, 512, 512)
  alexnet: the relu after each of the 5 convs (64, 192, 384, 256, 256)
  squeeze: 7 slices (64, 128, 256, 384, 384, 512, 512)
Weights load from the .npz that tools/convert_lpips.py writes for the JAX
package ({"tower": ..., "lins": [...]}).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.losses.nets import channel, nchw, to_torch_params

# ScalingLayer constants, RGB.
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

LPIPS_CHANNELS = {
    "vgg": [64, 128, 256, 512, 512],
    "alex": [64, 192, 384, 256, 256],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}


def _conv_relu(x, params, i, stride=1, padding=0):
    return F.relu(F.conv2d(x, params[f"w{i}"], params[f"b{i}"], stride=stride,
                           padding=padding))


def vgg16_features(params: Dict, x) -> List:
    """VGG16 tower (NCHW), its 5 LPIPS slices."""
    outs, i = [], 0
    for n in (2, 2, 3, 3, 3):
        for _ in range(n):
            x = _conv_relu(x, params, i, padding=1)
            i += 1
        outs.append(x)
        if len(outs) < 5:
            x = F.max_pool2d(x, 2, 2)
    return outs


def alexnet_features(params: Dict, x) -> List:
    """AlexNet tower (NCHW), its 5 LPIPS slices."""
    x = _conv_relu(x, params, 0, stride=4, padding=2)
    outs = [x]
    x = _conv_relu(F.max_pool2d(x, 3, 2), params, 1, padding=2)
    outs.append(x)
    x = F.max_pool2d(x, 3, 2)
    for i in (2, 3, 4):
        x = _conv_relu(x, params, i, padding=1)
        outs.append(x)
    return outs


def _fire(params, x, idx):
    s = _conv_relu(x, params, f"{idx}_s")
    return torch.cat([_conv_relu(s, params, f"{idx}_e1"),
                      _conv_relu(s, params, f"{idx}_e3", padding=1)], dim=1)


def squeezenet_features(params: Dict, x) -> List:
    """SqueezeNet 1.1 tower (NCHW), its 7 LPIPS slices."""
    x = _conv_relu(x, params, 0, stride=2)
    outs = [x]
    x = _fire(params, _fire(params, F.max_pool2d(x, 3, 2), 1), 2)
    outs.append(x)
    x = _fire(params, _fire(params, F.max_pool2d(x, 3, 2), 3), 4)
    outs.append(x)
    x = _fire(params, F.max_pool2d(x, 3, 2), 5)
    outs.append(x)
    for idx in (6, 7, 8):
        x = _fire(params, x, idx)
        outs.append(x)
    return outs


_TOWERS = {"vgg": vgg16_features, "alex": alexnet_features, "squeeze": squeezenet_features}


def normalize_tensor(x, eps=1e-10):
    """Unit-normalise NCHW x over its channels."""
    return x / (torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps)


def lpips_distance(params: Dict, img0, img1, net: str = "alex"):
    """LPIPS distance per batch element of NHWC images in [-1, 1]. params:
    {"tower": {...}, "lins": [[C] per slice]}, the heads' 1x1 convs to one
    channel without bias."""
    tower = _TOWERS[net]
    shift, scale = img0.new_tensor(_SHIFT), img0.new_tensor(_SCALE)
    f0 = tower(params["tower"], nchw((img0 - shift) / scale))
    f1 = tower(params["tower"], nchw((img1 - shift) / scale))
    val = 0.0
    for a, b, w in zip(f0, f1, params["lins"]):
        d = torch.square(normalize_tensor(a) - normalize_tensor(b))
        val = val + torch.mean(torch.sum(d * channel(w), dim=1), dim=(1, 2))
    return val


def make_lpips_loss(params: Dict, net: str = "alex"):
    """Loss-stack term: the mean LPIPS distance of img and target."""
    def loss(img, target):
        return torch.mean(lpips_distance(params, img, target, net=net))
    return loss


def _random_lpips_tree(net: str, seed: int):
    rng = np.random.RandomState(seed)

    def conv_p(cin, cout, k):
        return (rng.randn(k, k, cin, cout).astype(np.float32) / np.sqrt(cin * k * k),
                np.zeros(cout, np.float32))

    tower = {}
    if net == "vgg":
        cfg = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256), (256, 256),
               (256, 512), (512, 512), (512, 512), (512, 512), (512, 512), (512, 512)]
        for i, (cin, cout) in enumerate(cfg):
            tower[f"w{i}"], tower[f"b{i}"] = conv_p(cin, cout, 3)
    elif net == "alex":
        specs = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
        for i, (cin, cout, k) in enumerate(specs):
            tower[f"w{i}"], tower[f"b{i}"] = conv_p(cin, cout, k)
    elif net == "squeeze":
        tower["w0"], tower["b0"] = conv_p(3, 64, 3)
        fire_specs = [(64, 16, 64), (128, 16, 64), (128, 32, 128), (256, 32, 128),
                      (256, 48, 192), (384, 48, 192), (384, 64, 256), (512, 64, 256)]
        for idx, (cin, sq, ex) in enumerate(fire_specs, start=1):
            tower[f"w{idx}_s"], tower[f"b{idx}_s"] = conv_p(cin, sq, 1)
            tower[f"w{idx}_e1"], tower[f"b{idx}_e1"] = conv_p(sq, ex, 1)
            tower[f"w{idx}_e3"], tower[f"b{idx}_e3"] = conv_p(sq, ex, 3)
    else:
        raise ValueError(net)
    lins = [np.abs(rng.randn(c)).astype(np.float32) * 0.1 for c in LPIPS_CHANNELS[net]]
    return {"tower": tower, "lins": lins}


def random_lpips_params(net: str = "alex", seed: int = 0, device="cuda") -> Dict:
    """The JAX package's random_lpips_params (the same draws), as tensors."""
    return to_torch_params(_random_lpips_tree(net, seed), device)


def load_lpips_params(path: str, net: str = "alex", device="cuda") -> Dict:
    """The .npz of tools/convert_lpips.py (tower w*/b*, heads lin0, lin1,
    ...) as tensors. A heads-only .npz (`--tower none`) gets the seeded
    random tower of random_lpips_params and `"tower_source": "random"`."""
    tower, lins = {}, []
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("lin"):
                lins.append((int(key[3:]), data[key]))
            else:
                tower[key] = data[key]
    lins = [v for _, v in sorted(lins, key=lambda kv: kv[0])]
    expected = len(LPIPS_CHANNELS[net])
    if len(lins) != expected:
        raise ValueError(f"{path}: {len(lins)} lin heads, expected {expected} for '{net}'")
    params = {"tower": tower, "lins": lins}
    if not tower:
        params = {"tower": _random_lpips_tree(net, 0)["tower"], "lins": lins,
                  "tower_source": "random"}
    return to_torch_params(params, device)
