"""Convert an ArcFace iresnet torch state_dict to the .npz of the identity
loss (port of the JAX package's tools/convert_iresnet.py, without JAX).

The reference ships the backbone family at backbones/iresnet.py and a
get_model registry (backbones/__init__.py:5-25); the insightface-trained
weights (.pth state_dicts) convert here: conv OIHW->HWIO, BatchNorm folded
to scale/shift, PReLU slopes kept, fc [out,in]->[in,out]. The .npz is what
losses/face_embedding.py `load_iresnet_npz` reads (and the JAX package's
loader), the same keys and arrays as the JAX package's converter writes.

Usage:
  python -m morphganformer_tpu_torch.tools.convert_iresnet iresnet18 backbone.pth out/iresnet18.npz
"""

import sys

import numpy as np
import torch

from morphganformer_tpu_torch.losses.face_embedding import IRESNET_LAYERS


def _hwio(w):
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0), np.float32)


def fold_bn(sd, prefix, eps=1e-5):
    scale = np.asarray(sd[f"{prefix}.weight"], np.float32) / np.sqrt(
        np.asarray(sd[f"{prefix}.running_var"], np.float32) + eps)
    shift = np.asarray(sd[f"{prefix}.bias"], np.float32) - scale * np.asarray(
        sd[f"{prefix}.running_mean"], np.float32)
    return {"scale": scale, "shift": shift}


def convert_state_dict(name, sd):
    layers = IRESNET_LAYERS[name]
    flat = {}

    def put(path, arr):
        flat[path] = np.asarray(arr, np.float32)

    put("conv1_w", _hwio(sd["conv1.weight"]))
    bn = fold_bn(sd, "bn1")
    put("bn1_scale", bn["scale"])
    put("bn1_shift", bn["shift"])
    put("prelu", sd["prelu.weight"])
    for li, blocks in enumerate(layers, start=1):
        for bi in range(blocks):
            pre = f"layer{li}.{bi}"
            tag = f"layer{li}_{bi}"
            for bnn in ("bn1", "bn2", "bn3"):
                bn = fold_bn(sd, f"{pre}.{bnn}")
                put(f"{tag}_{bnn}_scale", bn["scale"])
                put(f"{tag}_{bnn}_shift", bn["shift"])
            put(f"{tag}_conv1", _hwio(sd[f"{pre}.conv1.weight"]))
            put(f"{tag}_conv2", _hwio(sd[f"{pre}.conv2.weight"]))
            put(f"{tag}_prelu", sd[f"{pre}.prelu.weight"])
            if f"{pre}.downsample.0.weight" in sd:
                put(f"{tag}_down_w", _hwio(sd[f"{pre}.downsample.0.weight"]))
                bn = fold_bn(sd, f"{pre}.downsample.1")
                put(f"{tag}_down_scale", bn["scale"])
                put(f"{tag}_down_shift", bn["shift"])
    bn = fold_bn(sd, "bn2")
    put("bn2_scale", bn["scale"])
    put("bn2_shift", bn["shift"])
    put("fc_w", np.asarray(sd["fc.weight"], np.float32).T)
    put("fc_b", sd["fc.bias"])
    # features BatchNorm1d (weight frozen at 1, iresnet.py:100-102).
    scale = np.asarray(sd["features.weight"], np.float32) / np.sqrt(
        np.asarray(sd["features.running_var"], np.float32) + 1e-5)
    put("feat_scale", scale)
    put("feat_shift", np.asarray(sd["features.bias"], np.float32)
        - scale * np.asarray(sd["features.running_mean"], np.float32))
    return flat


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print(__doc__)
        return 1
    name, pth, out = argv
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    flat = convert_state_dict(name, sd)
    np.savez(out, **flat)
    print(f"wrote {out}: {len(flat)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
