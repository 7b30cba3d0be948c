"""Convert LPIPS weights (a feature tower's state dict and the reference's
linear heads) to the .npz of the LPIPS loss (port of the JAX package's
tools/convert_lpips.py, without JAX).

The reference bundles the calibration heads at lpips/weights/v0.1/{alex,vgg,
squeeze}.pth (keys lin{k}.model.1.weight, shape [1, C, 1, 1]); the feature
towers are torchvision's alexnet, vgg16 and squeezenet1_1. This reads both
state dicts with weights_only=True and writes the flat .npz that
losses/lpips.py `load_lpips_params` reads (and the JAX package's loader):

  tower conv weights -> HWIO float32 under the names w{i}/b{i}
  (w{i}_s/e1/e3 for squeeze fire modules), heads -> lin{k} [C].

Both files are named: the JAX package's script falls back on torchvision's
pretrained download for the tower and on a reference checkout for the heads,
and neither is here.

Usage:
  python -m morphganformer_tpu_torch.tools.convert_lpips alex out/lpips_alex.npz \
      --lins lpips/weights/v0.1/alex.pth \
      --tower alexnet_torchvision_state_dict.pth     (or --tower none: heads only)
"""

import argparse
import os
import sys

import numpy as np
import torch


def _hwio(w):
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0),
                                dtype=np.float32)


def convert_tower(net, state):
    """torchvision features.* state_dict -> lpips.py param names."""
    out = {}
    if net == "vgg":
        conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
        for i, li in enumerate(conv_idx):
            out[f"w{i}"] = _hwio(state[f"features.{li}.weight"])
            out[f"b{i}"] = np.asarray(state[f"features.{li}.bias"], np.float32)
    elif net == "alex":
        conv_idx = [0, 3, 6, 8, 10]
        for i, li in enumerate(conv_idx):
            out[f"w{i}"] = _hwio(state[f"features.{li}.weight"])
            out[f"b{i}"] = np.asarray(state[f"features.{li}.bias"], np.float32)
    elif net == "squeeze":
        out["w0"] = _hwio(state["features.0.weight"])
        out["b0"] = np.asarray(state["features.0.bias"], np.float32)
        fire_idx = [3, 4, 6, 7, 9, 10, 11, 12]  # squeezenet1_1 fire modules
        for n, li in enumerate(fire_idx, start=1):
            for tag, tname in (("s", "squeeze"), ("e1", "expand1x1"),
                               ("e3", "expand3x3")):
                out[f"w{n}_{tag}"] = _hwio(state[f"features.{li}.{tname}.weight"])
                out[f"b{n}_{tag}"] = np.asarray(
                    state[f"features.{li}.{tname}.bias"], np.float32)
    else:
        raise ValueError(net)
    return out


def convert_lins(path):
    # The bundled v0.1 heads are plain tensor state dicts; weights_only=True
    # loads them without any pickle code execution (reference
    # lpips/__init__.py:31-41 loads these same files).
    state = torch.load(path, map_location="cpu", weights_only=True)
    lins = {}
    k = 0
    while f"lin{k}.model.1.weight" in state:
        w = np.asarray(state[f"lin{k}.model.1.weight"], np.float32)
        lins[f"lin{k}"] = w.reshape(-1)  # [1,C,1,1] -> [C]
        k += 1
    assert lins, f"no lin heads in {path}"
    return lins


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m morphganformer_tpu_torch.tools.convert_lpips",
        description="LPIPS tower and heads -> .npz")
    p.add_argument("net", choices=["alex", "vgg", "squeeze"])
    p.add_argument("out")
    p.add_argument("--lins", required=True,
                   help="the reference's lpips/weights/v0.1/<net>.pth (the linear heads)")
    p.add_argument("--tower", default=None,
                   help="torchvision state_dict .pth of the tower, or 'none' for a "
                        "heads-only npz")
    args = p.parse_args(argv)
    if args.tower is None:
        p.error("--tower is required: a torchvision state_dict .pth of the tower, or "
                "--tower none for the heads alone (torchvision's pretrained download is "
                "not used)")
    if args.tower == "none":
        out = {}
    else:
        out = convert_tower(args.net, torch.load(args.tower, map_location="cpu",
                                                 weights_only=True))
    out.update(convert_lins(args.lins))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **out)
    print(f"wrote {args.out}: {len(out)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
