"""Convert torchvision InceptionV3 weights to the .npz of the FID detector
(port of the JAX package's tools/convert_inception.py, without JAX).

Layout: conv OIHW->HWIO, BatchNorm folded into scale/shift, fc transposed;
the same keys and arrays as the JAX package's converter writes. Read by
metrics/inception.py `load_inception_npz` (and by the JAX package's loader).
The state dict is required: the JAX package's script falls back on
torchvision's pretrained download, which needs torchvision and a network.

Usage:
  python -m morphganformer_tpu_torch.tools.convert_inception <inception_v3_state_dict.pth> out.npz
"""

import sys

import numpy as np
import torch

# torchvision module path -> our param tree tag.
_BLOCK_MAP = {
    "Conv2d_1a_3x3": ("c1a",), "Conv2d_2a_3x3": ("c2a",),
    "Conv2d_2b_3x3": ("c2b",), "Conv2d_3b_1x1": ("c3b",),
    "Conv2d_4a_3x3": ("c4a",),
}

_A_BRANCHES = {"branch1x1": "b1x1", "branch5x5_1": "b5_1",
               "branch5x5_2": "b5_2", "branch3x3dbl_1": "b3_1",
               "branch3x3dbl_2": "b3_2", "branch3x3dbl_3": "b3_3",
               "branch_pool": "bpool"}
_B_BRANCHES = {"branch3x3": "b3", "branch3x3dbl_1": "bd_1",
               "branch3x3dbl_2": "bd_2", "branch3x3dbl_3": "bd_3"}
_C_BRANCHES = {"branch1x1": "b1x1", "branch7x7_1": "b7_1",
               "branch7x7_2": "b7_2", "branch7x7_3": "b7_3",
               "branch7x7dbl_1": "bd_1", "branch7x7dbl_2": "bd_2",
               "branch7x7dbl_3": "bd_3", "branch7x7dbl_4": "bd_4",
               "branch7x7dbl_5": "bd_5", "branch_pool": "bpool"}
_D_BRANCHES = {"branch3x3_1": "b3_1", "branch3x3_2": "b3_2",
               "branch7x7x3_1": "b7_1", "branch7x7x3_2": "b7_2",
               "branch7x7x3_3": "b7_3", "branch7x7x3_4": "b7_4"}
_E_BRANCHES = {"branch1x1": "b1x1", "branch3x3_1": "b3_1",
               "branch3x3_2a": "b3_2a", "branch3x3_2b": "b3_2b",
               "branch3x3dbl_1": "bd_1", "branch3x3dbl_2": "bd_2",
               "branch3x3dbl_3a": "bd_3a", "branch3x3dbl_3b": "bd_3b",
               "branch_pool": "bpool"}

_MIXED = {
    "Mixed_5b": ("m5b", _A_BRANCHES), "Mixed_5c": ("m5c", _A_BRANCHES),
    "Mixed_5d": ("m5d", _A_BRANCHES), "Mixed_6a": ("m6a", _B_BRANCHES),
    "Mixed_6b": ("m6b", _C_BRANCHES), "Mixed_6c": ("m6c", _C_BRANCHES),
    "Mixed_6d": ("m6d", _C_BRANCHES), "Mixed_6e": ("m6e", _C_BRANCHES),
    "Mixed_7a": ("m7a", _D_BRANCHES), "Mixed_7b": ("m7b", _E_BRANCHES),
    "Mixed_7c": ("m7c", _E_BRANCHES),
}


def _conv_bn(sd, prefix, eps=1e-3):
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)
    scale = np.asarray(sd[f"{prefix}.bn.weight"], np.float32) / np.sqrt(
        np.asarray(sd[f"{prefix}.bn.running_var"], np.float32) + eps)
    shift = np.asarray(sd[f"{prefix}.bn.bias"], np.float32) - scale * \
        np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    return {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "scale": scale, "shift": shift}


def convert_state_dict(sd):
    flat = {}

    def put(tag, sub):
        d = _conv_bn(sd, sub)
        flat[f"{tag}_w"] = d["w"]
        flat[f"{tag}_scale"] = d["scale"]
        flat[f"{tag}_shift"] = d["shift"]

    for tv_name, (tag,) in _BLOCK_MAP.items():
        put(tag, tv_name)
    for tv_name, (tag, branches) in _MIXED.items():
        for tv_branch, our_branch in branches.items():
            put(f"{tag}.{our_branch}", f"{tv_name}.{tv_branch}")
    flat["fc_w"] = np.asarray(sd["fc.weight"], np.float32).T
    flat["fc_b"] = np.asarray(sd["fc.bias"], np.float32)
    return flat


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        print("convert_inception needs the state dict: <inception_v3_state_dict.pth> out.npz "
              "(torchvision's pretrained download is not used)", file=sys.stderr)
        return 1
    sd = torch.load(argv[0], map_location="cpu", weights_only=True)
    flat = convert_state_dict(sd)
    np.savez(argv[1], **flat)
    print(f"wrote {argv[1]}: {len(flat)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
