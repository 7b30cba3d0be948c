"""Convert facenet_pytorch InceptionResnetV1 (VGGFace2) weights to the .npz
of the FaceNet loss (port of the JAX package's tools/convert_facenet.py,
without JAX).

Layout: conv OIHW->HWIO, BN folded to scale/shift; the arrays are the JAX
package's converter's, bit for bit. The keys are `<module>_<leaf>`
("repeat_1.0.b1_0_w", "conv2d_1a_scale", "last_w"), the names that
losses/facenet.py `load_facenet_npz` and the JAX package's loader read. (The
JAX package's script joins the leaf with a dot, "repeat_1.0.b1_0.w", which
neither loader reads.)

Usage: python -m morphganformer_tpu_torch.tools.convert_facenet <state_dict.pt> out/facenet.npz
"""

import sys

import numpy as np
import torch


def _hwio(w):
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0), np.float32)


def _cb(sd, prefix, eps=1e-3):
    scale = np.asarray(sd[f"{prefix}.bn.weight"], np.float32) / np.sqrt(
        np.asarray(sd[f"{prefix}.bn.running_var"], np.float32) + eps)
    shift = np.asarray(sd[f"{prefix}.bn.bias"], np.float32) - scale * \
        np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    return {"w": _hwio(sd[f"{prefix}.conv.weight"]), "scale": scale,
            "shift": shift}


def _cv(sd, prefix):
    return {"w": _hwio(sd[f"{prefix}.weight"]),
            "b": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def convert_state_dict(sd):
    flat = {}

    def put(tag, d):
        flat.update({f"{tag}_{leaf}": v for leaf, v in d.items()})

    for tag in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b",
                "conv2d_4a", "conv2d_4b"):
        put(tag, _cb(sd, tag))
    for i in range(5):
        pre = f"repeat_1.{i}"
        put(f"repeat_1.{i}.b0", _cb(sd, f"{pre}.branch0"))
        put(f"repeat_1.{i}.b1_0", _cb(sd, f"{pre}.branch1.0"))
        put(f"repeat_1.{i}.b1_1", _cb(sd, f"{pre}.branch1.1"))
        put(f"repeat_1.{i}.b2_0", _cb(sd, f"{pre}.branch2.0"))
        put(f"repeat_1.{i}.b2_1", _cb(sd, f"{pre}.branch2.1"))
        put(f"repeat_1.{i}.b2_2", _cb(sd, f"{pre}.branch2.2"))
        put(f"repeat_1.{i}.conv2d", _cv(sd, f"{pre}.conv2d"))
    put("mixed_6a.b0", _cb(sd, "mixed_6a.branch0"))
    put("mixed_6a.b1_0", _cb(sd, "mixed_6a.branch1.0"))
    put("mixed_6a.b1_1", _cb(sd, "mixed_6a.branch1.1"))
    put("mixed_6a.b1_2", _cb(sd, "mixed_6a.branch1.2"))
    for i in range(10):
        pre = f"repeat_2.{i}"
        put(f"repeat_2.{i}.b0", _cb(sd, f"{pre}.branch0"))
        put(f"repeat_2.{i}.b1_0", _cb(sd, f"{pre}.branch1.0"))
        put(f"repeat_2.{i}.b1_1", _cb(sd, f"{pre}.branch1.1"))
        put(f"repeat_2.{i}.b1_2", _cb(sd, f"{pre}.branch1.2"))
        put(f"repeat_2.{i}.conv2d", _cv(sd, f"{pre}.conv2d"))
    put("mixed_7a.b0_0", _cb(sd, "mixed_7a.branch0.0"))
    put("mixed_7a.b0_1", _cb(sd, "mixed_7a.branch0.1"))
    put("mixed_7a.b1_0", _cb(sd, "mixed_7a.branch1.0"))
    put("mixed_7a.b1_1", _cb(sd, "mixed_7a.branch1.1"))
    put("mixed_7a.b2_0", _cb(sd, "mixed_7a.branch2.0"))
    put("mixed_7a.b2_1", _cb(sd, "mixed_7a.branch2.1"))
    put("mixed_7a.b2_2", _cb(sd, "mixed_7a.branch2.2"))
    for i in range(5):
        pre = f"repeat_3.{i}"
        put(f"repeat_3.{i}.b0", _cb(sd, f"{pre}.branch0"))
        put(f"repeat_3.{i}.b1_0", _cb(sd, f"{pre}.branch1.0"))
        put(f"repeat_3.{i}.b1_1", _cb(sd, f"{pre}.branch1.1"))
        put(f"repeat_3.{i}.b1_2", _cb(sd, f"{pre}.branch1.2"))
        put(f"repeat_3.{i}.conv2d", _cv(sd, f"{pre}.conv2d"))
    put("block8.b0", _cb(sd, "block8.branch0"))
    put("block8.b1_0", _cb(sd, "block8.branch1.0"))
    put("block8.b1_1", _cb(sd, "block8.branch1.1"))
    put("block8.b1_2", _cb(sd, "block8.branch1.2"))
    put("block8.conv2d", _cv(sd, "block8.conv2d"))
    flat["last_w"] = np.asarray(sd["last_linear.weight"], np.float32).T
    scale = np.asarray(sd["last_bn.weight"], np.float32) / np.sqrt(
        np.asarray(sd["last_bn.running_var"], np.float32) + 1e-3)
    flat["last_bn_scale"] = scale
    flat["last_bn_shift"] = np.asarray(sd["last_bn.bias"], np.float32) - \
        scale * np.asarray(sd["last_bn.running_mean"], np.float32)
    return flat


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    sd = torch.load(argv[0], map_location="cpu", weights_only=True)
    out = convert_state_dict(sd)
    np.savez(argv[1], **out)
    print(f"wrote {argv[1]}: {len(out)} arrays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
