"""Convert the reference's MDF discriminator pickles to the .npz of the MDF
loss (port of the JAX package's tools/convert_mdf.py, without JAX).

The reference's mdf-main/weights/Ds_{SISR,Denoising,JPEG}.pth files are
torch pickles of a list of SinGAN WDiscriminators (mdfloss.py:9-14,
SinGAN/models.py:15-38). This reads them with stand-ins for the pickled
`SinGAN.models` classes, folds each BatchNorm's running stats into
scale/shift, records the convs' padding, and writes arrays named
  d{i}_head_{w,b,bn_scale,bn_shift}, d{i}_body{j}_..., d{i}_tail_{w,b}, padding
for losses/mdf.py `load_mdf_params` (and the JAX package's loader): the same
keys and arrays as the JAX package's converter writes.

Usage: python -m morphganformer_tpu_torch.tools.convert_mdf Ds_SISR.pth out/mdf_sisr.npz
"""

import sys
import types

import numpy as np
import torch


def _hwio(w):
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0), np.float32)


def fold_bn(weight, bias, mean, var, eps=1e-5):
    scale = np.asarray(weight, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps)
    shift = np.asarray(bias, np.float32) - scale * np.asarray(mean, np.float32)
    return scale, shift


class _Stub:
    """Data-only stand-in for the reference's pickled SinGAN classes.

    The Ds_*.pth files pickle live `SinGAN.models.{WDiscriminator,ConvBlock}`
    instances (mdfloss.py:16-22). Instead of importing (= executing) the
    reference's module, we register stub classes under the same qualified
    names; unpickling then only restores their `__dict__` (nested torch
    modules — Conv2d/BatchNorm2d/Sequential — resolve to real torch classes,
    which is fine: torch is an installed library, not reference code)."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def _load_ds_stubbed(path):
    injected = []
    for name in ("SinGAN", "SinGAN.models"):
        if name not in sys.modules:
            sys.modules[name] = types.ModuleType(name)
            injected.append(name)
    mod = sys.modules["SinGAN.models"]
    patched = []
    for cls_name in ("WDiscriminator", "ConvBlock"):
        if not hasattr(mod, cls_name):
            setattr(mod, cls_name, type(cls_name, (_Stub,), {}))
            patched.append(cls_name)
    try:
        # weights_only must be False: the payload is module objects, not a
        # plain state dict (torch>=2.6 flipped the default).
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for cls_name in patched:
            delattr(mod, cls_name)
        for name in injected:
            del sys.modules[name]


def _named_tensors(obj, prefix=""):
    """state_dict() replacement that works for both real nn.Modules and the
    _Stub containers: walk _parameters/_buffers/_modules recursively."""
    d = getattr(obj, "__dict__", {})
    for k, v in {**(d.get("_parameters") or {}),
                 **(d.get("_buffers") or {})}.items():
        if v is not None:
            yield prefix + k, v.detach().numpy()
    for k, m in (d.get("_modules") or {}).items():
        if m is not None:
            yield from _named_tensors(m, prefix + k + ".")


def _conv_padding(obj, path):
    """Padding of the Conv2d at dotted `path` (e.g. 'head.conv')."""
    for part in path.split("."):
        obj = (getattr(obj, "__dict__", {}).get("_modules") or {})[part]
    pad = obj.__dict__.get("padding", 0)
    return int(pad[0] if isinstance(pad, (tuple, list)) else pad)


def convert(path, out_path):
    ds = _load_ds_stubbed(path)
    out = {}
    paddings = []
    for i, d in enumerate(ds):
        sd = dict(_named_tensors(d)) if not isinstance(d, dict) else d
        sd = {k: np.asarray(v) for k, v in sd.items()}
        if not isinstance(d, dict):
            paddings.append(_conv_padding(d, "head.conv"))
        out[f"d{i}_head_w"] = _hwio(sd["head.conv.weight"])
        out[f"d{i}_head_b"] = np.asarray(sd["head.conv.bias"], np.float32)
        out[f"d{i}_head_bn_scale"], out[f"d{i}_head_bn_shift"] = fold_bn(
            sd["head.norm.weight"], sd["head.norm.bias"],
            sd["head.norm.running_mean"], sd["head.norm.running_var"])
        j = 1
        while f"body.block{j}.conv.weight" in sd:
            pre = f"body.block{j}"
            out[f"d{i}_body{j - 1}_w"] = _hwio(sd[f"{pre}.conv.weight"])
            out[f"d{i}_body{j - 1}_b"] = np.asarray(sd[f"{pre}.conv.bias"],
                                                    np.float32)
            (out[f"d{i}_body{j - 1}_bn_scale"],
             out[f"d{i}_body{j - 1}_bn_shift"]) = fold_bn(
                sd[f"{pre}.norm.weight"], sd[f"{pre}.norm.bias"],
                sd[f"{pre}.norm.running_mean"], sd[f"{pre}.norm.running_var"])
            j += 1
        out[f"d{i}_tail_w"] = _hwio(sd["tail.weight"])
        out[f"d{i}_tail_b"] = np.asarray(sd["tail.bias"], np.float32)
    if paddings:
        assert len(set(paddings)) == 1, f"mixed paddings {paddings}"
        out["padding"] = np.int32(paddings[0])
    np.savez(out_path, **out)
    print(f"wrote {out_path}: {len(ds)} discriminators, {len(out)} arrays, "
          f"padding={out.get('padding', 'n/a')}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
