"""The port's net converters (morphganformer_tpu_torch/tools/convert_iresnet,
convert_inception, convert_facenet, convert_lpips, convert_mdf) against the
JAX package's (tools/convert_*.py) on state dicts under each net's torch key
names, made from a numpy seed: iresnet18, InceptionV3, facenet's
InceptionResnetV1, the LPIPS towers (alex, vgg, squeeze) with their heads,
and an MDF stack pickled with stand-in `SinGAN.models` classes.

Checks: both converters write .npz files with the same keys and bit-equal
arrays; the port's loader on the port's file gives the JAX loader's tree on
JAX's file, and a forward within tests/test_torch_loss_terms.py's
tolerances (a term's value within 1e-4 relative in float32 and float64, its
image gradient within 1e-3 of the largest entry in float64; InceptionV3's
features and probabilities within 1e-5 relative, as
tests/test_torch_metrics.py holds them); without a state dict the LPIPS and
InceptionV3 converters refuse and name what is missing."""

import re
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from morphganformer_tpu.losses import face_embedding as jface
from morphganformer_tpu.losses import facenet as jfacenet
from morphganformer_tpu.losses import lpips as jlpips
from morphganformer_tpu.losses import mdf as jmdf
from morphganformer_tpu.metrics import inception as jinc
from morphganformer_tpu_torch.losses import face_embedding, facenet, lpips, mdf
from morphganformer_tpu_torch.metrics import inception
from morphganformer_tpu_torch.tools import (convert_facenet, convert_inception, convert_iresnet,
                                            convert_lpips, convert_mdf)
from tools import convert_facenet as jconvert_facenet
from tools import convert_inception as jconvert_inception
from tools import convert_iresnet as jconvert_iresnet
from tools import convert_lpips as jconvert_lpips
from tools import convert_mdf as jconvert_mdf

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)
from .test_torch_loss_terms import (GRAD_TOL, VALUE_RTOL, assert_same_tree, cast, images,
                                    term_value_and_grad)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# ------------------------------------------------------------ state dicts

def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def bn(rng, prefix, c):
    """A BatchNorm's four tensors under `prefix`, and its step counter."""
    return {f"{prefix}.weight": t(1 + 0.2 * rng.randn(c)), f"{prefix}.bias": t(0.1 * rng.randn(c)),
            f"{prefix}.running_mean": t(0.1 * rng.randn(c)),
            f"{prefix}.running_var": t(rng.uniform(0.5, 1.5, c)),
            f"{prefix}.num_batches_tracked": torch.tensor(7)}


def conv(rng, shape):
    """An OIHW conv weight."""
    o, i, kh, kw = shape
    return t(rng.randn(*shape) / np.sqrt(i * kh * kw))


def iresnet18_state(rng):
    """insightface's iresnet18 state_dict (backbones/iresnet.py names)."""
    p = face_embedding.random_iresnet_params(device="cpu")
    sd = {"conv1.weight": conv(rng, p["conv1_w"].shape), **bn(rng, "bn1", 64),
          "prelu.weight": t(0.25 + 0.05 * rng.randn(64))}
    for li in range(1, 5):
        for bi, blk in enumerate(p[f"layer{li}"]):
            pre = f"layer{li}.{bi}"
            for name in ("bn1", "bn2", "bn3"):
                sd.update(bn(rng, f"{pre}.{name}", blk[name]["scale"].numel()))
            sd[f"{pre}.conv1.weight"] = conv(rng, blk["conv1"].shape)
            sd[f"{pre}.conv2.weight"] = conv(rng, blk["conv2"].shape)
            sd[f"{pre}.prelu.weight"] = t(0.25 + 0.05 * rng.randn(blk["prelu"].numel()))
            if "down_w" in blk:
                sd[f"{pre}.downsample.0.weight"] = conv(rng, blk["down_w"].shape)
                sd.update(bn(rng, f"{pre}.downsample.1", blk["down_w"].shape[0]))
    sd.update(bn(rng, "bn2", 512))
    fc_in, fc_out = p["fc_w"].shape
    sd["fc.weight"] = t(0.01 * rng.randn(fc_out, fc_in))
    sd["fc.bias"] = t(0.01 * rng.randn(fc_out))
    sd.update(bn(rng, "features", fc_out))
    sd["features.weight"] = torch.ones(fc_out)          # frozen at 1 (iresnet.py:100-102)
    return sd


def inception_state(rng):
    """torchvision's inception_v3 state_dict (its module names), with the
    auxiliary head the converter leaves out."""
    p = inception.random_inception_params(0)
    sd = {}

    def conv_bn(prefix, node):
        sd[f"{prefix}.conv.weight"] = conv(rng, node["w"].transpose(3, 2, 0, 1).shape)
        sd.update(bn(rng, f"{prefix}.bn", node["scale"].shape[0]))

    for tv_name, (tag,) in jconvert_inception._BLOCK_MAP.items():
        conv_bn(tv_name, p[tag])
    for tv_name, (tag, branches) in jconvert_inception._MIXED.items():
        for tv_branch, ours in branches.items():
            conv_bn(f"{tv_name}.{tv_branch}", p[tag][ours])
    sd["fc.weight"] = t(0.01 * rng.randn(1000, 2048))
    sd["fc.bias"] = t(0.01 * rng.randn(1000))
    sd["AuxLogits.fc.weight"] = t(rng.randn(1000, 768))
    return sd


def facenet_state(rng):
    """facenet_pytorch's InceptionResnetV1 state_dict (its module names)."""
    p = facenet.random_facenet_params(device="cpu")
    sd = {}

    def torch_name(ours):                    # b1_0 -> branch1.0, b0 -> branch0
        m = re.fullmatch(r"b(\d)(?:_(\d))?", ours)
        return ours if m is None else f"branch{m.group(1)}" + (
            f".{m.group(2)}" if m.group(2) else "")

    def put(prefix, node):
        if "scale" in node:
            sd[f"{prefix}.conv.weight"] = conv(rng, node["w"].shape)
            sd.update(bn(rng, f"{prefix}.bn", node["scale"].numel()))
        else:
            sd[f"{prefix}.weight"] = conv(rng, node["w"].shape)
            sd[f"{prefix}.bias"] = t(0.1 * rng.randn(node["b"].numel()))

    for name, node in p.items():
        if name.startswith("conv2d_"):
            put(name, node)
        elif isinstance(node, list):
            for i, blk in enumerate(node):
                for ours, leaf in blk.items():
                    put(f"{name}.{i}.{torch_name(ours)}", leaf)
        elif isinstance(node, dict):
            for ours, leaf in node.items():
                put(f"{name}.{torch_name(ours)}", leaf)
    sd["last_linear.weight"] = t(0.01 * rng.randn(512, 1792))
    sd.update(bn(rng, "last_bn", 512))
    return sd


LPIPS_FEATURES = {"alex": [0, 3, 6, 8, 10], "vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28],
                  "squeeze": [3, 4, 6, 7, 9, 10, 11, 12]}


def lpips_states(rng, net):
    """(torchvision tower state_dict, the reference's lin heads state_dict)."""
    p = lpips.random_lpips_params(net, device="cpu")
    tower, sd = p["tower"], {}
    if net == "squeeze":
        sd["features.0.weight"] = conv(rng, tower["w0"].shape)
        sd["features.0.bias"] = t(0.1 * rng.randn(tower["b0"].numel()))
        for n, li in enumerate(LPIPS_FEATURES[net], start=1):
            for tag, tname in (("s", "squeeze"), ("e1", "expand1x1"), ("e3", "expand3x3")):
                sd[f"features.{li}.{tname}.weight"] = conv(rng, tower[f"w{n}_{tag}"].shape)
                sd[f"features.{li}.{tname}.bias"] = t(0.1 * rng.randn(
                    tower[f"b{n}_{tag}"].numel()))
    else:
        for i, li in enumerate(LPIPS_FEATURES[net]):
            sd[f"features.{li}.weight"] = conv(rng, tower[f"w{i}"].shape)
            sd[f"features.{li}.bias"] = t(0.1 * rng.randn(tower[f"b{i}"].numel()))
    lins = {f"lin{k}.model.1.weight": t(np.abs(rng.randn(1, c.numel(), 1, 1)) * 0.1)
            for k, c in enumerate(p["lins"])}
    return sd, lins


# ------------------------------------------------------------ the MDF stack

def singan_classes():
    """Stand-ins for SinGAN.models.{ConvBlock, WDiscriminator} (SinGAN/
    models.py:7-38), registered so that torch.save writes their GLOBALs."""
    class ConvBlock(nn.Sequential):
        def __init__(self, cin, cout, ker, padd, stride):
            super().__init__()
            self.add_module("conv", nn.Conv2d(cin, cout, ker, stride, padd))
            self.add_module("norm", nn.BatchNorm2d(cout))
            self.add_module("LeakyRelu", nn.LeakyReLU(0.2, inplace=True))

    class WDiscriminator(nn.Module):
        def __init__(self, nfc, min_nfc, num_layer=5, nc_im=3, ker=3, padd=0):
            super().__init__()
            n = nfc
            self.head = ConvBlock(nc_im, n, ker, padd, 1)
            self.body = nn.Sequential()
            for i in range(num_layer - 2):
                n = int(nfc / 2 ** (i + 1))
                self.body.add_module(f"block{i + 1}", ConvBlock(
                    max(2 * n, min_nfc), max(n, min_nfc), ker, padd, 1))
            self.tail = nn.Conv2d(max(n, min_nfc), 1, ker, 1, padd)

    mod = types.ModuleType("SinGAN.models")
    for cls in (ConvBlock, WDiscriminator):
        cls.__module__, cls.__qualname__ = "SinGAN.models", cls.__name__
        setattr(mod, cls.__name__, cls)
    return mod


def write_mdf_pickle(path, rng, num_discs=3, nfc=16, min_nfc=8, padd=1):
    """torch.save of a list of WDiscriminators with random weights and
    running stats; the stand-in module is removed again, so a reader sees
    the reference's names alone."""
    mod = singan_classes()
    sys.modules["SinGAN"], sys.modules["SinGAN.models"] = types.ModuleType("SinGAN"), mod
    try:
        ds = []
        for _ in range(num_discs):
            d = mod.WDiscriminator(nfc, min_nfc, padd=padd)
            with torch.no_grad():
                for name, v in d.state_dict().items():
                    if name.endswith("running_var"):
                        v.copy_(t(rng.uniform(0.5, 1.5, v.shape)))
                    elif v.is_floating_point():
                        v.copy_(t(0.3 * rng.randn(*v.shape)))
            ds.append(d)
        torch.save(ds, path)
    finally:
        del sys.modules["SinGAN"], sys.modules["SinGAN.models"]


# ------------------------------------------------------------ checks

def assert_same_npz(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            g, w = got[k], want[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        return len(want.files)


def assert_loaded_term_matches(jterm_of, term_of, a, b, jparams, tparams):
    """tests/test_torch_loss_terms.py's assert_term_matches with each side's
    own loaded parameters: the value in float32, the value and d value / d a
    in float64."""
    want = jax.jit(jterm_of(jparams))(jnp.asarray(a), jnp.asarray(b))
    got, _ = term_value_and_grad(term_of(tparams), a, b)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    with jax.enable_x64(True):
        jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    cast(jax.device_get(jparams), np.float64))
        want, want_grad = jax.jit(jax.value_and_grad(jterm_of(jp)))(jnp.asarray(a64),
                                                                    jnp.asarray(b64))
        want, want_grad = float(want), np.asarray(want_grad)
    got, got_grad = term_value_and_grad(term_of(cast(tparams, torch.float64)), a64, b64)
    assert np.isfinite(want) and np.abs(want_grad).max() > 0
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


def test_iresnet_converter_matches_jax(tmp_path):
    pth = tmp_path / "backbone.pth"
    torch.save(iresnet18_state(np.random.RandomState(0)), pth)
    want = tmp_path / "jax.npz"
    np.savez(want, **jconvert_iresnet.convert_state_dict(
        "iresnet18", torch.load(pth, map_location="cpu", weights_only=True)))
    assert convert_iresnet.main(["iresnet18", str(pth), str(tmp_path / "port.npz")]) == 0
    assert assert_same_npz(tmp_path / "port.npz", want) == 94
    tp = face_embedding.load_iresnet_npz(str(tmp_path / "port.npz"), device="cpu")
    jp = jconvert_iresnet.load_iresnet_npz(str(want))
    assert_same_tree(tp, jp)
    a, b = images(30, 64)
    assert_loaded_term_matches(jface.make_identity_loss, face_embedding.make_identity_loss,
                               a, b, jp, tp)


def test_inception_converter_matches_jax(tmp_path):
    pth = tmp_path / "inception_v3.pth"
    torch.save(inception_state(np.random.RandomState(1)), pth)
    want = tmp_path / "jax.npz"
    np.savez(want, **jconvert_inception.convert_state_dict(
        torch.load(pth, map_location="cpu", weights_only=True)))
    assert convert_inception.main([str(pth), str(tmp_path / "port.npz")]) == 0
    assert assert_same_npz(tmp_path / "port.npz", want) == 284
    tp = inception.load_inception_npz(str(tmp_path / "port.npz"))
    jp = jinc.load_inception_npz(str(want))
    x = np.random.RandomState(14).uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
    both = jax.jit(lambda p, x: (jinc.inception_features(p, x), jinc.inception_probs(p, x)))
    for kind, w in zip(("features", "probs"), both(jp, jnp.asarray(x))):
        got, w = inception.make_detector(tp, kind, device="cpu")(x).numpy(), np.asarray(w)
        assert got.shape == w.shape
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max(), kind


def test_facenet_converter_matches_jax(tmp_path):
    pth = tmp_path / "facenet.pt"
    torch.save(facenet_state(np.random.RandomState(2)), pth)
    want = tmp_path / "jax.npz"
    np.savez(want, **jconvert_facenet.convert_state_dict(
        torch.load(pth, map_location="cpu", weights_only=True)))
    assert convert_facenet.main([str(pth), str(tmp_path / "port.npz")]) == 0
    # JAX's script names a leaf "<module>.<leaf>", which no loader reads
    # ("repeat_1.0.b0.w": JAX's load_facenet_npz fails on it); the port
    # writes the "<module>_<leaf>" the loaders read, the same arrays.
    with np.load(want) as data:
        renamed = {(k if "." not in k else k[:k.rfind(".")] + "_" + k[k.rfind(".") + 1:]): data[k]
                   for k in data.files}
    with pytest.raises(KeyError):
        jconvert_facenet.load_facenet_npz(str(want))
    np.savez(want, **renamed)
    assert assert_same_npz(tmp_path / "port.npz", want) == 378
    tp = facenet.load_facenet_npz(str(tmp_path / "port.npz"), device="cpu")
    jp = jconvert_facenet.load_facenet_npz(str(tmp_path / "port.npz"))
    assert_same_tree(tp, jp)
    a, b = images(31, 40)
    assert_loaded_term_matches(jfacenet.make_facenet_loss, facenet.make_facenet_loss, a, b,
                               jp, tp)


@pytest.mark.parametrize("net,size", [("alex", 64), ("vgg", 32), ("squeeze", 48)])
def test_lpips_converter_matches_jax(tmp_path, net, size):
    tower, lins = lpips_states(np.random.RandomState(3), net)
    torch.save(tower, tmp_path / "tower.pth")
    torch.save(lins, tmp_path / "lins.pth")
    want = tmp_path / "jax.npz"
    state = torch.load(tmp_path / "tower.pth", map_location="cpu", weights_only=True)
    np.savez(want, **jconvert_lpips.convert_tower(net, state),
             **jconvert_lpips.convert_lins(str(tmp_path / "lins.pth")))
    assert convert_lpips.main([net, str(tmp_path / "port.npz"), "--lins",
                               str(tmp_path / "lins.pth"), "--tower",
                               str(tmp_path / "tower.pth")]) == 0
    assert assert_same_npz(tmp_path / "port.npz", want) == len(tower) + len(lins)
    tp = lpips.load_lpips_params(str(tmp_path / "port.npz"), net, device="cpu")
    jp = jlpips.load_lpips_params(str(want), net)
    assert_same_tree(tp, jp)
    a, b = images(32, size)
    assert_loaded_term_matches(lambda p: jlpips.make_lpips_loss(p, net),
                               lambda p: lpips.make_lpips_loss(p, net), a, b, jp, tp)
    # --tower none: the heads alone.
    assert convert_lpips.main([net, str(tmp_path / "heads.npz"), "--lins",
                               str(tmp_path / "lins.pth"), "--tower", "none"]) == 0
    with np.load(tmp_path / "heads.npz") as heads:
        assert sorted(heads.files) == sorted(f"lin{k}" for k in range(len(lins)))


def test_mdf_converter_matches_jax(tmp_path):
    write_mdf_pickle(tmp_path / "Ds.pth", np.random.RandomState(4))
    want = tmp_path / "jax.npz"
    jconvert_mdf.convert(str(tmp_path / "Ds.pth"), str(want))
    assert "SinGAN.models" not in sys.modules
    assert convert_mdf.main([str(tmp_path / "Ds.pth"), str(tmp_path / "port.npz")]) == 0
    assert "SinGAN.models" not in sys.modules
    assert assert_same_npz(tmp_path / "port.npz", want) == 3 * 18 + 1
    tp, tpad = mdf.load_mdf_params(str(tmp_path / "port.npz"), with_padding=True, device="cpu")
    jp, jpad = jconvert_mdf.load_mdf_params(str(want), with_padding=True)
    assert tpad == jpad == 1
    assert_same_tree(tp, jp)
    a, b = images(33, 24)
    assert_loaded_term_matches(lambda p: jmdf.make_mdf_loss(p, padding=jpad),
                               lambda p: mdf.make_mdf_loss(p, padding=tpad), a, b, jp, tp)


def test_lpips_and_inception_refuse_without_a_state_dict(tmp_path, capsys):
    """JAX's scripts download torchvision's weights here; the port refuses
    and names what is missing."""
    lins = lpips_states(np.random.RandomState(5), "alex")[1]
    torch.save(lins, tmp_path / "lins.pth")
    with pytest.raises(SystemExit) as e:
        convert_lpips.main(["alex", str(tmp_path / "out.npz"), "--lins",
                            str(tmp_path / "lins.pth")])
    assert e.value.code == 2 and "--tower" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        convert_lpips.main(["alex", str(tmp_path / "out.npz"), "--tower", "none"])
    assert e.value.code == 2 and "--lins" in capsys.readouterr().err
    assert convert_inception.main([str(tmp_path / "out.npz")]) == 1
    assert "needs the state dict" in capsys.readouterr().err
    assert not (tmp_path / "out.npz").exists()


def test_state_dicts_load_weights_only(tmp_path):
    """A pickle that is not plain tensors is refused by the state-dict
    converters (weights_only=True), as JAX's LPIPS heads loader refuses it."""
    torch.save({"conv1.weight": nn.Conv2d(3, 64, 3)}, tmp_path / "module.pth")
    with pytest.raises(Exception, match="[Ww]eights only"):
        convert_iresnet.main(["iresnet18", str(tmp_path / "module.pth"),
                              str(tmp_path / "out.npz")])
