"""Convert a reference MorphGANformer .pkl checkpoint to the native format
(port of the JAX package's tools/convert_checkpoint.py, without JAX).

Reads the reference's {G, D, Gs} pickles (loader.py:26-47) WITHOUT executing
the source code embedded by torch_utils/persistence (persistence.py:27-80):
a stub unpickler intercepts `_reconstruct_persistent_obj` and captures the
raw module state (parameters, buffers, init kwargs) instead of rebuilding
live nn.Modules; `dnnlib`'s EasyDict reads as a dict and the TF-legacy
`dnnlib.tflib.network.Network` as a data-only stub. Both the zipfile
(`torch.save`) and the plain pickle forms read. The captured tensors are
then remapped onto the flax variable tree that the port's checkpoints hold
(checkpoint/convert.py):

  layout:   FC [out,in] -> [in,out];  conv OIHW -> HWIO;  const [C,4,4] ->
            [4,4,C];  noise_const -> 'buffers' collection;  w_avg ->
            'moving_stats'.
  naming:   the reference's module paths (mapping.global_mlp.l0.fc0.weight,
            synthesis.b64.conv0.transformer.to_queries.weight, ...) map 1:1
            onto the module tree (models/*.py keeps the names).

It writes arch.json and <role>.msgpack for every role in the pickle, the
files the JAX package's converter writes, byte for byte. It builds no net
and draws no weights: a tree that does not fit the net is refused when it
is loaded (checkpoint/convert.py `load_flax`).

Usage: python -m morphganformer_tpu_torch.tools.convert_checkpoint <snapshot.pkl> <out_dir>
"""

import io
import pickle
import sys

import numpy as np
import torch

from morphganformer_tpu_torch.checkpoint.io import save_discriminator, save_generator
from morphganformer_tpu_torch.models.config import (AttentionConfig, DiscriminatorConfig,
                                                    GANformerConfig, MappingConfig)


class _PersistentStub:
    """Captures a persistence-pickled module without executing its source."""

    def __init__(self, meta):
        self.meta = meta

    @property
    def state(self):
        return self.meta["state"]


def _reconstruct_stub(meta):
    return _PersistentStub(meta)


class _TFNetworkStub:
    """Legacy dnnlib.tflib.network.Network capture (reference loader.py:51-58):
    holds version / name / static_kwargs / components / variables without
    importing TensorFlow."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    @property
    def static_kwargs(self):
        return self.__dict__.get("static_kwargs", {}) or {}

    @property
    def components(self):
        return self.__dict__.get("components", {}) or {}

    @property
    def variables(self):
        return self.__dict__.get("variables", []) or []

    @property
    def version(self):
        return self.__dict__.get("version", 0)


class _StubUnpickler(pickle.Unpickler):
    """Map persistence/dnnlib internals to local stubs; everything else
    (torch tensor rebuilds, collections) resolves normally."""

    def find_class(self, module, name):
        if name == "_reconstruct_persistent_obj":
            return _reconstruct_stub
        if module.startswith("dnnlib") and name == "EasyDict":
            return dict
        if module == "dnnlib.tflib.network" and name == "Network":
            return _TFNetworkStub
        return super().find_class(module, name)


def load_reference_pickle(path):
    """Return the raw {G, D, Gs} dict of _PersistentStub objects (or the
    TF-legacy (G, D, Gs) tuple of _TFNetworkStub objects)."""
    with open(path, "rb") as f:
        data = f.read()
    # torch.load reads the zipfile form (torch.save); a plain pickle has no
    # torch magic number, which torch.load refuses, and reads directly.
    try:
        return torch.load(io.BytesIO(data), map_location="cpu",
                          pickle_module=_make_pickle_module(), weights_only=False)
    except (RuntimeError, pickle.UnpicklingError):
        return _StubUnpickler(io.BytesIO(data)).load()


def _make_pickle_module():
    class _Mod:
        Unpickler = _StubUnpickler
        load = staticmethod(lambda f, **kw: _StubUnpickler(f).load())
        # torch.load probes these attributes.
        __name__ = "stub_pickle"
    return _Mod


def flatten_module_state(stub, prefix=""):
    """Walk a captured nn.Module state dict into {dotted_name: np.ndarray}.

    torch nn.Module state layout: _parameters / _buffers / _modules."""
    flat = {}
    state = stub.state if isinstance(stub, _PersistentStub) else stub
    if not isinstance(state, dict):
        return flat
    for coll in ("_parameters", "_buffers"):
        for name, tensor in (state.get(coll) or {}).items():
            if tensor is None:
                continue
            flat[prefix + name] = np.asarray(tensor.detach().cpu().numpy()
                                             if hasattr(tensor, "detach")
                                             else tensor)
    for name, child in (state.get("_modules") or {}).items():
        if child is None:
            continue
        child_state = child.state if isinstance(child, _PersistentStub) else \
            getattr(child, "__dict__", None)
        if child_state is None and isinstance(child, dict):
            child_state = child
        flat.update(flatten_module_state(
            _PersistentStub({"state": child_state}) if not isinstance(
                child, _PersistentStub) else child,
            prefix + name + "."))
    return flat


def get_init_kwargs(stub):
    state = stub.state
    kwargs = state.get("_init_kwargs", {}) or {}
    return dict(kwargs)


# ---------------------------------------------------------------------------
# Name mapping: reference torch module paths -> flax variable tree paths.
# ---------------------------------------------------------------------------

def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def map_generator_params(flat):
    """Map the flat torch name->array dict into flax collections
    {params, buffers, moving_stats}. Returns (variables, unmapped_names)."""
    params, buffers, stats = {}, {}, {}
    unmapped = []
    for name, arr in flat.items():
        parts = name.split(".")
        leaf = parts[-1]
        a = np.asarray(arr, dtype=np.float32)
        try:
            if name == "pos":
                _set(params, ("pos",), a)
            elif leaf == "w_avg":
                _set(stats, tuple(parts[:-1]) + ("w_avg",), a)
            elif leaf == "noise_const":
                _set(buffers, tuple(parts[:-1]) + ("noise_const",), a)
            elif leaf == "const":
                _set(params, tuple(parts), a.transpose(1, 2, 0))     # C44->44C
            elif len(parts) >= 2 and parts[-2] == "conv_stem":
                # latent_stem FC emits the 4x4 grid flattened NCHW in torch
                # (networks.py:1144-1145 reshape to [N,C,4,4]); our model
                # reshapes NHWC — permute the FC's output axis.
                if leaf == "weight":
                    o, i = a.shape
                    a = (a.reshape(o // 16, 4, 4, i).transpose(1, 2, 0, 3)
                         .reshape(o, i))
                    _set(params, tuple(parts), a.T)
                elif leaf == "bias":
                    a = a.reshape(-1, 4, 4).transpose(1, 2, 0).reshape(-1)
                    _set(params, tuple(parts), a)
                else:
                    raise ValueError("unknown conv_stem leaf")
            elif leaf == "weight":
                if a.ndim == 2:                                       # FC
                    _set(params, tuple(parts), a.T)
                elif a.ndim == 4:                                     # conv
                    _set(params, tuple(parts), a.transpose(2, 3, 1, 0))
                else:
                    raise ValueError(f"odd weight rank {a.shape}")
            elif leaf == "bias":
                # biasAct.bias lives under the BiasAct submodule in flax too.
                _set(params, tuple(parts), a)
            elif leaf in ("noise_strength", "att_weight", "centroids"):
                _set(params, tuple(parts), a)
            elif leaf.startswith("pos") and leaf[3:].isdigit():
                _set(params, tuple(parts), a)                         # grid_pos
            elif leaf == "resample_kernel" or leaf == "grid_pos":
                pass                                                   # static
            else:
                raise ValueError("unknown leaf")
        except Exception:
            unmapped.append(name)
    variables = {"params": params}
    if buffers:
        variables["buffers"] = buffers
    if stats:
        variables["moving_stats"] = stats
    return variables, unmapped


def map_discriminator_params(flat):
    """Map the flat torch-layout D dict into a flax {params} collection
    (mirror of map_generator_params; reference layout per networks.py:1339-
    1510: conv OIHW -> HWIO, FC [out,in] -> [in,out])."""
    params, unmapped = {}, []
    for name, arr in flat.items():
        parts = tuple(name.split("."))
        leaf = parts[-1]
        a = np.asarray(arr, dtype=np.float32)
        try:
            if leaf == "weight":
                if a.ndim == 2:
                    if parts[-2] == "fc" and a.shape[1] == a.shape[0] * 16:
                        # Epilogue fc consumes the flattened 4x4 feature map:
                        # torch flattens NCHW (C,H,W order), our NHWC model
                        # flattens (H,W,C) — permute the input axis
                        # (networks.py:1466 `x.flatten(1)`).
                        o, i = a.shape
                        a = (a.reshape(o, o, 4, 4).transpose(2, 3, 1, 0)
                             .reshape(i, o))
                        _set(params, parts, a)
                    else:
                        _set(params, parts, a.T)
                elif a.ndim == 4:
                    _set(params, parts, a.transpose(2, 3, 1, 0))
                else:
                    raise ValueError(f"odd weight rank {a.shape}")
            elif leaf == "bias":
                _set(params, parts, a)
            elif leaf == "resample_kernel":
                pass                                                   # static
            else:
                raise ValueError("unknown leaf")
        except Exception:
            unmapped.append(name)
    return {"params": params}, unmapped


# ---------------------------------------------------------------------------
# TF-legacy pickles (reference loader.py:91-314): translate TF variable
# names/layouts into the SAME flat torch-layout dicts that
# flatten_module_state produces, then reuse the torch->flax mapping above.
# ---------------------------------------------------------------------------

def collect_tf_params(tf_net):
    """Reference _collect_tf_params (loader.py:60-68)."""
    out = {}

    def recurse(prefix, net):
        for name, value in net.variables:
            out[prefix + name] = np.asarray(value)
        for name, comp in net.components.items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


_PLURAL = {"query": "queries", "key": "keys", "value": "values"}


def _tf_attlayer_to_torch(rest, a, dst):
    """AttLayer_* sub-variables -> TransformerLayer param names
    (reference loader.py:197-205,216-227). dst is the torch prefix
    ('mapping.mlp.sa3' or 'synthesis.b64.conv0.transformer')."""
    import re
    m = re.fullmatch(r"(weight|bias)_(query|key|value)", rest)
    if m:
        leaf, s = m.groups()
        a = a.T if leaf == "weight" else a
        return [(f"{dst}.to_{_PLURAL[s]}.{leaf}", a)]
    m = re.fullmatch(r"(weight|bias)_(from|to)_pos", rest)
    if m:
        leaf, s = m.groups()
        a = a.T if leaf == "weight" else a
        return [(f"{dst}.{s}_pos_map.{leaf}", a)]
    m = re.fullmatch(r"(weight|bias)_out", rest)
    if m:
        leaf = m.group(1)
        a = a.T if leaf == "weight" else a
        return [(f"{dst}.modulation.{leaf}", a)]
    m = re.fullmatch(r"(weight|bias)_key2", rest)
    if m:
        leaf = m.group(1)
        a = a.T if leaf == "weight" else a
        return [(f"{dst}.queries2centroids.{leaf}", a)]
    if rest == "toasgn_init":
        return [(f"{dst}.centroids", a)]
    if rest == "iter_0/st_weights":
        return [(f"{dst}.att_weight", a)]
    return None


def tf_generator_to_torch(tf_params, img_resolution, z_dim=512):
    """TF generator variable names -> flat torch-layout dict (the inverse
    direction of reference loader.py:182-246, including the conv-weight
    [::-1,::-1] flips, OIHW transposes, mod_bias+1 and noise index math).
    Returns (flat, unmapped_names, architecture_override)."""
    import re

    tf_params = dict(tf_params)
    arch = None
    # ToRGB_lod remap (loader.py:167-172) marks pre-skip "orig" snapshots.
    for name in list(tf_params):
        m = re.fullmatch(r"ToRGB_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf_params[f"synthesis/{r}x{r}/ToRGB/{m.group(2)}"] = \
                tf_params.pop(name)
            arch = "orig"

    out, unmapped = {}, []

    def conv_idx(tag):
        # TF layer tags: Conv0_up -> conv0; Conv1 / Conv (res 4) -> conv1.
        return 0 if tag == "Conv0_up" else 1

    for name, a in tf_params.items():
        a = np.asarray(a)
        if name == "ltnt_emb/emb":
            out["pos"] = a
            continue
        if name == "dlatent_avg":
            out["mapping.w_avg"] = a
            continue
        if name == "mapping/LabelConcat/weight":
            out["mapping.embed.weight"] = a.T
            # TF has no embed bias; the torch module does (loader.py:187).
            out["mapping.embed.bias"] = np.zeros([z_dim], np.float32)
            continue
        m = re.fullmatch(r"mapping/(global/)?Dense(\d+)_(\d+)/(weight|bias)",
                         name)
        if m:
            g, i, j, leaf = m.groups()
            net = "global_mlp" if g else "mlp"
            out[f"mapping.{net}.l{i}.fc{j}.{leaf}"] = \
                a.T if leaf == "weight" else a
            continue
        m = re.fullmatch(r"mapping/(global/)?Dense(\d+)/(weight|bias)", name)
        if m:
            g, _, leaf = m.groups()
            net = "global_mlp" if g else "mlp"
            out[f"mapping.{net}.out_layer.{leaf}"] = \
                a.T if leaf == "weight" else a
            continue
        m = re.fullmatch(r"mapping/AttLayer_(\d+)/(.*)", name)
        if m:
            i, rest = m.groups()
            mapped = _tf_attlayer_to_torch(rest, a, f"mapping.mlp.sa{i}")
            if mapped:
                out.update(dict(mapped))
                continue
            unmapped.append(name)
            continue
        if name == "synthesis/4x4/Const/const":
            out["synthesis.b4.const"] = a[0]
            continue
        m = re.fullmatch(r"synthesis/noise(\d+)", name)
        if m:
            # noise{n}: n = 2*log2(r) - 5 + i  (loader.py:213)
            n = int(m.group(1))
            i = (n + 5) % 2
            r = 2 ** ((n + 5 - i) // 2)
            out[f"synthesis.b{r}.conv{i}.noise_const"] = a[0, 0]
            continue
        m = re.fullmatch(
            r"synthesis/(\d+)x\1/(Conv0_up|Conv1|Conv)/(.*)", name)
        if m:
            r, tag, rest = m.groups()
            i = conv_idx(tag)
            dst = f"synthesis.b{r}.conv{i}"
            if rest == "weight":
                w = a[::-1, ::-1] if tag == "Conv0_up" else a
                out[f"{dst}.weight"] = w.transpose(3, 2, 0, 1)
            elif rest == "bias":
                out[f"{dst}.biasAct.bias"] = a
            elif rest == "noise_strength":
                out[f"{dst}.noise_strength"] = a
            elif rest == "mod_weight":
                out[f"{dst}.affine.weight"] = a.T
            elif rest == "mod_bias":
                out[f"{dst}.affine.bias"] = a + 1            # loader.py:215
            elif rest.startswith("AttLayer_l2n/"):
                mapped = _tf_attlayer_to_torch(
                    rest[len("AttLayer_l2n/"):], a, f"{dst}.transformer")
                if mapped:
                    out.update(dict(mapped))
                else:
                    unmapped.append(name)
            else:
                unmapped.append(name)
            continue
        m = re.fullmatch(
            r"synthesis/(\d+)x\1/ToRGB/extraLayer/(weight|mod_weight|mod_bias|bias)",
            name)
        if m:
            r, rest = m.groups()
            dst = f"synthesis.b{r}.conv_last"
            if rest == "weight":
                out[f"{dst}.weight"] = a.transpose(3, 2, 0, 1)
            elif rest == "bias":
                out[f"{dst}.biasAct.bias"] = a
            elif rest == "mod_weight":
                out[f"{dst}.affine.weight"] = a.T
            else:
                out[f"{dst}.affine.bias"] = a + 1
            continue
        m = re.fullmatch(r"synthesis/(\d+)x\1/ToRGB/(weight|bias|mod_weight|mod_bias)",
                         name)
        if m:
            r, rest = m.groups()
            dst = f"synthesis.b{r}.torgb"
            if rest == "weight":
                out[f"{dst}.weight"] = a.transpose(3, 2, 0, 1)
            elif rest == "bias":
                out[f"{dst}.biasAct.bias"] = a
            elif rest == "mod_weight":
                out[f"{dst}.affine.weight"] = a.T
            else:
                out[f"{dst}.affine.bias"] = a + 1            # loader.py:231
            continue
        m = re.fullmatch(r"synthesis/(\d+)x\1/Skip/weight", name)
        if m:
            out[f"synthesis.b{m.group(1)}.skip.weight"] = \
                a[::-1, ::-1].transpose(3, 2, 0, 1)
            continue
        if name.endswith("resample_kernel") or name.endswith("grid_pos") or \
                name.startswith("Labels") or name == "lod":
            continue                                          # static / unused
        unmapped.append(name)
    return out, unmapped, arch


def tf_discriminator_to_torch(tf_params, img_resolution):
    """TF discriminator variable names -> flat torch-layout dict
    (inverse of reference loader.py:292-306)."""
    import re

    tf_params = dict(tf_params)
    arch = None
    for name in list(tf_params):
        m = re.fullmatch(r"FromRGB_lod(\d+)/(.*)", name)
        if m:
            r = img_resolution // (2 ** int(m.group(1)))
            tf_params[f"{r}x{r}/FromRGB/{m.group(2)}"] = tf_params.pop(name)
            arch = "orig"

    out, unmapped = {}, []
    for name, a in tf_params.items():
        a = np.asarray(a)
        m = re.fullmatch(r"(\d+)x\1/FromRGB/(weight|bias)", name)
        if m:
            r, leaf = m.groups()
            if leaf == "weight":
                out[f"b{r}.fromrgb.weight"] = a.transpose(3, 2, 0, 1)
            else:
                out[f"b{r}.fromrgb.biasAct.bias"] = a
            continue
        m = re.fullmatch(r"(\d+)x\1/Conv(\d)(?:_down)?/(weight|bias)", name)
        if m:
            r, i, leaf = m.groups()
            if leaf == "weight":
                out[f"b{r}.conv{i}.weight"] = a.transpose(3, 2, 0, 1)
            else:
                out[f"b{r}.conv{i}.biasAct.bias"] = a
            continue
        m = re.fullmatch(r"4x4/Conv/(weight|bias)", name)
        if m:
            leaf = m.group(1)
            if leaf == "weight":
                out["b4.conv.weight"] = a.transpose(3, 2, 0, 1)
            else:
                out["b4.conv.biasAct.bias"] = a
            continue
        m = re.fullmatch(r"(\d+)x\1/Skip/weight", name)
        if m:
            out[f"b{m.group(1)}.skip.weight"] = a.transpose(3, 2, 0, 1)
            continue
        m = re.fullmatch(r"4x4/Dense0/(weight|bias)", name)
        if m:
            leaf = m.group(1)
            out[f"b4.fc.{leaf}"] = a.T if leaf == "weight" else a
            continue
        m = re.fullmatch(r"Output/(weight|bias)", name)
        if m:
            leaf = m.group(1)
            out[f"b4.out.{leaf}"] = a.T if leaf == "weight" else a
            continue
        if name.endswith("resample_kernel") or name == "lod":
            continue
        unmapped.append(name)
    return out, unmapped, arch


def _tf_kwarg(static_kwargs, tf_name, default=None, none=None):
    val = static_kwargs.get(tf_name, default)
    return val if val is not None else none


def tf_generator_kwargs(tf_net):
    """TF static_kwargs -> torch-style init kwargs (loader.py:104-154)."""
    kw = tf_net.static_kwargs
    g = lambda n, d=None, none=None: _tf_kwarg(kw, n, d, none)
    return dict(
        z_dim=g("latent_size", 512), c_dim=g("label_size", 0),
        w_dim=g("dlatent_size", 512),
        k=g("components_num", 1) + int(kw.get("transformer", False)),
        img_resolution=g("resolution", 1024),
        img_channels=g("num_channels", 3),
        mapping_kwargs=dict(
            num_layers=g("mapping_layersnum", 8),
            layer_dim=g("mapping_dim"),
            act=g("mapping_nonlinearity", "lrelu"),
            lrmul=g("mapping_lrmul", 0.01),
            w_avg_beta=g("dlatent_avg_beta", 0.995, none=1),
            resnet=g("mapping_resnet", False),
            ltnt2ltnt=g("mapping_ltnt2ltnt", False),
            use_pos=g("use_pos", False),
            normalize_global=False),
        synthesis_kwargs=dict(
            channel_base=g("fmap_base", 16 << 10) * 2,
            channel_max=g("fmap_max", 512),
            architecture=g("architecture", "skip"),
            resample_kernel=g("resample_kernel", [1, 3, 3, 1]),
            local_noise=g("local_noise", True),
            act=g("nonlinearity", "lrelu"),
            latent_stem=g("latent_stem", False),
            style=g("style", True),
            transformer=g("transformer", False),
            start_res=g("start_res", 0), end_res=g("end_res", 8),
            num_heads=g("num_heads", 1),
            attention_dropout=g("attention_dropout", 0.12),
            integration=g("integration", "add"),
            norm=g("norm"), kmeans=g("kmeans", False),
            kmeans_iters=g("kmeans_iters", 1),
            iterative=g("iterative", False),
            use_pos=g("use_pos", False), pos_dim=g("pos_dim"),
            pos_type=g("pos_type", "sinus"), pos_init=g("pos_init", "uniform"),
            pos_directions_num=g("pos_directions_num", 2)),
    )


def tf_discriminator_kwargs(tf_net):
    """TF static_kwargs -> torch-style D kwargs (loader.py:258-280)."""
    kw = tf_net.static_kwargs
    g = lambda n, d=None: _tf_kwarg(kw, n, d)
    return dict(
        c_dim=g("label_size", 0), img_resolution=g("resolution", 1024),
        img_channels=g("num_channels", 3),
        architecture=g("architecture", "resnet"),
        channel_base=g("fmap_base", 16 << 10) * 2,
        channel_max=g("fmap_max", 512),
        block_kwargs=dict(act=g("nonlinearity", "lrelu"),
                          resample_kernel=g("resample_kernel", [1, 3, 3, 1])),
        epilogue_kwargs=dict(act=g("nonlinearity", "lrelu"),
                             mbstd_group_size=g("mbstd_group_size", 4),
                             mbstd_num_channels=g("mbstd_num_features", 1)),
    )


def build_generator_config(kwargs):
    """Torch-style G init kwargs -> GANformerConfig."""
    mk = dict(kwargs.get("mapping_kwargs", {}))
    sk = dict(kwargs.get("synthesis_kwargs", {}))
    return GANformerConfig(
        z_dim=kwargs.get("z_dim", 32), c_dim=kwargs.get("c_dim", 0),
        w_dim=kwargs.get("w_dim", 32), k=kwargs.get("k", 17),
        img_resolution=kwargs.get("img_resolution", 1024),
        img_channels=kwargs.get("img_channels", 3),
        channel_base=sk.get("channel_base", 32 << 10),
        channel_max=sk.get("channel_max", 512),
        architecture=sk.get("architecture", "skip"),
        latent_stem=sk.get("latent_stem", False),
        style=sk.get("style", True),
        local_noise=sk.get("local_noise", True),
        act=sk.get("act", "lrelu"),
        transformer=sk.get("transformer", True),
        start_res=sk.get("start_res", 0), end_res=sk.get("end_res", 8),
        mapping=MappingConfig(
            num_layers=mk.get("num_layers", 8),
            layer_dim=mk.get("layer_dim"),
            act=mk.get("act", "lrelu"), lrmul=mk.get("lrmul", 0.01),
            w_avg_beta=mk.get("w_avg_beta", 0.995),
            resnet=mk.get("resnet", False),
            ltnt2ltnt=mk.get("ltnt2ltnt", False),
            normalize_global=mk.get("normalize_global", True),
            use_pos=mk.get("use_pos", False)),
        attention=AttentionConfig(
            num_heads=sk.get("num_heads", 1),
            dropout=sk.get("attention_dropout", 0.12),
            integration=sk.get("integration", "add"),
            norm=sk.get("norm"), kmeans=sk.get("kmeans", False),
            kmeans_iters=sk.get("kmeans_iters", 1),
            iterative=sk.get("iterative", False),
            pos_dim=sk.get("pos_dim"),
            pos_type=sk.get("pos_type", "sinus"),
            pos_init=sk.get("pos_init", "uniform"),
            pos_directions_num=sk.get("pos_directions_num", 2)),
    )


def build_discriminator_config(kwargs):
    """Torch-style D init kwargs -> DiscriminatorConfig
    (reference Discriminator signature, networks.py:1475-1490)."""
    bk = dict(kwargs.get("block_kwargs", {}))
    ek = dict(kwargs.get("epilogue_kwargs", {}))
    return DiscriminatorConfig(
        c_dim=kwargs.get("c_dim", 0),
        img_resolution=kwargs.get("img_resolution", 1024),
        img_channels=kwargs.get("img_channels", 3),
        architecture=kwargs.get("architecture", "resnet"),
        channel_base=kwargs.get("channel_base", 32 << 10),
        channel_max=kwargs.get("channel_max", 512),
        act=bk.get("act", ek.get("act", "lrelu")),
        resample_kernel=tuple(bk.get("resample_kernel", (1, 3, 3, 1))),
        mbstd_group_size=ek.get("mbstd_group_size", 4),
        mbstd_num_channels=ek.get("mbstd_num_channels", 1),
    )


def _role_states(nets):
    """Normalize either pickle form into {role: (kwargs, flat_torch)}.

    Torch pickles: {G, D, Gs} of persistence stubs. TF-legacy pickles: a
    (G, D, Gs) tuple of tflib Network stubs (reference load_network_pkl,
    loader.py:32-47) whose names/layouts get translated to torch form."""
    out = {}
    if isinstance(nets, tuple) and len(nets) == 3 and \
            all(isinstance(n, _TFNetworkStub) for n in nets):
        tf_G, tf_D, tf_Gs = nets
        for role, tf_net in (("G", tf_G), ("Gs", tf_Gs)):
            if tf_net.version < 4:
                raise ValueError("TensorFlow pickle version too low "
                                 "(reference loader.py:92-93)")
            kwargs = tf_generator_kwargs(tf_net)
            flat, unmapped, arch = tf_generator_to_torch(
                collect_tf_params(tf_net), kwargs["img_resolution"],
                z_dim=kwargs["z_dim"])
            if arch:
                kwargs["synthesis_kwargs"]["architecture"] = arch
            out[role] = (kwargs, flat, unmapped)
        kwargs = tf_discriminator_kwargs(tf_D)
        flat, unmapped, arch = tf_discriminator_to_torch(
            collect_tf_params(tf_D), kwargs["img_resolution"])
        if arch:
            kwargs["architecture"] = arch
        out["D"] = (kwargs, flat, unmapped)
        return out
    for role in ("Gs", "G", "D"):
        if role in nets:
            stub = nets[role]
            out[role] = (get_init_kwargs(stub), flatten_module_state(stub), [])
    return out


def convert(pkl_path, out_dir):
    nets = load_reference_pickle(pkl_path)
    for role, (kwargs, flat, tf_unmapped) in _role_states(nets).items():
        if tf_unmapped:
            print(f"[{role}] WARNING unmapped TF variables: "
                  f"{tf_unmapped[:20]}{'...' if len(tf_unmapped) > 20 else ''}")
        if role == "D":
            cfg = build_discriminator_config(kwargs)
            variables, unmapped = map_discriminator_params(flat)
            save_discriminator(out_dir, cfg, variables)
        else:
            cfg = build_generator_config(kwargs)
            variables, unmapped = map_generator_params(flat)
            save_generator(out_dir, cfg, variables, role=role)
        if unmapped:
            print(f"[{role}] WARNING unmapped params: {unmapped[:20]}"
                  f"{'...' if len(unmapped) > 20 else ''}")
        print(f"[{role}] converted {len(flat) - len(unmapped)} tensors "
              f"-> {out_dir}")
    print("done")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 1
    convert(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
