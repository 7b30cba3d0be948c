"""Reference-format pickles of a generator and a discriminator, for the
converter's tests and chip_smoke.py's phase convert.

The nets come as flax-form variable trees ({params, buffers, moving_stats},
numpy leaves: `checkpoint.to_flax(net)` of the port, or a JAX tree) with
their configs. They are written back into the reference's names and layouts,
the inverse of the maps of morphganformer_tpu_torch/tools/convert_checkpoint.py:

  persistence_pickle  {G, D, Gs} of torch_utils.persistence objects (each
                      module a `_reconstruct_persistent_obj(meta)` call whose
                      meta.state holds _parameters / _buffers / _modules and
                      _init_kwargs), written with `pickle` or `torch.save`
                      (zipfile);
  tf_pickle           the TF-legacy (G, D, Gs) tuple of
                      dnnlib.tflib.network.Network objects (static_kwargs,
                      components, variables in TF names and layouts).

Stand-in modules under the reference's names (`register_reference_modules`)
make the pickles carry the reference's GLOBALs; the stand-in reconstruct
raises, so a reader that ran the reference's code would fail. Imports torch
and numpy only, so that it runs on a machine without JAX.
"""

import math
import pickle
import re
import sys
import types

import numpy as np
import torch

PERSISTENCE = "torch_utils.persistence"
EASYDICT = "dnnlib.util"
TF_NETWORK = "dnnlib.tflib.network"


def _reconstruct_persistent_obj(meta):  # pragma: no cover - a reader must not call it
    raise RuntimeError("the reference's persistence reconstruct was executed")


class EasyDict(dict):
    """dnnlib.util.EasyDict: a dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


class Network:
    """dnnlib.tflib.network.Network: data only (its __dict__ is pickled)."""


def _module(name):
    """sys.modules[name], made (with its parents) when absent."""
    parts = name.split(".")
    for i in range(1, len(parts) + 1):
        sub = ".".join(parts[:i])
        if sub not in sys.modules:
            sys.modules[sub] = types.ModuleType(sub)
            if i > 1:
                setattr(sys.modules[".".join(parts[:i - 1])], parts[i - 1], sys.modules[sub])
    return sys.modules[name]


def register_reference_modules():
    """Register the stand-ins under the reference's module names, keeping any
    already registered. Returns (reconstruct function, EasyDict class,
    Network class) as registered: pickle writes an object by the name under
    which it finds that very object."""
    for mod, obj in ((PERSISTENCE, _reconstruct_persistent_obj), (EASYDICT, EasyDict),
                     (TF_NETWORK, Network)):
        name = obj.__name__
        m = _module(mod)
        if not hasattr(m, name):
            obj.__module__, obj.__qualname__ = mod, name
            setattr(m, name, obj)
    return (sys.modules[PERSISTENCE]._reconstruct_persistent_obj,
            sys.modules[EASYDICT].EasyDict, sys.modules[TF_NETWORK].Network)


class Persistent:
    """A module as torch_utils.persistence pickles it."""

    def __init__(self, class_name, state):
        self.class_name, self.state = class_name, state

    def __reduce__(self):
        meta = dict(type="class", version=6, module_src="# source of the reference module",
                    class_name=self.class_name, state=self.state)
        return (register_reference_modules()[0], (meta,))


# ---------------------------------------------------------------- torch layout

def _walk(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


def generator_flat(variables):
    """A G's flax tree -> {reference name: torch-layout array} (the inverse of
    map_generator_params): FC [in,out] -> [out,in], conv HWIO -> OIHW, const
    [4,4,C] -> [C,4,4]; noise_const and w_avg keep their names."""
    flat = {}
    for coll in ("params", "buffers", "moving_stats"):
        for path, a in _walk(variables.get(coll, {})):
            leaf = path[-1]
            if leaf == "weight":
                if len(path) >= 2 and path[-2] == "conv_stem":
                    raise ValueError("a latent_stem generator is not exported")
                a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            elif leaf == "const":
                a = a.transpose(2, 0, 1)
            flat[".".join(path)] = np.array(a, order="C")
    return flat


def discriminator_flat(variables):
    """A D's flax tree -> {reference name: torch-layout array} (the inverse of
    map_discriminator_params, the epilogue FC's input axis back to NCHW)."""
    flat = {}
    for path, a in _walk(variables["params"]):
        if path[-1] == "weight":
            if a.ndim == 2 and path[-2] == "fc" and a.shape[0] == 16 * a.shape[1]:
                i, o = a.shape
                a = a.reshape(4, 4, o, o).transpose(3, 2, 0, 1).reshape(o, i)
            elif a.ndim == 2:
                a = a.T
            else:
                a = a.transpose(3, 2, 0, 1)
        flat[".".join(path)] = np.array(a, order="C")
    return flat


# ---------------------------------------------------------------- init kwargs

def _same_as_default(cfg, fields, what):
    default = type(cfg)()
    bad = [f for f in fields if getattr(cfg, f) != getattr(default, f)]
    if bad:
        raise ValueError(f"the reference's {what} cannot carry {bad}")


def generator_init_kwargs(cfg):
    """A GANformerConfig as the reference Generator's init kwargs (the
    inverse of build_generator_config)."""
    m, a = cfg.mapping, cfg.attention
    _same_as_default(cfg, ("resample_kernel", "crop_ratio", "component_dropout", "dtype"),
                     "G kwargs")
    _same_as_default(m, ("embed_dim", "shared", "ltnt_gate", "fused"), "mapping kwargs")
    _same_as_default(a, ("ltnt_gate", "img_gate"), "attention kwargs")
    return EasyDict(
        z_dim=cfg.z_dim, c_dim=cfg.c_dim, w_dim=cfg.w_dim, k=cfg.k,
        img_resolution=cfg.img_resolution, img_channels=cfg.img_channels,
        mapping_kwargs=EasyDict(
            num_layers=m.num_layers, layer_dim=m.layer_dim, act=m.act, lrmul=m.lrmul,
            w_avg_beta=m.w_avg_beta, resnet=m.resnet, ltnt2ltnt=m.ltnt2ltnt,
            normalize_global=m.normalize_global, use_pos=m.use_pos),
        synthesis_kwargs=EasyDict(
            channel_base=cfg.channel_base, channel_max=cfg.channel_max,
            architecture=cfg.architecture, latent_stem=cfg.latent_stem, style=cfg.style,
            local_noise=cfg.local_noise, act=cfg.act, transformer=cfg.transformer,
            start_res=cfg.start_res, end_res=cfg.end_res, num_heads=a.num_heads,
            attention_dropout=a.dropout, integration=a.integration, norm=a.norm,
            kmeans=a.kmeans, kmeans_iters=a.kmeans_iters, iterative=a.iterative,
            pos_dim=a.pos_dim, pos_type=a.pos_type, pos_init=a.pos_init,
            pos_directions_num=a.pos_directions_num))


def discriminator_init_kwargs(cfg):
    """A DiscriminatorConfig as the reference Discriminator's init kwargs
    (the inverse of build_discriminator_config)."""
    _same_as_default(cfg, ("dtype",), "D kwargs")
    return EasyDict(
        c_dim=cfg.c_dim, img_resolution=cfg.img_resolution, img_channels=cfg.img_channels,
        architecture=cfg.architecture, channel_base=cfg.channel_base,
        channel_max=cfg.channel_max,
        block_kwargs=EasyDict(act=cfg.act, resample_kernel=list(cfg.resample_kernel)),
        epilogue_kwargs=EasyDict(act=cfg.act, mbstd_group_size=cfg.mbstd_group_size,
                                 mbstd_num_channels=cfg.mbstd_num_channels))


# ---------------------------------------------------------------- persistence

BUFFERS = ("noise_const", "w_avg", "resample_kernel")


def module_tree(class_name, flat, init_kwargs):
    """{dotted name: array} -> nested Persistent modules, each leaf a tensor
    of its module's _parameters (or _buffers: noise_const, w_avg,
    resample_kernel); the root holds the init kwargs."""
    def node(name, extra=None):
        state = {"training": False, "_parameters": {}, "_buffers": {}, "_modules": {}}
        state.update(extra or {})
        return Persistent(name, state)

    root = node(class_name, {"_init_kwargs": init_kwargs})
    for name, a in flat.items():
        *mods, leaf = name.split(".")
        mod = root
        for part in mods:
            mod = mod.state["_modules"].setdefault(part, node(part))
        coll = "_buffers" if leaf in BUFFERS else "_parameters"
        mod.state[coll][leaf] = torch.from_numpy(np.array(a, np.float32))
    return root


def persistence_nets(g_cfg, g_vars, d_cfg=None, d_vars=None, roles=("G", "D", "Gs"),
                     extra=None):
    """{role: Persistent} for `roles`: G and Gs from one tree (each its own
    copy of the arrays, as a snapshot holds two nets), D from the other.
    `extra` {role: {name: array}} adds leaves to a role's export."""
    extra = extra or {}
    nets = {}
    for role in roles:
        if role == "D":
            flat = discriminator_flat(d_vars)
            kwargs = discriminator_init_kwargs(d_cfg)
        else:
            flat = generator_flat(g_vars)
            kwargs = generator_init_kwargs(g_cfg)
        flat.update(extra.get(role, {}))
        nets[role] = module_tree("Discriminator" if role == "D" else "Generator", flat, kwargs)
    return nets


def write_persistence_pickle(path, nets, zipfile=False):
    """Write {role: Persistent} with `pickle` (the reference's snapshots) or,
    with `zipfile`, through `torch.save`."""
    register_reference_modules()
    with open(path, "wb") as f:
        if zipfile:
            torch.save(nets, f)
        else:
            pickle.dump(nets, f, protocol=pickle.HIGHEST_PROTOCOL)


# ---------------------------------------------------------------- TF legacy

_ATT_TF = {"to_queries": "query", "to_keys": "key", "to_values": "value"}


def _att_to_tf(sub, leaf, a):
    """A TransformerLayer leaf -> (TF AttLayer suffix, array)."""
    kind = "weight" if leaf == "weight" else "bias"
    arr = a.T if leaf == "weight" else a
    if sub in _ATT_TF:
        return f"{kind}_{_ATT_TF[sub]}", arr
    if sub in ("from_pos_map", "to_pos_map"):
        return f"{kind}_{sub.split('_')[0]}_pos", arr
    if sub == "modulation":
        return f"{kind}_out", arr
    if sub == "queries2centroids":
        return f"{kind}_key2", arr
    if sub == "centroids":
        return "toasgn_init", a
    if sub == "att_weight":
        return "iter_0/st_weights", a
    raise ValueError(f"no TF name for attention leaf {sub}")


def tf_generator_params(flat):
    """A G's torch-layout dict -> TF variable names and layouts (the inverse
    of tf_generator_to_torch: the conv0 and skip flips, HWIO, mod_bias - 1,
    the noise index)."""
    tf = {}
    for name, a in flat.items():
        if name == "pos":
            tf["ltnt_emb/emb"] = a
        elif name == "mapping.w_avg":
            tf["dlatent_avg"] = a
        elif (m := re.fullmatch(r"mapping\.(mlp|global_mlp)\.l(\d+)\.fc(\d+)\.(weight|bias)",
                                name)):
            net, i, j, leaf = m.groups()
            g = "global/" if net == "global_mlp" else ""
            tf[f"mapping/{g}Dense{i}_{j}/{leaf}"] = a.T if leaf == "weight" else a
        elif (m := re.fullmatch(r"mapping\.(mlp|global_mlp)\.out_layer\.(weight|bias)", name)):
            net, leaf = m.groups()
            g = "global/" if net == "global_mlp" else ""
            tf[f"mapping/{g}Dense7/{leaf}"] = a.T if leaf == "weight" else a
        elif (m := re.fullmatch(r"mapping\.mlp\.sa(\d+)\.([a-z_2]+)\.?(weight|bias)?", name)):
            i, sub, leaf = m.groups()
            suffix, arr = _att_to_tf(sub, leaf, a)
            tf[f"mapping/AttLayer_{i}/{suffix}"] = arr
        elif name == "synthesis.b4.const":
            tf["synthesis/4x4/Const/const"] = a[None]
        elif (m := re.fullmatch(r"synthesis\.b(\d+)\.conv(\d)\.(.+)", name)):
            r, i, rest = m.groups()
            tag = "Conv0_up" if i == "0" else ("Conv" if r == "4" else "Conv1")
            base = f"synthesis/{r}x{r}/{tag}"
            if rest == "weight":
                w = a.transpose(2, 3, 1, 0)
                tf[f"{base}/weight"] = w[::-1, ::-1] if i == "0" else w
            elif rest == "biasAct.bias":
                tf[f"{base}/bias"] = a
            elif rest == "noise_strength":
                tf[f"{base}/noise_strength"] = a
            elif rest == "affine.weight":
                tf[f"{base}/mod_weight"] = a.T
            elif rest == "affine.bias":
                tf[f"{base}/mod_bias"] = a - 1
            elif rest == "noise_const":
                n = 2 * int(math.log2(int(r))) - 5 + int(i)
                tf[f"synthesis/noise{n}"] = a[None, None]
            elif rest.startswith("transformer."):
                parts = rest.split(".")
                suffix, arr = _att_to_tf(parts[1], parts[2] if len(parts) > 2 else None, a)
                tf[f"{base}/AttLayer_l2n/{suffix}"] = arr
            else:
                raise ValueError(f"no TF name for {name}")
        elif (m := re.fullmatch(
                r"synthesis\.b(\d+)\.(torgb|conv_last)\.(weight|biasAct\.bias|affine\.weight|"
                r"affine\.bias)", name)):
            r, layer, rest = m.groups()
            base = f"synthesis/{r}x{r}/ToRGB" + ("/extraLayer" if layer == "conv_last" else "")
            tf[f"{base}/" + {"weight": "weight", "biasAct.bias": "bias",
                             "affine.weight": "mod_weight", "affine.bias": "mod_bias"}[rest]] = (
                a.transpose(2, 3, 1, 0) if rest == "weight" else
                a.T if rest == "affine.weight" else a - 1 if rest == "affine.bias" else a)
        elif (m := re.fullmatch(r"synthesis\.b(\d+)\.skip\.weight", name)):
            r = m.group(1)
            tf[f"synthesis/{r}x{r}/Skip/weight"] = a.transpose(2, 3, 1, 0)[::-1, ::-1]
        else:
            raise ValueError(f"no TF name for {name}")
    return {k: np.array(v, order="C") for k, v in tf.items()}


def tf_discriminator_params(flat):
    """A D's torch-layout dict -> TF variable names and layouts (the inverse
    of tf_discriminator_to_torch)."""
    tf = {}
    for name, a in flat.items():
        w = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
        if (m := re.fullmatch(r"b(\d+)\.fromrgb\.(weight|biasAct\.bias)", name)):
            r, leaf = m.groups()
            tf[f"{r}x{r}/FromRGB/{'weight' if leaf == 'weight' else 'bias'}"] = w
        elif (m := re.fullmatch(r"b4\.conv\.(weight|biasAct\.bias)", name)):
            tf[f"4x4/Conv/{'weight' if m.group(1) == 'weight' else 'bias'}"] = w
        elif (m := re.fullmatch(r"b(\d+)\.conv(\d)\.(weight|biasAct\.bias)", name)):
            r, i, leaf = m.groups()
            tag = f"Conv{i}" if i == "0" else f"Conv{i}_down"
            tf[f"{r}x{r}/{tag}/{'weight' if leaf == 'weight' else 'bias'}"] = w
        elif (m := re.fullmatch(r"b(\d+)\.skip\.weight", name)):
            tf[f"{m.group(1)}x{m.group(1)}/Skip/weight"] = w
        elif (m := re.fullmatch(r"b4\.(fc|out)\.(weight|bias)", name)):
            layer, leaf = m.groups()
            tf[f"{'4x4/Dense0' if layer == 'fc' else 'Output'}/{leaf}"] = (
                a.T if leaf == "weight" else a)
        else:
            raise ValueError(f"no TF name for {name}")
    return {k: np.array(v, order="C") for k, v in tf.items()}


def tf_config(cfg):
    """The GANformerConfig that the TF form of `cfg` converts to: its
    static_kwargs carry no normalize_global, which the converter sets False
    (the reference's TF mapping leaves the global latent as it is)."""
    import dataclasses

    return dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                                normalize_global=False))


def tf_generator_static_kwargs(cfg):
    """A GANformerConfig as TF static_kwargs (the inverse of
    tf_generator_kwargs, up to `tf_config`)."""
    m, a = cfg.mapping, cfg.attention
    if m.w_avg_beta is None:
        raise ValueError("the TF form cannot carry w_avg_beta None")
    if cfg.channel_base % 2:
        raise ValueError("the TF form's fmap_base is channel_base / 2")
    _same_as_default(cfg, ("resample_kernel", "crop_ratio", "component_dropout", "dtype"),
                     "TF G kwargs")
    _same_as_default(m, ("embed_dim", "shared", "ltnt_gate", "fused"), "TF mapping kwargs")
    _same_as_default(a, ("ltnt_gate", "img_gate"), "TF attention kwargs")
    return dict(
        latent_size=cfg.z_dim, label_size=cfg.c_dim, dlatent_size=cfg.w_dim,
        components_num=cfg.k - int(cfg.transformer), transformer=cfg.transformer,
        resolution=cfg.img_resolution, num_channels=cfg.img_channels,
        mapping_layersnum=m.num_layers, mapping_dim=m.layer_dim, mapping_nonlinearity=m.act,
        mapping_lrmul=m.lrmul, dlatent_avg_beta=m.w_avg_beta, mapping_resnet=m.resnet,
        mapping_ltnt2ltnt=m.ltnt2ltnt, use_pos=m.use_pos,
        fmap_base=cfg.channel_base // 2, fmap_max=cfg.channel_max,
        architecture=cfg.architecture, resample_kernel=list(cfg.resample_kernel),
        local_noise=cfg.local_noise, nonlinearity=cfg.act, latent_stem=cfg.latent_stem,
        style=cfg.style, start_res=cfg.start_res, end_res=cfg.end_res,
        num_heads=a.num_heads, attention_dropout=a.dropout, integration=a.integration,
        norm=a.norm, kmeans=a.kmeans, kmeans_iters=a.kmeans_iters, iterative=a.iterative,
        pos_dim=a.pos_dim, pos_type=a.pos_type, pos_init=a.pos_init,
        pos_directions_num=a.pos_directions_num)


def tf_discriminator_static_kwargs(cfg):
    """A DiscriminatorConfig as TF static_kwargs (the inverse of
    tf_discriminator_kwargs)."""
    _same_as_default(cfg, ("dtype",), "TF D kwargs")
    if cfg.channel_base % 2:
        raise ValueError("the TF form's fmap_base is channel_base / 2")
    return dict(label_size=cfg.c_dim, resolution=cfg.img_resolution,
                num_channels=cfg.img_channels, architecture=cfg.architecture,
                fmap_base=cfg.channel_base // 2, fmap_max=cfg.channel_max,
                nonlinearity=cfg.act, resample_kernel=list(cfg.resample_kernel),
                mbstd_group_size=cfg.mbstd_group_size,
                mbstd_num_features=cfg.mbstd_num_channels)


def _network(name, static_kwargs, variables, components=None):
    n = register_reference_modules()[2]()
    n.__dict__.update(version=4, name=name, static_kwargs=static_kwargs,
                      components=components or {}, variables=list(variables.items()))
    return n


def tf_nets(g_cfg, g_vars, d_cfg, d_vars, extra=None):
    """The TF-legacy (G, D, Gs) tuple: G and Gs each a Network with mapping
    and synthesis components from one tree (their own copies), D from the
    other. `extra` {role: {TF name: array}} adds variables to a role."""
    extra = extra or {}

    def generator(role):
        tf = tf_generator_params(generator_flat(g_vars))
        tf.update(extra.get(role, {}))
        comps = {c: {k[len(c) + 1:]: np.array(v) for k, v in tf.items()
                     if k.startswith(c + "/")} for c in ("mapping", "synthesis")}
        top = {k: np.array(v) for k, v in tf.items()
               if not k.startswith(("mapping/", "synthesis/"))}
        return _network(role, tf_generator_static_kwargs(g_cfg), top, components={
            c: _network(c, {}, v) for c, v in comps.items()})

    tf_d = tf_discriminator_params(discriminator_flat(d_vars))
    tf_d.update(extra.get("D", {}))
    return (generator("G"), _network("D", tf_discriminator_static_kwargs(d_cfg), tf_d),
            generator("Gs"))


def write_tf_pickle(path, nets):
    register_reference_modules()
    with open(path, "wb") as f:
        pickle.dump(nets, f, protocol=pickle.HIGHEST_PROTOCOL)
