"""Checkpoints between the JAX package and the port: the port's msgpack
codec (checkpoint/msgpack_codec.py) against flax.serialization, `to_flax`
against the flax trees, and arch.json + <role>.msgpack directories in both
directions (checkpoint/io.py) for G and D in the `resnet`, `skip` and
`orig` layouts: every leaf bit-equal, forwards within 2e-4 (the JAX suite's
tolerance, tests/test_packed_pipeline.py:95)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from morphganformer_tpu.checkpoint import io as jio
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.discriminator import Discriminator as JDiscriminator
from morphganformer_tpu.models.generator import init_generator as j_init_generator
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import from_flax, load_flax, to_flax
from morphganformer_tpu_torch.checkpoint import io as tio
from morphganformer_tpu_torch.checkpoint import msgpack_codec as mc
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models.discriminator import init_discriminator

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4
LAYOUTS = ("resnet", "skip", "orig")


def g_cfg(mod, arch="resnet"):
    return mod.GANformerConfig(img_resolution=32, z_dim=8, w_dim=8, k=3, channel_base=256,
                               channel_max=32, end_res=3, architecture=arch,
                               mapping=mod.MappingConfig(num_layers=2),
                               attention=mod.AttentionConfig())


def d_cfg(mod, arch="resnet"):
    return mod.DiscriminatorConfig(img_resolution=32, channel_base=256, channel_max=64,
                                   architecture=arch, mbstd_group_size=2)


def leaves(tree):
    """{path: numpy array} of a flax or port tree."""
    return {"/".join(p): np.asarray(v) for p, v in _walk(tree)}


def _walk(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _walk(v, prefix + (str(k),))
    else:
        yield prefix, tree


def assert_bit_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert la[k].tobytes() == lb[k].tobytes(), k


def bumped(variables):
    """Fresh inits have zero noise strengths and w_avg: make both count."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(s in jax.tree_util.keystr(p)
                                    for s in ("noise_strength", "w_avg")) else x, variables)


def bump_port(net):
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith(("noise_strength", "w_avg")):
                t.add_(0.3)
    return net


# ------------------------------------------------------------ the codec

def sample_tree():
    rng = np.random.RandomState(0)
    return {"params": {"dense": {"kernel": rng.randn(3, 4).astype(np.float32),
                                 "bias": np.zeros(4, np.float32)},
                       "f64": rng.randn(2, 2), "f16": rng.randn(5).astype(np.float16),
                       "i32": np.arange(-3, 3, dtype=np.int32),
                       "i64": np.array([2 ** 40, -2 ** 40], np.int64),
                       "u8": rng.randint(0, 255, (2, 3, 3)).astype(np.uint8),
                       "flag": np.array([True, False])},
            "zero_d": np.array(1.25, np.float32), "scalar": np.float32(-2.5),
            "int_scalar": np.int64(7), "count": 123456789, "neg": -70000, "small": -5,
            "rate": 0.125, "on": True, "off": False, "nothing": None,
            "name": "x" * 40, "empty": {}, "deep": {"a": {"b": {"c": np.ones((1, 1, 1))}}}}


def test_codec_writes_flax_bytes():
    tree = sample_tree()
    assert mc.msgpack_serialize(tree) == serialization.msgpack_serialize(tree, in_place=True)


@pytest.mark.parametrize("writer", ["port", "flax"])
def test_codec_round_trip_with_flax(writer):
    tree = sample_tree()
    data = (mc.msgpack_serialize(tree) if writer == "port"
            else serialization.msgpack_serialize(tree, in_place=True))
    got = (serialization.msgpack_restore(data) if writer == "port"
           else mc.msgpack_restore(data))
    assert_bit_equal({k: v for k, v in got.items() if v is not None and v != {}},
                     {k: v for k, v in tree.items() if v is not None and v != {}})
    assert isinstance(got["scalar"], np.float32) and got["scalar"] == np.float32(-2.5)
    assert got["count"] == 123456789 and got["rate"] == 0.125 and got["on"] is True
    assert got["nothing"] is None and got["empty"] == {} and got["name"] == "x" * 40


def test_codec_bfloat16_leaves_as_torch():
    words = jnp.arange(-3, 3, dtype=jnp.bfloat16).reshape(2, 3) / 4
    got = mc.msgpack_restore(serialization.msgpack_serialize({"w": np.asarray(words)}))
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(words, np.float32))
    back = serialization.msgpack_restore(mc.msgpack_serialize(got))
    assert back["w"].dtype == jnp.bfloat16
    assert back["w"].tobytes() == np.asarray(words).tobytes()


@pytest.mark.parametrize("writer", ["port", "flax"])
def test_codec_chunks_large_arrays(monkeypatch, writer):
    """flax splits an array over MAX_CHUNK_SIZE bytes into a chunk dict;
    both sides write and read that form (the limit lowered here)."""
    monkeypatch.setattr(mc, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.random.RandomState(1).randn(7, 9).astype(np.float32)      # 252 bytes
    tree = {"a": {"big": big, "small": np.ones(3, np.float32)}}
    if writer == "port":
        data = mc.msgpack_serialize(tree)
        assert data == serialization.msgpack_serialize(
            jax.tree_util.tree_map(lambda x: x, tree), in_place=True)
        got = serialization.msgpack_restore(data)
    else:
        got = mc.msgpack_restore(serialization.msgpack_serialize(tree, in_place=True))
    assert got["a"]["big"].shape == (7, 9)
    assert got["a"]["big"].tobytes() == big.tobytes()
    assert sorted(mc._chunk(big)["chunks"]) == [str(i) for i in range(4)]


def test_codec_refuses_complex():
    with pytest.raises(ValueError, match="complex"):
        mc.msgpack_restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(TypeError, match="complex"):
        mc.msgpack_serialize({"c": 1 + 2j})


# ------------------------------------------------------------ to_flax

@pytest.fixture(scope="module")
def jax_nets():
    """{layout: (G model, G variables, D model, D variables)} of the JAX
    package, with non-zero noise strengths and w_avg."""
    out = {}
    for arch in LAYOUTS:
        gm, gv = j_init_generator(g_cfg(jcfg, arch), seed=0)
        dm = JDiscriminator(d_cfg(jcfg, arch))
        dv = jax.jit(dm.init)(jax.random.PRNGKey(4), jnp.zeros((4, 32, 32, 3)))
        out[arch] = (gm, jax.device_get(bumped(gv)), dm, jax.device_get(dv))
    return out


@pytest.mark.parametrize("arch", LAYOUTS)
def test_to_flax_gives_the_flax_trees(jax_nets, arch):
    """`to_flax` of a port net has the JAX init tree's collections, paths,
    shapes and float32 leaves; it inverts `from_flax`."""
    gm, gv, dm, dv = jax_nets[arch]
    G = init_generator(g_cfg(tcfg, arch), seed=1, device="cpu")
    D = init_discriminator(d_cfg(tcfg, arch), seed=2, device="cpu")
    for net, ref in ((G, gv), (D, dv)):
        tree = to_flax(net)
        want = {k: v.shape for k, v in leaves(ref).items()}
        assert {k: v.shape for k, v in leaves(tree).items()} == want
        assert all(v.dtype == np.float32 for v in leaves(tree).values())
        state = from_flax(tree)
        for k, v in net.state_dict().items():
            assert torch.equal(state[k], v), k


def jax_g_forward(model, variables, z):
    fn = jax.jit(lambda v, zz: model.apply(v, zz, truncation_psi=0.7, noise_mode="const"))
    return np.asarray(fn(variables, jnp.asarray(z)))


def jax_d_forward(model, variables, img):
    return np.asarray(jax.jit(model.apply)(variables, jnp.asarray(img)))


@pytest.mark.parametrize("arch", LAYOUTS)
def test_jax_checkpoint_loads_in_the_port(jax_nets, arch, tmp_path):
    gm, gv, dm, dv = jax_nets[arch]
    jio.save_generator(str(tmp_path), g_cfg(jcfg, arch), gv, role="Gs")
    jio.save_discriminator(str(tmp_path), d_cfg(jcfg, arch), dv)
    assert sorted(json.load(open(tmp_path / "arch.json"))) == ["D", "Gs"]

    cfg, G = tio.load_generator(str(tmp_path), device="cpu")
    dcfg, D = tio.load_discriminator(str(tmp_path), device="cpu")
    assert cfg == g_cfg(tcfg, arch) and dcfg == d_cfg(tcfg, arch)
    assert not G.training
    assert_bit_equal(to_flax(G), gv)
    assert_bit_equal(to_flax(D), dv)

    rng = np.random.RandomState(0)
    z = rng.randn(2, cfg.k, cfg.z_dim).astype(np.float32)
    img = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got_g = G(z=torch.from_numpy(z), truncation_psi=0.7).numpy()
        got_d = D(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got_g, jax_g_forward(gm, gv, z), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_d, jax_d_forward(dm, dv, img), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", LAYOUTS)
def test_port_checkpoint_loads_in_jax(arch, tmp_path):
    G = bump_port(init_generator(g_cfg(tcfg, arch), seed=3, device="cpu"))
    D = init_discriminator(d_cfg(tcfg, arch), seed=4, device="cpu")
    tio.save_generator(str(tmp_path), G.cfg, G, role="G")
    tio.save_generator(str(tmp_path), G.cfg, to_flax(G), role="Gs")
    tio.save_discriminator(str(tmp_path), D.cfg, D)
    assert sorted(json.load(open(tmp_path / "arch.json"))) == ["D", "G", "Gs"]

    for role in ("G", "Gs"):
        cfg, gm, gv = jio.load_generator(str(tmp_path), role=role)
        assert cfg == g_cfg(jcfg, arch)
        assert_bit_equal(jax.device_get(gv), to_flax(G))
    dcfg, dm, dv = jio.load_discriminator(str(tmp_path))
    assert dcfg == d_cfg(jcfg, arch)
    assert_bit_equal(jax.device_get(dv), to_flax(D))

    rng = np.random.RandomState(1)
    z = rng.randn(2, cfg.k, cfg.z_dim).astype(np.float32)
    img = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want_g = G(z=torch.from_numpy(z), truncation_psi=0.7).numpy()
        want_d = D(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(jax_g_forward(gm, gv, z), want_g, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(jax_d_forward(dm, dv, img), want_d, rtol=TOL, atol=TOL)


def test_generate_entry_point_on_a_jax_checkpoint(jax_nets, tmp_path):
    """`cli generate --model <dir>` on a directory that JAX wrote gives the
    images of the loaded generator."""
    gm, gv, _, _ = jax_nets["resnet"]
    jio.save_generator(str(tmp_path / "ckpt"), g_cfg(jcfg), gv)
    cli.main(["generate", "--model", str(tmp_path / "ckpt"), "--device", "cpu",
              "--output-dir", str(tmp_path / "out"), "--images-num", "3", "--batch-size", "2"])
    assert sorted(os.listdir(tmp_path / "out")) == [f"sample_{i:06d}.png" for i in range(3)]
    cfg, G = cli.get_model(str(tmp_path / "ckpt"), device="cpu")
    imgs = cli.run_generate(G, str(tmp_path / "again"), 3, batch_size=2)
    for i in range(3):
        assert (open(tmp_path / "out" / f"sample_{i:06d}.png", "rb").read()
                == open(tmp_path / "again" / f"sample_{i:06d}.png", "rb").read())
    assert imgs.shape == (3, 32, 32, 3) and np.isfinite(imgs).all()


def test_load_network_refuses_a_pickle_and_a_missing_role(tmp_path):
    with pytest.raises(ValueError, match="convert_checkpoint.py"):
        tio.load_network("network-snapshot-000100.pkl")
    G = init_generator(g_cfg(tcfg), seed=0, device="cpu")
    tio.save_generator(str(tmp_path), G.cfg, G, role="G")
    with pytest.raises(KeyError, match="'Gs' not in checkpoint"):
        tio.load_network(str(tmp_path), device="cpu")
    cfg, G2 = tio.load_network(str(tmp_path), role="G", device="cpu")
    assert_bit_equal(to_flax(G2), to_flax(G))


def test_load_flax_refuses_a_tree_of_another_net(jax_nets):
    _, gv, _, _ = jax_nets["skip"]
    G = init_generator(g_cfg(tcfg, "resnet"), seed=0, device="cpu")
    with pytest.raises(KeyError, match="without a port counterpart"):
        load_flax(G, gv)
    with pytest.raises(KeyError, match="no flax collection"):
        net = torch.nn.Module()
        net.register_buffer("running_mean", torch.zeros(2))
        to_flax(net)


def test_discriminator_config_from_checkpoint_json(tmp_path):
    cfg = dataclasses.replace(d_cfg(tcfg, "skip"), mbstd_num_channels=2)
    D = init_discriminator(cfg, seed=0, device="cpu")
    tio.save_discriminator(str(tmp_path), cfg, D)
    got, D2 = tio.load_discriminator(str(tmp_path), device="cpu")
    assert got == cfg
    assert_bit_equal(to_flax(D2), to_flax(D))
