"""The port's reference-checkpoint converter
(morphganformer_tpu_torch/tools/convert_checkpoint.py) against the JAX
package's (tools/convert_checkpoint.py) on synthetic pickles in the
reference's wire format (tests/torch_reference_pickles.py): the persistence
dict written with `pickle` and with `torch.save` (zipfile), and the TF-legacy
(G, D, Gs) tuple, at tests/test_models.py's small config in the resnet and
skip layouts, with Gs alone and with G, D and Gs. The weights are the port's
init perturbed from a numpy seed.

Checks: every <role>.msgpack byte-identical to JAX's; arch.json parsing to
equal configs; the same warnings for unmapped names; the port's output
loaded by the port and JAX's loaded by JAX giving G images (noise_mode
"const") and D logits within 2e-4 (the JAX suite's tolerance,
tests/test_packed_pipeline.py:95); the reference's persistence reconstruct
never executed. And the converter runs in a process that cannot import JAX,
flax, optax, PIL, torchvision, the JAX package or tools/."""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from morphganformer_tpu.checkpoint import io as jio
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu_torch.checkpoint import io as tio
from morphganformer_tpu_torch.checkpoint import to_flax
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models.discriminator import init_discriminator
from morphganformer_tpu_torch.tools import convert_checkpoint as tconv
from tools import convert_checkpoint as jconv

from . import torch_reference_pickles as refpk
from .test_torch_checkpoint_io import assert_bit_equal, jax_d_forward, jax_g_forward
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4
RES = 16
FORMS = ("plain", "zipfile", "tf")


def g_cfg(mod, arch):
    """tests/test_models.py's small_cfg in the `arch` layout."""
    return mod.GANformerConfig(img_resolution=RES, z_dim=8, w_dim=8, k=4, channel_base=512,
                               channel_max=64, end_res=3, architecture=arch,
                               mapping=mod.MappingConfig(num_layers=2, lrmul=0.01),
                               attention=mod.AttentionConfig())


def d_cfg(mod, arch):
    return mod.DiscriminatorConfig(img_resolution=RES, channel_base=512, channel_max=64,
                                   architecture=arch, mbstd_group_size=2)


def perturbed(tree, rng):
    """A flax tree with every leaf moved by N(0, 0.1) from `rng`."""
    if isinstance(tree, dict):
        return {k: perturbed(v, rng) for k, v in tree.items()}
    return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """{arch: (G tree, D tree)}: the port's init, perturbed from a seed."""
    rng = np.random.RandomState(0)
    out = {}
    for arch in ("resnet", "skip"):
        G = init_generator(g_cfg(tcfg, arch), seed=0, device="cpu")
        D = init_discriminator(d_cfg(tcfg, arch), seed=1, device="cpu")
        out[arch] = (perturbed(to_flax(G), rng), perturbed(to_flax(D), rng))
    return out


def write_pickle(path, form, arch, trees, roles=("G", "D", "Gs"), extra=None):
    gv, dv = trees
    if form == "tf":
        refpk.write_tf_pickle(path, refpk.tf_nets(g_cfg(tcfg, arch), gv, d_cfg(tcfg, arch), dv,
                                                  extra=extra))
    else:
        nets = refpk.persistence_nets(g_cfg(tcfg, arch), gv, d_cfg(tcfg, arch), dv,
                                      roles=roles, extra=extra)
        refpk.write_persistence_pickle(path, nets, zipfile=form == "zipfile")
    return str(path)


def converted(pkl, out_dir, convert):
    """Run `convert(pkl, out_dir)`; its printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        convert(pkl, str(out_dir))
    return buf.getvalue().splitlines()


def expected_g_cfg(mod, form, arch):
    cfg = g_cfg(mod, arch)
    return refpk.tf_config(cfg) if form == "tf" else cfg


CASES = [(form, arch, roles) for form in ("plain", "zipfile") for arch in ("resnet", "skip")
         for roles in (("Gs",), ("G", "D", "Gs"))] + [
    ("tf", arch, ("G", "D", "Gs")) for arch in ("resnet", "skip")]


@pytest.mark.parametrize("form,arch,roles", CASES,
                         ids=[f"{f}-{a}-{'+'.join(r)}" for f, a, r in CASES])
def test_port_writes_jax_converter_bytes(nets, tmp_path, form, arch, roles):
    pkl = write_pickle(tmp_path / "snapshot.pkl", form, arch, nets[arch], roles)
    want_lines = converted(pkl, tmp_path / "jax", jconv.convert)
    got_lines = converted(pkl, tmp_path / "port", tconv.convert)
    assert got_lines == [line.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
                         for line in want_lines]
    assert not any("WARNING" in line for line in got_lines), got_lines
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        ["arch.json"] + [f"{r}.msgpack" for r in roles])
    for role in roles:
        got = (tmp_path / "port" / f"{role}.msgpack").read_bytes()
        assert got == (tmp_path / "jax" / f"{role}.msgpack").read_bytes(), role
    arch_got = json.loads((tmp_path / "port" / "arch.json").read_text())
    arch_want = json.loads((tmp_path / "jax" / "arch.json").read_text())
    assert arch_got == arch_want
    for role in roles:
        if role == "D":
            assert tcfg.DiscriminatorConfig.from_json(json.dumps(arch_got[role])) == \
                d_cfg(tcfg, arch)
        else:
            assert tcfg.GANformerConfig.from_json(json.dumps(arch_got[role])) == \
                expected_g_cfg(tcfg, form, arch)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("arch", ["resnet", "skip"])
def test_converted_nets_match_jax(nets, tmp_path, form, arch):
    """The port's output loaded by the port, JAX's loaded by JAX: every leaf
    the exported tree; G images and D logits within 2e-4."""
    pkl = write_pickle(tmp_path / "snapshot.pkl", form, arch, nets[arch])
    converted(pkl, tmp_path / "jax", jconv.convert)
    converted(pkl, tmp_path / "port", tconv.convert)
    gv, dv = nets[arch]
    rng = np.random.RandomState(2)
    z = rng.randn(2, 4, 8).astype(np.float32)
    img = rng.uniform(-1, 1, (4, RES, RES, 3)).astype(np.float32)
    for role in ("G", "Gs"):
        cfg, G = tio.load_generator(str(tmp_path / "port"), role=role, device="cpu")
        assert cfg == expected_g_cfg(tcfg, form, arch)
        assert_bit_equal(to_flax(G), gv)
        jc, gm, jv = jio.load_generator(str(tmp_path / "jax"), role=role)
        assert jc == expected_g_cfg(jcfg, form, arch)
        with torch.no_grad():
            got = G(z=torch.from_numpy(z), truncation_psi=0.7, noise_mode="const").numpy()
        np.testing.assert_allclose(got, jax_g_forward(gm, jv, z), rtol=TOL, atol=TOL)
    dc, D = tio.load_discriminator(str(tmp_path / "port"), device="cpu")
    assert dc == d_cfg(tcfg, arch)
    assert_bit_equal(to_flax(D), dv)
    _, dm, jdv = jio.load_discriminator(str(tmp_path / "jax"))
    with torch.no_grad():
        got = D(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, jax_d_forward(dm, jdv, img), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("form", FORMS)
def test_unmapped_names_give_jax_warnings(nets, tmp_path, form):
    """Leaves the maps do not know are left out with the same warnings; the
    static resample kernels pass silently."""
    k = np.ones((4,), np.float32)
    if form == "tf":
        extra = {"G": {"synthesis/8x8/Conv1/bogus": k, "mapping/Dense9_9/extra": k},
                 "D": {"8x8/Bogus/weight": k}, "Gs": {"synthesis/8x8/ToRGB/oddity": k}}
    else:
        extra = {"G": {"synthesis.b8.conv1.bogus": k, "synthesis.b8.conv0.resample_kernel": k},
                 "D": {"b8.conv1.running_var": k, "b8.conv1.resample_kernel": k},
                 "Gs": {"mapping.odd.weight": np.ones((2, 2, 2), np.float32)}}
    pkl = write_pickle(tmp_path / "snapshot.pkl", form, "resnet", nets["resnet"], extra=extra)
    want = converted(pkl, tmp_path / "jax", jconv.convert)
    got = converted(pkl, tmp_path / "port", tconv.convert)
    assert got == [line.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for line in want]
    warned = [line for line in got if "WARNING" in line]
    assert len(warned) == 3, got
    for role in ("G", "D", "Gs"):
        assert (tmp_path / "port" / f"{role}.msgpack").read_bytes() == \
            (tmp_path / "jax" / f"{role}.msgpack").read_bytes()


@pytest.mark.parametrize("form", ["plain", "zipfile"])
def test_persistence_reconstruct_is_never_executed(nets, tmp_path, form):
    """The pickle's GLOBAL is the reference's `_reconstruct_persistent_obj`,
    registered here as a function that raises: a plain unpickler runs it,
    the converter's stub does not."""
    pkl = write_pickle(tmp_path / "snapshot.pkl", form, "resnet", nets["resnet"], ("Gs",))
    data = open(pkl, "rb").read()
    if form == "plain":
        assert b"_reconstruct_persistent_obj" in data
        import pickle
        with pytest.raises(RuntimeError):
            pickle.loads(data)
    loaded = tconv.load_reference_pickle(pkl)
    assert isinstance(loaded["Gs"], tconv._PersistentStub)
    assert loaded["Gs"].meta["class_name"] == "Generator"
    kwargs = tconv.get_init_kwargs(loaded["Gs"])
    assert type(kwargs["mapping_kwargs"]) is dict            # EasyDict read as a dict
    assert tconv.build_generator_config(kwargs) == g_cfg(tcfg, "resnet")


def test_tf_pickle_version_is_checked(nets, tmp_path):
    gv, dv = nets["resnet"]
    tf = refpk.tf_nets(g_cfg(tcfg, "resnet"), gv, d_cfg(tcfg, "resnet"), dv)
    tf[0].__dict__["version"] = 3
    refpk.write_tf_pickle(tmp_path / "old.pkl", tf)
    for convert in (jconv.convert, tconv.convert):
        with pytest.raises(ValueError, match="version too low"):
            converted(str(tmp_path / "old.pkl"), tmp_path / "out", convert)


def test_exported_configs_refuse_what_the_reference_cannot_carry():
    with pytest.raises(ValueError, match="fused"):
        refpk.generator_init_kwargs(dataclasses.replace(
            g_cfg(tcfg, "resnet"), mapping=tcfg.MappingConfig(fused=False)))
    with pytest.raises(ValueError, match="w_avg_beta"):
        refpk.tf_generator_static_kwargs(dataclasses.replace(
            g_cfg(tcfg, "resnet"), mapping=tcfg.MappingConfig(w_avg_beta=None)))


BLOCKER = """
import importlib.abc, sys
BLOCKED = {"jax", "flax", "optax", "PIL", "torchvision", "morphganformer_tpu", "tools"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
sys.meta_path.insert(0, Block())
"""


def run_without_jax(code, *args, timeout=300):
    """`python -c code args` in a process whose sys.meta_path refuses jax,
    flax, optax, PIL, torchvision, the JAX package and tools/."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", BLOCKER + code, *args], capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT, env=env)


def test_converter_runs_without_jax(nets, tmp_path):
    pkl = write_pickle(tmp_path / "snapshot.pkl", "zipfile", "skip", nets["skip"])
    run = run_without_jax("import runpy\nrunpy.run_module("
                          "'morphganformer_tpu_torch.tools.convert_checkpoint', "
                          "run_name='__main__', alter_sys=True)\n", pkl, str(tmp_path / "out"))
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.splitlines()[-1] == "done"
    converted(pkl, tmp_path / "jax", jconv.convert)
    for role in ("G", "D", "Gs"):
        assert (tmp_path / "out" / f"{role}.msgpack").read_bytes() == \
            (tmp_path / "jax" / f"{role}.msgpack").read_bytes()
    # The blocker works: importing the JAX package there fails.
    run = run_without_jax("import morphganformer_tpu\n", timeout=60)
    assert run.returncode != 0 and "blocked" in run.stderr


def test_converter_prints_usage_without_two_arguments(capsys):
    assert tconv.main(["only-one"]) == 1
    assert "Usage" in capsys.readouterr().out
