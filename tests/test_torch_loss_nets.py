"""The port's biometric loss terms (losses/facenet.py, face_embedding.py)
against the JAX package on the same parameters, their .npz loaders against
the JAX converters' loaders, and the projection's whole loss slice: the
port's `loss_and_grad` on a small fused generator under
"lpips+0.01*wing+1*mse" (cli.projection_loss, random perceptual weights)
against JAX's value_and_grad at one latent with the same weights.

Tolerances: a term's value within 1e-4 relative, its image gradient within
1e-3 of the largest entry (float64, as tests/test_torch_loss_terms.py
says why); the slice's loss within 1e-4 relative and its latent gradient
within 1e-3 of the largest entry, in float32."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cli.project import make_extra_terms as jmake_extra_terms
from morphganformer_tpu.losses import face_embedding as jface
from morphganformer_tpu.losses import facenet as jfacenet
from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.losses.stack import parse_loss_spec as jparse_loss_spec
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import load_flax
from morphganformer_tpu_torch.losses import face_embedding, facenet
from morphganformer_tpu_torch.losses.nets import to_torch_params
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.projection import ProjectionConfig, loss_and_grad
from tools.convert_facenet import load_facenet_npz as jload_facenet_npz
from tools.convert_iresnet import load_iresnet_npz as jload_iresnet_npz

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)
from .test_torch_loss_terms import VALUE_RTOL, assert_same_tree, assert_term_matches, images

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_facenet_term_matches_jax():
    """InceptionResnetV1 at 160^2 (a 40^2 image grown to it)."""
    a, b = images(20, 40)
    assert_term_matches(jfacenet.make_facenet_loss, facenet.make_facenet_loss, a, b,
                        jfacenet.random_facenet_params(seed=1))


def test_arcface_term_and_similarity_match_jax():
    """iresnet18 at 112^2 (a 130^2 image shrunk to it), and the identity
    similarity of a batch of two."""
    jp = jface.random_iresnet_params(seed=2)
    a, b = images(21, 130)
    assert_term_matches(jface.make_identity_loss, face_embedding.make_identity_loss, a, b, jp)
    a2, b2 = images(22, 64, batch=2)
    want = np.asarray(jax.jit(lambda x, y: jface.cosine_similarity(jp, x, y))(
        jnp.asarray(a2), jnp.asarray(b2)))
    got = face_embedding.cosine_similarity(to_torch_params(jp, "cpu"), torch.from_numpy(a2),
                                           torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


def test_random_params_are_jax_draws():
    """--random-perceptual gives both packages the same FaceNet and ArcFace
    weights."""
    assert_same_tree(facenet.random_facenet_params(device="cpu"),
                     jfacenet.random_facenet_params())
    assert_same_tree(face_embedding.random_iresnet_params(device="cpu"),
                     jface.random_iresnet_params())


def _small(tree, rng):
    """The tree's structure with small arrays (a loader maps names only)."""
    if isinstance(tree, dict):
        return {k: _small(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_small(v, rng) for v in tree]
    shape = tuple(tree.shape)
    return rng.randn(*(shape[:2] + (2, 3) if len(shape) == 4 else (5,) * len(shape))
                     ).astype(np.float32)


def test_facenet_loader_matches_jax(tmp_path):
    """An .npz named as tools/convert_facenet.py names its arrays."""
    tree = _small(jfacenet.random_facenet_params(), np.random.RandomState(3))
    flat = {}
    for name, node in tree.items():
        if isinstance(node, list):
            for i, blk in enumerate(node):
                for sub, leaves in blk.items():
                    flat.update({f"{name}.{i}.{sub}_{leaf}": v for leaf, v in leaves.items()})
        elif name in ("mixed_6a", "mixed_7a", "block8"):
            for sub, leaves in node.items():
                flat.update({f"{name}.{sub}_{leaf}": v for leaf, v in leaves.items()})
        elif isinstance(node, dict):
            flat.update({f"{name}_{leaf}": v for leaf, v in node.items()})
        else:
            flat[name] = node
    np.savez(tmp_path / "facenet.npz", **flat)
    want = jload_facenet_npz(str(tmp_path / "facenet.npz"))
    assert_same_tree(facenet.load_facenet_npz(str(tmp_path / "facenet.npz"), device="cpu"), want)
    assert_same_tree(to_torch_params(want, "cpu"), tree)


def test_iresnet_loader_matches_jax(tmp_path):
    """An .npz named as tools/convert_iresnet.py names its arrays."""
    tree = _small(jface.random_iresnet_params(), np.random.RandomState(4))
    flat = {"conv1_w": tree["conv1_w"], "prelu": tree["prelu"], "fc_w": tree["fc_w"],
            "fc_b": tree["fc_b"], "feat_scale": tree["feat_scale"],
            "feat_shift": tree["feat_shift"]}
    for bn in ("bn1", "bn2"):
        flat.update({f"{bn}_{leaf}": v for leaf, v in tree[bn].items()})
    for li in range(1, 5):
        for bi, blk in enumerate(tree[f"layer{li}"]):
            tag = f"layer{li}_{bi}"
            for key, node in blk.items():
                if key == "down_bn":
                    flat.update({f"{tag}_down_{leaf}": v for leaf, v in node.items()})
                elif isinstance(node, dict):
                    flat.update({f"{tag}_{key}_{leaf}": v for leaf, v in node.items()})
                else:
                    flat[f"{tag}_{key}"] = node
    np.savez(tmp_path / "iresnet.npz", **flat)
    want = jload_iresnet_npz(str(tmp_path / "iresnet.npz"))
    assert_same_tree(face_embedding.load_iresnet_npz(str(tmp_path / "iresnet.npz"),
                                                     device="cpu"), want)
    assert_same_tree(to_torch_params(want, "cpu"), tree)


@pytest.fixture(scope="module")
def split():
    """(JAX model, variables, the port's generator with the same weights) at
    32^2, the smallest size the alex tower takes."""
    jc, tc = _cfg(jcfg, "split"), _cfg(tcfg, "split")
    model = JGenerator(jc)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "noise", "mask", "dropout"))}
    variables = model.init(rngs, jnp.zeros((1, jc.k, jc.z_dim)), noise_mode="const")
    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.3 if any(s in jax.tree_util.keystr(p)
                                    for s in ("noise_strength", "w_avg")) else x, variables)
    G = load_flax(init_generator(tc, seed=5, device="cpu"), jax.device_get(variables))
    return model, variables, G


def test_slice_loss_and_latent_gradient_match_jax(split, monkeypatch):
    """One projection step's loss and latent gradient under
    "lpips+0.01*wing+1*mse" with --random-perceptual: the port's fused
    generator (plain kernels on the CPU) and loss stack against JAX's
    unpacked generator, cli/project.py's make_extra_terms and
    value_and_grad."""
    model, variables, G = split
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    spec = "lpips+0.01*wing+1*mse"
    rng = np.random.RandomState(0)
    latent = rng.randn(1, G.cfg.k, G.cfg.z_dim).astype(np.float32)
    target = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)

    weights = jparse_loss_spec(spec)
    jloss = jbuild_loss_stack(weights, extra_terms=jmake_extra_terms(
        weights, argparse.Namespace(random_perceptual=True, lpips_net="alex")))

    def total(lat):
        img = model.apply(variables, lat, truncation_psi=0.7, noise_mode="const")
        loss, comps = jloss(img, jnp.asarray(target))
        return loss, comps

    (want, want_comps), want_grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(latent))
    want_grad = np.asarray(want_grad)

    loss_fn = cli.projection_loss(spec, 32, "cpu", nets=cli.LossNets(random_perceptual=True))
    per_img, comps, grad = loss_and_grad(G, torch.from_numpy(latent), torch.from_numpy(target),
                                         loss_fn, ProjectionConfig())
    assert set(comps) == {"lpips", "wing", "mse"} and np.abs(want_grad).max() > 0
    np.testing.assert_allclose(per_img[0].item(), float(want), rtol=1e-4)
    for k in comps:
        np.testing.assert_allclose(comps[k][0].item(), float(want_comps[k]), rtol=1e-4)
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=1e-3 * np.abs(want_grad).max())
