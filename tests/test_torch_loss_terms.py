"""The port's perceptual and landmark loss terms (losses/lbp.py, wing.py,
landmarks.py, lpips.py, mdf.py) against the JAX package on the same
parameters, the JAX trees carried over by `losses.nets.to_torch_params`,
and the port's random parameters and .npz loaders against JAX's.

Tolerances: a term's value within 1e-4 relative of JAX's, in float32 and in
float64; its gradient with respect to the image within 1e-3 of the
gradient's largest entry, both packages in float64. (In float32 a ReLU
input within rounding of 0 can take either side: the wing term at 300^2
puts 10 of 270000 gradient entries 2.3e-3 of the largest apart, where the
port's float32 gradient is within 4e-7 of float64's and JAX's is not.) The
JAX side runs under jax.jit (one compile, not one per op)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.losses import landmarks as jlandmarks
from morphganformer_tpu.losses import lbp as jlbp
from morphganformer_tpu.losses import lpips as jlpips
from morphganformer_tpu.losses import mdf as jmdf
from morphganformer_tpu.losses import wing as jwing
from morphganformer_tpu_torch.losses import landmarks, lbp, lpips, mdf, wing
from morphganformer_tpu_torch.losses.nets import to_torch_params
from tools.convert_mdf import load_mdf_params as jload_mdf_params

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VALUE_RTOL = 1e-4
GRAD_TOL = 1e-3


def images(seed, size, batch=1):
    """Two NHWC images in [-1, 1], the second near the first."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    b = np.clip(a + 0.5 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    return a, b


def cast(tree, dtype):
    """A parameter tree (numpy or tensors) in another float type."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype)
    return np.asarray(tree, dtype) if hasattr(tree, "shape") else tree


def term_value_and_grad(term, a, b):
    at = torch.tensor(a, requires_grad=True)
    value = term(at, torch.from_numpy(b))
    grad, = torch.autograd.grad(value, at)
    return value.item(), grad.numpy()


def assert_term_matches(jterm_of, term_of, a, b, jparams=None):
    """The JAX term jterm_of(params) against the port's term_of(params) at
    (a, b), on `jparams` (a JAX tree, carried over): the value in float32,
    the value and d value / d a in float64."""
    def tparams(dtype):
        return None if jparams is None else cast(to_torch_params(jparams, "cpu"), dtype)

    want = jax.jit(jterm_of(jparams))(jnp.asarray(a), jnp.asarray(b))
    got, _ = term_value_and_grad(term_of(tparams(torch.float32)), a, b)
    np.testing.assert_allclose(got, float(want), rtol=VALUE_RTOL)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    with jax.enable_x64(True):
        jp = None if jparams is None else jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float64), cast(jparams, np.float64))
        want, want_grad = jax.jit(jax.value_and_grad(jterm_of(jp)))(jnp.asarray(a64),
                                                                    jnp.asarray(b64))
        want, want_grad = float(want), np.asarray(want_grad)
    got, got_grad = term_value_and_grad(term_of(tparams(torch.float64)), a64, b64)
    assert np.isfinite(want) and np.abs(want_grad).max() > 0
    np.testing.assert_allclose(got, want, rtol=VALUE_RTOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=0,
                               atol=GRAD_TOL * np.abs(want_grad).max())


def test_soft_lbp_loss_matches_jax():
    a, b = images(0, 24)
    assert_term_matches(lambda p: jlbp.soft_lbp_loss, lambda p: lbp.soft_lbp_loss, a, b)


def test_hard_lbp_matches_jax():
    img = np.random.RandomState(1).randint(0, 256, (20, 17, 3))
    np.testing.assert_array_equal(lbp.local_binary_pattern(img), jlbp.local_binary_pattern(img))
    np.testing.assert_array_equal(lbp.lbp_histogram(img), jlbp.lbp_histogram(img))
    other = np.random.RandomState(2).randint(0, 256, (20, 17, 3))
    assert lbp.lbp_distance(img, other) == jlbp.lbp_distance(img, other)
    with pytest.raises(ValueError):
        lbp.local_binary_pattern(img, P=16)


@pytest.fixture(scope="module")
def landmark_trees():
    """The landmark net's JAX parameters: random from a seed, and the
    bundled synthetic-face model."""
    path = jlandmarks.bundled_landmark_path()
    assert path and os.path.exists(path)
    return {"random": jlandmarks.random_landmark_params(width=16, seed=3),
            "bundled": jlandmarks.load_landmark_npz(path)}


@pytest.mark.parametrize("which", ["random", "bundled"])
@pytest.mark.parametrize("size", [32, 300])
def test_wing_term_matches_jax(landmark_trees, which, size):
    """The coordinate-space wing term at project's temperature 0.05, the
    target's landmarks recomputed each call; 32 grows to the net's 256 and
    300 shrinks to it."""
    a, b = images(4, size)
    assert_term_matches(
        lambda p: jwing.make_wing_loss_term(jlandmarks.make_landmark_fn(p, temperature=0.05)),
        lambda p: wing.make_wing_loss_term(landmarks.make_landmark_fn(p, temperature=0.05)),
        a, b, landmark_trees[which])


@pytest.mark.parametrize("which", ["random", "bundled"])
def test_adaptive_wing_term_matches_jax(landmark_trees, which):
    a, b = images(5, 40)
    assert_term_matches(
        lambda p: jwing.make_adaptive_wing_loss_term(
            lambda im: jlandmarks.landmark_heatmaps_01(p, im)),
        lambda p: wing.make_adaptive_wing_loss_term(
            lambda im: landmarks.landmark_heatmaps_01(p, im)),
        a, b, landmark_trees[which])


def test_landmark_heatmaps_and_coordinates_match_jax(landmark_trees):
    """landmark_heatmaps (NHWC [B, 64, 64, 68]) and soft_argmax in pixels."""
    jp = landmark_trees["bundled"]
    tp = to_torch_params(jp, "cpu")
    a, _ = images(6, 48, batch=2)
    want = np.asarray(jax.jit(lambda x: jlandmarks.landmark_heatmaps(jp, x))(jnp.asarray(a)))
    got = landmarks.landmark_heatmaps(tp, torch.from_numpy(a))
    assert got.shape == want.shape == (2, 64, 64, 68)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    coords = np.asarray(jlandmarks.make_landmark_fn(jp, image_size=48)(jnp.asarray(a)))
    got_c = landmarks.make_landmark_fn(tp, image_size=48)(torch.from_numpy(a))
    np.testing.assert_allclose(got_c.numpy(), coords, rtol=VALUE_RTOL, atol=1e-4)
    # soft_argmax alone on given heatmaps, and its gradient.
    hm = np.random.RandomState(7).randn(2, 8, 6, 5).astype(np.float32)
    gw = np.random.RandomState(8).randn(2, 5, 2).astype(np.float32)
    want_g = np.asarray(jax.grad(lambda h: jnp.sum(jlandmarks.soft_argmax(h, 0.05) * gw))(
        jnp.asarray(hm)))
    ht = torch.tensor(hm, requires_grad=True)
    got_g, = torch.autograd.grad((landmarks.soft_argmax(ht, 0.05) * torch.from_numpy(gw)).sum(),
                                 ht)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0, atol=GRAD_TOL * np.abs(want_g).max())


@pytest.mark.parametrize("net,size", [("alex", 64), ("vgg", 32), ("squeeze", 48)])
def test_lpips_term_matches_jax(net, size):
    a, b = images(9, size)
    assert_term_matches(lambda p: jlpips.make_lpips_loss(p, net),
                        lambda p: lpips.make_lpips_loss(p, net), a, b,
                        jlpips.random_lpips_params(net, seed=1))


def test_lpips_distance_is_per_image():
    jp = jlpips.random_lpips_params("alex", seed=2)
    a, b = images(10, 64, batch=2)
    want = np.asarray(jlpips.lpips_distance(jp, jnp.asarray(a), jnp.asarray(b), "alex"))
    got = lpips.lpips_distance(to_torch_params(jp, "cpu"), torch.from_numpy(a),
                               torch.from_numpy(b), "alex")
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=VALUE_RTOL)


@pytest.mark.parametrize("padding", [0, 1])
def test_mdf_term_matches_jax(padding):
    """MDF over 3 scales of the 8-discriminator stack; padding as a converted
    stack records it."""
    a, b = images(11, 24)
    assert_term_matches(lambda p: jmdf.make_mdf_loss(p, padding=padding),
                        lambda p: mdf.make_mdf_loss(p, padding=padding), a, b,
                        jmdf.random_mdf_params(num_discs=3, nfc=16, min_nfc=8, seed=2))


def assert_same_tree(got, want):
    """A port tree (tensors, OIHW) equal to a JAX tree carried over."""
    def same(g, w):
        assert type(g) is type(w)
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                same(gi, wi)
        elif isinstance(w, torch.Tensor):
            assert g.dtype == torch.float32 and g.shape == w.shape and torch.equal(g, w)
        else:
            assert g == w
    same(got, to_torch_params(want, "cpu"))


def test_to_torch_params_turns_hwio_into_oihw():
    w = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    t = to_torch_params({"w": w, "v": [np.ones(3)], "tag": "random"}, "cpu")
    assert t["w"].shape == (5, 4, 2, 3) and t["w"][4, 3, 1, 2] == w[1, 2, 3, 4]
    assert t["w"].is_contiguous() and t["v"][0].dtype == torch.float32 and t["tag"] == "random"


@pytest.mark.parametrize("which", ["landmarks", "lpips-alex", "lpips-vgg", "lpips-squeeze",
                                   "mdf"])
def test_random_params_are_jax_draws(which):
    """--random-perceptual gives both packages the same weights."""
    if which == "landmarks":
        got, want = landmarks.random_landmark_params(device="cpu"), \
            jlandmarks.random_landmark_params()
    elif which == "mdf":
        got, want = mdf.random_mdf_params(device="cpu"), jmdf.random_mdf_params()
    else:
        net = which.split("-")[1]
        got, want = lpips.random_lpips_params(net, device="cpu"), jlpips.random_lpips_params(net)
    assert_same_tree(got, want)


def test_landmark_loader_reads_the_bundled_and_a_written_npz(tmp_path, monkeypatch):
    path = landmarks.bundled_landmark_path()
    assert path == jlandmarks.bundled_landmark_path()
    assert_same_tree(landmarks.load_landmark_npz(path, "cpu"), jlandmarks.load_landmark_npz(path))
    tree = jlandmarks.random_landmark_params(width=4, seed=5)
    flat = {"head_w": tree["head_w"], "head_b": tree["head_b"],
            **{f"{n}_{leaf}": v for n, p in tree.items() if isinstance(p, dict)
               for leaf, v in p.items()}}
    np.savez(tmp_path / "lm.npz", **{k: np.asarray(v) for k, v in flat.items()})
    assert_same_tree(landmarks.load_landmark_npz(tmp_path / "lm.npz", "cpu"),
                     jlandmarks.load_landmark_npz(tmp_path / "lm.npz"))
    # $MGT_LANDMARK_NPZ names another model, as in JAX.
    monkeypatch.setenv("MGT_LANDMARK_NPZ", str(tmp_path / "lm.npz"))
    assert landmarks.bundled_landmark_path() == jlandmarks.bundled_landmark_path() \
        == str(tmp_path / "lm.npz")


@pytest.mark.parametrize("net", ["alex", "squeeze"])
@pytest.mark.parametrize("heads_only", [False, True])
def test_lpips_loader_matches_jax(tmp_path, net, heads_only):
    """A tower + heads .npz, and a heads-only one (tools/convert_lpips.py
    --tower none), which gets the seeded random tower and the tag."""
    tree = jlpips.random_lpips_params(net, seed=4)
    arrays = {f"lin{k}": np.asarray(v) for k, v in enumerate(tree["lins"])}
    if not heads_only:
        arrays.update({k: np.asarray(v) for k, v in tree["tower"].items()})
    np.savez(tmp_path / "lp.npz", **arrays)
    got = lpips.load_lpips_params(str(tmp_path / "lp.npz"), net, device="cpu")
    want = jlpips.load_lpips_params(str(tmp_path / "lp.npz"), net)
    assert (got.get("tower_source") == "random") == heads_only
    assert_same_tree(got, want)
    with pytest.raises(ValueError, match="lin heads"):
        lpips.load_lpips_params(str(tmp_path / "lp.npz"), "squeeze" if net == "alex" else "alex",
                                device="cpu")


@pytest.mark.parametrize("padding", [None, 1])
def test_mdf_loader_matches_jax(tmp_path, padding):
    tree = jmdf.random_mdf_params(num_discs=2, nfc=8, min_nfc=8, num_layer=4, seed=6)
    arrays = {}
    for i, d in enumerate(tree):
        for leaf, v in d["head"].items():
            arrays[f"d{i}_head_{leaf}"] = np.asarray(v)
        for j, blk in enumerate(d["body"]):
            for leaf, v in blk.items():
                arrays[f"d{i}_body{j}_{leaf}"] = np.asarray(v)
        arrays[f"d{i}_tail_w"], arrays[f"d{i}_tail_b"] = np.asarray(d["tail_w"]), \
            np.asarray(d["tail_b"])
    if padding is not None:
        arrays["padding"] = np.int32(padding)
    np.savez(tmp_path / "mdf.npz", **arrays)
    got, got_pad = mdf.load_mdf_params(str(tmp_path / "mdf.npz"), with_padding=True, device="cpu")
    want, want_pad = jload_mdf_params(str(tmp_path / "mdf.npz"), with_padding=True)
    assert got_pad == want_pad == (padding or 0)
    assert_same_tree(got, want)
    assert_same_tree(mdf.load_mdf_params(str(tmp_path / "mdf.npz"), device="cpu"), want)
