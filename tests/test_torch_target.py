"""Projection targets of any size and the loss at a lower resolution, in the
port (utils/image.py: lanczos_resize, load_target; losses/nets.py:
resize_bilinear; cli.projection_loss's `size`) against Pillow and the JAX
package.

Tolerances: the resized uint8 image equals Pillow's LANCZOS result at
every pixel, or differs by at most 1 at under 0.1 % of them; the float
target within 1/127.5 of JAX's load_target (one uint8 step); the bilinear
resize within 1e-5 of jax.image.resize and its gradient within 1e-5 of the
largest entry; the loss stack at `--size` within 1e-4 relative and its
image gradient within 1e-3 of the largest entry."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cli.project import make_extra_terms as jmake_extra_terms
from morphganformer_tpu.losses.stack import build_loss_stack as jbuild_loss_stack
from morphganformer_tpu.losses.stack import parse_loss_spec as jparse_loss_spec
from morphganformer_tpu.utils.image import load_target as jload_target
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.losses.nets import resize_bilinear
from morphganformer_tpu_torch.utils.image import lanczos_resize, load_target, read_png

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def assert_near_pil(got, want):
    """At most 1 apart, at under 0.1 % of the values."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())


def photo(seed, h, w):
    """A smooth random RGB image with some sharp noise (uint8)."""
    rng = np.random.RandomState(seed)
    x = np.cumsum(np.cumsum(rng.randn(h, w, 3), 0), 1)
    x = (x - x.min()) / np.ptp(x) * 230 + rng.randint(0, 25, (h, w, 3))
    return x.astype(np.uint8)


@pytest.mark.parametrize("h,w,out_h,out_w", [
    (50, 80, 32, 51), (90, 45, 64, 32), (20, 24, 32, 38), (37, 53, 16, 23),
    (300, 410, 256, 350), (64, 64, 17, 64), (64, 64, 64, 31), (16, 16, 40, 40)])
def test_lanczos_resize_is_pillows(h, w, out_h, out_w):
    """Shrinking, growing, one side alone, and non-integer ratios."""
    img = photo(h * w, h, w)
    want = np.asarray(Image.fromarray(img, "RGB").resize((out_w, out_h), Image.LANCZOS))
    got = lanczos_resize(img, out_h, out_w)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert_near_pil(got, want)


@pytest.mark.parametrize("name,h,w,mode,size", [
    ("wide", 50, 80, "RGB", 32), ("tall", 90, 45, "RGB", 32), ("up", 20, 24, "RGB", 32),
    ("exact", 32, 47, "RGB", 32), ("gray", 40, 60, "L", 32), ("gray_alpha", 33, 47, "LA", 24),
    ("rgba", 70, 50, "RGBA", 32), ("photo", 300, 410, "RGB", 256)])
def test_load_target_matches_pillow_and_jax(tmp_path, name, h, w, mode, size):
    img = photo(len(name), h, w)
    pil = Image.fromarray(img, "RGB")
    if mode == "L":
        pil = pil.convert("L")
    elif mode in ("LA", "RGBA"):
        alpha = Image.fromarray(photo(7, h, w)[:, :, 0], "L")
        pil = pil.convert(mode[:-1])
        pil.putalpha(alpha)
    path = str(tmp_path / f"{name}.png")
    pil.save(path)
    got = load_target(path, size=size)
    want = jload_target(path, size=size)
    assert got.shape == want.shape == (1, size, size, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1 / 127.5)
    # The uint8 image before the range change, against Pillow's.
    rgb = pil.convert("RGB")
    scale = size / min(w, h)
    nw, nh = max(size, round(w * scale)), max(size, round(h * scale))
    left, top = (nw - size) // 2, (nh - size) // 2
    want_u8 = np.asarray(rgb.resize((nw, nh), Image.LANCZOS))[top:top + size,
                                                                left:left + size]
    assert_near_pil(np.rint((got[0] + 1.0) * 127.5).astype(np.uint8), want_u8)
    # read_png decodes what Pillow wrote.
    np.testing.assert_array_equal(read_png(path).reshape(np.asarray(pil).shape), np.asarray(pil))


@pytest.mark.parametrize("fmt,name", [("JPEG", "JPEG"), ("GIF", "GIF"), ("BMP", "BMP"),
                                      ("TIFF", "TIFF"), ("WEBP", "WebP")])
def test_load_target_refuses_other_formats(tmp_path, fmt, name):
    path = tmp_path / f"face.{fmt.lower()}"
    try:
        Image.fromarray(photo(1, 20, 20), "RGB").save(path, format=fmt)
    except (KeyError, OSError) as e:      # a Pillow build without that encoder
        pytest.skip(f"Pillow cannot write {fmt}: {e}")
    with pytest.raises(ValueError, match=f"a {name} image, not a PNG.*convert it to PNG"):
        load_target(path, size=16)


@pytest.mark.parametrize("h,size", [(24, 7), (24, 13), (37, 16), (30, 29), (20, 21), (10, 64),
                                    (64, 32), (300, 256)])
def test_resize_bilinear_matches_jax(h, size):
    """`jax.image.resize(..., "linear")` (antialiased when it shrinks): at
    non-integer ratios, growing, halving, and on the borders; values and
    the gradient."""
    rng = np.random.RandomState(h * size)
    x = rng.uniform(-1, 1, (2, h, h + 3, 3)).astype(np.float32)
    g = rng.randn(2, size, size + 1, 3).astype(np.float32)

    def f(a):
        return jax.image.resize(a, (2, size, size + 1, 3), "linear")
    want = np.asarray(f(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * g))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = resize_bilinear(xt, size, size + 1)
    got_grad, = torch.autograd.grad((got * torch.from_numpy(g)).sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
    assert resize_bilinear(xt, h, h + 3) is xt


def test_loss_at_a_lower_size_matches_jax():
    """project --size 24 on 40^2 images, with --lamda and --beta: the port's
    projection_loss against cli/project.py's resize wrapper around JAX's
    stack (random landmark weights)."""
    spec, size = "mse+0.5*ssim+lbp+wing+awing", 24
    rng = np.random.RandomState(3)
    a = rng.uniform(-1, 1, (1, 40, 40, 3)).astype(np.float32)
    b = np.clip(a + 0.4 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    weights = jparse_loss_spec(spec)
    weights.update(wing=0.02, awing=0.02, mse=3.0)            # --lamda 0.02 --beta 3
    jstack = jbuild_loss_stack(weights, extra_terms=jmake_extra_terms(
        weights, argparse.Namespace(random_perceptual=True)))
    shape = (1, size, size, 3)

    def jloss(img):
        total, comps = jstack(jax.image.resize(img, shape, "linear"),
                              jax.image.resize(jnp.asarray(b), shape, "linear"))
        return total, comps

    (want, want_comps), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(a))
    want_grad = np.asarray(want_grad)
    loss_fn = cli.projection_loss(spec, 40, "cpu", size=size, lamda=0.02, beta=3.0,
                                  nets=cli.LossNets(random_perceptual=True))
    at = torch.tensor(a, requires_grad=True)
    total, comps = loss_fn(at, torch.from_numpy(b))
    got_grad, = torch.autograd.grad(total.sum(), at)
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-4)
    assert set(comps) == set(want_comps) == {"mse", "ssim", "lbp", "wing", "awing"}
    for k in comps:
        np.testing.assert_allclose(comps[k].item(), float(want_comps[k]), rtol=1e-4)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-3 * np.abs(want_grad).max())
    # At or above the model's resolution, --size changes nothing (as in JAX).
    same = cli.projection_loss("mse", 40, "cpu", size=40)
    plain = cli.projection_loss("mse", 40, "cpu")
    assert same(at, torch.from_numpy(b))[0].item() == plain(at, torch.from_numpy(b))[0].item()
