"""The landmark net's trainer without JAX
(morphganformer_tpu_torch/tools/train_landmarks.py) and its sampler
(losses/synthetic_faces.py) against the JAX package's
(tools/train_landmarks.py, morphganformer_tpu/losses/synthetic_faces.py).

Tolerances: the sampler bit for bit; gaussian_targets within 1e-6; loss_fn
within 1e-5 relative and its gradient on JAX's initial parameters carried
across within 1e-5 of the gradient's largest entry (over every leaf, as
tests/test_torch_loss_terms.py holds an image gradient to its largest
entry: per leaf, float32 rounding alone puts one of c3_b's 128 entries
1.3e-5 of that leaf's largest apart); three Adam steps (optax.adam against
torch.optim.Adam, lr 2e-3) on the same gradients within 1e-5 of the
largest parameter (see the test for why not on each package's own). A
20-step run on the CPU writes an .npz both packages' loaders read; the
trainer runs in a process that cannot import JAX, optax, torchvision or the
JAX package; the port's bundled weights are a byte copy of JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morphganformer_tpu.losses import landmarks as jlandmarks
from morphganformer_tpu.losses import synthetic_faces as jfaces
from morphganformer_tpu_torch.losses import landmarks, synthetic_faces
from morphganformer_tpu_torch.losses.nets import to_torch_params
from morphganformer_tpu_torch.tools import train_landmarks as ttl
from tools import train_landmarks as jtl

from .test_torch_convert_checkpoint import run_without_jax
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)
from .test_torch_loss_terms import assert_same_tree

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 991])
def test_sample_batch_is_jax_bit_for_bit(seed):
    got = synthetic_faces.sample_batch(np.random.RandomState(seed), 3, 64)
    want = jfaces.sample_batch(np.random.RandomState(seed), 3, 64)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(synthetic_faces.template_landmarks(),
                                  jfaces.template_landmarks())


def test_gaussian_targets_match_jax():
    coords = np.random.RandomState(3).uniform(0, 1, (2, 68, 2)).astype(np.float32)
    got = ttl.gaussian_targets(torch.from_numpy(coords)).numpy()
    want = np.asarray(jtl.gaussian_targets(jnp.asarray(coords)))
    assert got.shape == want.shape == (2, 64, 64, 68)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def hwio(t):
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def port_params(jparams):
    """JAX's landmark tree carried across, each leaf a tensor to train."""
    p = to_torch_params(jax.device_get(jparams), "cpu")
    for t in ttl.leaves(p):
        t.requires_grad_(True)
    return p


def assert_close(got, want, what):
    """Every leaf of a port tree (OIHW) within TOL of the largest entry of the
    JAX tree `want` (HWIO)."""
    pairs = [(name, hwio(t), np.asarray(want[name] if name in ("head_w", "head_b") else
                                        want[name.rsplit("_", 1)[0]][name.rsplit("_", 1)[1]]))
             for name, t in ttl._named(got)]
    scale = max(np.abs(w).max() for _, _, w in pairs)
    for name, g, w in pairs:
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def batches():
    """Three batches of 4 faces at 128^2 and JAX's initial parameters."""
    rng = np.random.RandomState(7)
    return [synthetic_faces.sample_batch(rng, 4, 128) for _ in range(3)], \
        jlandmarks.random_landmark_params(seed=0)


def test_loss_and_gradient_match_jax(batches):
    data, jparams = batches
    imgs, lms = data[0]
    (want, want_aux), want_g = jax.jit(jax.value_and_grad(jtl.loss_fn, has_aux=True))(
        jparams, jnp.asarray(imgs), jnp.asarray(lms))
    p = port_params(jparams)
    got, got_aux = ttl.loss_fn(p, torch.from_numpy(imgs), torch.from_numpy(lms))
    got.backward()
    for g, w in ((got, want), *zip(got_aux, want_aux)):
        np.testing.assert_allclose(g.item(), float(w), rtol=TOL)
    grads = {name: t.grad for name, t in ttl._named(p)}
    grad_tree = {}
    for name, g in grads.items():
        if name in ("head_w", "head_b"):
            grad_tree[name] = g
        else:
            grad_tree.setdefault(name.rsplit("_", 1)[0], {})[name.rsplit("_", 1)[1]] = g
    assert_close(grad_tree, jax.device_get(want_g), "gradient")


def oihw_tree(tree):
    """A JAX landmark tree as float32 tensors (conv weights OIHW)."""
    return to_torch_params(jax.device_get(tree), "cpu")


def test_three_adam_steps_match_optax(batches):
    """Three steps of optax.adam(2e-3) on JAX's loss against the port's.
    torch.optim.Adam fed JAX's gradients lands on JAX's parameters within
    1e-5 of the largest. Each package on its own gradients is not held to
    1e-5: an entry whose float32 gradient is within rounding of Adam's eps
    takes a step of another size (0.4% of c1_w's entries 5.5e-4 apart after
    three steps; one of c3_w's 2.1e-5 apart even in float64, where both
    soft-argmaxes still compute in float32; the third loss then 1.2e-5
    relative apart). So the port's train_step is held to JAX's first loss
    and to torch's Adam on the port's own gradient."""
    data, jparams = batches
    opt = optax.adam(2e-3)

    @jax.jit
    def step(params, opt_state, bi, bl):
        (loss, _), grads = jax.value_and_grad(jtl.loss_fn, has_aux=True)(params, bi, bl)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    want, state, losses, grads = jparams, opt.init(jparams), [], []
    for imgs, lms in data:
        want, state, loss, g = step(want, state, jnp.asarray(imgs), jnp.asarray(lms))
        losses.append(float(loss))
        grads.append(oihw_tree(g))
    want = jax.device_get(want)

    fed = port_params(jparams)
    topt = torch.optim.Adam(ttl.leaves(fed), lr=2e-3)
    assert topt.defaults["betas"] == (0.9, 0.999) and topt.defaults["eps"] == 1e-8
    for g in grads:
        for t, gt in zip(ttl.leaves(fed), ttl.leaves(g)):
            t.grad = gt.clone()
        topt.step()
    assert_close(fed, want, "Adam fed JAX's gradients, after 3 steps")
    moved = max((t - s).abs().max().item() for t, s in zip(ttl.leaves(fed),
                                                            ttl.leaves(oihw_tree(jparams))))
    assert moved > 1e-3                                  # well past the tolerance

    # The port's train_step: JAX's first loss, and the step of torch's Adam
    # on the gradient of the port's loss_fn, bit for bit.
    imgs, lms = (torch.from_numpy(a) for a in data[0])
    own = port_params(jparams)
    loss, _ = ttl.train_step(own, torch.optim.Adam(ttl.leaves(own), lr=2e-3), imgs, lms)
    np.testing.assert_allclose(loss.item(), losses[0], rtol=TOL)
    ref = port_params(jparams)
    ttl.loss_fn(ref, imgs, lms)[0].backward()
    torch.optim.Adam(ttl.leaves(ref), lr=2e-3).step()
    assert all(torch.equal(a, b) for a, b in zip(ttl.leaves(own), ttl.leaves(ref)))


def test_a_short_cpu_run_writes_an_npz_both_loaders_read(tmp_path, capsys):
    out = str(tmp_path / "lm.npz")
    stats = ttl.main(steps=20, out=out, batch=2, dataset_size=8, val_size=4, log_every=10,
                     device="cpu")
    assert stats["steps"] == 20 and np.isfinite(stats["val_err_px"]) and stats["out"] == out
    printed = capsys.readouterr().out
    assert "step     0" in printed and "step    19" in printed and f"saved -> {out}" in printed
    tp = landmarks.load_landmark_npz(out, "cpu")
    assert_same_tree(tp, jlandmarks.load_landmark_npz(out))
    coords = landmarks.make_landmark_fn(tp, temperature=0.05)(torch.zeros(1, 32, 32, 3))
    assert coords.shape == (1, 68, 2) and torch.isfinite(coords).all()


def test_the_trainer_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttl.main(steps=1, device="cuda")


def test_the_trainer_runs_without_jax(tmp_path):
    """Its module imported and run (2 steps on a small set) where JAX, optax
    and the JAX package cannot be imported; and its command line."""
    out = str(tmp_path / "lm.npz")
    run = run_without_jax("import sys\nfrom morphganformer_tpu_torch.tools import "
                          "train_landmarks as t\na = t.parse_args(sys.argv[1:])\n"
                          "t.main(a.steps, a.out, batch=2, dataset_size=4, val_size=2, "
                          "device=a.device)\n", "2", out, "--device", "cpu")
    assert run.returncode == 0, run.stderr[-3000:]
    assert f"saved -> {out}" in run.stdout
    with np.load(out) as data:
        assert sorted(data.files) == sorted(
            [f"c{i}_{leaf}" for i in range(5) for leaf in ("w", "b")] + ["head_w", "head_b"])


def test_bundled_weights_are_the_port_own_copy_of_jax():
    """The port reads no file of the JAX package's tree: its bundled
    landmark net is a byte copy of JAX's, found by default."""
    path = landmarks.BUNDLED_NPZ
    assert os.path.dirname(path) == os.path.join(os.path.dirname(landmarks.__file__), "weights")
    with open(path, "rb") as a, open(jlandmarks.bundled_landmark_path(), "rb") as b:
        assert a.read() == b.read()
    if not os.environ.get("MGT_LANDMARK_NPZ"):
        assert landmarks.bundled_landmark_path() == path
