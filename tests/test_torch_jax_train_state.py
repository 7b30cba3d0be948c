"""Resume from the JAX package's train state: its train_state.msgpack (the
tree of its loop's `save_train_state`: g, d, gs_params, gs_stats, optax's
Adam states, pl_mean, cur_nimg) read by the port, converted by
checkpoint/convert.py `from_jax_train_state`, written back by
`to_jax_train_state` for JAX's `load_train_state`, and two iterations
resumed from one file on either side.

The trainers are the small pair of tests/test_torch_train_step.py with
randomness off (z given); the JAX state has taken one full iteration at
step 0 (every stage), so both Adams hold moments and a count, and pl_mean
and w_avg have moved."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from morphganformer_tpu.checkpoint.orbax_io import AsyncSnapshotter as JaxOrbaxSnapshotter
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.training import loop as jloop
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch.checkpoint import (
    from_jax_train_state,
    is_jax_train_state,
    to_jax_train_state,
)
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore, msgpack_serialize
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.training import loop as tloop
from morphganformer_tpu_torch.training import loss as tloss
from morphganformer_tpu_torch.training import train_step as tts

from .test_torch_checkpoint_io import assert_bit_equal, leaves
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_parallel import assert_trees_close
from .test_torch_train_step import _cfgs

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _train_cfg(mod, loss_mod):
    return mod.TrainConfig(batch_size=4, batch_gpu=4, loss=loss_mod.LossConfig(style_mixing=0.0))


def _jax_snapshot(tmp_path_factory, local_noise):
    jg, jd = _cfgs(jcfg)
    trainer = jts.GANTrainer(dataclasses.replace(jg, local_noise=local_noise), jd,
                             _train_cfg(jts, jloss))
    state = trainer.init_state(seed=0)
    real = jax.random.normal(jax.random.PRNGKey(3), (4, 16, 16, 3))
    state, _ = trainer.train_iteration(state, real, jax.random.PRNGKey(1), step=0)
    snap = tmp_path_factory.mktemp("jaxsnap") / "network-snapshot-000000"
    snap.mkdir()
    jloop.save_train_state(str(snap / "train_state.msgpack"), state)
    return trainer, jax.device_get(state), str(snap)


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """(JAX trainer, its state after one iteration at step 0 on the host,
    the snapshot directory holding JAX's train_state.msgpack)."""
    return _jax_snapshot(tmp_path_factory, local_noise=False)


@pytest.fixture(scope="module")
def jax_file_noise(tmp_path_factory):
    """`jax_file` with G's local noise on: g carries the const-noise
    buffers that JAX's Gs takes from g."""
    return _jax_snapshot(tmp_path_factory, local_noise=True)


def _port_state(seed=3, local_noise=False):
    tg, td = _cfgs(tcfg)
    trainer = tts.GANTrainer(dataclasses.replace(tg, local_noise=local_noise), td,
                             _train_cfg(tts, tloss), device="cpu")
    return trainer, trainer.init_state(seed=seed)


def _opt_leaves(opt, net):
    """{name: (step, exp_avg, exp_avg_sq)} of a torch Adam's state."""
    out = {}
    for name, p in net.named_parameters():
        st = opt.state[p]
        out[name.replace(".", "/")] = (float(st["step"]), st["exp_avg"].numpy(),
                                       st["exp_avg_sq"].numpy())
    return out


def test_port_reads_jax_train_state(jax_file_noise):
    """JAX's file, loaded into a port state made from other weights, leaf by
    leaf: G, D, the EMA G (gs_params, gs_stats and g's noise buffers), both
    Adams (mu, nu and the one count as every parameter's step), pl_mean and
    cur_nimg."""
    _, jstate, snap = jax_file_noise
    _, state = _port_state(local_noise=True)
    tloop.load_train_state(os.path.join(snap, "train_state.msgpack"), state)
    got = tloop.train_state_tree(state)
    assert_bit_equal(got["G"], jstate["g"])
    assert_bit_equal(got["D"], jstate["d"])
    assert "buffers" in jstate["g"]
    assert_bit_equal(got["G_ema"], {"params": jstate["gs_params"],
                                    "moving_stats": jstate["gs_stats"],
                                    "buffers": jstate["g"]["buffers"]})
    for opt, net, key in ((state.g_opt, state.G, "g_opt"), (state.d_opt, state.D, "d_opt")):
        mu, nu = leaves(jstate[key][0].mu), leaves(jstate[key][0].nu)
        count = int(jstate[key][0].count)
        assert count > 0
        ours = _opt_leaves(opt, net)
        assert sorted(ours) == sorted(mu)
        for name, (step, exp_avg, exp_avg_sq) in ours.items():
            assert step == count
            assert exp_avg.tobytes() == mu[name].tobytes(), name
            assert exp_avg_sq.tobytes() == nu[name].tobytes(), name
    assert float(state.pl_mean) == float(jstate["pl_mean"]) != 0.0
    assert state.cur_nimg == int(jstate["cur_nimg"]) == 4


def test_round_trip_back_to_jax(jax_file_noise, tmp_path):
    """to_jax_train_state of the port's tree, written by the port's msgpack
    writer, read by JAX's load_train_state: every leaf bit-equal to JAX's
    own state; and the tree converts back to the port's unchanged."""
    trainer, jstate, snap = jax_file_noise
    _, state = _port_state(local_noise=True)
    tloop.load_train_state(os.path.join(snap, "train_state.msgpack"), state)
    tree = tloop.train_state_tree(state)
    back = to_jax_train_state(tree)
    assert is_jax_train_state(back) and not is_jax_train_state(tree)
    path = tmp_path / "train_state.msgpack"
    path.write_bytes(msgpack_serialize(back))
    template = jax.device_get(trainer.init_state(seed=5))
    loaded = jloop.load_train_state(str(path), template)
    flat_j = jax.tree_util.tree_leaves_with_path(jstate)
    flat_l = dict(jax.tree_util.tree_leaves_with_path(loaded))
    assert len(flat_j) == len(flat_l) > 100
    for key, want in flat_j:
        got = np.asarray(flat_l[key])
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key
    assert_bit_equal(from_jax_train_state(msgpack_restore(path.read_bytes())), tree)


def test_fresh_state_round_trips():
    """A port state before any step (no Adam state) goes to JAX's layout
    with count 0 and zero moments, and back to no Adam state."""
    _, state = _port_state()
    tree = tloop.train_state_tree(state)
    back = to_jax_train_state(tree)
    assert int(back["g_opt"]["0"]["count"]) == 0
    assert all(not np.any(v) for v in leaves(back["d_opt"]["0"]["mu"]).values())
    assert_bit_equal(from_jax_train_state(back), tree)


def test_resume_from_jax_file_matches_jax(jax_file):
    """Two iterations (steps 1 and 2: G_main, D_main and the EMA) resumed
    from the one JAX file, on JAX and on the port, on the same z and reals:
    G, D, the EMA G and both Adams' moments, each leaf within its tolerance
    against its own largest entry (test_torch_parallel's
    `assert_trees_close`)."""
    jtrainer, jstate, snap = jax_file
    template = jax.device_get(jtrainer.init_state(seed=5))
    js = jloop.load_train_state(os.path.join(snap, "train_state.msgpack"), template)
    js = jax.tree_util.tree_map(jnp.asarray, js)
    trainer, state = _port_state()
    tloop.load_train_state(os.path.join(snap, "train_state.msgpack"), state)
    rng = np.random.RandomState(11)
    for step in (1, 2):
        z = rng.randn(1, 4, 3, 8).astype(np.float32)
        real = rng.randn(1, 4, 16, 16, 3).astype(np.float32)
        js, _ = jtrainer.g_main_step(js, jnp.asarray(z), None, jax.random.PRNGKey(step))
        js, _ = jtrainer.d_main_step(js, jnp.asarray(real), jnp.asarray(z), None,
                                     jax.random.PRNGKey(step))
        trainer.train_iteration(state, torch.from_numpy(real[0]), step,
                                z=torch.from_numpy(z[0]))
    js = jax.device_get(js)
    got = leaves(tloop.train_state_tree(state))
    want = leaves(from_jax_train_state(serialization.to_state_dict(js)))
    for tree in (got, want):
        tree.pop("cur_nimg")
    assert int(js["cur_nimg"]) == state.cur_nimg == 12
    assert assert_trees_close(got, want) > 100


def _data(root, res=16):
    os.makedirs(os.path.join(root, str(res)))
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray((rng.rand(res, res, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, str(res), f"{i:04d}.png"))
    return root


def test_training_loop_resumes_jax_snapshot(jax_file, tmp_path):
    """training_loop(resume=<JAX snapshot>) starts from JAX's state (here at
    its total, so it only resumes and snapshots); a JAX Orbax snapshot is
    refused by name."""
    _, jstate, snap = jax_file
    tg, td = _cfgs(tcfg)
    l_cfg = tloop.LoopConfig(run_dir=str(tmp_path / "run"), total_kimg=0.004,
                             img_snapshot_ticks=0, tensorboard=False)
    state = tloop.training_loop(tg, td, _train_cfg(tts, tloss), l_cfg,
                                _data(str(tmp_path / "data")), resume=snap, device="cpu")
    assert state.cur_nimg == 4
    assert_bit_equal(tloop.train_state_tree(state)["G"], jstate["g"])

    orbax = tmp_path / "orbax-snapshot"
    saver = JaxOrbaxSnapshotter()
    saver.save(str(orbax), jstate)
    saver.close()
    assert os.path.isdir(orbax / "orbax")
    with pytest.raises(ValueError, match="Orbax"):
        tloop.resume_train_state(str(orbax), _port_state()[1])
