"""The port's training loop and its parts (training/loop.py, stats.py,
tensorboard.py, visualize.py, utils/summary.py, checkpoint/async_io.py,
the `train` entry point) against the JAX package on small configs.

The parts: Collector moments, EventWriter bytes under a fixed wall time,
image grids, truncation_cutoff, and the visualisations with carried
weights and JAX's latents (the float images within 2e-4; the noise map
with the same noise handed to both). The loop: two ticks on a folder of
PNGs with the Python feed take JAX's batches, write the run's files and a
snapshot that JAX loads, and resume at the saved cur_nimg with a
bit-equal state; the async backend writes the same train state."""

import contextlib
import dataclasses
import glob
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image

from morphganformer_tpu.checkpoint import io as jio
from morphganformer_tpu.data import dataset as jds
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import init_generator as j_init_generator
from morphganformer_tpu.training import stats as jstats
from morphganformer_tpu.training import tensorboard as jtb
from morphganformer_tpu.training import visualize as jvz
from morphganformer_tpu.utils import image as jimage
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint import load_flax, to_flax
from morphganformer_tpu_torch.checkpoint.async_io import AsyncSnapshotter
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
from morphganformer_tpu_torch.data import native_loader as tnl
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.training import loop as tloop
from morphganformer_tpu_torch.training import stats as tstats
from morphganformer_tpu_torch.training import tensorboard as ttb
from morphganformer_tpu_torch.training import train_step as tts
from morphganformer_tpu_torch.training import visualize as tvz
from morphganformer_tpu_torch.utils import image as timage
from morphganformer_tpu_torch.utils.summary import discriminator_summary, generator_summary

from .test_torch_checkpoint_io import assert_bit_equal, bumped, leaves
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 2e-4
RES = 32


def g_cfg(mod):
    return mod.GANformerConfig(img_resolution=RES, z_dim=8, w_dim=8, k=3, channel_base=256,
                               channel_max=32, end_res=3, mapping=mod.MappingConfig(num_layers=2),
                               attention=mod.AttentionConfig())


def d_cfg(mod):
    return mod.DiscriminatorConfig(img_resolution=RES, channel_base=256, channel_max=64,
                                   mbstd_group_size=2)


# ------------------------------------------------------------ the parts

def test_collector_matches_jax():
    rng = np.random.RandomState(0)
    j, t = jstats.Collector(), tstats.Collector()
    for _ in range(5):
        d = {"Loss/G/loss": np.float32(rng.randn()), "Loss/scores/fake": rng.randn(3)}
        j.report_dict(d)
        t.report_dict({"Loss/G/loss": torch.tensor(d["Loss/G/loss"]),
                       "Loss/scores/fake": torch.from_numpy(d["Loss/scores/fake"])})
    t.report("Loss/D/reg", 2.0)
    j.report("Loss/D/reg", 2.0)
    assert t.names() == j.names()
    for k in j.names():
        assert t.mean(k) == j.mean(k) and t.std(k) == j.std(k)
    assert t.as_dict() == j.as_dict()


def test_collector_reads_device_stats_in_one_copy(monkeypatch):
    """report_dict moves the tensors to the host with one .cpu() and no
    .item() (each would be a synchronisation on the card)."""
    calls = []
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    monkeypatch.setattr(torch.Tensor, "item", lambda self: pytest.fail(".item() called"))
    c = tstats.Collector()
    c.report_dict({"a": torch.tensor(1.5), "b": torch.tensor(-2.0), "c": torch.tensor([1., 3.])})
    assert calls == [(4,)]
    assert (c.mean("a"), c.mean("b"), c.mean("c")) == (1.5, -2.0, 2.0)


def test_event_writer_bytes_match_jax(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1700000000.25)
    for mod, name in ((jtb, "jax"), (ttb, "port")):
        with mod.EventWriter(str(tmp_path / name)) as w:
            w.add_scalars(16, {"Loss/G/loss": 0.5, "Timing/sec_per_tick": 12.75})
            w.add_scalars(32, {"Loss/D/loss": -1.0})
    (fj,), (ft,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert ft == fj
    assert (tmp_path / "port" / ft).read_bytes() == (tmp_path / "jax" / fj).read_bytes()
    assert ttb.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n,rows,cols", [(16, None, None), (5, None, None), (8, 1, 8),
                                         (9, 3, 3)])
def test_image_grid_matches_jax(n, rows, cols):
    imgs = np.random.RandomState(n).uniform(-1.1, 1.1, (n, 6, 5, 3)).astype(np.float32)
    want = np.asarray(jimage.create_img_grid(imgs, rows, cols))
    np.testing.assert_array_equal(timage.create_img_grid(imgs, rows, cols), want)


@pytest.fixture(scope="module")
def carried():
    """The JAX generator, its variables (noise strengths and w_avg moved off
    0) and the port's generator with those weights."""
    model, variables = j_init_generator(g_cfg(jcfg), seed=0)
    variables = jax.device_get(bumped(variables))
    G = load_flax(init_generator(g_cfg(tcfg), seed=1, device="cpu"), variables)
    return model, variables, G


@pytest.mark.parametrize("cutoff", [None, 0, 3, 100])
def test_truncation_cutoff_matches_jax(carried, cutoff):
    model, variables, G = carried
    z = np.random.RandomState(2).randn(2, 3, 8).astype(np.float32)
    apply = jax.jit(model.apply, static_argnames=("truncation_psi", "truncation_cutoff",
                                                  "noise_mode", "return_ws"))
    want_img, want_ws = apply(variables, jnp.asarray(z), truncation_psi=0.5,
                              truncation_cutoff=cutoff, noise_mode="const", return_ws=True)
    with torch.no_grad():
        img, ws = G(z=torch.from_numpy(z), truncation_psi=0.5, truncation_cutoff=cutoff,
                    return_ws=True)
    np.testing.assert_allclose(ws.numpy(), np.asarray(want_ws), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=TOL, atol=TOL)


def _capture(monkeypatch, mod, name):
    seen = []
    real = getattr(mod, name)

    def wrapped(x, *a, **kw):
        seen.append(np.array(x, dtype=np.float32))
        return real(x, *a, **kw)

    monkeypatch.setattr(mod, name, wrapped)
    return seen


def _same_picture(port, jax_pil, floats_t, floats_j):
    (ft,), (fj,) = floats_t, floats_j
    np.testing.assert_allclose(ft, fj, rtol=TOL, atol=TOL)
    assert np.abs(port.astype(int) - np.asarray(jax_pil).astype(int)).max() <= 1


def test_interpolation_grid_matches_jax(carried, monkeypatch):
    model, variables, G = carried
    cfg = g_cfg(jcfg)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    z1, z2 = (np.asarray(jax.random.normal(r, (1, cfg.k, cfg.z_dim))) for r in (r1, r2))
    fj, ft = _capture(monkeypatch, jvz, "create_img_grid"), _capture(monkeypatch, tvz,
                                                                       "create_img_grid")
    want = jvz.interpolation_grid(model, variables, cfg, steps=5)
    got = tvz.interpolation_grid(G, G.cfg, steps=5, z1=z1, z2=z2, batch=2)
    assert got.shape == (RES, 5 * RES, 3)
    _same_picture(got, want, ft, fj)


def test_style_mixing_table_matches_jax(carried, monkeypatch):
    model, variables, G = carried
    cfg = g_cfg(jcfg)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    z_rows = np.asarray(jax.random.normal(r1, (3, cfg.k, cfg.z_dim)))
    z_cols = np.asarray(jax.random.normal(r2, (3, cfg.k, cfg.z_dim)))
    fj, ft = _capture(monkeypatch, jvz, "create_img_grid"), _capture(monkeypatch, tvz,
                                                                       "create_img_grid")
    want = jvz.style_mixing_table(model, variables, cfg)
    got = tvz.style_mixing_table(G, G.cfg, z_rows=z_rows, z_cols=z_cols, batch=4)
    assert got.shape == (3 * RES, 3 * RES, 3)
    _same_picture(got, want, ft, fj)


def test_noise_variance_map_matches_jax(carried, monkeypatch):
    """Both sides draw their per-layer noise in the same order; the test
    hands the n-th draw of each side the same numpy array."""
    model, variables, G = carried
    cfg = g_cfg(jcfg)
    z = np.random.RandomState(5).randn(1, cfg.k, cfg.z_dim).astype(np.float32)
    draws = {"jax": 0, "port": 0}

    def noise(side, shape):
        n = draws[side]
        draws[side] += 1
        return np.random.RandomState(100 + n).randn(*shape[:3]).astype(np.float32)

    real_randn, real_normal = torch.randn, jax.random.normal

    def jax_normal(key, shape, *a, **kw):       # JAX's noise: [N, R, R, 1]
        if len(shape) == 4 and shape[3] == 1 and shape[1] == shape[2]:
            return jnp.asarray(noise("jax", shape)).reshape(shape)
        return real_normal(key, shape, *a, **kw)

    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    fj, ft = _capture(monkeypatch, jvz, "to_pil"), _capture(monkeypatch, tvz, "to_uint8")
    want = jvz.noise_variance_map(model, variables, cfg, z=jnp.asarray(z), samples=4)
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: (
        torch.from_numpy(noise("port", shape)) if len(shape) == 3 else real_randn(shape, **kw)))
    got = tvz.noise_variance_map(G, G.cfg, z=z, samples=4)
    assert draws["jax"] == draws["port"] > 4
    assert got.shape == (RES, RES, 3) and float(ft[0].max()) == 1.0
    _same_picture(got, want, ft, fj)


def test_attention_blends_are_refused():
    """A generator without attention layers has no maps to blend (JAX's
    fails inside numpy on its zeros([1]))."""
    cfg = dataclasses.replace(g_cfg(tcfg), end_res=2)
    with pytest.raises(ValueError, match="attention layers"):
        tvz.attention_blends(None, cfg)


def test_module_summaries_list_the_modules(carried):
    _, _, G = carried
    from morphganformer_tpu_torch.models.discriminator import init_discriminator

    text = generator_summary(G) + discriminator_summary(init_discriminator(d_cfg(tcfg),
                                                                          device="cpu"))
    assert "mapping" in text and "synthesis.b32" in text and "b4" in text
    assert f"1x{RES}x{RES}x3" in text
    assert f"Total: {sum(p.numel() for p in G.parameters()):,} parameters" in text


# ------------------------------------------------------------ the loop

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("traindata")
    (root / str(RES)).mkdir()
    rng = np.random.RandomState(0)
    for i in range(12):
        Image.fromarray((rng.rand(RES, RES, 3) * 255).astype(np.uint8)).save(
            root / str(RES) / f"{i:04d}.png")
    return str(root)


def run_loop(run_dir, data_root, max_ticks, resume=None, **kw):
    """training_loop on the CPU; returns (state, its stdout, the batches
    that reached train_iteration)."""
    seen = []
    real = tts.GANTrainer.train_iteration

    def recording(self, state, real_img, step, z=None):
        seen.append(real_img.numpy().copy())
        return real(self, state, real_img, step, z)

    l_cfg = tloop.LoopConfig(run_dir=run_dir, total_kimg=1, kimg_per_tick=0.008,
                             snapshot_ticks=1, **{"img_snapshot_ticks": 0, **kw})
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(tts.GANTrainer, "train_iteration", recording)
        mp.setattr(tnl, "native_available", lambda: False)      # the Python feed
        state = tloop.training_loop(g_cfg(tcfg), d_cfg(tcfg), tts.TrainConfig(batch_size=4),
                                    l_cfg, data_root, resume=resume, max_ticks=max_ticks,
                                    device="cpu")
    return state, out.getvalue(), seen


@pytest.fixture(scope="module")
def two_ticks(data_root, tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("loop") / "run")
    state, out, seen = run_loop(run_dir, data_root, 2, img_snapshot_ticks=1,
                                vis=("grid", "interp", "mixing"))
    return run_dir, state, out, seen


def test_two_ticks_write_the_run(two_ticks):
    run_dir, state, out, seen = two_ticks
    assert state.cur_nimg == 16 and len(seen) == 4
    assert "python feed: the native loader is unavailable" in out
    assert "feed: python" in out and out.count("snapshot ") == 2
    lines = [json.loads(line) for line in open(os.path.join(run_dir, "stats.jsonl"))]
    assert [(e["tick"], e["kimg"]) for e in lines] == [(1, 0.008), (2, 0.016)]
    assert lines[0]["Loss/G/reg"]["num"] == 1 and "Loss/G/reg" not in lines[1]
    assert all(np.isfinite(e["Loss/D/loss"]["mean"]) for e in lines)
    assert len(glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))) == 1
    assert os.path.getsize(glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))[0]) > 100
    for name in ("fakes000000.png", "vis000000/interpolation.png",
                 "vis000000/style_mixing.png", "module_summary.txt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert timage.read_png(os.path.join(run_dir, "fakes000000.png")).shape == (4 * RES,
                                                                               4 * RES, 3)
    opts = json.load(open(os.path.join(run_dir, "training_options.json")))
    assert opts["G"] == json.loads(g_cfg(tcfg).to_json()) and opts["train"]["batch_size"] == 4
    assert opts["loop"]["snapshot_backend"] == "msgpack" and opts["loop"]["seed"] == 0
    snap, = glob.glob(os.path.join(run_dir, "network-snapshot-*"))
    assert sorted(os.listdir(snap)) == ["D.msgpack", "G.msgpack", "Gs.msgpack", "arch.json",
                                        "train_state.msgpack"]


def test_loop_feeds_the_jax_batches(data_root, two_ticks):
    _, _, _, seen = two_ticks
    jb = jds.infinite_batches(jds.ImageFolderDataset(data_root, RES), 4, seed=0)
    for got in seen:
        assert got.tobytes() == next(jb)[0].tobytes()


def test_snapshot_loads_in_jax(two_ticks):
    run_dir, state, _, _ = two_ticks
    snap = tloop.latest_snapshot(run_dir)
    for role, net in (("G", state.G), ("Gs", state.G_ema)):
        cfg, model, variables = jio.load_generator(snap, role=role)
        assert_bit_equal(jax.device_get(variables), to_flax(net))
    z = np.random.RandomState(0).randn(1, 3, 8).astype(np.float32)
    img = jax.jit(lambda v, zz: model.apply(v, zz, noise_mode="const"))(variables, jnp.asarray(z))
    with torch.no_grad():
        want = state.G_ema(z=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(np.asarray(img), want, rtol=TOL, atol=TOL)
    _, _, dv = jio.load_discriminator(snap)
    assert_bit_equal(jax.device_get(dv), to_flax(state.D))


def test_train_state_round_trips_bit_for_bit(two_ticks):
    """The saved tree is the in-memory state; loading it into a fresh state
    gives the same tree; flax reads the file."""
    run_dir, state, _, _ = two_ticks
    path = os.path.join(tloop.latest_snapshot(run_dir), "train_state.msgpack")
    data = open(path, "rb").read()
    saved = msgpack_restore(data)
    tree = tloop.train_state_tree(state)
    assert_bit_equal(saved, tree)
    # Adam steps: G_main at each of the 4 steps and G_reg at step 0.
    assert saved["cur_nimg"] == 16 and saved["g_opt"]["step"]["params"]["pos"] == 5
    assert_bit_equal(serialization.msgpack_restore(data), tree)

    trainer = tts.GANTrainer(g_cfg(tcfg), d_cfg(tcfg), tts.TrainConfig(batch_size=4),
                             device="cpu")
    fresh = tloop.load_train_state(path, trainer.init_state(seed=3))
    assert fresh.cur_nimg == 16
    assert_bit_equal(tloop.train_state_tree(fresh), tree)
    assert set(leaves(tree["g_opt"]["exp_avg"])) == {
        "params/" + k.replace(".", "/") for k, _ in state.G.named_parameters()}


def test_auto_resume_continues_from_the_snapshot(data_root, two_ticks, tmp_path):
    """A resumed run starts at the saved cur_nimg and restarts its batches
    (and draws) from the seed."""
    run_dir, _, _, _ = two_ticks
    resumed = str(tmp_path / "resumed")
    os.makedirs(resumed)
    snap = tloop.latest_snapshot(run_dir)
    os.system(f"cp -r {snap} {resumed}/")
    state, out, seen = run_loop(resumed, data_root, 1, resume="auto")
    assert f"at cur_nimg 16" in out and state.cur_nimg == 24 and len(seen) == 2
    jb = jds.infinite_batches(jds.ImageFolderDataset(data_root, RES), 4, seed=0)
    assert seen[0].tobytes() == next(jb)[0].tobytes()
    stats = [json.loads(line) for line in open(os.path.join(resumed, "stats.jsonl"))]
    assert [e["tick"] for e in stats] == [3]
    assert "Loss/G/reg" in stats[0]       # step 4 runs G_reg


def test_async_backend_round_trip(data_root, tmp_path):
    run_dir = str(tmp_path / "async")
    state, out, _ = run_loop(run_dir, data_root, 1, snapshot_backend="async")
    snap = tloop.latest_snapshot(run_dir)
    assert_bit_equal(msgpack_restore(open(os.path.join(snap, "train_state.msgpack"),
                                          "rb").read()), tloop.train_state_tree(state))
    state2, out2, _ = run_loop(run_dir, data_root, 1, resume="auto", snapshot_backend="async")
    assert "at cur_nimg 8" in out2 and state2.cur_nimg == 16


def test_async_snapshotter_raises_a_failed_write(tmp_path):
    s = AsyncSnapshotter()
    s.save(str(tmp_path / "missing_dir"), {"a": np.ones(2, np.float32)})
    with pytest.raises(FileNotFoundError):
        s.wait()
    os.makedirs(tmp_path / "snap")
    s.save(str(tmp_path / "snap"), {"a": np.ones(2, np.float32)})
    tree = s.restore(str(tmp_path / "snap"))
    np.testing.assert_array_equal(tree["a"], np.ones(2, np.float32))
    s.close()


def test_prune_keeps_the_newest(tmp_path):
    for kimg in (0, 4, 12, 100, 40):
        os.makedirs(tmp_path / f"network-snapshot-{kimg:06d}")
    tloop.prune_snapshots(str(tmp_path), 2)
    assert sorted(os.listdir(tmp_path)) == ["network-snapshot-000040", "network-snapshot-000100"]
    tloop.prune_snapshots(str(tmp_path), 0)
    assert len(os.listdir(tmp_path)) == 2
    assert tloop.latest_snapshot(str(tmp_path)).endswith("network-snapshot-000100")


@pytest.mark.parametrize("change,error,match", [
    ({"eval_metrics": ("fid50k_full", "fid99")}, ValueError, "unknown metric"),
    ({"vis": ("grid", "attention"), "G": {"end_res": 2}}, ValueError,
     "attention layers"),
    ({"vis": ("grid", "video")}, ValueError, "unknown vis"),
    ({"snapshot_backend": "orbax"}, ValueError, '"async"'),
])
def test_loop_refuses_what_it_cannot_do(data_root, tmp_path, change, error, match):
    change = dict(change)
    g = dataclasses.replace(g_cfg(tcfg), **change.pop("G", {}))
    l_cfg = dataclasses.replace(tloop.LoopConfig(run_dir=str(tmp_path)), **change)
    with pytest.raises(error, match=match):
        tloop.training_loop(g, d_cfg(tcfg), tts.TrainConfig(batch_size=4), l_cfg,
                            data_root, device="cpu")


TRAIN_FLAGS = ["train", "--resolution", str(RES), "--components-num", "2", "--latent-size", "16",
               "--channel-base", "256", "--channel-max", "32", "--end-res", "3",
               "--batch", "4", "--device", "cpu", "--ganformer-default"]


@pytest.mark.parametrize("flags,want", [
    pytest.param(["--multihost"], (None, None, None, True), id='flags0-"Parallel"'),
    pytest.param(["--coordinator", "localhost:1234"], ("localhost:1234", None, None, False),
                 id='flags1-"Parallel"'),
    pytest.param(["--num-processes", "2"], (None, 2, None, False), id='flags2-"Parallel"'),
    pytest.param(["--process-id", "0"], (None, None, 0, False), id='flags3-"Parallel"'),
])
def test_train_entry_point_refuses_flags(tmp_path, monkeypatch, flags, want):
    """Each of JAX's group flags reaches initialize_distributed as JAX's
    cli/train.py passes it: (coordinator, num_processes, process_id,
    requested=multihost)."""
    calls = []

    class Joined(Exception):
        pass

    def initialize_distributed(*args, **kwargs):
        calls.append((*args, kwargs["requested"]))
        raise Joined

    monkeypatch.setattr(cli, "initialize_distributed", initialize_distributed)
    with pytest.raises(Joined):
        cli.main(TRAIN_FLAGS + ["--data-dir", str(tmp_path), "--result-dir", str(tmp_path)]
                 + flags)
    assert calls == [want]


def test_train_entry_point_runs_and_resumes(data_root, tmp_path, capsys):
    flags = TRAIN_FLAGS + ["--data-dir", data_root, "--result-dir", str(tmp_path),
                           "--expname", "e", "--kimg-per-tick", "0.004", "--max-ticks", "1",
                           "--img-snapshot-ticks", "0"]
    cli.main(flags)
    cli.main(flags)
    out = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["e-000", "e-001"]
    assert "auto-resume from" in out and "at cur_nimg 4" in out
    opts = json.load(open(tmp_path / "e-001" / "training_options.json"))
    assert opts["G"]["k"] == 3 and opts["G"]["z_dim"] == 8
    assert opts["train"]["loss"]["r1_gamma"] == 10
    state = msgpack_restore(open(tmp_path / "e-001" / "network-snapshot-000000" /
                                 "train_state.msgpack", "rb").read())
    assert state["cur_nimg"] == 8
