"""The port's data parallelism on torch.distributed (parallel/, the trainer
under a mesh, the minibatch-std across ranks, the stats' all-reduce),
multi-process on gloo: each rank is a subprocess of
tests/torch_parallel_workers.py that meets the others at a free localhost
port, with a timeout of its own (as tests/test_parallel.py runs JAX's
rendezvous).

The training cases hold the small pair of tests/test_torch_train_step.py
with randomness off and z given, D's b16 on the fused ops (their plain
versions on the CPU) and the path-length noise a function of each row's z
(`torch_parallel_workers.patched`). Each leaf is held to its own largest
entry (`assert_trees_close`): the parameters within 1e-5 of it plus a
thousandth of one Adam step, the Adam moments within the train-step
tests' gradient tolerance. The ranks' gradients are averaged in another
order than one process sums them, and Adam's steps, lr * g / (|g| + eps),
carry the rounding of a gradient element that sums terms of opposite
sign into the parameter at lr's scale."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models import discriminator as jdisc
from morphganformer_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint.convert import to_flax
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_serialize
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.parallel import (
    data_sharding,
    free_port,
    initialize_distributed,
    is_main_process,
    make_data_mesh,
)

from . import torch_parallel_workers as workers
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_reg import _adam_moves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))


def run_ranks(case, work, world=2):
    """Start `world` ranks of `case`; each must end with code 0 within the
    timeout (a rank still running then is killed and the test fails)."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_workers", case,
                               str(r), str(world), str(port), str(work)],
                              cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{err[-3000:]}"
    return [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(world)]


GRAD_TOL = 1e-4


def adam_moves(grads, lr, b2, floors, eps=1e-8):
    """Per element, the most that the Adam steps (beta1 0) of one or two
    stages can move a parameter between two runs whose stage gradients
    each differ by up to twice the gradient tolerance, GRAD_TOL of the
    leaf's largest entry floored at `floors[stage]` of the stage's largest
    (test_torch_reg's `_check_grads`): test_torch_reg's `_adam_moves`, or
    its first step alone. `grads` maps each parameter path to its list of
    stage gradients (this run's)."""
    tops = [max(float(np.abs(g[s]).max()) for g in grads.values())
            for s in range(len(next(iter(grads.values()))))]
    out = {}
    for path, gs in grads.items():
        gs = [np.asarray(g, np.float64) for g in gs]
        ds = [GRAD_TOL * max(float(np.abs(g).max()), floor * top)
              for g, top, floor in zip(gs, tops, floors)]
        if len(gs) == 2:
            out[path] = _adam_moves(gs[0], gs[1], lr, b2, ds[0], ds[1], eps)
        else:
            u = lambda a: a / (np.abs(a) + eps)                             # noqa: E731
            out[path] = lr * (u(gs[0] + 2 * ds[0]) - u(gs[0] - 2 * ds[0]))
    return out


def _leaf_tolerances(want, tol, lr, grad_floor, moves):
    """Each leaf's tolerance (a number, or an array of one per element),
    against its own largest entry:
    - the nets' and the EMA copy's leaves: tol * max|leaf| plus a
      thousandth of one Adam step (lr), since an Adam step of a gradient
      element that sums terms of opposite sign carries that element's
      rounding into the parameter at lr's scale; with `moves`
      ({"g"|"d": {path: array}}), plus the most the Adam steps can move
      each element within the gradient tolerance (`adam_moves`);
    - the Adam moments: GRAD_TOL * max|leaf| (twice it for exp_avg_sq, a
      square), that floored at `grad_floor[optimizer]` of the optimizer's
      largest (test_torch_reg's `_check_grads` floors at 1e-3 against JAX,
      at 1.0 for R1); their step counts exactly;
    - pl_mean: tol of itself.
    A parameter whose gradient is rounding noise on both sides (its
    exp_avg_sq at most 1e-12 of its optimizer's largest: a gradient a
    millionth of the net's largest, as of a bias added to every key before
    a softmax over the keys) takes, from that noise's sign, Adam steps of
    +-lr that two summation orders need not share: its moments must be
    that noise on both sides ("noise"), and its values are not compared
    (None)."""
    top = {(opt, m): max(float(np.abs(v).max()) for k, v in want.items()
                         if k.startswith(f"{opt}/{m}/"))
           for opt in ("g_opt", "d_opt") for m in ("exp_avg", "exp_avg_sq")}

    def noise(opt, path):
        key = f"{opt}/exp_avg_sq/params/{path}"
        return key in want and float(np.abs(want[key]).max()) <= 1e-12 * top[opt, "exp_avg_sq"]

    out = {}
    for key, w in want.items():
        parts = key.split("/")
        scale = float(np.abs(w).max())
        if parts[0] in ("g_opt", "d_opt") and parts[1] == "step":
            out[key] = ("value", 0.0)
        elif parts[0] in ("g_opt", "d_opt"):
            if noise(parts[0], "/".join(parts[3:])):
                out[key] = ("noise", 1e-12 * top[parts[0], "exp_avg_sq"]
                            if parts[1] == "exp_avg_sq"
                            else 1e-6 * np.sqrt(top[parts[0], "exp_avg_sq"]))
            else:
                k = 2 if parts[1] == "exp_avg_sq" else 1
                floor = grad_floor.get(parts[0], 0.0)
                out[key] = ("moment", k * GRAD_TOL * max(scale, floor * top[parts[0], parts[1]]))
        elif parts[0] == "pl_mean":
            out[key] = ("value", tol * scale)
        else:
            net = "d" if parts[0] == "D" else "g"
            path = "/".join(parts[2:])
            if parts[1] == "params" and noise(net + "_opt", path):
                out[key] = ("noise", None)
            else:
                extra = moves[net][path] if moves is not None and parts[1] == "params" else 0.0
                out[key] = ("value", tol * scale + 1e-3 * lr + extra)
    return out


def assert_trees_close(got, want, lr=0.002, tol=1e-5, grad_floor=None, moves=None):
    """Every leaf of `want` in `got` within its tolerance
    (`_leaf_tolerances`); a noise leaf's moments bounded on both sides.
    The message names the worst leaves by error over tolerance. Returns
    the number of leaves whose values were compared."""
    tols = _leaf_tolerances(want, tol, lr, grad_floor or {}, moves)
    ratios = []
    for key, w in want.items():
        assert key in got, key
        kind, bound = tols[key]
        if bound is None:
            continue
        g = np.asarray(got[key], np.float64)
        if kind == "noise":
            err = np.maximum(np.abs(g), np.abs(w))
        else:
            err = np.abs(g - w)
        ratio = np.where(err == 0, 0.0, err / np.maximum(bound, 1e-300))
        ratios.append((float(ratio.max()), key, float(err.max())))
    ratios.sort(reverse=True)
    assert ratios[0][0] <= 1.0, f"worst leaves (error / tolerance, leaf, error): {ratios[:5]}"
    return sum(1 for r in ratios if tols[r[1]][0] != "noise")


def test_initialize_distributed_is_a_no_op_unless_asked(monkeypatch):
    monkeypatch.delenv("MGT_MULTIHOST", raising=False)
    assert initialize_distributed(device="cpu") == 0
    assert initialize_distributed(num_processes=1, device="cpu") == 0
    assert not torch.distributed.is_initialized() and is_main_process()
    mesh = make_data_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.devices) == (1, 0, (torch.device("cpu"),))
    with pytest.raises(ValueError, match="needs 2 processes|as many processes"):
        make_data_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("localhost:1", device="cpu")
    x = torch.arange(6.0)
    assert data_sharding(mesh, x) is x


def test_two_rank_rendezvous(tmp_path):
    """Two processes meet through initialize_distributed: the gate is true
    on rank 0 only, a cross-rank sum is right and the mesh spans both."""
    outs = run_ranks("rendezvous", tmp_path)
    for r, out in enumerate(outs):
        assert out["rank"] == out["mesh_rank"] == r
        assert out["main"] == (r == 0)
        assert out["sum"] == 3.0 and out["world"] == 2
        assert out["devices"] == ["cpu", "cpu"]


def _spawn(fn_name, work):
    code = ("import sys; from morphganformer_tpu_torch.parallel import spawn_local; "
            f"from tests.torch_parallel_workers import {fn_name}; "
            f"spawn_local({fn_name}, 2, 'gloo', args=(sys.argv[1],), timeout_s=60)")
    return subprocess.run([sys.executable, "-c", code, str(work)], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def test_spawn_local_two_processes(tmp_path):
    """spawn_local(nprocs=2) on gloo: both ranks run the function in one
    group at a free port."""
    out = _spawn("spawned", tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    for r in (0, 1):
        got = json.load(open(tmp_path / f"spawn{r}.json"))
        assert got["rank"] == r and got["main"] == (r == 0) and got["sum"] == 3.0


def test_spawn_local_raises_when_a_rank_raises(tmp_path):
    """A rank that raises takes its group down: rank 0, waiting in a
    collective, fails or is ended, and spawn_local raises (the first error
    it sees: rank 1's, or rank 0's collective losing its peer)."""
    out = _spawn("spawned_failing", tmp_path)
    assert out.returncode != 0
    assert "ProcessRaisedException" in out.stderr, out.stderr[-3000:]


def test_collector_all_reduces_its_moments(tmp_path):
    outs = run_ranks("collector", tmp_path)
    values = {"Loss/G/loss": [float(np.float32(r + i / 10)) for r in (0, 1)
                              for i in range(r + 2)],
              "Loss/D/loss": [float(r * i) for r in (0, 1) for i in range(r + 2)]}
    line = json.loads(open(tmp_path / "stats.jsonl").read().splitlines()[0])
    for out in outs:
        for name, v in values.items():
            assert out[name]["num"] == len(v) == line[name]["num"]
            np.testing.assert_allclose(out[name]["mean"], np.mean(v), rtol=1e-12)
            np.testing.assert_allclose(out[name]["std"], np.std(v), rtol=1e-9)
            np.testing.assert_allclose(line[name]["mean"], np.mean(v), rtol=1e-12)


def test_minibatch_std_across_ranks_matches_jax(tmp_path):
    """The 2-rank layer forms JAX's strided groups over the global batch:
    value and input gradient against JAX's minibatch_std within 1e-6."""
    rng = np.random.RandomState(4)
    x = rng.randn(8, 4, 4, 6).astype(np.float32)
    cot = rng.randn(8, 4, 4, 8).astype(np.float32)
    np.savez(tmp_path / "mbstd.npz", x=x, cot=cot, group=4, channels=2)
    run_ranks("mbstd", tmp_path)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    want, vjp = jax.vjp(lambda v: jdisc.minibatch_std(v, 4, 2), jnp.asarray(x))
    want_grad, = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g["grad"] for g in got]),
                               np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    # Per-rank groups (the reference DDP's) would give other values.
    local = tdisc.minibatch_std(torch.from_numpy(x[:4]), 4, 2).numpy()
    assert np.abs(local - got[0]["y"]).max() > 1e-3


def flat(tree, prefix):
    """A JAX tree's leaves by their "/"-joined paths under `prefix`."""
    return {"/".join(((prefix,) if prefix else ()) + tuple(str(getattr(k, "key", k))
                                                            for k in path)): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _write_batch(work, steps, pl_batch_shrink, seed=0, pl_noise=None):
    """<work>/batch.npz: the global z and reals of each step, the
    path-length noise of JAX's rows of the global microbatch (seeded unless
    given) and the shrink."""
    rng = np.random.RandomState(seed)
    n = len(steps)
    z = rng.randn(n, 4, 3, 8).astype(np.float32)
    real = rng.randn(n, 4, 16, 16, 3).astype(np.float32)
    if pl_noise is None:
        pl_noise = (rng.randn(max(4 // pl_batch_shrink, 1), 16, 16, 3) / 16).astype(np.float32)
    np.savez(work / "batch.npz", z=z, real=real, pl_noise=pl_noise, steps=np.asarray(steps),
             pl_batch_shrink=pl_batch_shrink)
    return z, real


def _assert_ranks_agree(work):
    """Every leaf bit-equal across the ranks (they start from one broadcast
    and apply the same averaged gradients)."""
    a, b = (np.load(work / f"rank{r}.npz") for r in (0, 1))
    assert set(a.files) == set(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    return {k: a[k] for k in a.files}


@pytest.mark.parametrize("pl_batch_shrink", [1, 2, 3])
def test_two_rank_training_matches_one_rank(tmp_path, pl_batch_shrink):
    """Two iterations (the first with G_reg and D_reg due) at world 2 against
    world 1 on the same global batch of 4: G, D, the EMA copy, both Adams'
    moments and pl_mean within each leaf's tolerance (`assert_trees_close`).
    The path length takes JAX's rows of the global microbatch: at shrink 1
    both ranks' 2 rows, at 2 rank 0's 2 rows and none of rank 1's, at 3 the
    first of rank 0's."""
    g_cfg, d_cfg = workers.small_cfgs(tcfg)
    G = init_generator(g_cfg, seed=3, device="cpu")
    with torch.no_grad():
        G.mapping.w_avg.add_(0.3)
    D = tdisc.init_discriminator(d_cfg, seed=4, device="cpu")
    (tmp_path / "pair.msgpack").write_bytes(msgpack_serialize({"g": to_flax(G),
                                                               "d": to_flax(D)}))
    _write_batch(tmp_path, (0, 1), pl_batch_shrink)
    stats = run_ranks("train", tmp_path)
    assert all(np.isfinite(v) for s in stats for v in s.values())
    got = _assert_ranks_agree(tmp_path)
    want, _ = workers.run_iterations(str(tmp_path), None)
    assert set(got) == set(want)
    assert any(k.startswith("g_opt/exp_avg/") for k in want)
    assert assert_trees_close(got, want) > 100
    assert float(want["pl_mean"]) != 0.0


@pytest.mark.parametrize("step,pl_batch_shrink", [(1, 1), (0, 2)])
def test_two_rank_step_matches_jax_data_mesh(tmp_path, step, pl_batch_shrink):
    """One JAX GANTrainer iteration on a 2-device data mesh against the
    port's 2 ranks on the same weights, z and reals: G, D, the EMA copy,
    w_avg, pl_mean and both Adams' moments (the gradients they took) within
    each leaf's tolerance (`assert_trees_close`) at the train-step tests'
    tolerance against JAX: the gradients within 1e-4 of their leaf's
    largest entry floored at 1e-3 of the stage's, the parameters within
    1e-5 of theirs plus what the Adam steps can make of that (one element
    can be as far off as the same stages are on one device). Step 1 runs
    G_main and D_main with the EMA; step 0 G_reg and D_reg as well, at the
    default shrink, where the path length takes the first 2 rows of JAX's
    global microbatch (all on rank 0) with JAX's noise."""
    jg, jd = workers.small_cfgs(jcfg)
    cfg = jts.TrainConfig(batch_size=4, batch_gpu=2,
                          loss=jloss.LossConfig(style_mixing=0.0,
                                                pl_batch_shrink=pl_batch_shrink))
    mesh = jax_data_mesh(jax.devices()[:2])
    jtrainer = jts.GANTrainer(jg, jd, cfg, mesh=mesh)
    assert jtrainer.n_accum == 1
    keys = jax.random.split(jax.random.PRNGKey(step), 3)
    # The noise `_g_pl_loss` draws in `g_reg_step`'s one round.
    _, rng_noise = jax.random.split(jax.random.split(keys[1], 1)[0])
    pl_rows = max(4 // pl_batch_shrink, 1)
    pl_noise = np.asarray(jax.random.normal(rng_noise, (pl_rows, 16, 16, 3)) / 16.0)
    with mesh:
        jstate = jtrainer.init_state(seed=0)
        jstate["g"]["moving_stats"] = jax.tree_util.tree_map(
            lambda v: v + 0.3, jstate["g"]["moving_stats"])
        host = jax.device_get({"g": jstate["g"], "d": jstate["d"]})
        (tmp_path / "pair.msgpack").write_bytes(msgpack_serialize(host))
        z_np, real_np = _write_batch(tmp_path, (step,), pl_batch_shrink, seed=2,
                                     pl_noise=pl_noise)
        z = jtrainer._shard_micro(jnp.asarray(z_np))
        real = jtrainer._shard_micro(jnp.asarray(real_np))
        # Each stage's gradient is its Adam's exp_avg after it (beta1 0).
        stages = {"g": [], "d": []}

        def took(net):
            stages[net].append(flat(jax.device_get(jstate[net + "_opt"][0].mu), None))

        jstate, _ = jtrainer.g_main_step(jstate, z, None, keys[0])
        took("g")
        if step % cfg.g_reg_interval == 0:
            jstate, _ = jtrainer.g_reg_step(jstate, z, None, keys[1])
            took("g")
        jstate, _ = jtrainer.d_main_step(jstate, real, z, None, keys[2])
        took("d")
        if step % cfg.d_reg_interval == 0:
            jstate, _ = jtrainer.d_reg_step(jstate, real, None)
            took("d")
        jstate = jax.device_get(jstate)
    run_ranks("train", tmp_path)
    got = _assert_ranks_agree(tmp_path)

    want = {**flat(jstate["g"], "G"), **flat(jstate["d"], "D"),
            **flat({"params": jstate["gs_params"], "moving_stats": jstate["gs_stats"]},
                   "G_ema"), "pl_mean": np.asarray(jstate["pl_mean"])}
    for net, opt in (("g", "g_opt"), ("d", "d_opt")):
        want.update(flat(jstate[opt][0].mu, f"{opt}/exp_avg/params"))
        want.update(flat(jstate[opt][0].nu, f"{opt}/exp_avg_sq/params"))
    # The stages' gradient floors: 1e-3 of the stage's largest entry, and
    # for R1 (D_reg) 1.0, as test_torch_reg holds R1 against JAX: its bias
    # gradients are sums that cancel, and float32 moves them by up to 2e-3
    # of themselves on either side.
    floors = {"g": [1e-3] * len(stages["g"]), "d": [1e-3, 1.0][:len(stages["d"])]}
    moves = {}
    for net, r, lr in (("g", cfg.g_reg_interval, cfg.g_lr), ("d", cfg.d_reg_interval, cfg.d_lr)):
        ratio = r / (r + 1)
        moves[net] = adam_moves({p: [g[p] for g in stages[net]] for p in stages[net][0]},
                                lr * ratio, cfg.beta2 ** ratio, floors[net])
    assert assert_trees_close(got, {k: v for k, v in want.items()
                                    if not k.startswith("G_ema/buffers")},
                              grad_floor={"g_opt": floors["g"][-1], "d_opt": floors["d"][-1]},
                              moves=moves) > 100
    assert (float(got["pl_mean"]) != 0.0) == (step == 0)


def _flag_calls(monkeypatch, tmp_path, flags):
    calls = []

    class Stop(Exception):
        pass

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        raise Stop

    monkeypatch.setattr(cli, "initialize_distributed", fake)
    with pytest.raises(Stop):
        cli.main(["train", "--data-dir", str(tmp_path), "--result-dir", str(tmp_path),
                  "--device", "cpu"] + flags)
    return calls


@pytest.mark.parametrize("flags,want", [
    ([], (None, None, None, False)),
    (["--multihost", "--num-processes", "4", "--process-id", "3", "--coordinator",
      "10.0.0.1:1234"], ("10.0.0.1:1234", 4, 3, True)),
])
def test_train_passes_the_group_flags(monkeypatch, tmp_path, flags, want):
    """train hands JAX's (coordinator, num_processes, process_id,
    requested=multihost) to initialize_distributed, with its device."""
    (args, kwargs), = _flag_calls(monkeypatch, tmp_path, flags)
    assert (*args, kwargs["requested"]) == want and kwargs["device"] == "cpu"


def test_train_cli_two_processes(tmp_path):
    """`train --coordinator localhost:<port> --num-processes 2 --process-id
    <r>` in two processes on the CPU: one run directory (rank 0 makes it
    and hands its name on), written by rank 0 alone, one stats line a tick
    (the ranks' stats all-reduced: 8 images a tick, 4 rows a stage stat),
    and a snapshot whose train state holds the global image count."""
    from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
    from morphganformer_tpu_torch.utils.image import write_png

    data = tmp_path / "data" / "32"
    data.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        write_png(str(data / f"{i:04d}.png"), (rng.rand(32, 32, 3) * 255).astype(np.uint8))
    port = free_port()
    flags = ["train", "--data-dir", str(tmp_path / "data"), "--result-dir",
             str(tmp_path / "runs"), "--resolution", "32", "--components-num", "2",
             "--latent-size", "16", "--channel-base", "256", "--channel-max", "32",
             "--end-res", "3", "--batch", "4", "--batch-gpu", "2", "--ganformer-default",
             "--kimg-per-tick", "0.008", "--max-ticks", "1", "--device", "cpu",
             "--coordinator", f"localhost:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen([sys.executable, "-m", "morphganformer_tpu_torch.cli"] + flags
                              + ["--process-id", str(r)], cwd=ROOT, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    runs = os.listdir(tmp_path / "runs")
    assert runs == ["exp-000"], runs
    run_dir = tmp_path / "runs" / "exp-000"
    assert "run dir:" in outs[0][0] and "run dir:" not in outs[1][0]
    assert "tick 1" in outs[0][0] and "tick 1" not in outs[1][0]
    assert json.load(open(run_dir / "training_options.json"))["world"] == 2
    lines = open(run_dir / "stats.jsonl").read().splitlines()
    assert len(lines) == 1
    stat = json.loads(lines[0])["Loss/G/loss"]
    assert stat["num"] == 4.0 and np.isfinite(stat["mean"])   # 2 iterations x 2 ranks
    snap, = [d for d in os.listdir(run_dir) if d.startswith("network-snapshot-")]
    tree = msgpack_restore(open(run_dir / snap / "train_state.msgpack", "rb").read())
    assert int(tree["cur_nimg"]) == 8
