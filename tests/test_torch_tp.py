"""The port's tensor parallelism (parallel/tp.py, the trainer on a ('data',
'model') mesh, `dryrun_train_step`) against the JAX package, on gloo:
each rank is a subprocess of tests/torch_parallel_workers.py, as in
tests/test_torch_parallel.py, with a timeout of its own. Every case runs
JAX's tiny config (16^2, channel_max 32, k 3); on the CPU the fused blocks
(G's b8 and b16, and D's b16, forced fused by
`torch_parallel_workers.patched`) take their kernels' plain versions on
this rank's slice of the output channels."""

import dataclasses
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu.models.generator import Generator as JGenerator
from morphganformer_tpu.parallel import tp as jtp
from morphganformer_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from morphganformer_tpu.training import loss as jloss
from morphganformer_tpu.training import train_step as jts
from morphganformer_tpu_torch.checkpoint.convert import set_leaf, to_flax
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_serialize
from morphganformer_tpu_torch.models import config as tcfg
from morphganformer_tpu_torch.models import discriminator as tdisc
from morphganformer_tpu_torch.models import init_generator
from morphganformer_tpu_torch.models.generator import Generator
from morphganformer_tpu_torch.parallel.tp import (
    DataModelMesh,
    ModelAxis,
    make_mesh,
    sharded_names,
)
from morphganformer_tpu_torch.training import train_step as tts

from . import torch_parallel_workers as workers
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_parallel import GRAD_TOL, ROOT, TIMEOUT_S, _env, _write_batch, flat, run_ranks

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_sharded(tree, m):
    """The "/"-joined paths of the leaves JAX's `_leaf_spec` puts on the
    'model' axis."""
    specs = jax.tree_util.tree_map_with_path(lambda p, leaf: jtp._leaf_spec(p, leaf, m), tree)
    return {"/".join(str(k.key) for k in path)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            if "model" in tuple(spec)}


def _shape_tree(net):
    """The flax params tree of `net` (to_flax's names: the dotted parameter
    names split), leaves as shapes."""
    tree = {}
    for name, p in net.named_parameters():
        set_leaf(tree, name.split("."), jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32))
    return tree


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("pair", ["ffhq1024", "tiny"])
def test_sharded_set_is_jax_leaf_spec(pair, m):
    """(a) The port's sharded parameters are exactly those JAX's `_leaf_spec`
    shards, over the to_flax names of G and D: FFHQ-1024 with a 1024^2 D
    (built on the meta device) and the dry run's tiny pair."""
    if pair == "tiny":
        g_cfg, d_cfg = tts.dryrun_configs()
        G = init_generator(g_cfg, seed=0, device="cpu")
        names = {"/".join(path[1:]) for path in _flax_paths(to_flax(G)["params"])}
        assert names == {n.replace(".", "/") for n, _ in G.named_parameters()}
        D = tdisc.init_discriminator(d_cfg, seed=0, device="cpu")
    else:
        g_cfg, d_cfg = tcfg.ffhq1024_config(), tcfg.DiscriminatorConfig()
        with torch.device("meta"):
            G, D = Generator(g_cfg), tdisc.Discriminator(d_cfg)
    for net in (G, D):
        want = _jax_sharded(_shape_tree(net), m)
        got = {n.replace(".", "/") for n in sharded_names(net, m)}
        assert got == want
        assert want and len(want) < sum(1 for _ in net.parameters())
    if pair == "ffhq1024":
        got = sharded_names(G, m)
        assert "synthesis.b1024.torgb.weight" not in got and "pos" not in got
        assert "synthesis.b1024.conv1.weight" in got and "synthesis.b1024.torgb.affine.weight" in got
        assert "b4.out.weight" not in sharded_names(D, m) and "b1024.conv1.weight" in sharded_names(D, m)


def _flax_paths(tree, prefix=("params",)):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_model_parallel_loss_and_grads_match_jax_replicated(tmp_path):
    """(b) JAX's test_model_parallel_grads_match_replicated at a 1 x 2 mesh:
    the loss mean(img^2) + mean(|img|) of G(z, truncation_psi 0.8, const
    noise) and every leaf's gradient, gathered whole, against JAX's
    replicated `jax.value_and_grad` on the same parameters (loss rtol 1e-5,
    gradients rtol 1e-4, atol 1e-6). Both ranks agree to the bit, the rule
    shards leaves of both the fused blocks (b8, b16) and the unfused
    attention block (b4) and the mapping, and `unshard_params` gives back
    the loaded tree to the bit."""
    g_cfg, _ = tts.dryrun_configs()
    G = init_generator(g_cfg, seed=5, device="cpu")
    with torch.no_grad():
        G.mapping.w_avg.add_(0.3)
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.1)
    variables = to_flax(G)
    (tmp_path / "g.msgpack").write_bytes(msgpack_serialize(variables))
    z = np.random.RandomState(0).randn(4, g_cfg.k, g_cfg.z_dim).astype(np.float32)
    np.savez(tmp_path / "tp_loss.npz", z=z)
    outs = run_ranks("tp_loss", tmp_path, world=2)

    jg = jcfg.GANformerConfig(img_resolution=16, z_dim=8, w_dim=8, k=3, channel_base=256,
                              channel_max=32, end_res=3,
                              mapping=jcfg.MappingConfig(num_layers=2),
                              attention=jcfg.AttentionConfig())
    model = JGenerator(jg)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    def loss(params):
        img = model.apply(dict(jvars, params=params), jnp.asarray(z), truncation_psi=0.8,
                          noise_mode="const")
        img = img[0] if isinstance(img, tuple) else img
        return jnp.mean(jnp.square(img)) + jnp.mean(jnp.abs(img))

    l_ref, g_ref = jax.jit(jax.value_and_grad(loss))(jvars["params"])
    want = flat(jax.device_get(g_ref), None)
    got = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for key in got[0].files:
        np.testing.assert_array_equal(got[0][key], got[1][key], err_msg=key)
    np.testing.assert_allclose(float(got[0]["loss"]), float(l_ref), rtol=1e-5)
    assert {k[len("grad/"):] for k in got[0].files if k.startswith("grad/")} == \
        {k.replace("/", ".") for k in want}
    for key, w in want.items():
        np.testing.assert_allclose(got[0]["grad/" + key.replace("/", ".")], w, rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    assert all(o["round_trip"] and not o["tp_left"] for o in outs)
    sharded = set(outs[0]["sharded"])
    for name in ("synthesis.b16.conv1.weight", "synthesis.b8.conv0.weight",
                 "synthesis.b4.conv1.weight", "synthesis.b4.conv1.transformer.to_queries.weight",
                 "mapping.global_mlp.out_layer.weight"):
        assert name in sharded, name
        full = want[name.replace(".", "/")].shape
        assert outs[0]["local_shapes"][name] == [*full[:-1], full[-1] // 2], name


def _jax_step0_stats(work, start):
    """JAX's GANTrainer on a 2-device data mesh, one step-0 iteration (all
    four stages) at the default pl_batch_shrink, as
    test_two_rank_step_matches_jax_data_mesh runs it. The pair it starts
    from goes to <work>/pair.msgpack with the batch; then `start()` runs
    while JAX compiles and steps. Returns (JAX's stats, what `start`
    returned)."""
    jg, jd = workers.small_cfgs(jcfg)
    cfg = jts.TrainConfig(batch_size=4, batch_gpu=2,
                          loss=jloss.LossConfig(style_mixing=0.0, pl_batch_shrink=2))
    mesh = jax_data_mesh(jax.devices()[:2])
    jtrainer = jts.GANTrainer(jg, jd, cfg, mesh=mesh)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    _, rng_noise = jax.random.split(jax.random.split(keys[1], 1)[0])
    pl_noise = np.asarray(jax.random.normal(rng_noise, (2, 16, 16, 3)) / 16.0)
    stats = {}
    with mesh:
        jstate = jtrainer.init_state(seed=0)
        jstate["g"]["moving_stats"] = jax.tree_util.tree_map(
            lambda v: v + 0.3, jstate["g"]["moving_stats"])
        host = jax.device_get({"g": jstate["g"], "d": jstate["d"]})
        (work / "pair.msgpack").write_bytes(msgpack_serialize(host))
        z_np, real_np = _write_batch(work, (0,), 2, seed=2, pl_noise=pl_noise)
        started = start()
        z = jtrainer._shard_micro(jnp.asarray(z_np))
        real = jtrainer._shard_micro(jnp.asarray(real_np))
        jstate, aux = jtrainer.g_main_step(jstate, z, None, keys[0])
        stats.update(aux)
        jstate, aux = jtrainer.g_reg_step(jstate, z, None, keys[1])
        stats.update(aux)
        jstate, aux = jtrainer.d_main_step(jstate, real, z, None, keys[2])
        stats.update(aux)
        jstate, aux = jtrainer.d_reg_step(jstate, real, None)
        stats.update(aux)
    return {k: float(jnp.mean(v)) for k, v in stats.items() if k != "pl_mean"}, started


def _stage_tops(grads):
    return {stage: max(float(np.abs(v).max()) for k, v in grads.items()
                       if k.startswith(f"grads/{stage}/"))
            for stage in ("g_main", "g_reg", "d_main", "d_reg")}


def test_two_by_two_iteration_matches_jax_and_the_data_mesh(tmp_path):
    """(c) One step-0 iteration (G_main, G_reg, D_main, D_reg) on a 2 x 2
    mesh of the small pair with its randomness off: the stats of each data
    rank's rows, averaged over the data axis, against JAX's data-parallel
    iteration (rtol 2e-4, atol 2e-5, as tests/test_parallel.py:348-352);
    each stage's gradients from one state, gathered whole, against the
    port's 2-rank data mesh within the train-step tolerance (GRAD_TOL of
    each leaf's largest entry, floored at 1e-3 of the stage's largest, 1.0
    for R1); after the iteration the replicated leaves (parameters, EMA,
    Adam moments) bit-equal across each model group, the sharded ones
    across each data group, and the sharded leaves half-width."""
    tp_dir, dp_dir = tmp_path / "tp", tmp_path / "dp"

    def start():
        # Both groups of ranks run beside JAX's compile.
        pool = ThreadPoolExecutor(2)
        runs = []
        for d, world in ((tp_dir, 4), (dp_dir, 2)):
            d.mkdir()
            for f in ("pair.msgpack", "batch.npz"):
                (d / f).write_bytes((tmp_path / f).read_bytes())
            runs.append(pool.submit(run_ranks, "tp_train", d, world))
        pool.shutdown(wait=False)
        return runs

    want_stats, runs = _jax_step0_stats(tmp_path, start)
    tp_stats, _ = (r.result() for r in runs)
    tp = [dict(np.load(tp_dir / f"rank{r}.npz")) for r in range(4)]
    dp = dict(np.load(dp_dir / "rank0.npz"))

    for key, want in want_stats.items():
        got = (tp_stats[0][key] + tp_stats[2][key]) / 2
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5, err_msg=key)
        assert tp_stats[0][key] == tp_stats[1][key], key

    grads = {k: v for k, v in tp[0].items() if k.startswith("grads/")}
    assert set(grads) == {k for k in dp if k.startswith("grads/")}
    tops = _stage_tops(dp)
    worst = (0.0, None)
    for key, g in grads.items():
        stage = key.split("/")[1]
        want = dp[key].astype(np.float64)
        bound = GRAD_TOL * max(float(np.abs(want).max()),
                               (1.0 if stage == "d_reg" else 1e-3) * tops[stage])
        err = float(np.abs(g - want).max())
        worst = max(worst, (err / bound if bound > 0 else float(err > 0), key))
        np.testing.assert_array_equal(g, tp[2][key], err_msg=key)
    assert worst[0] <= 1.0, worst

    local = {k: v for k, v in tp[0].items() if k.startswith("state/")}
    whole = {k: v for k, v in dp.items() if k.startswith("state/")}
    assert set(local) == set(whole)
    halved = differ = 0
    for key, v in local.items():
        if v.shape == whole[key].shape:
            for a, b in ((0, 1), (2, 3)):
                np.testing.assert_array_equal(tp[a][key], tp[b][key], err_msg=key)
        else:
            assert v.shape[:-1] == whole[key].shape[:-1] and 2 * v.shape[-1] == \
                whole[key].shape[-1], key
            halved += 1
            differ += not np.array_equal(tp[0][key], tp[1][key])
        for a, b in ((0, 2), (1, 3)):
            np.testing.assert_array_equal(tp[a][key], tp[b][key], err_msg=key)
    assert halved > 50 and differ > halved // 2, (halved, differ)


def test_dryrun_train_step_four_cpu_ranks():
    """(d) `dryrun_train_step(4, device="cpu")`: JAX's two ok lines, the
    mesh {'data': 2, 'model': 2}."""
    code = ("import torch; torch.set_num_threads(1); "
            "from morphganformer_tpu_torch.training.train_step import dryrun_train_step; "
            "dryrun_train_step(4, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dryrun_multichip ok on 4 devices (mesh {'data': 2, 'model': 2}); stats:" \
        in out.stdout, out.stdout
    assert "dryrun sharded projection ok: batch 4 over ('data',) x4, per-image loss" \
        in out.stdout, out.stdout


def test_make_mesh_refusals():
    """(e) `make_mesh` refuses a model axis that does not divide the devices
    (JAX's error), and the trainer a bfloat16 pair on a model axis, naming
    the axis and the type; model_parallel 1 is the data mesh."""
    mesh = make_mesh(model_parallel=1, device="cpu")
    assert type(mesh).__name__ == "DataMesh" and mesh.shape == {"data": 1}
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        make_mesh(model_parallel=2, device="cpu")
    two_d = DataModelMesh(devices=(torch.device("cpu"),), world=1, rank=0,
                          model=ModelAxis(2, 0))
    g_cfg, d_cfg = tts.dryrun_configs()
    for g, d in ((dataclasses.replace(g_cfg, dtype="bfloat16"), d_cfg),
                 (g_cfg, dataclasses.replace(d_cfg, dtype="bfloat16"))):
        with pytest.raises(ValueError, match=r"model axis 2.*bfloat16"):
            tts.GANTrainer(g, d, tts.TrainConfig(batch_size=4, batch_gpu=4), device="cpu",
                           mesh=two_d)
    tts.GANTrainer(g_cfg, d_cfg, tts.TrainConfig(batch_size=4, batch_gpu=4), device="cpu",
                   mesh=two_d)
