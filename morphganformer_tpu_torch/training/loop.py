"""The training loop: ticks, snapshots, auto-resume and stats (port of
morphganformer_tpu/training/loop.py).

Reference training/training_loop.py: the dataset feed (:41-50), nets and
resume (:74-111), the kimg tick loop with snapshots and visualisations
(:384-453), stats.jsonl (:258-302), snapshot retention (:129-130), and
auto-resume from the newest snapshot, its kimg read from the name
(run_network.py:327-360), and the metrics of `eval_metrics` on the EMA
generator at each snapshot tick and after the last (:227-236,
metric_main.py), appended to <run_dir>/metric-<name>.jsonl.

A snapshot `network-snapshot-<kimg>` holds arch.json, G.msgpack,
Gs.msgpack (the EMA generator) and D.msgpack, which the JAX package loads
too, and train_state.msgpack: the port's own tree of G, D and G_ema (flax
variables trees), both Adams' exp_avg, exp_avg_sq and step keyed by the
same flax leaf paths, pl_mean and cur_nimg. A resumed run restarts its
random draws and its batch order from `LoopConfig.seed`, as JAX's does.
A snapshot of the JAX package (its train_state.msgpack tree: g, d,
gs_params, gs_stats, optax's Adam states) resumes too: it is converted on
load (checkpoint/convert.py `from_jax_train_state`). A JAX Orbax snapshot
is refused by name.

Under a process group of more than one rank (parallel/launch.py) the loop
trains data-parallel over a `make_data_mesh()`: each rank's feed takes its
shard of the data (`shard_index=rank, num_shards=world`) in batches of
batch_size / world, its generator is seeded `seed + rank`, and the run
directory's files (options, summary, stats.jsonl, TensorBoard, images,
snapshots, pruning, metrics) are written by rank 0 alone, the stats
all-reduced first. Every rank waits at a barrier before and after each
snapshot, so none runs ahead of a save.

The feed is chosen once, before the first step, and printed: the raw cache
when MGT_RAW_CACHE=1 (`--raw-cache`), else the native C++ loader when its
library builds, else `read_png` in Python, with the reason. MGT_DEBUG_NANS=1 turns on
autograd's anomaly mode (a backward that makes a NaN raises), the
counterpart of JAX's jax_debug_nans.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

from morphganformer_tpu_torch.checkpoint.async_io import (
    TRAIN_STATE_FILE,
    AsyncSnapshotter,
    write_tree,
)
from morphganformer_tpu_torch.checkpoint.convert import (
    flatten,
    from_jax_train_state,
    is_jax_train_state,
    load_flax,
    set_leaf,
    to_flax,
)
from morphganformer_tpu_torch.checkpoint.io import save_discriminator, save_generator
from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
from morphganformer_tpu_torch.data.dataset import ImageFolderDataset, infinite_batches
from morphganformer_tpu_torch.models.config import DiscriminatorConfig, GANformerConfig
from morphganformer_tpu_torch.models.generator import set_compute_dtype
from morphganformer_tpu_torch.parallel.launch import is_main_process, local_device
from morphganformer_tpu_torch.parallel.mesh import DataMesh, make_data_mesh, replicated
from morphganformer_tpu_torch.training import visualize as vz
from morphganformer_tpu_torch.training.stats import Collector
from morphganformer_tpu_torch.training.tensorboard import EventWriter
from morphganformer_tpu_torch.training.train_step import GANTrainer, TrainConfig, TrainState
from morphganformer_tpu_torch.utils.summary import discriminator_summary, generator_summary

VIS = ("grid", "interp", "mixing", "attention", "noise")
BACKENDS = ("msgpack", "async")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    run_dir: str = "results/exp"
    total_kimg: float = 25000
    kimg_per_tick: float = 4
    snapshot_ticks: int = 50          # <= 0 disables snapshots
    img_snapshot_ticks: int = 50      # <= 0 disables image snapshots/vis
    last_snapshots: int = 10          # retention GC (training_loop.py:129-130)
    eval_metrics: tuple = ()          # computed at snapshot ticks (training_loop.py:227-236)
    eval_images_num: int = 50000
    eval_batch: int = 16
    detector: str = "auto"            # "auto" | "raw" | <inception .npz path>
    vis: tuple = ("grid",)            # of: grid, interp, mixing, attention, noise
    tensorboard: bool = True          # tfevents mirror of stats.jsonl
    snapshot_backend: str = "msgpack"  # "msgpack" | "async" (background writes)
    seed: int = 0


def _snapshot_kimg(path):
    m = re.search(r"network-snapshot-(\d+)", path)
    return int(m.group(1)) if m else -1


def latest_snapshot(run_dir):
    """Auto-resume discovery (reference run_network.py:327-360)."""
    snaps = sorted(glob.glob(os.path.join(run_dir, "network-snapshot-*")), key=_snapshot_kimg)
    return snaps[-1] if snaps else None


def prune_snapshots(run_dir, keep):
    """Delete all but the `keep` newest snapshots (keep <= 0 deletes none)."""
    snaps = sorted(glob.glob(os.path.join(run_dir, "network-snapshot-*")), key=_snapshot_kimg)
    for old in snaps[:-keep] if keep > 0 else ():
        shutil.rmtree(old)


# ------------------------------------------------------------ train state

ADAM_KEYS = ("exp_avg", "exp_avg_sq", "step")


def _host(t):
    """A host copy (on the CPU too, where .numpy() would share memory)."""
    return t.detach().to("cpu", copy=True).numpy()


def _adam_tree(opt, model):
    out = {key: {} for key in ADAM_KEYS}
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        for key in (ADAM_KEYS if st else ()):
            set_leaf(out[key], ("params", *name.split(".")), _host(st[key]))
    return out


def train_state_tree(state: TrainState) -> dict:
    """The state as a host tree of numpy arrays and ints, copied, so that
    training on leaves it as it was."""
    return {"G": to_flax(state.G), "D": to_flax(state.D), "G_ema": to_flax(state.G_ema),
            "g_opt": _adam_tree(state.g_opt, state.G),
            "d_opt": _adam_tree(state.d_opt, state.D),
            "pl_mean": _host(state.pl_mean),
            "cur_nimg": int(state.cur_nimg)}


def _load_adam(opt, model, tree):
    flat = {key: {".".join(path[1:]): leaf for path, leaf in flatten(tree[key])}
            for key in ADAM_KEYS}
    params = dict(model.named_parameters())
    unknown = sorted(set().union(*flat.values()) - set(params))
    if unknown:
        raise KeyError(f"optimizer state of parameters the net does not have: {unknown}")
    for name, p in params.items():
        have = [name in flat[key] for key in ADAM_KEYS]
        if not any(have):
            opt.state.pop(p, None)
        elif not all(have):
            raise KeyError(f"optimizer state of {name} is incomplete")
        else:
            opt.state[p] = {"step": torch.tensor(np.array(flat["step"][name])),
                            **{key: torch.tensor(np.array(flat[key][name]), device=p.device)
                               for key in ("exp_avg", "exp_avg_sq")}}


def apply_train_state(state: TrainState, tree) -> TrainState:
    """Load a train-state tree, the port's or the JAX package's, into `state`
    in place (the modules keep their parameters, so the optimizers keep
    pointing at them)."""
    if is_jax_train_state(tree):
        tree = from_jax_train_state(tree)
    for name in ("G", "D", "G_ema"):
        load_flax(getattr(state, name), tree[name])
    _load_adam(state.g_opt, state.G, tree["g_opt"])
    _load_adam(state.d_opt, state.D, tree["d_opt"])
    state.pl_mean = torch.tensor(np.array(tree["pl_mean"]), device=state.pl_mean.device)
    state.cur_nimg = int(tree["cur_nimg"])
    return state


def save_train_state(path, state: TrainState) -> None:
    write_tree(path, train_state_tree(state))


def load_train_state(path, state: TrainState) -> TrainState:
    """Load a train_state.msgpack of either package into `state`."""
    with open(path, "rb") as f:
        return apply_train_state(state, msgpack_restore(f.read()))


def resume_train_state(snap_dir, state: TrainState, snapshotter=None,
                       mesh: Optional[DataMesh] = None) -> TrainState:
    """Load snapshot `snap_dir`'s train state into `state` (through the
    background writer's `restore` when there is one), then broadcast the
    nets from rank 0. A JAX Orbax snapshot (an `orbax` directory, no
    train_state.msgpack) raises: the port reads msgpack only."""
    path = os.path.join(snap_dir, TRAIN_STATE_FILE)
    if not os.path.exists(path) and os.path.isdir(os.path.join(snap_dir, "orbax")):
        raise ValueError(f"{snap_dir} is a JAX Orbax snapshot (snapshot_backend=\"orbax\"); "
                         f"the port resumes from train_state.msgpack only: resave it with the "
                         f"JAX package's msgpack backend")
    if snapshotter is not None:
        apply_train_state(state, snapshotter.restore(snap_dir))
    else:
        load_train_state(path, state)
    for net in (state.G, state.D, state.G_ema):
        replicated(net, mesh)
    return state


# ------------------------------------------------------------ the feed

def select_feed(dataset: ImageFolderDataset, batch_size: int, seed: int, shard_index=0,
                num_shards=1):
    """(name, batches): the feed of this run (of this rank's shard of the
    data, `batch_size` rows a batch), chosen once."""
    from morphganformer_tpu_torch.data import native_loader
    from morphganformer_tpu_torch.data.raw_cache import raw_infinite_batches

    path, res = dataset.path, dataset.resolution
    shard = dict(seed=seed, shard_index=shard_index, num_shards=num_shards)
    if os.environ.get("MGT_RAW_CACHE") == "1":
        return "raw cache", raw_infinite_batches(path, res, batch_size, **shard)
    if native_loader.native_available():
        return "native", native_loader.native_infinite_batches(path, res, batch_size, **shard)
    print(f"(python feed: the native loader is unavailable: {native_loader.build_error()})",
          flush=True)
    return "python", infinite_batches(dataset, batch_size, **shard)


# ------------------------------------------------------------ the loop

def _check(g_cfg: GANformerConfig, l_cfg: LoopConfig):
    from morphganformer_tpu_torch.metrics.registry import is_valid_metric, list_valid_metrics

    unknown = [m for m in l_cfg.eval_metrics if not is_valid_metric(m)]
    if unknown:
        raise ValueError(f"unknown metric {unknown}; valid: {list_valid_metrics()}")
    if l_cfg.snapshot_backend == "orbax":
        raise ValueError('the port has no Orbax; snapshot_backend="async" writes snapshots '
                         "on a background thread")
    if l_cfg.snapshot_backend not in BACKENDS:
        raise ValueError(f"snapshot_backend must be one of {BACKENDS}, "
                         f"got {l_cfg.snapshot_backend!r}")
    unknown = sorted(set(l_cfg.vis) - set(VIS))
    if unknown:
        raise ValueError(f"unknown vis products {unknown}; known: {VIS}")
    if "attention" in l_cfg.vis and not vz.has_attention(g_cfg):
        raise ValueError("vis \"attention\" needs a generator with attention layers; "
                         "this one has none")


def _barrier(mesh: Optional[DataMesh]):
    if mesh is not None and mesh.has_group:
        torch.distributed.barrier()


def training_loop(g_cfg: GANformerConfig, d_cfg: DiscriminatorConfig, t_cfg: TrainConfig,
                  l_cfg: LoopConfig, dataset_path: str, resume: Optional[str] = "auto",
                  max_ticks: Optional[int] = None, device="cuda") -> TrainState:
    """Run (or resume) training until total_kimg or `max_ticks` ticks, data
    parallel over the process group when it has more than one rank.
    Returns the final state."""
    _check(g_cfg, l_cfg)
    if os.environ.get("MGT_DEBUG_NANS") == "1":
        torch.autograd.set_detect_anomaly(True)
    mesh = (make_data_mesh(device=device) if torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1 else None)
    main = is_main_process()
    world, rank = (mesh.world, mesh.rank) if mesh is not None else (1, 0)

    os.makedirs(l_cfg.run_dir, exist_ok=True)
    if main:
        with open(os.path.join(l_cfg.run_dir, "training_options.json"), "w") as f:
            json.dump({"G": json.loads(g_cfg.to_json()),
                       "D": json.loads(d_cfg.to_json()),
                       "train": dataclasses.asdict(t_cfg),
                       "loop": {k: v for k, v in dataclasses.asdict(l_cfg).items()
                                if not isinstance(v, tuple)},
                       "world": world},
                      f, indent=2, default=str)

    trainer = GANTrainer(g_cfg, d_cfg, t_cfg, device=local_device(device), mesh=mesh)
    dataset = ImageFolderDataset(dataset_path, g_cfg.img_resolution)
    # Rank 0 first: it builds the raw cache that the others then read.
    if not main:
        _barrier(mesh)
    feed, batches = select_feed(dataset, t_cfg.batch_size // world, l_cfg.seed,
                                shard_index=rank, num_shards=world)
    if main:
        _barrier(mesh)
        print(f"feed: {feed} ({len(dataset)} images of {g_cfg.img_resolution}^2 under "
              f"{dataset_path}; {world} rank(s) of {t_cfg.batch_size // world} rows)",
              flush=True)

    state = trainer.init_state(seed=l_cfg.seed)

    if main:
        summary = generator_summary(state.G) + "\n" + discriminator_summary(state.D)
        with open(os.path.join(l_cfg.run_dir, "module_summary.txt"), "w") as f:
            f.write(summary)
        print(summary, flush=True)

    snapshotter = AsyncSnapshotter() if l_cfg.snapshot_backend == "async" and main else None
    if resume == "auto":
        resume = latest_snapshot(l_cfg.run_dir)
    if resume:
        resume_train_state(resume, state, snapshotter, mesh)
        if main:
            print(f"Resuming from {resume} at cur_nimg {state.cur_nimg}", flush=True)

    collector = Collector(mesh)
    stats_jsonl = os.path.join(l_cfg.run_dir, "stats.jsonl")
    tb_writer = EventWriter(l_cfg.run_dir) if l_cfg.tensorboard and main else None
    dev = trainer.device

    tick = int(state.cur_nimg // (l_cfg.kimg_per_tick * 1000))
    step = state.cur_nimg // t_cfg.batch_size
    tick_start = start_time = time.time()
    last_snap_kimg = -1

    def maybe_snapshot(force=False):
        """Snapshot unless this kimg has one (a forced one overwrites it);
        returns the directory, or None where it was skipped and a resumed
        run's directory holds it."""
        nonlocal last_snap_kimg
        kimg = state.cur_nimg // 1000
        snap_dir = os.path.join(l_cfg.run_dir, f"network-snapshot-{kimg:06d}")
        if not force and kimg == last_snap_kimg:
            return snap_dir if os.path.exists(snap_dir) else None
        # Whether a directory exists is not the same on every rank at the
        # same moment: a multi-rank run decides on the kimg alone, as JAX's.
        if not force and mesh is None and os.path.exists(snap_dir):
            return None
        last_snap_kimg = kimg
        _barrier(mesh)
        if main:
            save_generator(snap_dir, g_cfg, state.G, role="G")
            save_generator(snap_dir, g_cfg, state.G_ema, role="Gs")
            save_discriminator(snap_dir, d_cfg, state.D)
            if snapshotter is not None:
                snapshotter.save(snap_dir, train_state_tree(state))
            else:
                save_train_state(os.path.join(snap_dir, TRAIN_STATE_FILE), state)
            print(f"snapshot {snap_dir} at cur_nimg {state.cur_nimg}", flush=True)
            prune_snapshots(l_cfg.run_dir, l_cfg.last_snapshots)
        _barrier(mesh)
        return snap_dir

    def evaluate(snapshot_dir=None):
        """The metrics of `eval_metrics` on G_ema against `eval_images_num`
        dataset images, cycled in order (JAX's loop.py:273-301). G_ema runs
        in float32 there whatever the training type, as calc_metrics runs
        it, and goes back to the training type after."""
        from morphganformer_tpu_torch.metrics.detector import detector_kind, resolve_detector
        from morphganformer_tpu_torch.metrics.registry import compute_metric, report_metric

        for metric in l_cfg.eval_metrics:
            detector = resolve_detector(l_cfg.detector, kind=detector_kind(metric), device=dev)

            def data_iter():
                n = 0
                while n < l_cfg.eval_images_num:
                    b = min(l_cfg.eval_batch, len(dataset) - n % len(dataset))
                    yield np.stack([dataset[(n + j) % len(dataset)][0] for j in range(b)])
                    n += b

            set_compute_dtype(state.G_ema, "float32")
            try:
                result = compute_metric(metric, detector=detector, dataset=data_iter(),
                                        G=state.G_ema, batch=l_cfg.eval_batch,
                                        max_items=l_cfg.eval_images_num, device=dev)
            finally:
                set_compute_dtype(state.G_ema, g_cfg.dtype)
            report_metric(result, run_dir=l_cfg.run_dir, snapshot_pkl=snapshot_dir)

    def save_visualizations():
        """Image-snapshot products (reference training_loop.py -> vis())."""
        G = state.G_ema
        kimg = state.cur_nimg // 1000
        if "grid" in l_cfg.vis:
            vz.sample_grid(G, g_cfg, num=16, psi=0.7, seed=0,
                           path=os.path.join(l_cfg.run_dir, f"fakes{kimg:06d}.png"))
        extras = [v for v in l_cfg.vis if v != "grid"]
        if not extras:
            return
        vis_dir = os.path.join(l_cfg.run_dir, f"vis{kimg:06d}")
        os.makedirs(vis_dir, exist_ok=True)
        if "interp" in extras:
            vz.interpolation_grid(G, g_cfg, path=os.path.join(vis_dir, "interpolation.png"))
        if "mixing" in extras:
            vz.style_mixing_table(G, g_cfg, path=os.path.join(vis_dir, "style_mixing.png"))
        if "attention" in extras:
            vz.attention_blends(G, g_cfg, out_dir=vis_dir)
        if "noise" in extras and g_cfg.local_noise:
            vz.noise_variance_map(G, g_cfg, path=os.path.join(vis_dir, "noise_map.png"))

    ticks_done = 0
    while state.cur_nimg < l_cfg.total_kimg * 1000:
        real, _ = next(batches)
        stats = trainer.train_iteration(state, torch.from_numpy(real).to(dev), step)
        step += 1
        collector.report_dict(stats)

        if state.cur_nimg >= (tick + 1) * l_cfg.kimg_per_tick * 1000:
            tick += 1
            ticks_done += 1
            now = time.time()
            collector.sync()
            fields = [f"tick {tick}", f"kimg {state.cur_nimg / 1000:.1f}",
                      f"time {now - start_time:.0f}s", f"sec/tick {now - tick_start:.1f}"]
            fields += [f"{k.split('/')[-1]} {collector.mean(k):.3f}"
                       for k in collector.names() if k.startswith("Loss/")]
            if main:
                print(" | ".join(fields), flush=True)
                collector.write_jsonl(stats_jsonl, kimg=state.cur_nimg / 1000, tick=tick)
            if tb_writer is not None:
                tb_writer.add_scalars(
                    state.cur_nimg,
                    {name: collector.mean(name) for name in collector.names()}
                    | {"Timing/sec_per_tick": now - tick_start,
                       "Timing/total_sec": now - start_time})
            collector.reset()
            tick_start = now
            if main and l_cfg.img_snapshot_ticks > 0 and tick % l_cfg.img_snapshot_ticks == 0:
                save_visualizations()
            if l_cfg.snapshot_ticks > 0 and tick % l_cfg.snapshot_ticks == 0:
                snap = maybe_snapshot()
                if main:
                    evaluate(snapshot_dir=snap)
            if max_ticks is not None and ticks_done >= max_ticks:
                break

    snap = maybe_snapshot(force=True)
    if main:
        evaluate(snapshot_dir=snap)
    batches.close()
    if snapshotter is not None:
        snapshotter.close()
    if tb_writer is not None:
        tb_writer.close()
    return state
