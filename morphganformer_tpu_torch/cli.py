"""Entry points of the port: generate, merge, project, morph, demorph, train,
calc_metrics, dataset_tool, warp_morphs and make_video.

    python -m morphganformer_tpu_torch.cli generate --model init:1024 --output-dir images
    python -m morphganformer_tpu_torch.cli merge --model init:1024 --latents a.mat b.mat \
        --out morphs
    python -m morphganformer_tpu_torch.cli project --model init:1024 --img face.png \
        --step 1000 --path_to_gen images/projection
    python -m morphganformer_tpu_torch.cli morph --model init:1024 --img-a a.png --img-b b.png \
        --out images/morphs
    python -m morphganformer_tpu_torch.cli demorph --model init:1024 \
        --morph-latent m.mat --accomplice-latent a.mat --out demorph
    python -m morphganformer_tpu_torch.cli demorph --model init:1024 \
        --morph-img m.png --accomplice-img a.png --out demorph
    python -m morphganformer_tpu_torch.cli train --data-dir datasets/ffhq --resolution 1024 \
        --ganformer-default --batch 4 --batch-gpu 4 --expname ffhq
    python -m morphganformer_tpu_torch.cli calc_metrics --model init:1024 \
        --data datasets/ffhq --metrics fid2k_full --detector raw --run-dir results
    python -m morphganformer_tpu_torch.cli dataset_tool create_from_images datasets/faces \
        photos/ --resolution 1024 --lods 2
    python -m morphganformer_tpu_torch.cli warp_morphs --morph m.png --img-a a.png \
        --img-b b.png --predict-landmarks --out warped
    python -m morphganformer_tpu_torch.cli make_video --images frames/ --out clip.gif --fps 24
    python -m morphganformer_tpu_torch.cli extract_features --backbone iresnet18.npz \
        --bona faces/bona --morph faces/morphs

They mirror cli/generate.py, cli/merge.py, cli/project.py, cli/morph.py,
cli/demorph.py, cli/train.py, cli/calc_metrics.py, cli/dataset_tool.py,
cli/warp_morphs.py, cli/make_video.py and cli/extract_features.py of the JAX
package. `--model <dir>` loads the EMA generator ("Gs") of a checkpoint
directory (arch.json + Gs.msgpack, written by either package; a training
snapshot is one). `--model
init:<res>` builds a randomly initialised FFHQ-style generator at that
resolution (weights from seed 0 whatever `--seed` says, as the JAX entry
points build them; `--seed` picks z, the prior statistics and the
projection noise). Everything
runs on the card; `--device cpu` asks for the CPU. `--dtype` is the
synthesis' compute type, with JAX's defaults: bfloat16 for project, morph
and demorph, float32 for generate and merge (the weights, the latent, Adam
and the loss stay float32); calc_metrics has no `--dtype` and runs float32,
as JAX's does. `train --dtype bfloat16` trains with G's synthesis and D's
blocks in bfloat16 (the parameters, Adam, the EMA, pl_mean and the losses
stay float32; the metrics run G_ema in float32). Latents are fed to the
generator as z, as the JAX entry points do. Projection targets are photos
of any size in PNG, JPEG, BMP or Netpbm (`utils/image.py` `read_image_rgb`,
bit-equal to Pillow's decoders), Lanczos-resized and centre-cropped as JAX's
load_target does.
`project --loss` takes JAX's whole loss stack: the pixel terms and lpips,
wing, awing, facenet, arcface, mdf and lbp, their networks' weights from
the .npz files of the port's converters (`python -m
morphganformer_tpu_torch.tools.convert_<net>`; the JAX package's write the
same files), the bundled landmark model, or `--random-perceptual`:

    python -m morphganformer_tpu_torch.cli project --model init:1024 --img face.png \
        --loss "lpips+0.01*wing+1*mse" --random-perceptual --size 256

`project --noise_regularize 1e5` optimizes the const-noise maps with the
latent and writes them beside it (<latent>.noises.npz); `merge --noises`
applies such maps before generating. `morph --pairs-csv pairs.csv` projects
the pairs of a CSV (img_a,img_b[,similarity]), `--pairs-per-batch` of them
as one batch-2P projection; `morph --shard` splits each such projection's
rows over the visible GPUs when their number divides the batch.

`train` runs one process per visible GPU when there are more than one
(spawned, met at a free localhost port, NCCL), or joins a process group
that several launches form: `--coordinator host:port --num-processes N
--process-id i` on each (or `--multihost` under torchrun's environment),
each process on `cuda:<local rank>`. The global `--batch` is split over the
processes; rank 0 writes the run directory.

extract_features embeds a folder of PNGs and JPEGs with the ArcFace iresnet on the
card (`--images`, to an .npz of `files` and `features`), or fits the linear
SVM of bona fide against morph embeddings (`--bona`, `--morph`) and prints
its accuracies as JSON; the split and the SVM are the port's own
(metrics/fingerprint.py), equal to scikit-learn's.

dataset_tool, warp_morphs and make_video read what the JAX scripts read
through Pillow, as `read_image_rgb` does (PNG, JPEG, BMP, Netpbm; WebP and
the other formats raise and name the file). warp_morphs warps on the card in float64 (the
Delaunay triangulation is scipy's, on the host); make_video writes an
animated GIF, and for another container prints JAX's fallback line and
writes the GIF beside it.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import functools
import glob
import itertools
import json
import os
import re
import zlib
from typing import Optional

import numpy as np
import torch

from morphganformer_tpu_torch.checkpoint.io import load_network
from morphganformer_tpu_torch.data import dataset_tool
from morphganformer_tpu_torch.losses import (
    build_loss_stack,
    face_embedding,
    facenet,
    landmarks,
    lbp,
    lpips,
    mdf,
    parse_loss_spec,
    stack,
    wing,
)
from morphganformer_tpu_torch.losses.nets import resize_bilinear
from morphganformer_tpu_torch.models import GANformerConfig, init_generator, set_compute_dtype
from morphganformer_tpu_torch.metrics import fingerprint
from morphganformer_tpu_torch.morph import (
    demorph_latent,
    load_latent_mat,
    morph_latents,
    save_latent_mat,
)
from morphganformer_tpu_torch.parallel.launch import (
    initialize_distributed,
    is_main_process,
    spawn_local,
)
from morphganformer_tpu_torch.projection import (
    ProjectionConfig,
    latent_stats,
    merge_noise_buffers,
    project,
)
from morphganformer_tpu_torch.utils import video
from morphganformer_tpu_torch.utils.device import resolve_device
from morphganformer_tpu_torch.utils.image import (
    crop_max_rectangle,
    load_target,
    read_image_rgb,
    to_uint8,
    write_png,
)


def unconditional(G, model_spec):
    """G, or a ValueError naming the checkpoint when G is conditional: the
    entry points that draw images from z alone (generate, merge, project,
    morph, demorph, calc_metrics, train --eval) take no labels. JAX's fail
    inside the label embedding, given None."""
    if G.cfg.c_dim > 0:
        raise ValueError(f"{model_spec} is a conditional generator (c_dim {G.cfg.c_dim}); "
                         "generate, merge, project, morph, demorph, calc_metrics and "
                         "train --eval take no labels")
    return G


def get_model(model_spec: str, device="cuda", dtype="float32"):
    """(cfg, generator) for `--model`, as JAX's `cli/generate.py:get_model`:
    a checkpoint directory gives its "Gs" (refused when conditional:
    `unconditional`); `init:<res>` random weights from seed 0. The
    synthesis computes in `dtype` ("float32" or "bfloat16"), whatever the
    checkpoint's arch.json says; the weights stay float32."""
    if model_spec.startswith("init:"):
        cfg = GANformerConfig(img_resolution=int(model_spec.split(":", 1)[1]))
        G = init_generator(cfg, seed=0, device=device)
    else:
        _, G = load_network(model_spec, role="Gs", device=device)
        unconditional(G, model_spec)
    set_compute_dtype(G, dtype)
    return G.cfg, G


@torch.no_grad()
def synthesize(G, z, truncation_psi=0.7, plain=False):
    """Images [B,H,W,C] in [-1, 1] from z [B,k,z_dim] (numpy or tensor),
    with const noise. `plain=True` runs the fused blocks on the plain
    versions of their kernels."""
    z = torch.as_tensor(z, dtype=torch.float32, device=next(G.parameters()).device)
    return G(z=z, truncation_psi=truncation_psi, noise_mode="const", plain=plain)


def _save_png(path, img, ratio=1.0):
    write_png(path, crop_max_rectangle(to_uint8(img), ratio))


def run_generate(G, output_dir, images_num, truncation_psi=0.7, ratio=1.0,
                 batch_size=4, seed=0):
    """Draw z from a `torch.Generator` seeded with `seed`, write
    <output_dir>/sample_{i:06d}.png; returns the images [N,H,W,C]."""
    cfg = G.cfg
    os.makedirs(output_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for done in range(0, images_num, batch_size):
        b = min(batch_size, images_num - done)
        z = torch.randn((b, cfg.k, cfg.z_dim), generator=gen)
        imgs = synthesize(G, z, truncation_psi).cpu().numpy()
        for i in range(b):
            _save_png(os.path.join(output_dir, f"sample_{done + i:06d}.png"), imgs[i], ratio)
        out.append(imgs)
    return np.concatenate(out)


def _as_batch(w):
    return w[None] if w.ndim == 2 else w


def load_noises(path):
    """The noise maps of a `.noises.npz` (project --noise_regularize, of
    either package), keyed by their flattened paths."""
    with np.load(path) as nz:
        return {k: nz[k] for k in nz.files}


def run_merge(G, latent_files, out_dir, alpha=0.5, truncation_psi=0.7, all_pairs=False,
              noises=None):
    """Morph pairs of .mat latents (in order, or every pair with
    `all_pairs`): W = alpha*w1 + (1-alpha)*w2, regenerate, write
    <a>_<b>.png and <a>_<b>.mat. Returns [(stem, image, W)]. `noises` (a
    `.noises.npz` path) is copied into G's noise buffers first, so that
    `--latents w.mat w.mat --noises w.noises.npz` gives that projection's
    best image."""
    if len(latent_files) < 2:
        raise ValueError("need at least two latents")
    if noises:
        merge_noise_buffers(G, load_noises(noises))
        print(f"merged optimized noise maps from {noises}")
    os.makedirs(out_dir, exist_ok=True)
    pairs = (itertools.combinations(latent_files, 2) if all_pairs
             else zip(latent_files[::2], latent_files[1::2]))
    results = []
    for fa, fb in pairs:
        stem = "_".join(os.path.splitext(os.path.basename(f))[0] for f in (fa, fb))
        w = _as_batch(morph_latents(load_latent_mat(fa), load_latent_mat(fb), alpha))
        img = synthesize(G, w, truncation_psi).cpu().numpy()
        _save_png(os.path.join(out_dir, f"{stem}.png"), img[0])
        save_latent_mat(os.path.join(out_dir, f"{stem}.mat"), w[0])
        results.append((stem, img[0], w[0]))
    return results


def _targets(G, paths):
    imgs = np.concatenate([load_target(p, size=G.cfg.img_resolution) for p in paths])
    return torch.from_numpy(imgs).to(next(G.parameters()).device)


def _print_progress(steps):
    def progress(step, loss, best):
        print(f"  step {step}/{steps}  loss {loss:.5f}  min_loss {best:.5f}", flush=True)
    return progress


@dataclasses.dataclass(frozen=True)
class LossNets:
    """Where the perceptual and biometric terms' networks get their weights
    (project's flags of the same names): the .npz files that the port's
    converters (morphganformer_tpu_torch/tools/convert_*.py) write; for
    wing and awing the bundled
    synthetic-face landmark model when no file is named; random weights for
    a net without a file when `random_perceptual` is set."""
    lpips_weights: Optional[str] = None
    lpips_net: str = "alex"
    landmark_weights: Optional[str] = None
    facenet_weights: Optional[str] = None
    arcface_weights: Optional[str] = None
    mdf_weights: Optional[str] = None
    random_perceptual: bool = False


def make_extra_terms(weights, nets: LossNets, device="cuda"):
    """The perceptual and biometric terms that `weights` names, each a
    closure over its network's parameters on `device` (JAX's
    cli/project.py:make_extra_terms). A term whose weights are not given
    raises SystemExit unless `nets.random_perceptual`."""
    rand = nets.random_perceptual
    extra, landmark_params = {}, None

    def weight_path(flag, name):
        path = getattr(nets, flag)
        if path is None and not rand:
            raise SystemExit(f"loss term '{name}' needs --{flag.replace('_', '-')} "
                             f"(or --random-perceptual for a smoke run)")
        return path

    for name in weights:
        if name in stack.BUILTIN_TERMS:
            continue
        if name == "lpips":
            path = weight_path("lpips_weights", name)
            params = (lpips.load_lpips_params(path, nets.lpips_net, device) if path
                      else lpips.random_lpips_params(nets.lpips_net, device=device))
            if params.pop("tower_source", None) == "random":
                print("lpips: real calibration heads x placeholder tower "
                      "(torchvision tower weights unavailable)")
            extra[name] = lpips.make_lpips_loss(params, nets.lpips_net)
        elif name in ("wing", "awing"):
            path = nets.landmark_weights
            if path is None and not rand:
                path = landmarks.bundled_landmark_path()
                if path is None:
                    raise SystemExit(f"loss term '{name}' needs --landmark-weights "
                                     "(or --random-perceptual for a smoke run)")
                print(f"landmarks: bundled synthetic model ({path}); "
                      "pass --landmark-weights for a real-data model")
            if landmark_params is None:      # wing and awing share one load
                landmark_params = (landmarks.load_landmark_npz(path, device) if path
                                   else landmarks.random_landmark_params(device=device))
            if name == "wing":
                extra[name] = wing.make_wing_loss_term(
                    landmarks.make_landmark_fn(landmark_params, temperature=0.05))
            else:
                extra[name] = wing.make_adaptive_wing_loss_term(
                    functools.partial(landmarks.landmark_heatmaps_01, landmark_params))
        elif name == "facenet":
            path = weight_path("facenet_weights", name)
            extra[name] = facenet.make_facenet_loss(
                facenet.load_facenet_npz(path, device) if path
                else facenet.random_facenet_params(device=device))
        elif name == "arcface":
            path = weight_path("arcface_weights", name)
            extra[name] = face_embedding.make_identity_loss(
                face_embedding.load_iresnet_npz(path, device=device) if path
                else face_embedding.random_iresnet_params(device=device))
        elif name == "mdf":
            path = weight_path("mdf_weights", name)
            ds, padding = (mdf.load_mdf_params(path, with_padding=True, device=device) if path
                           else (mdf.random_mdf_params(device=device), 0))
            extra[name] = mdf.make_mdf_loss(ds, padding=padding)
        elif name == "lbp":
            extra[name] = lbp.soft_lbp_loss
        else:
            raise SystemExit(f"unknown loss term '{name}'")
    return extra


def projection_loss(spec, resolution, device="cuda", size=None, lamda=None, beta=None,
                    nets: Optional[LossNets] = None):
    """project's loss: the stack of `spec` with JAX's overrides (`lamda`
    sets the wing and awing weights, `beta` the mse weight, as the reference's
    all_loss = p + lamda * wing + beta * mse) and, when `size` is below the
    model's `resolution`, both images resized (bilinear, antialiased) to
    `size` before it."""
    weights = parse_loss_spec(spec)
    if lamda is not None:
        wing_terms = [t for t in ("wing", "awing") if t in weights]
        if not wing_terms:
            raise SystemExit("--lamda sets the wing weight; add wing to --loss")
        for t in wing_terms:
            weights[t] = lamda
    if beta is not None:
        if "mse" not in weights:
            raise SystemExit("--beta sets the mse weight; add mse to --loss")
        weights["mse"] = beta
    loss_fn = build_loss_stack(weights, make_extra_terms(weights, nets or LossNets(), device))
    if not size or size >= resolution:
        return loss_fn

    def resized(img, target):
        return loss_fn(resize_bilinear(img, size), resize_bilinear(target, size))
    return resized


def run_project(G, img, out_dir, loss="mse", steps=5000, lr=0.1, lr_rampup=0.05,
                lr_rampdown=0.25, noise=0.05, noise_ramp=0.75, truncation_psi=0.7,
                n_mean_latent=10000, chunk=250, w_plus=False, init_latent=None,
                save_latent=None, ratio=1.0, seed=0, progress=None, size=None, lamda=None,
                beta=None, nets: Optional[LossNets] = None, noise_regularize=0.0):
    """Project the photo `img` into G's latent space under the loss stack
    `loss` (`projection_loss` with `size`, `lamda`, `beta` and `nets`). The
    prior statistics and then the per-step noise are drawn from one
    torch.Generator seeded with `seed`. Writes
    <out_dir>/sample_{best_step:06d}_{best_loss:.4f}.png and the best latent
    to `save_latent` (default <out_dir>/w.mat); with `noise_regularize` > 0
    also the best noise maps to <latent>.noises.npz (the best image was
    made with them). Returns the ProjectionResult. `progress(step, loss,
    best)` is called every `chunk` steps (by default it prints a line)."""
    pcfg = ProjectionConfig(steps=steps, lr=lr, lr_rampup=lr_rampup, lr_rampdown=lr_rampdown,
                            noise=noise, noise_ramp=noise_ramp, truncation_psi=truncation_psi,
                            n_mean_latent=n_mean_latent, chunk=chunk, w_plus=w_plus,
                            noise_regularize=noise_regularize)
    loss_fn = projection_loss(loss, G.cfg.img_resolution, next(G.parameters()).device, size,
                              lamda, beta, nets)
    gen = torch.Generator().manual_seed(seed)
    mean, std = latent_stats(G.cfg, gen, n_mean_latent)
    result = project(G, _targets(G, [img]), loss_fn, pcfg, mean, std, generator=gen,
                     progress=progress or _print_progress(steps),
                     init_latent=None if init_latent is None else load_latent_mat(init_latent))
    os.makedirs(out_dir, exist_ok=True)
    name = f"sample_{result.best_step:06d}_{result.best_loss:.4f}.png"
    _save_png(os.path.join(out_dir, name), result.best_img[0].cpu().numpy(), ratio)
    latent_path = save_latent or os.path.join(out_dir, "w.mat")
    save_latent_mat(latent_path, result.latent[0].cpu().numpy())
    if result.noises is not None:
        noises_path = os.path.splitext(latent_path)[0] + ".noises.npz"
        np.savez(noises_path, **{k: v.cpu().numpy() for k, v in result.noises.items()})
        print(f"optimized noise maps -> {noises_path} (merge --noises applies them)")
    return result


def read_pairs_csv(path, img_root="", min_similarity=0.5):
    """The pairs of a CSV with columns img_a,img_b[,similarity] (paths under
    `img_root`); rows whose similarity is below `min_similarity` are left
    out (reference projection_example_v2_percept_morph.py:339-344)."""
    with open(path, newline="") as f:
        rows = [row for row in csv.DictReader(f)
                if float(row.get("similarity", 1.0)) >= min_similarity]
    return [(os.path.join(img_root, r["img_a"]), os.path.join(img_root, r["img_b"]))
            for r in rows]


def shard_devices(G, batch):
    """`morph --shard`'s devices for a batch: every visible device of G's
    kind when more than one divides the batch (JAX's cli/morph.py:74-83),
    else None, with JAX's message."""
    dev = next(G.parameters()).device
    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    if len(devices) > 1 and batch % len(devices) == 0:
        print(f"sharding the batch-{batch} projection over {len(devices)} devices", flush=True)
        return devices
    print(f"--shard ignored: {len(devices)} device(s), batch {batch}", flush=True)
    return None


def run_morph_pairs(G, pairs, out_dir, loss="mse", steps=1000, lr=0.1, truncation_psi=0.7,
                    n_mean_latent=10000, chunk=250, alpha=0.5, seed=0, progress=None,
                    pairs_per_batch=4, shard=False):
    """Project `pairs` of photos, `pairs_per_batch` pairs as one batch-2P
    projection (each image tracks its own best; the loss is the batch's mean,
    so the result is that of 2P separate runs on the same noise but for
    Adam's eps and coupled decay, which weigh more against a smaller
    gradient), morph each pair's best latents (W = alpha*w_a +
    (1-alpha)*w_b) and regenerate every morph of a group in one batched
    forward. The prior statistics, then each group's per-step noise, are
    drawn from one torch.Generator seeded with `seed`. Writes per pair
    <a>_rec.png, <b>_rec.png, <a>.mat, <b>.mat, <a>_<b>_morph.png and
    <a>_<b>_morph.mat; returns [(ProjectionResult, morph images [P,H,W,3],
    morph latents [P,...])] a group. `progress` as in `run_project`. `shard`
    splits each group's rows over the visible devices (`shard_devices`)."""
    pcfg = ProjectionConfig(steps=steps, lr=lr, truncation_psi=truncation_psi,
                            n_mean_latent=n_mean_latent, chunk=chunk)
    gen = torch.Generator().manual_seed(seed)
    mean, std = latent_stats(G.cfg, gen, n_mean_latent)
    loss_fn = build_loss_stack(parse_loss_spec(loss))
    os.makedirs(out_dir, exist_ok=True)
    per = max(1, pairs_per_batch)
    out = []
    for lo in range(0, len(pairs), per):
        group = pairs[lo:lo + per]
        paths = [p for pair in group for p in pair]
        names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        print(f"projecting {len(group)} pair(s) as one batch-{len(paths)} projection "
              f"({steps} steps, loss={loss})...", flush=True)
        mesh = shard_devices(G, len(paths)) if shard else None
        res = project(G, _targets(G, paths), loss_fn, pcfg, mean, std, generator=gen,
                      progress=progress or _print_progress(steps), mesh=mesh)
        latents = res.latent.cpu().numpy()
        for i, name in enumerate(names):
            _save_png(os.path.join(out_dir, f"{name}_rec.png"), res.best_img[i].cpu().numpy())
            save_latent_mat(os.path.join(out_dir, f"{name}.mat"), latents[i])
        w_morphs = np.stack([morph_latents(latents[2 * i], latents[2 * i + 1], alpha)
                             for i in range(len(group))])
        imgs = synthesize(G, w_morphs, truncation_psi).cpu().numpy()
        for i in range(len(group)):
            stem = f"{names[2 * i]}_{names[2 * i + 1]}_morph"
            _save_png(os.path.join(out_dir, f"{stem}.png"), imgs[i])
            save_latent_mat(os.path.join(out_dir, f"{stem}.mat"), w_morphs[i])
            print(f"morph -> {os.path.join(out_dir, stem + '.png')}", flush=True)
        out.append((res, imgs, w_morphs))
    return out


def tag_seed(seed, tag):
    """The projection seed of one de-morph input: seed + crc32(tag) % 97.
    (The JAX script adds Python's hash(tag) % 97, which changes from process
    to process; crc32 gives every run the same draws.)"""
    return seed + zlib.crc32(tag.encode()) % 97


def run_demorph(G, morph_latent=None, accomplice_latent=None, out_dir="images/demorph",
                alpha=0.5, truncation_psi=0.7, morph_img=None, accomplice_img=None,
                loss="mse", steps=1000, n_mean_latent=10000, seed=0):
    """Recover the second identity from a morph and the accomplice:
    each given as a latent (.mat) or as a photo, which is projected first
    (prior statistics from `seed`, per-step noise from `tag_seed`). Writes
    demorph.png and demorph.mat; returns (image, recovered latent)."""
    def get_latent(mat, img, tag):
        if mat:
            return _as_batch(load_latent_mat(mat))
        if not img:
            raise ValueError(f"need the {tag} latent or the {tag} image")
        pcfg = ProjectionConfig(steps=steps, truncation_psi=truncation_psi,
                                n_mean_latent=n_mean_latent)
        mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(seed), n_mean_latent)
        print(f"projecting {tag} ({steps} steps)...", flush=True)
        res = project(G, _targets(G, [img]), build_loss_stack(parse_loss_spec(loss)), pcfg,
                      mean, std, generator=torch.Generator().manual_seed(tag_seed(seed, tag)),
                      progress=_print_progress(steps))
        return res.latent.cpu().numpy()

    os.makedirs(out_dir, exist_ok=True)
    w_rec = demorph_latent(get_latent(morph_latent, morph_img, "morph"),
                           get_latent(accomplice_latent, accomplice_img, "accomplice"), alpha)
    img = synthesize(G, w_rec, truncation_psi).cpu().numpy()
    _save_png(os.path.join(out_dir, "demorph.png"), img[0])
    save_latent_mat(os.path.join(out_dir, "demorph.mat"), w_rec[0])
    return img[0], w_rec[0]


def dataset_batches(path, resolution, batch=16, max_items=None):
    """NHWC uint8 batches of the images under <path>/<resolution>/, in
    order (JAX's cli/calc_metrics.py:dataset_batches)."""
    from morphganformer_tpu_torch.data.dataset import ImageFolderDataset

    ds = ImageFolderDataset(path, resolution, max_items=max_items)
    n = len(ds)
    for i in range(0, n, batch):
        yield np.stack([ds[j][0] for j in range(i, min(i + batch, n))])


def run_calc_metrics(G, data, metrics, max_items=None, batch=16, run_dir=None, detector="auto",
                     device="cuda"):
    """Each metric of `metrics` on G against the dataset under `data`:
    compute_metric, then its JSON line printed and appended to
    <run_dir>/metric-<name>.jsonl (JAX's cli/calc_metrics.py). `detector`:
    "auto", "raw", an .npz of InceptionV3 or a callable. Returns the results
    dicts."""
    from morphganformer_tpu_torch.metrics.detector import detector_kind, resolve_detector
    from morphganformer_tpu_torch.metrics.registry import compute_metric, report_metric

    kind = "probs" if any(detector_kind(m) == "probs" for m in metrics) else "features"
    det = resolve_detector(detector, kind=kind, device=device)
    out = []
    for metric in metrics:
        kwargs = dict(detector=det, dataset=dataset_batches(data, G.cfg.img_resolution, batch,
                                                            max_items),
                      G=G, batch=batch, device=device)
        if max_items:
            kwargs["max_items"] = max_items
        result = compute_metric(metric, **kwargs)
        report_metric(result, run_dir=run_dir)
        out.append(result)
    return out


def morph_qa(dir_a, dir_b, size=None, device="cuda"):
    """Mean PSNR and SSIM between the paired PNGs of two directories (sorted
    by name), each loaded by load_target at `size` (default: the width of
    the first image of the pair, as Pillow's `Image.open(fa).size[0]`)."""
    from morphganformer_tpu_torch.losses.pixel import psnr, ssim
    from morphganformer_tpu_torch.utils.image import read_image

    files_a = sorted(glob.glob(os.path.join(dir_a, "*.png")))
    files_b = sorted(glob.glob(os.path.join(dir_b, "*.png")))
    if len(files_a) != len(files_b) or not files_a:
        raise ValueError(f"paired dirs mismatch: {len(files_a)} vs {len(files_b)}")
    psnrs, ssims = [], []
    for fa, fb in zip(files_a, files_b):
        sz = size or read_image(fa).shape[1]
        a, b = (torch.from_numpy(load_target(f, sz)).to(device) for f in (fa, fb))
        psnrs.append(float(psnr(a, b)))
        ssims.append(float(ssim(a, b)))
    return {"psnr_mean": float(np.mean(psnrs)), "ssim_mean": float(np.mean(ssims)),
            "num_pairs": len(psnrs)}


def landmark_predictor(weights=None, device="cuda"):
    """img (HWC, 0-255 floats) -> [68, 2] (x, y) pixel landmarks from the
    landmark net (`weights`, default the bundled model) at temperature
    0.05, scaled by the image's size as JAX's `cli/warp_morphs.py:42-67`
    scales them."""
    path = weights or landmarks.bundled_landmark_path()
    if path is None:
        raise SystemExit("--predict-landmarks needs --landmark-weights "
                         "(no bundled landmark model found)")
    fn = landmarks.make_landmark_fn(landmarks.load_landmark_npz(path, device), temperature=0.05)

    @torch.no_grad()
    def predict(img):
        unit = fn(torch.from_numpy(img[None] / 127.5 - 1.0).to(device))[0].cpu().numpy()
        h, w = img.shape[:2]
        return unit * np.asarray([w, h], dtype=np.float64)

    return predict


def _warp_jobs(args):
    """(morph, morph CSV, a CSV, b CSV, image a, image b) per morph."""
    if not args.batch_list:
        if not args.morph:
            raise SystemExit("--morph (or --batch-list) is required")
        return [(args.morph, args.landmarks_morph, args.landmarks_a, args.landmarks_b,
                 args.img_a, args.img_b)]
    jobs = []
    with open(args.batch_list) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            if len(parts) not in (3, 4):
                raise SystemExit(f"bad batch line: {line!r}")
            morph, csv_a, csv_b = parts[:3]
            jobs.append((morph, parts[3] if len(parts) == 4 else None, csv_a, csv_b, None, None))
    return jobs


def run_warp_morphs(args):
    """The landmark-Delaunay warp of GAN morphs (JAX `cli/warp_morphs.py`):
    each morph warped onto the average of its two bona fide landmark sets,
    read from CSVs or predicted by the landmark net; the warp runs on
    `args.device` in float64. Writes `<out>/<name>_warped.png`; returns
    the paths."""
    from morphganformer_tpu_torch.morph.warp import (
        load_landmarks_csv,
        warp_morph_to_average_landmarks,
    )

    def load(path):
        return read_image_rgb(path).astype(np.float32)

    device = resolve_device(args.device)
    predict = (landmark_predictor(args.landmark_weights, device)
               if args.predict_landmarks else None)
    outputs, used_paths = [], set()
    for morph_path, csv_m, csv_a, csv_b, img_a, img_b in _warp_jobs(args):
        morph_img = load(morph_path)
        if csv_m:
            lm_m = load_landmarks_csv(csv_m)
        elif predict is not None:
            lm_m = predict(morph_img)
        else:
            raise SystemExit("need --landmarks-morph or --predict-landmarks")
        if csv_a and csv_b:
            lm_a, lm_b = load_landmarks_csv(csv_a), load_landmarks_csv(csv_b)
        elif predict is not None and img_a and img_b:
            lm_a, lm_b = predict(load(img_a)), predict(load(img_b))
        else:
            raise SystemExit("need --landmarks-a/--landmarks-b CSVs, or "
                             "--img-a/--img-b with --predict-landmarks")
        warped = warp_morph_to_average_landmarks(torch.from_numpy(morph_img).to(device),
                                                 lm_m, lm_a, lm_b).cpu().numpy()
        name = os.path.splitext(os.path.basename(morph_path))[0]
        out_path = os.path.join(args.out, f"{name}_warped.png")
        n = len(outputs)
        while out_path in used_paths:  # same basename from another directory
            out_path = os.path.join(args.out, f"{name}_{n:03d}_warped.png")
            n += 1
        used_paths.add(out_path)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        # JAX truncates: np.clip(...).astype(uint8).
        write_png(out_path, np.clip(warped, 0, 255).astype(np.uint8))
        outputs.append(out_path)
        print(f"saved {out_path}")
    return outputs


def run_extract_features(args, parser):
    """extract_features: embeddings of --images to --out, or the SVM
    fingerprinting of --bona against --morph printed as JSON (JAX's
    cli/extract_features.py)."""
    if args.random_backbone:
        params = face_embedding.random_iresnet_params(args.backbone_name, device=args.device)
    elif args.backbone:
        params = face_embedding.load_iresnet_npz(args.backbone, args.backbone_name,
                                                 device=args.device)
    else:
        parser.error("extract_features needs --backbone or --random-backbone")
    if args.bona and args.morph:
        _, bona = fingerprint.extract_dir(params, args.bona, device=args.device)
        _, morph = fingerprint.extract_dir(params, args.morph, device=args.device)
        print(json.dumps(fingerprint.svm_fingerprinting(bona, morph)), flush=True)
    elif args.images:
        files, feats = fingerprint.extract_dir(params, args.images, device=args.device)
        np.savez(args.out, files=np.asarray(files), features=feats)
        print(f"{len(files)} embeddings ({feats.shape[1]}-d) -> {args.out}", flush=True)
    else:
        parser.error("extract_features needs --images, or --bona and --morph")


def run_eval(args):
    """train --eval: the metrics (default fid2k_full) of the newest snapshot's
    Gs over the earlier runs of the same name, on 2000 images, written
    beside the snapshot (JAX's cli/train.py:176-200)."""
    from morphganformer_tpu_torch.metrics.detector import detector_kind, resolve_detector
    from morphganformer_tpu_torch.metrics.registry import compute_metric, report_metric
    from morphganformer_tpu_torch.training.loop import latest_snapshot

    prev = sorted(glob.glob(os.path.join(args.result_dir, f"{args.expname}-*")))
    snaps = [s for d in prev if (s := latest_snapshot(d))]
    if not snaps:
        raise FileNotFoundError(f"no snapshot to evaluate under {args.result_dir}/"
                                f"{args.expname}-*")
    _, G = load_network(snaps[-1], role="Gs", device=args.device)
    unconditional(G, snaps[-1])
    set_compute_dtype(G, "float32")         # the metrics run G in float32, as calc_metrics
    for metric in (args.metrics or ["fid2k_full"]):
        result = compute_metric(
            metric, detector=resolve_detector(args.detector, kind=detector_kind(metric),
                                              device=args.device),
            dataset=dataset_batches(args.data_dir, G.cfg.img_resolution, max_items=2000),
            G=G, max_items=2000, device=args.device)
        report_metric(result, run_dir=os.path.dirname(snaps[-1]), snapshot_pkl=snaps[-1])


GAMMAS = {"ffhq": 10, "cityscapes": 20, "clevr": 40, "bedrooms": 100}


def make_run_dir(result_dir, expname):
    """<result_dir>/<expname>-NNN, numbered after the existing ones
    (reference run_network.py:310-324)."""
    os.makedirs(result_dir, exist_ok=True)
    existing = [int(m.group(1)) for d in glob.glob(os.path.join(result_dir, f"{expname}-*"))
                if (m := re.fullmatch(rf"{re.escape(expname)}-(\d+)", os.path.basename(d)))]
    run_dir = os.path.join(result_dir, f"{expname}-{max(existing, default=-1) + 1:03d}")
    os.makedirs(run_dir, exist_ok=True)
    return run_dir


def build_train_configs(args):
    """(G, D, train) configs of the train flags, as JAX's cli/train.py
    builds them: the GANformer preset, the per-dataset R1 gamma and the
    batch and learning-rate heuristics (reference run_network.py:61-85,
    :162-177)."""
    from morphganformer_tpu_torch.models.config import (AttentionConfig, DiscriminatorConfig,
                                                        MappingConfig)
    from morphganformer_tpu_torch.training.loss import LossConfig
    from morphganformer_tpu_torch.training.train_step import TrainConfig

    if args.ganformer_default:
        attention = AttentionConfig(kmeans=True, integration="mul", norm="layer")
        mapping = MappingConfig(resnet=True, ltnt2ltnt=True, use_pos=True)
        gamma = args.gamma if args.gamma is not None else GAMMAS.get(args.dataset_name, 10)
    else:
        attention = AttentionConfig(kmeans=args.kmeans, integration=args.integration,
                                    norm=args.normalize)
        mapping = MappingConfig(resnet=args.mapping_resnet, ltnt2ltnt=args.mapping_ltnt2ltnt,
                                use_pos=args.use_pos)
        gamma = args.gamma if args.gamma is not None else 10
    z_per = args.latent_size // args.components_num
    g_cfg = GANformerConfig(
        z_dim=z_per, w_dim=z_per, k=args.components_num + 1, img_resolution=args.resolution,
        channel_base=args.channel_base, channel_max=args.channel_max,
        architecture=args.g_arch, transformer=args.transformer, start_res=args.start_res,
        end_res=args.end_res, component_dropout=args.component_dropout,
        mapping=mapping, attention=attention, dtype=args.dtype)
    d_cfg = DiscriminatorConfig(img_resolution=args.resolution, channel_base=args.channel_base,
                                channel_max=args.channel_max, architecture=args.d_arch,
                                dtype=args.dtype)
    batch = args.batch if args.batch is not None else min(min(4096 // args.resolution, 32), 64)
    lr = args.lrate if args.lrate is not None else (0.002 if args.resolution >= 1024 else 0.0025)
    t_cfg = TrainConfig(batch_size=batch, batch_gpu=args.batch_gpu, g_lr=lr, d_lr=lr,
                        loss=LossConfig(r1_gamma=gamma, style_mixing=args.style_mixing,
                                        component_mixing=args.component_mixing))
    return g_cfg, d_cfg, t_cfg


def _train_rank(rank, args):
    run_train(args)


def _from_rank0(value):
    """`value` as rank 0 has it, on every rank of the process group."""
    if not torch.distributed.is_initialized():
        return value
    box = [value]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


def run_train(args):
    """The train subcommand: the process group (JAX's --multihost,
    --coordinator, --num-processes and --process-id; or one spawned process
    per visible GPU when there are more), a numbered run directory,
    auto-resume from the newest snapshot of the earlier runs of the same
    name, then the loop."""
    from morphganformer_tpu_torch.training.loop import LoopConfig, latest_snapshot, training_loop

    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           requested=args.multihost, device=args.device)
    if (not torch.distributed.is_initialized() and not args.eval
            and resolve_device(args.device).type == "cuda" and torch.cuda.device_count() > 1):
        print(f"training on {torch.cuda.device_count()} GPUs, one process each", flush=True)
        spawn_local(_train_rank, torch.cuda.device_count(), "nccl", args=(args,))
        return None
    if args.eval:
        if is_main_process():
            run_eval(args)
        return None
    if args.raw_cache:
        os.environ["MGT_RAW_CACHE"] = "1"
    g_cfg, d_cfg, t_cfg = build_train_configs(args)
    resume = run_dir = None
    if is_main_process():
        resume = args.resume
        if resume == "auto":
            prev = sorted(glob.glob(os.path.join(args.result_dir, f"{args.expname}-*")))
            snaps = [s for d in prev if (s := latest_snapshot(d))]
            resume = snaps[-1] if snaps else None
            if resume:
                print(f"auto-resume from {resume}")
        run_dir = make_run_dir(args.result_dir, args.expname)
        print(f"run dir: {run_dir}")
    resume, run_dir = _from_rank0((resume, run_dir))
    l_cfg = LoopConfig(run_dir=run_dir, total_kimg=args.total_kimg,
                       kimg_per_tick=args.kimg_per_tick, snapshot_ticks=args.snapshot_ticks,
                       img_snapshot_ticks=args.img_snapshot_ticks,
                       eval_metrics=tuple(args.metrics), vis=tuple(args.vis),
                       detector=args.detector, snapshot_backend=args.snapshot_backend)
    return training_loop(g_cfg, d_cfg, t_cfg, l_cfg, args.data_dir, resume=resume,
                         max_ticks=args.max_ticks, device=args.device)


def train_parser(sub):
    """The flags of JAX's cli/train.py that the port honours; the others it
    refuses when they are set."""
    t = sub.add_parser("train", help="train a GANformer on a folder of PNGs")
    t.add_argument("--data-dir", required=True, help="dataset root: <data-dir>/<res>/*.png")
    t.add_argument("--dataset-name", default="ffhq")
    t.add_argument("--result-dir", default="results")
    t.add_argument("--expname", default="exp")
    t.add_argument("--resume", default="auto", help='"auto", a snapshot directory, or ""')
    t.add_argument("--total-kimg", type=int, default=25000)
    t.add_argument("--eval", action="store_true",
                   help="evaluate the newest snapshot's Gs on --metrics (default fid2k_full) "
                        "and stop")
    t.add_argument("--metrics", nargs="*", default=[],
                   help="metrics computed at every snapshot, e.g. fid50k_full")
    t.add_argument("--ganformer-default", action="store_true")
    t.add_argument("--resolution", type=int, default=256)
    t.add_argument("--components-num", type=int, default=16)
    t.add_argument("--latent-size", type=int, default=512)
    t.add_argument("--transformer", action="store_true", default=True)
    t.add_argument("--kmeans", action="store_true")
    t.add_argument("--integration", default="add")
    t.add_argument("--normalize", default=None)
    t.add_argument("--use-pos", dest="use_pos", action="store_true")
    t.add_argument("--mapping-resnet", action="store_true")
    t.add_argument("--mapping-ltnt2ltnt", action="store_true")
    t.add_argument("--g-arch", default="resnet", choices=["orig", "skip", "resnet"])
    t.add_argument("--d-arch", default="resnet", choices=["orig", "skip", "resnet"])
    t.add_argument("--start-res", type=int, default=0)
    t.add_argument("--end-res", type=int, default=8)
    t.add_argument("--component-dropout", type=float, default=0.0)
    t.add_argument("--channel-base", type=int, default=32 << 10)
    t.add_argument("--channel-max", type=int, default=512)
    t.add_argument("--batch", type=int, default=None)
    t.add_argument("--batch-gpu", type=int, default=4)
    t.add_argument("--lrate", type=float, default=None)
    t.add_argument("--gamma", type=float, default=None)
    t.add_argument("--style-mixing", type=float, default=0.9)
    t.add_argument("--component-mixing", type=float, default=0.0)
    t.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute type of G's synthesis and D's blocks (the parameters, the "
                        "optimizer state and the losses stay float32)")
    t.add_argument("--kimg-per-tick", type=float, default=4)
    t.add_argument("--snapshot-ticks", type=int, default=50)
    t.add_argument("--img-snapshot-ticks", type=int, default=50)
    t.add_argument("--vis", nargs="*", default=["grid"],
                   help="products at image-snapshot ticks: grid interp mixing attention noise")
    t.add_argument("--detector", default="auto",
                   help='the metrics\' detector: "auto", "raw" or an InceptionV3 .npz')
    t.add_argument("--max-ticks", type=int, default=None, help="stop after N ticks")
    t.add_argument("--snapshot-backend", default="msgpack", choices=["msgpack", "async", "orbax"],
                   help="async writes train_state.msgpack on a background thread; orbax is "
                        "refused")
    t.add_argument("--raw-cache", action="store_true",
                   help="decode the dataset once into <data-dir>/<res>.rawcache and train from "
                        "it (else the native loader if it builds, else read_image)")
    t.add_argument("--device", default="cuda")
    t.add_argument("--multihost", action="store_true",
                   help="join a process group (torchrun's environment without --coordinator)")
    t.add_argument("--coordinator", default=None,
                   help="host:port of the rendezvous of a multi-process run")
    t.add_argument("--num-processes", type=int, default=None)
    t.add_argument("--process-id", type=int, default=None)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m morphganformer_tpu_torch.cli",
                                description="GANformer generation, projection, morphing, "
                                            "de-morphing and training")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, dtype):
        sp.add_argument("--model", required=True, help="a checkpoint directory (its Gs), or "
                        "init:<resolution> (random weights)")
        sp.add_argument("--dtype", default=dtype, choices=["float32", "bfloat16"],
                        help=f"synthesis compute type (default {dtype}, as in JAX)")
        sp.add_argument("--seed", type=int, default=0, help="seed of the random weights and z")
        sp.add_argument("--device", default="cuda")
        sp.add_argument("--truncation-psi", "--truncation_psi", dest="truncation_psi",
                        type=float, default=0.7)

    g = sub.add_parser("generate", help="generate images from random z")
    common(g, "float32")
    g.add_argument("--output-dir", default="images")
    g.add_argument("--images-num", type=int, default=32)
    g.add_argument("--ratio", type=float, default=1.0)
    g.add_argument("--batch-size", type=int, default=4)

    m = sub.add_parser("merge", help="morph pairs of stored latents")
    common(m, "float32")
    m.add_argument("--latents", nargs="*", default=[], help=".mat latents, pairs in order")
    m.add_argument("--latent-dir", help="directory of .mat latents; every pair")
    m.add_argument("--out", default="images/merged")
    m.add_argument("--alpha", type=float, default=0.5)
    m.add_argument("--noises", default=None,
                   help="optimized noise maps (<latent>.noises.npz of project "
                        "--noise_regularize), applied before generating")

    def projection_flags(sp, steps, terms="mse, l1, psnr and ssim"):
        sp.add_argument("--loss", default="mse", help=f'loss stack spec, e.g. "mse", '
                        f'"lpips+mse", "lpips+0.01*wing+1*mse". Terms: {terms}')
        sp.add_argument("--step", type=int, default=steps)
        sp.add_argument("--n_mean_latent", type=int, default=10000)

    pr = sub.add_parser("project", help="project a photo into the latent space")
    common(pr, "bfloat16")
    projection_flags(pr, 5000, "mse l1 psnr ssim lpips wing awing facenet arcface mdf lbp")
    pr.add_argument("--img", required=True,
                    help="target photo: PNG, JPEG, BMP or Netpbm (any size)")
    pr.add_argument("--size", type=int, default=None,
                    help="compute the loss at this resolution (downsamples both images when "
                         "below the model resolution)")
    pr.add_argument("--lamda", type=float, default=None,
                    help="wing (and awing) weight override: p + lamda*wing + beta*mse")
    pr.add_argument("--beta", type=float, default=None, help="mse weight override")
    pr.add_argument("--lpips-weights", dest="lpips_weights", default=None,
                    help=".npz of python -m morphganformer_tpu_torch.tools.convert_lpips")
    pr.add_argument("--lpips-net", dest="lpips_net", default="alex",
                    choices=["alex", "vgg", "squeeze"])
    pr.add_argument("--landmark-weights", dest="landmark_weights", default=None,
                    help="landmark net .npz (default: the bundled synthetic-face model; python -m "
                         "morphganformer_tpu_torch.tools.train_landmarks retrains it)")
    pr.add_argument("--facenet-weights", dest="facenet_weights", default=None,
                    help=".npz of python -m morphganformer_tpu_torch.tools.convert_facenet")
    pr.add_argument("--arcface-weights", dest="arcface_weights", default=None,
                    help=".npz of python -m morphganformer_tpu_torch.tools.convert_iresnet "
                         "(iresnet18)")
    pr.add_argument("--mdf-weights", dest="mdf_weights", default=None,
                    help=".npz of python -m morphganformer_tpu_torch.tools.convert_mdf")
    pr.add_argument("--random-perceptual", action="store_true",
                    help="random weights for the perceptual nets without a file (smoke run)")
    pr.add_argument("--path_to_gen", default="images/projection")
    pr.add_argument("--lr", type=float, default=0.1)
    pr.add_argument("--lr_rampup", type=float, default=0.05)
    pr.add_argument("--lr_rampdown", type=float, default=0.25)
    pr.add_argument("--noise", type=float, default=0.05)
    pr.add_argument("--noise_ramp", type=float, default=0.75)
    pr.add_argument("--chunk", type=int, default=250)
    pr.add_argument("--w_plus", action="store_true",
                    help="optimize per-layer W+ latents [k, num_ws, w_dim]")
    pr.add_argument("--noise_regularize", type=float, default=0.0,
                    help="> 0: optimize the const-noise maps with the latent under this "
                         "weight of their autocorrelation penalty (batch 1); the maps go to "
                         "<latent>.noises.npz")
    pr.add_argument("--init-latent", default=None, help="start from a stored .mat latent")
    pr.add_argument("--save-latent", default=None)
    pr.add_argument("--ratio", type=float, default=1.0)

    mo = sub.add_parser("morph", help="project a pair of photos and morph them")
    common(mo, "bfloat16")
    projection_flags(mo, 1000)
    mo.add_argument("--img-a")
    mo.add_argument("--img-b")
    mo.add_argument("--pairs-csv", help="CSV with columns img_a,img_b[,similarity]; rows with "
                    "similarity < --min-similarity are skipped")
    mo.add_argument("--img-root", default="", help="prefix of the paths in --pairs-csv")
    mo.add_argument("--min-similarity", type=float, default=0.5)
    mo.add_argument("--pairs-per-batch", type=int, default=4,
                    help="CSV mode: pairs projected together as one batch-2P projection")
    mo.add_argument("--shard", action="store_true",
                    help="split each batch-2P projection's rows over the visible GPUs (when "
                         "their number divides the batch)")
    mo.add_argument("--out", default="images/morphs")
    mo.add_argument("--alpha", type=float, default=0.5)
    mo.add_argument("--lr", type=float, default=0.1)
    mo.add_argument("--chunk", type=int, default=250)

    d = sub.add_parser("demorph", help="recover an identity from a morph and an accomplice")
    common(d, "bfloat16")
    projection_flags(d, 1000)
    d.add_argument("--morph-latent", help=".mat of the morph latent")
    d.add_argument("--accomplice-latent", help=".mat of the accomplice latent")
    d.add_argument("--morph-img", help="morph photo (projected first)")
    d.add_argument("--accomplice-img", help="accomplice photo (projected first)")
    d.add_argument("--out", default="images/demorph")
    d.add_argument("--alpha", type=float, default=0.5)

    train_parser(sub)

    c = sub.add_parser("calc_metrics", help="quality metrics of a generator, or morph QA")
    c.add_argument("--model", help="a checkpoint directory (its Gs), or init:<resolution>")
    c.add_argument("--data", help="dataset root: <data>/<res>/*.png")
    c.add_argument("--metrics", nargs="+", default=["fid2k_full"])
    c.add_argument("--max-items", type=int, default=None)
    c.add_argument("--batch", type=int, default=16)
    c.add_argument("--run-dir", default=None, help="where metric-<name>.jsonl is appended")
    c.add_argument("--detector", default="auto",
                   help='"auto" (a converted InceptionV3 through $MGT_INCEPTION_NPZ or the '
                        'cache, else raw pixels), "raw", or an .npz')
    c.add_argument("--device", default="cuda")
    c.add_argument("--morph-qa", action="store_true",
                   help="mean PSNR and SSIM between the paired PNGs of --dir-a and --dir-b")
    c.add_argument("--dir-a")
    c.add_argument("--dir-b")
    c.add_argument("--size", type=int, default=None)

    dataset_tool.add_parser(sub)

    wm = sub.add_parser("warp_morphs", help="Delaunay landmark warp of GAN morphs")
    wm.add_argument("--morph", help="generated morph image")
    wm.add_argument("--img-a", help="bona fide photo A (with --predict-landmarks)")
    wm.add_argument("--img-b", help="bona fide photo B")
    wm.add_argument("--landmarks-morph", help="68-point CSV for the morph")
    wm.add_argument("--landmarks-a", help="68-point CSV for identity A")
    wm.add_argument("--landmarks-b", help="68-point CSV for identity B")
    wm.add_argument("--batch-list", help="text file: morph.png,a.csv,b.csv[,morph.csv] per line")
    wm.add_argument("--predict-landmarks", action="store_true",
                    help="predict landmarks with the landmark net instead of reading CSVs")
    wm.add_argument("--landmark-weights", default=None,
                    help="landmark net .npz (default: the bundled synthetic-face model; python -m "
                         "morphganformer_tpu_torch.tools.train_landmarks retrains it)")
    wm.add_argument("--out", default="images/warped")
    wm.add_argument("--device", default="cuda")

    mv = sub.add_parser("make_video", help="PNG or JPEG frames -> animated GIF")
    mv.add_argument("--images", help="directory of frames")
    mv.add_argument("--list", dest="list_file", help="text file of frame paths")
    mv.add_argument("--out", required=True)
    mv.add_argument("--fps", type=int, default=24)

    ef = sub.add_parser("extract_features",
                        help="face embeddings of a folder, or bona fide vs morph SVM detection")
    ef.add_argument("--backbone",
                    help="iresnet .npz of python -m morphganformer_tpu_torch.tools.convert_iresnet")
    ef.add_argument("--backbone-name", default="iresnet18")
    ef.add_argument("--random-backbone", action="store_true")
    ef.add_argument("--images", help="folder of PNGs and JPEGs to embed")
    ef.add_argument("--out", default="features.npz")
    ef.add_argument("--bona", help="bona fide folder (fingerprinting mode)")
    ef.add_argument("--morph", help="morph folder (fingerprinting mode)")
    ef.add_argument("--device", default="cuda")

    args = p.parse_args(argv)
    if args.command == "dataset_tool":
        code = dataset_tool.run(args)
        if code:
            raise SystemExit(code)
        return
    if args.command == "warp_morphs":
        run_warp_morphs(args)
        return
    if args.command == "extract_features":
        run_extract_features(args, p)
        return
    if args.command == "make_video":
        frames = video.collect_frames(args.images, args.list_file)
        out = video.write_video(frames, args.out, args.fps)
        print(f"{len(frames)} frames -> {out}")
        return
    if args.command == "train":
        run_train(args)
        return
    if args.command == "calc_metrics":
        if args.morph_qa:
            print(json.dumps(morph_qa(args.dir_a, args.dir_b, args.size, args.device)))
            return
        if not args.model:
            p.error("calc_metrics needs --model (or --morph-qa)")
        _, G = get_model(args.model, device=args.device)
        run_calc_metrics(G, args.data, args.metrics, args.max_items, args.batch, args.run_dir,
                         args.detector, args.device)
        return
    if args.command == "morph" and not args.pairs_csv and not (args.img_a and args.img_b):
        p.error("morph needs --img-a and --img-b, or --pairs-csv")
    _, G = get_model(args.model, device=args.device, dtype=args.dtype)
    if args.command == "generate":
        run_generate(G, args.output_dir, args.images_num, args.truncation_psi,
                     args.ratio, args.batch_size, args.seed)
    elif args.command == "merge":
        files = list(args.latents)
        if args.latent_dir:
            files += sorted(os.path.join(args.latent_dir, f)
                            for f in os.listdir(args.latent_dir) if f.endswith(".mat"))
        run_merge(G, files, args.out, args.alpha, args.truncation_psi,
                  all_pairs=bool(args.latent_dir), noises=args.noises)
    elif args.command == "project":
        nets = LossNets(**{f.name: getattr(args, f.name) for f in dataclasses.fields(LossNets)})
        run_project(G, args.img, args.path_to_gen, args.loss, args.step, args.lr,
                    args.lr_rampup, args.lr_rampdown, args.noise, args.noise_ramp,
                    args.truncation_psi, args.n_mean_latent, args.chunk, args.w_plus,
                    args.init_latent, args.save_latent, args.ratio, args.seed, size=args.size,
                    lamda=args.lamda, beta=args.beta, nets=nets,
                    noise_regularize=args.noise_regularize)
    elif args.command == "morph":
        pairs = (read_pairs_csv(args.pairs_csv, args.img_root, args.min_similarity)
                 if args.pairs_csv else [(args.img_a, args.img_b)])
        run_morph_pairs(G, pairs, args.out, args.loss, args.step, args.lr, args.truncation_psi,
                        args.n_mean_latent, args.chunk, args.alpha, args.seed,
                        pairs_per_batch=args.pairs_per_batch, shard=args.shard)
    else:
        run_demorph(G, args.morph_latent, args.accomplice_latent, args.out, args.alpha,
                    args.truncation_psi, args.morph_img, args.accomplice_img, args.loss,
                    args.step, args.n_mean_latent, args.seed)


if __name__ == "__main__":
    main()
