"""Entry points of the port: generate, merge and demorph.

    python -m morphganformer_tpu_torch.cli generate --model init:1024 --output-dir images
    python -m morphganformer_tpu_torch.cli merge --model init:1024 --latents a.mat b.mat --out morphs
    python -m morphganformer_tpu_torch.cli demorph --model init:1024 \
        --morph-latent m.mat --accomplice-latent a.mat --out demorph

They mirror cli/generate.py, cli/merge.py and cli/demorph.py of the JAX
package. `--model init:<res>` builds a randomly initialised FFHQ-style
generator at that resolution (weights from `--seed`); reading checkpoints is
not ported yet. Everything runs on the card; `--device cpu` asks for the CPU.
Latents are fed to the generator as z, as the JAX entry points do.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np
import torch

from morphganformer_tpu_torch.models import GANformerConfig, init_generator
from morphganformer_tpu_torch.morph import (
    demorph_latent,
    load_latent_mat,
    morph_latents,
    save_latent_mat,
)
from morphganformer_tpu_torch.utils.image import crop_max_rectangle, to_uint8, write_png


def get_model(model_spec: str, device="cuda", seed=0):
    """`init:<res>` -> (cfg, generator with random weights from `seed`)."""
    if not model_spec.startswith("init:"):
        raise NotImplementedError("loading checkpoints is not ported yet; use init:<res>")
    cfg = GANformerConfig(img_resolution=int(model_spec.split(":", 1)[1]))
    return cfg, init_generator(cfg, seed=seed, device=device)


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


def run_merge(G, latent_files, out_dir, alpha=0.5, truncation_psi=0.7, all_pairs=False):
    """Morph pairs of .mat latents (in order, or every pair with
    `all_pairs`): W = alpha*w1 + (1-alpha)*w2, regenerate, write
    <a>_<b>.png and <a>_<b>.mat. Returns [(stem, image, W)]."""
    if len(latent_files) < 2:
        raise ValueError("need at least two latents")
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


def run_demorph(G, morph_latent, accomplice_latent, out_dir, alpha=0.5, truncation_psi=0.7):
    """Recover the second identity from a morph latent and the accomplice's
    latent (.mat files), regenerate, write demorph.png and demorph.mat.
    Returns (image, recovered latent)."""
    os.makedirs(out_dir, exist_ok=True)
    w_rec = demorph_latent(_as_batch(load_latent_mat(morph_latent)),
                           _as_batch(load_latent_mat(accomplice_latent)), alpha)
    img = synthesize(G, w_rec, truncation_psi).cpu().numpy()
    _save_png(os.path.join(out_dir, "demorph.png"), img[0])
    save_latent_mat(os.path.join(out_dir, "demorph.mat"), w_rec[0])
    return img[0], w_rec[0]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m morphganformer_tpu_torch.cli",
                                description="GANformer generation, morphing and de-morphing")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--model", required=True, help="init:<resolution> (random weights)")
        sp.add_argument("--seed", type=int, default=0, help="seed of the random weights and z")
        sp.add_argument("--device", default="cuda")
        sp.add_argument("--truncation-psi", "--truncation_psi", dest="truncation_psi",
                        type=float, default=0.7)

    g = sub.add_parser("generate", help="generate images from random z")
    common(g)
    g.add_argument("--output-dir", default="images")
    g.add_argument("--images-num", type=int, default=32)
    g.add_argument("--ratio", type=float, default=1.0)
    g.add_argument("--batch-size", type=int, default=4)

    m = sub.add_parser("merge", help="morph pairs of stored latents")
    common(m)
    m.add_argument("--latents", nargs="*", default=[], help=".mat latents, pairs in order")
    m.add_argument("--latent-dir", help="directory of .mat latents; every pair")
    m.add_argument("--out", default="images/merged")
    m.add_argument("--alpha", type=float, default=0.5)

    d = sub.add_parser("demorph", help="recover an identity from a morph latent")
    common(d)
    d.add_argument("--morph-latent", required=True)
    d.add_argument("--accomplice-latent", required=True)
    d.add_argument("--out", default="images/demorph")
    d.add_argument("--alpha", type=float, default=0.5)

    args = p.parse_args(argv)
    _, G = get_model(args.model, device=args.device, seed=args.seed)
    if args.command == "generate":
        run_generate(G, args.output_dir, args.images_num, args.truncation_psi,
                     args.ratio, args.batch_size, args.seed)
    elif args.command == "merge":
        files = list(args.latents)
        if args.latent_dir:
            files += sorted(os.path.join(args.latent_dir, f)
                            for f in os.listdir(args.latent_dir) if f.endswith(".mat"))
        run_merge(G, files, args.out, args.alpha, args.truncation_psi,
                  all_pairs=bool(args.latent_dir))
    else:
        run_demorph(G, args.morph_latent, args.accomplice_latent, args.out,
                    args.alpha, args.truncation_psi)


if __name__ == "__main__":
    main()
