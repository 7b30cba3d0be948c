"""End-to-end training demo on the procedural faces (port of the JAX
package's tools/train_demo_synfaces.py).

Renders a small PNG dataset with the port's losses/synthetic_faces.py (the
stream that trained the landmark network) and `write_png`, then runs the
port's `cli train` on it with the JAX tool's flags: the whole adversarial
loop (G and D steps, lazy R1 and path-length regularisation, style mixing,
the EMA, snapshots, image grids and the metric) on the card unless
`--device cpu` is given. No real face data is in the repository, so this
shows the training stack end to end, not convergence to a published FID.
The dataset is JAX's for the same seed pixel for pixel (JAX writes it with
Pillow); fid2k_full runs on the raw-pixel detector unless an InceptionV3
.npz is named ($MGT_INCEPTION_NPZ), so it needs no download.

Usage: python -m morphganformer_tpu_torch.tools.train_demo_synfaces
       [--out $TMPDIR/synface_run] [--images 512] [--res 64] [--ticks 3]
       [--kimg-per-tick 2] [--metrics fid2k_full] [--device cuda]

`--kimg-per-tick` and `--metrics` keep JAX's values (2 and fid2k_full)
unless given; a smoke run cuts them (`--metrics` with no name runs none).
The dataset is rendered once: a later run with the same `--out` and
`--res` trains on the PNGs already there, as JAX's tool does.
"""

import argparse
import os
import tempfile

import numpy as np

from morphganformer_tpu_torch.losses.synthetic_faces import sample_face
from morphganformer_tpu_torch.utils.image import write_png


def build_dataset(root: str, images: int, res: int, seed: int = 42) -> None:
    """`images` faces at res^2 under <root>/<res>/%05d.png, drawn from
    RandomState(seed) as JAX's build_dataset draws them."""
    out = os.path.join(root, str(res))
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(images):
        img, _ = sample_face(rng, size=res)  # [-1, 1] float32 HWC
        write_png(os.path.join(out, f"{i:05d}.png"),
                  np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8))
    print(f"dataset: {images} images at {res}^2 under {out}", flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m morphganformer_tpu_torch.tools.train_demo_synfaces")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synface_run"))
    p.add_argument("--images", type=int, default=512)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--ticks", type=int, default=3)
    p.add_argument("--kimg-per-tick", type=float, default=2)
    p.add_argument("--metrics", nargs="*", default=["fid2k_full"])
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def train_argv(args):
    """The `cli train` arguments: JAX's flags (tools/train_demo_synfaces.py),
    then the device."""
    data_dir = os.path.join(args.out, "dataset")
    end_res = max(2, args.res.bit_length() - 1)  # attention up to res/2
    kimg = args.kimg_per_tick
    return [
        "train",
        "--data-dir", data_dir, "--dataset-name", "synface",
        "--ganformer-default",
        "--resolution", str(args.res), "--end-res", str(end_res),
        "--batch", "16", "--batch-gpu", "16",
        "--components-num", "8", "--latent-size", "128",
        "--channel-base", "8192", "--channel-max", "128",
        "--kimg-per-tick", f"{kimg:g}", "--total-kimg", str(max(1, round(kimg * args.ticks))),
        "--max-ticks", str(args.ticks),
        "--snapshot-ticks", "1", "--img-snapshot-ticks", "1",
        "--metrics", *args.metrics,
        "--result-dir", os.path.join(args.out, "results"),
        "--device", args.device,
    ]


def main(argv=None):
    """Build the dataset (once), then train through `cli.main` in this
    process. Returns the exit code."""
    from morphganformer_tpu_torch import cli

    args = parse_args(argv)
    data_dir = os.path.join(args.out, "dataset")
    if not os.path.isdir(os.path.join(data_dir, str(args.res))):
        build_dataset(data_dir, args.images, args.res)
    rest = train_argv(args)
    print("exec: python -m morphganformer_tpu_torch.cli " + " ".join(rest), flush=True)
    cli.main(rest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
