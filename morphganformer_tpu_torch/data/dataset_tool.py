"""Dataset preparation (port of cli/dataset_tool.py).

Builds the per-LoD PNG folder layout `out/{resolution}/*.png` that
`ImageFolderDataset` and `cli.py train --data-dir` read (reference
dataset_tool.py:66-77), with the `display`, `compare` and `extract`
self-checks (:177-225). Each image is centre-cropped to a square and
Lanczos-resized by the port's copy of Pillow's resampling, equal to it to
the bit, then written with the port's PNG encoder; the names, the levels
and the exit code of `compare` are JAX's.

    python -m morphganformer_tpu_torch.cli dataset_tool create_from_images out in \
        --resolution 1024 --lods 2
    python -m morphganformer_tpu_torch.cli dataset_tool display out --resolution 1024
    python -m morphganformer_tpu_torch.cli dataset_tool compare out other --resolution 1024
    python -m morphganformer_tpu_torch.cli dataset_tool extract out pngs --resolution 1024

The port reads PNG only: an input of another extension that JAX's tool
takes (jpg, jpeg, bmp, webp) raises by name before anything is written,
since leaving it out would build another dataset than JAX's.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from morphganformer_tpu_torch.data.dataset import ImageFolderDataset
from morphganformer_tpu_torch.utils.image import (
    create_img_grid,
    lanczos_resize,
    read_png_rgb,
    write_png,
)

IMAGE_PATTERNS = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.webp")


def iter_images(in_dir):
    """JAX's input list: every file under `in_dir` that matches one of its
    patterns, sorted."""
    files = []
    for e in IMAGE_PATTERNS:
        files += glob.glob(os.path.join(in_dir, "**", e), recursive=True)
    return sorted(files)


def center_crop(img):
    """The largest centred square, as JAX crops it with Pillow's box
    ((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2)."""
    h, w = img.shape[:2]
    s = min(w, h)
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]


def create_from_images(out_dir, in_dir, resolution, lods=1):
    """Centre-crop and resize every image under `in_dir` to `resolution`
    and write the PNG pyramid: full resolution plus `lods` - 1 halved
    levels, `out_dir/{res}/{i:08d}.png`."""
    files = iter_images(in_dir)
    if not files:
        raise FileNotFoundError(f"no images under {in_dir}")
    other = [f for f in files if not f.lower().endswith(".png")]
    if other:
        raise ValueError(f"{other[0]}: the port reads PNG only ({len(other)} such inputs under "
                         f"{in_dir}); convert them to PNG first (ROADMAP.md queue 1, "
                         "\"The rest\")")
    res_levels = [resolution // (2 ** i) for i in range(lods)]
    for r in res_levels:
        os.makedirs(os.path.join(out_dir, str(r)), exist_ok=True)
    for i, path in enumerate(files):
        img = center_crop(read_png_rgb(path))
        for r in res_levels:
            write_png(os.path.join(out_dir, str(r), f"{i:08d}.png"), lanczos_resize(img, r, r))
        if (i + 1) % 100 == 0:
            print(f"  {i + 1}/{len(files)}")
    print(f"wrote {len(files)} images at levels {res_levels} -> {out_dir}")


def display(dataset_dir, resolution, num=9):
    """A grid of the first `num` items, written as
    `dataset_dir/preview_{resolution}.png`; returns its path."""
    ds = ImageFolderDataset(dataset_dir, resolution)
    imgs = np.stack([ds[i][0] for i in range(min(num, len(ds)))])
    out = os.path.join(dataset_dir, f"preview_{resolution}.png")
    write_png(out, create_img_grid(imgs.astype(np.float32) / 127.5 - 1.0))
    print(f"{len(ds)} images; preview -> {out}")
    return out


def extract(dataset_dir, out_dir, resolution, num=None):
    """The prepared items back as `out_dir/img{i:08d}.png`."""
    ds = ImageFolderDataset(dataset_dir, resolution)
    os.makedirs(out_dir, exist_ok=True)
    n = len(ds) if num is None else min(num, len(ds))
    for i in range(n):
        write_png(os.path.join(out_dir, f"img{i:08d}.png"), ds[i][0])
    print(f"extracted {n} images -> {out_dir}")


def compare(dir_a, dir_b, resolution, max_errors=10):
    """Item-by-item diff of two prepared datasets; returns the number of
    differences (at most `max_errors`)."""
    a = ImageFolderDataset(dir_a, resolution)
    b = ImageFolderDataset(dir_b, resolution)
    errors = 0
    if len(a) != len(b):
        print(f"size mismatch: {len(a)} vs {len(b)}")
        errors += 1
    for i in range(min(len(a), len(b))):
        ia, ib = a[i][0], b[i][0]
        if not np.array_equal(ia, ib):
            print(f"item {i} differs (max abs diff "
                  f"{np.abs(ia.astype(int) - ib.astype(int)).max()})")
            errors += 1
            if errors >= max_errors:
                print("...")
                break
    print("identical" if errors == 0 else f"{errors} differences")
    return errors


def add_parser(sub):
    """The `dataset_tool` subcommand and its own subcommands (JAX's flags)."""
    p = sub.add_parser("dataset_tool", help="prepare a <res>/*.png dataset from a folder of PNGs")
    cmds = p.add_subparsers(dest="tool_cmd", required=True)
    c = cmds.add_parser("create_from_images")
    c.add_argument("out_dir")
    c.add_argument("in_dir")
    c.add_argument("--resolution", type=int, default=1024)
    c.add_argument("--lods", type=int, default=1)
    d = cmds.add_parser("display")
    d.add_argument("dataset_dir")
    d.add_argument("--resolution", type=int, required=True)
    cp = cmds.add_parser("compare")
    cp.add_argument("dir_a")
    cp.add_argument("dir_b")
    cp.add_argument("--resolution", type=int, required=True)
    ex = cmds.add_parser("extract")
    ex.add_argument("dataset_dir")
    ex.add_argument("out_dir")
    ex.add_argument("--resolution", type=int, required=True)
    ex.add_argument("--num", type=int, default=None)


def run(args):
    """Run a parsed `dataset_tool` command; returns the process's exit code
    (1 when `compare` finds a difference, as JAX's)."""
    if args.tool_cmd == "create_from_images":
        create_from_images(args.out_dir, args.in_dir, args.resolution, args.lods)
    elif args.tool_cmd == "display":
        display(args.dataset_dir, args.resolution)
    elif args.tool_cmd == "compare":
        return 1 if compare(args.dir_a, args.dir_b, args.resolution) else 0
    else:
        extract(args.dataset_dir, args.out_dir, args.resolution, args.num)
    return 0
