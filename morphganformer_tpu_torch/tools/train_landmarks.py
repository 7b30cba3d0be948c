"""Train the compact 68-point landmark CNN (losses/landmarks.py) on the
synthetic face stream (losses/synthetic_faces.py); port of the JAX package's
tools/train_landmarks.py, on torch and torch.optim.Adam.

The reference gets landmarks from dlib's iBUG-trained predictor
(1024_example_wing_loss_perceptual_sqz_MSE.py:131-170); that model and its
data are not in the repository, so this trains the same architecture the
projection uses on procedurally generated faces with exact landmark labels.
The result (bundled at morphganformer_tpu_torch/losses/weights/
landmarks_synthetic.npz) gives the wing losses true gradients; a model
trained on real faces is a weight swap through the same .npz layout.

Loss: the sigmoid heatmaps' MSE against unit-peak gaussians, times 10, plus
the soft-argmax (temperature 0.05) coordinates' squared L2. JAX's defaults:
2000 Adam steps at lr 2e-3 (torch's betas and eps are optax's), batch 32 of
128^2 faces drawn from a dataset of 2048 made from RandomState(seed), the
validation error on 128 faces from RandomState(seed + 1), in pixels at 256
scale. It runs on the card unless `--device cpu` is given.

Usage: python -m morphganformer_tpu_torch.tools.train_landmarks [steps] [out.npz] [--device cpu]
"""

import argparse
import os
import time

import numpy as np
import torch

from morphganformer_tpu_torch.losses.landmarks import (BUNDLED_NPZ, landmark_heatmaps,
                                                       random_landmark_params, soft_argmax)
from morphganformer_tpu_torch.losses.synthetic_faces import sample_batch
from morphganformer_tpu_torch.utils.device import resolve_device

HM = 64  # heatmap resolution (256-input backbone stride 4)


def gaussian_targets(coords, sigma=1.5):
    """coords [B,68,2] in [0,1] -> [B,HM,HM,68] unit-peak gaussians."""
    grid = (torch.arange(HM, dtype=torch.float32, device=coords.device) + 0.5) / HM
    dy = grid[None, :, None] - coords[:, None, :, 1]          # [B,HM,68]
    dx = grid[None, :, None] - coords[:, None, :, 0]
    s2 = 2.0 * (sigma / HM) ** 2
    gy = torch.exp(-torch.square(dy) / s2)
    gx = torch.exp(-torch.square(dx) / s2)
    return gy[:, :, None, :] * gx[:, None, :, :]              # [B,HM,HM,68]


def loss_fn(params, imgs, coords):
    """(loss, (heatmap loss, coordinate loss)) of a batch, JAX's loss_fn."""
    hm = landmark_heatmaps(params, imgs)
    target = gaussian_targets(coords)
    hm_loss = torch.mean(torch.square(torch.sigmoid(hm) - target))
    pred = soft_argmax(hm, temperature=0.05)
    coord_loss = torch.mean(torch.sum(torch.square(pred - coords), dim=-1))
    return hm_loss * 10.0 + coord_loss, (hm_loss, coord_loss)


def leaves(params):
    """The parameter tensors of a landmark tree, in a fixed order."""
    return [v for _, v in sorted(_named(params))]


def _named(params):
    for name, v in params.items():
        if isinstance(v, dict):
            for leaf, t in v.items():
                yield f"{name}_{leaf}", t
        else:
            yield name, v


def train_step(params, opt, imgs, coords):
    """One Adam step on a batch; returns (loss, (hm loss, coord loss))."""
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(params, imgs, coords)
    loss.backward()
    opt.step()
    return loss.detach(), tuple(a.detach() for a in aux)


@torch.no_grad()
def val_error(params, imgs, coords):
    """Mean landmark error over the faces, in [0, 1] units."""
    pred = soft_argmax(landmark_heatmaps(params, imgs), temperature=0.05)
    return torch.linalg.norm(pred - coords, dim=-1).mean()


def save_npz(path, params):
    """Inverse of losses.landmarks.load_landmark_npz: the JAX layout, conv
    weights HWIO."""
    flat = {}
    for name, t in _named(params):
        a = t.detach().cpu().numpy()
        flat[name] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    np.savez(path, **flat)


def main(steps=2000, out=None, batch=32, size=128, lr=2e-3, seed=0, dataset_size=2048,
         val_size=128, log_every=100, device="cuda"):
    """Train, save to `out` (the port's bundled weights by default) and
    return {dataset_s, steps, steps_per_s, val_err_px, out}."""
    dev = resolve_device(device)
    out = out or BUNDLED_NPZ
    rng = np.random.RandomState(seed)
    print(f"generating {dataset_size} synthetic faces...", flush=True)
    t0 = time.perf_counter()
    imgs, lms = sample_batch(rng, dataset_size, size)
    val_imgs, val_lms = sample_batch(np.random.RandomState(seed + 1), val_size, size)
    dataset_s = time.perf_counter() - t0
    print(f"dataset: {dataset_s:.3f} s", flush=True)
    imgs, lms = torch.from_numpy(imgs).to(dev), torch.from_numpy(lms).to(dev)
    val_imgs, val_lms = torch.from_numpy(val_imgs).to(dev), torch.from_numpy(val_lms).to(dev)

    params = random_landmark_params(seed=seed, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves(params), lr=lr)

    t0 = time.perf_counter()
    for i in range(steps):
        idx = torch.from_numpy(rng.randint(0, dataset_size, batch)).to(dev)
        loss, aux = train_step(params, opt, imgs[idx], lms[idx])
        if i % log_every == 0 or i == steps - 1:
            err = val_error(params, val_imgs, val_lms).item()
            print(f"step {i:5d} loss {loss.item():.5f} hm {aux[0].item():.5f} coord "
                  f"{aux[1].item():.5f} val_err {err * 256:.2f}px@256 "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    train_s = time.perf_counter() - t0
    print(f"trained {steps} steps in {train_s:.3f} s: {steps / train_s:.3f} steps/s on "
          f"{dev.type}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    save_npz(out, params)
    print(f"saved -> {out}", flush=True)
    return dict(dataset_s=dataset_s, steps=steps, steps_per_s=steps / train_s,
                val_err_px=err * 256, out=out)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m morphganformer_tpu_torch.tools.train_landmarks",
                                description="Train the landmark net on synthetic faces.")
    p.add_argument("steps", nargs="?", type=int, default=2000)
    p.add_argument("out", nargs="?", default=None,
                   help="the .npz to write (default: the port's bundled weights)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    main(a.steps, a.out, device=a.device)
