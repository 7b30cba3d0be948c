"""Visualisations written at image-snapshot ticks (port of
morphganformer_tpu/training/visualize.py): sample grids, attention blends,
latent interpolations, style-mixing tables and noise-variance maps
(reference visualize.py `vis()` :60-310).

Each function takes the generator (its weights are on its device) and
returns the picture as HWC uint8, written with `write_png` when `path` is
given. The latents are drawn from a CPU `torch.Generator` seeded with
`seed` unless the caller passes them (JAX draws its own, so a comparison
with JAX passes JAX's). Images are generated `batch` at a time, so 16
images of 1024^2 need the memory of `batch`; the result does not depend on
`batch`. Attention blends run their `num` images as one batch, as JAX's do:
their maps take 4 bytes a pixel for each image, component, layer and head.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from morphganformer_tpu_torch.utils.image import adjust_range, create_img_grid, to_uint8, write_png

# A fixed qualitative palette for component attention maps (JAX
# `visualize.py:22-28`).
_PALETTE = np.asarray([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [230, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
], dtype=np.float32)


def slerp(a, b, t):
    """Spherical interpolation over the last axis (reference
    perceptual_path_length.py:25-40; JAX `metrics/core.py:114-123`)."""
    a_n = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b_n = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a_n * b_n, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1, 1))
    c = b_n - d * a_n
    c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-10)
    return a * np.cos(p) + np.linalg.norm(a, axis=-1, keepdims=True) * c * np.sin(p)


def lerp(a, b, t):
    return a + (b - a) * t


def _device(G):
    return next(G.parameters()).device


def _tensor(x, device):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _draw(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).numpy()


@torch.no_grad()
def _generate(G, z=None, ws=None, psi=0.7, batch=4):
    """Images [N, H, W, C] (numpy) from z or ws with const noise, `batch` at
    a time."""
    latents = z if ws is None else ws
    dev = _device(G)
    out = []
    for i in range(0, latents.shape[0], batch):
        part = _tensor(latents[i:i + batch], dev)
        if ws is None:
            img = G(z=part, truncation_psi=psi, noise_mode="const")
        else:
            img = G(ws=part, noise_mode="const")
        out.append(img.cpu().numpy())
    return np.concatenate(out)


def _save(grid, path):
    if path:
        write_png(path, grid)
    return grid


def sample_grid(G, cfg, num=16, psi=0.7, seed=0, path=None, z=None, batch=4):
    """The fakes grid (reference visualize.py main grid)."""
    z = _draw((num, cfg.k, cfg.z_dim), seed) if z is None else z
    return _save(create_img_grid(_generate(G, z=z, psi=psi, batch=batch)), path)


def has_attention(cfg):
    return any(cfg.use_attention(r) for r in cfg.block_resolutions)


@torch.no_grad()
def attention_blends(G, cfg, num=4, psi=0.7, seed=0, out_dir=None, alpha=0.6, z=None):
    """Per-component attention maps as coloured overlays on the generated
    images (reference visualize.py:163-199; JAX `visualize.py:49-68`): the
    maps' mean over layers and heads, its argmax over components, that
    component's palette colour blended in with `alpha`. Writes
    sample_{i}.png and attention_{i}.png into `out_dir` when given; returns
    the blends [num, H, W, 3] float32 in [-1, 1]."""
    if not has_attention(cfg):
        raise ValueError("attention blends need a generator with attention layers "
                         "(cfg.transformer, and a block whose log2 resolution is in "
                         "[start_res, end_res))")
    z = _draw((num, cfg.k, cfg.z_dim), seed) if z is None else z
    imgs, att = G(z=_tensor(z, _device(G)), truncation_psi=psi, noise_mode="const",
                  return_att=True)
    hard = att.mean(dim=(2, 3)).argmax(dim=1).cpu().numpy()      # [B, H, W]
    del att
    imgs = imgs.cpu().numpy()
    blends = []
    for i in range(len(imgs)):
        color = _PALETTE[hard[i] % len(_PALETTE)] / 255.0 * 2 - 1
        blend = (1 - alpha) * imgs[i] + alpha * color
        blends.append(blend)
        if out_dir:
            write_png(os.path.join(out_dir, f"sample_{i}.png"), to_uint8(imgs[i]))
            write_png(os.path.join(out_dir, f"attention_{i}.png"), to_uint8(blend))
    return np.stack(blends)


def interpolation_grid(G, cfg, steps=8, psi=0.7, seed=0, space="z",
                       component: Optional[int] = None, path=None, z1=None, z2=None, batch=4):
    """Latent interpolations (reference visualize.py:203-252): slerp in z,
    lerp otherwise, optionally of one component only; one row of `steps`."""
    if z1 is None or z2 is None:
        z1 = _draw((1, cfg.k, cfg.z_dim), seed)
        z2 = _draw((1, cfg.k, cfg.z_dim), seed + 1)
    z1, z2 = np.asarray(z1, np.float32), np.asarray(z2, np.float32)
    frames = []
    for t in np.linspace(0, 1, steps):
        z = slerp(z1, z2, float(t)) if space == "z" else lerp(z1, z2, float(t))
        if component is not None:
            z_fixed = z1.copy()
            z_fixed[:, component] = z[:, component]
            z = z_fixed
        frames.append(z)
    imgs = _generate(G, z=np.concatenate(frames).astype(np.float32), psi=psi, batch=batch)
    return _save(create_img_grid(imgs, rows=1, cols=steps), path)


@torch.no_grad()
def style_mixing_table(G, cfg, num_rows=3, num_cols=3, cutoff=None, psi=0.7, seed=0,
                       path=None, z_rows=None, z_cols=None, batch=4):
    """Style-mixing table (reference visualize.py:272-310): the row sources
    give the ws layers before `cutoff`, the column sources the rest."""
    cutoff = cutoff if cutoff is not None else cfg.num_ws // 2
    if z_rows is None or z_cols is None:
        z_rows = _draw((num_rows, cfg.k, cfg.z_dim), seed)
        z_cols = _draw((num_cols, cfg.k, cfg.z_dim), seed + 1)
    dev = _device(G)
    ws_rows = G.run_mapping(_tensor(z_rows, dev), truncation_psi=psi)
    ws_cols = G.run_mapping(_tensor(z_cols, dev), truncation_psi=psi)
    tiles = []
    for r in range(num_rows):
        for c in range(num_cols):
            ws = ws_cols[c:c + 1].clone()
            ws[:, :, :cutoff] = ws_rows[r:r + 1, :, :cutoff]
            tiles.append(ws)
    imgs = _generate(G, ws=torch.cat(tiles).cpu().numpy(), batch=batch)
    return _save(create_img_grid(imgs, rows=num_rows, cols=num_cols), path)


@torch.no_grad()
def noise_variance_map(G, cfg, z=None, samples=16, psi=0.7, seed=0, path=None):
    """Per-pixel std over `samples` draws of the per-layer noise (reference
    visualize.py:257-267); draw i comes from a generator on G's device
    seeded with seed + 1 + i."""
    dev = _device(G)
    z = _draw((1, cfg.k, cfg.z_dim), seed) if z is None else z
    z = _tensor(z, dev)
    imgs = np.stack([
        G(z=z, truncation_psi=psi, noise_mode="random",
          gen=torch.Generator(device=dev).manual_seed(seed + 1 + i))[0].cpu().numpy()
        for i in range(samples)])
    var_map = imgs.std(axis=0).mean(axis=-1, keepdims=True)        # [H, W, 1]
    var_img = adjust_range(var_map / max(var_map.max(), 1e-8), (0, 1), (-1, 1))
    return _save(to_uint8(np.repeat(var_img, 3, axis=-1)), path)
