"""Perceptual path length (port of morphganformer_tpu/metrics/ppl.py).

Reference metrics/perceptual_path_length.py (:25-118): pairs of latents,
interpolated at t and t + epsilon (slerp in z, lerp in w), both endpoints
generated with const noise, centre-cropped (faces), box-downsampled to 256,
embedded by a perceptual feature net; the squared feature distance over
epsilon^2, and the mean inside the [1 %, 99 %] percentile band.

The draw of (t, z) (`ppl_draws`, from an explicit torch.Generator) is split
from the distances (`ppl_distances`), so that any draws, JAX's among them,
can be fed to the port. `feature_fn` maps NHWC images in [0, 255] to
embeddings; there is none by default, and PPL without one raises.
"""

from __future__ import annotations

import numpy as np
import torch

NO_FEATURE_NET = ("PPL needs a perceptual feature net (feature_fn: NHWC images in [0, 255] "
                  "-> embeddings, e.g. the LPIPS-VGG tower); none was given")


def _slerp(a, b, t):
    """Spherical interpolation over the last axis, in torch."""
    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1, keepdim=True)

    a_n, b_n = a / norm(a), b / norm(b)
    d = torch.sum(a_n * b_n, dim=-1, keepdim=True)
    p = t * torch.arccos(torch.clamp(d, -1, 1))
    c = b_n - d * a_n
    c = c / torch.clamp(norm(c), min=1e-10)
    return a * torch.cos(p) + norm(a) * c * torch.sin(p)


def ppl_draws(gen, batch, cfg, sampling="end"):
    """(t [batch], z [2 batch, k, z_dim]) from the CPU torch.Generator
    `gen`; t is 0 unless `sampling` is "full"."""
    t = torch.rand((batch,), generator=gen) * (1.0 if sampling == "full" else 0.0)
    z = torch.randn((2 * batch, cfg.k, cfg.z_dim), generator=gen)
    return t, z


@torch.no_grad()
def ppl_distances(G, t, z, feature_fn, epsilon=1e-4, space="w", crop=True, plain=False):
    """The squared feature distance over epsilon^2 of each of the `batch`
    pairs z[:batch], z[batch:] at t and t + epsilon: one synthesis of
    2 batch images on G's device. `plain=True` runs the fused blocks on the
    plain versions of their kernels."""
    if feature_fn is None:
        raise ValueError(NO_FEATURE_NET)
    cfg, dev = G.cfg, next(G.parameters()).device
    batch = t.shape[0]
    t, z = t.to(dev), z.to(dev)
    if space == "w":
        ws = G.run_mapping(z)
        w0, w1 = ws[:batch], ws[batch:]
        tt = t[:, None, None, None]
        wt0 = w0 + (w1 - w0) * tt
        wt1 = w0 + (w1 - w0) * (tt + epsilon)
    else:
        z0, z1 = z[:batch], z[batch:]
        tt = t[:, None, None]
        ws = G.run_mapping(torch.cat([_slerp(z0, z1, tt), _slerp(z0, z1, tt + epsilon)]))
        wt0, wt1 = ws[:batch], ws[batch:]
    img = G.run_synthesis(torch.cat([wt0, wt1]), noise_mode="const", plain=plain)
    if crop:
        c = img.shape[1] // 8
        img = img[:, c * 3:c * 7, c * 2:c * 6, :]
    factor = cfg.img_resolution // 256
    if factor > 1:
        b, h, w, ch = img.shape
        img = img.reshape(b, h // factor, factor, w // factor, factor, ch).mean(dim=(2, 4))
    img = (img + 1.0) * (255.0 / 2.0)
    feats = feature_fn(img)
    f0, f1 = feats[:batch], feats[batch:]
    return torch.sum(torch.square(f0 - f1), dim=-1) / epsilon ** 2


def make_ppl_sampler(G, feature_fn, epsilon=1e-4, space="w", sampling="end", crop=True,
                     plain=False):
    """(gen, batch) -> the distances of one batch of fresh draws."""
    def sample(gen, batch):
        t, z = ppl_draws(gen, batch, G.cfg, sampling)
        return ppl_distances(G, t, z, feature_fn, epsilon, space, crop, plain)

    return sample


def ppl_from_distances(dist):
    """The mean of the distances inside [the 1st percentile (numpy's
    "lower"), the 99th ("higher")]."""
    dist = np.asarray(dist)
    lo = np.percentile(dist, 1, method="lower")
    hi = np.percentile(dist, 99, method="higher")
    return float(dist[(dist >= lo) & (dist <= hi)].mean())


def compute_ppl(G, feature_fn, num_samples=2000, batch=8, epsilon=1e-4, space="w",
                sampling="end", crop=True, seed=0, plain=False):
    """PPL over `num_samples` pairs drawn from a torch.Generator seeded
    with `seed`, `batch` pairs a synthesis."""
    sampler = make_ppl_sampler(G, feature_fn, epsilon, space, sampling, crop, plain)
    gen = torch.Generator().manual_seed(seed)
    dist, done = [], 0
    while done < num_samples:
        dist.append(sampler(gen, batch).float().cpu().numpy())
        done += batch
    return ppl_from_distances(np.concatenate(dist)[:num_samples])
