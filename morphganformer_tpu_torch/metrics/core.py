"""FID, KID, IS, precision and recall, and the PPL interpolations (port of
morphganformer_tpu/metrics/core.py).

Reference metrics/: FID from means and covariances with scipy's sqrtm
(frechet_inception_distance.py:7-26), KID as the polynomial-kernel MMD over
random subsets (kernel_inception_distance.py:6-32), IS over splits
(inception_score.py:6-24), precision and recall from k-th neighbour
manifolds (precision_recall.py:6-45), slerp and lerp
(perceptual_path_length.py:25-40). FID, KID and IS run in float64 numpy on
the host as in JAX; the pairwise distances of P&R run in float32 torch on
`device`, as JAX runs them on its device.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def frechet_distance(mu1, cov1, mu2, cov2):
    """FID between two Gaussians (frechet_inception_distance.py:20-26)."""
    m = np.square(mu1 - mu2).sum()
    s = scipy.linalg.sqrtm(np.dot(cov1, cov2))
    return float(np.real(m + np.trace(cov1 + cov2 - s * 2)))


def compute_fid_from_stats(real_stats, gen_stats):
    mu_r, cov_r = real_stats.get_mean_cov()
    mu_g, cov_g = gen_stats.get_mean_cov()
    return frechet_distance(mu_g, cov_g, mu_r, cov_r)


def compute_kid_from_features(real_features, gen_features, num_subsets=100,
                              max_subset_size=1000, rng=None):
    """Polynomial-kernel MMD (kernel_inception_distance.py:21-32); the
    subsets are drawn from `rng` (np.random.RandomState(0) by default), as
    JAX draws them."""
    rng = rng or np.random.RandomState(0)
    n = real_features.shape[1]
    m = min(min(real_features.shape[0], gen_features.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = gen_features[rng.choice(gen_features.shape[0], m, replace=False)]
        y = real_features[rng.choice(real_features.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)


def compute_is_from_probs(gen_probs, num_splits=10):
    """Inception score over splits (inception_score.py:17-24): (mean, std)."""
    scores = []
    num = gen_probs.shape[0]
    for i in range(num_splits):
        part = gen_probs[i * num // num_splits:(i + 1) * num // num_splits]
        kl = part * (np.log(part) - np.log(np.mean(part, axis=0, keepdims=True)))
        scores.append(np.exp(np.mean(np.sum(kl, axis=1))))
    return float(np.mean(scores)), float(np.std(scores))


def _cdist_batched(rows, cols, batch=10000, device="cuda"):
    """Pairwise L2 distances [R, C] as a host array: float32 on `device`,
    `batch` columns at a time, |r|^2 - 2 r.c + |c|^2 clamped at 0."""
    out = []
    rows = torch.as_tensor(np.asarray(rows, dtype=np.float32), device=device)
    rsq = torch.sum(rows ** 2, dim=1)[:, None]
    for i in range(0, cols.shape[0], batch):
        c = torch.as_tensor(np.asarray(cols[i:i + batch], dtype=np.float32), device=device)
        d2 = rsq - 2 * rows @ c.T + torch.sum(c ** 2, dim=1)[None, :]
        out.append(torch.sqrt(torch.clamp(d2, min=0.0)).cpu().numpy())
    return np.concatenate(out, axis=1)


def compute_pr_from_features(real_features, gen_features, nhood_size=3, row_batch_size=10000,
                             col_batch_size=10000, device="cuda"):
    """Improved precision and recall (precision_recall.py:22-45)."""
    results = {}
    for name, manifold, probes in [("precision", real_features, gen_features),
                                   ("recall", gen_features, real_features)]:
        kth = []
        for i in range(0, manifold.shape[0], row_batch_size):
            dist = _cdist_batched(manifold[i:i + row_batch_size], manifold, col_batch_size,
                                  device)
            kth.append(np.partition(dist, nhood_size, axis=1)[:, nhood_size])
        kth = np.concatenate(kth)
        pred = []
        for i in range(0, probes.shape[0], row_batch_size):
            dist = _cdist_batched(probes[i:i + row_batch_size], manifold, col_batch_size,
                                  device)
            pred.append((dist <= kth[None, :]).any(axis=1))
        results[name] = float(np.concatenate(pred).mean())
    return results["precision"], results["recall"]


def slerp(a, b, t):
    """Spherical interpolation over the last axis (perceptual_path_length.py
    :25-40), in numpy; ppl.py has its torch form."""
    a_n = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b_n = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a_n * b_n, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1, 1))
    c = b_n - d * a_n
    c = c / np.maximum(np.linalg.norm(c, axis=-1, keepdims=True), 1e-10)
    return a * np.cos(p) + np.linalg.norm(a, axis=-1, keepdims=True) * c * np.sin(p)


def lerp(a, b, t):
    return a + (b - a) * t
