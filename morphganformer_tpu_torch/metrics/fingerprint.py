"""Face embeddings of a folder and linear-SVM morph detection
("fingerprinting"): the functions of the JAX package's
cli/extract_features.py (reference extract_FaceNet.py and
Facenet_torch/extract_feature_fingerprinting.py:14-18).

`extract_dir` embeds every PNG of a folder with the ArcFace iresnet
(losses/face_embedding.py) on the card. JAX splits and classifies with
scikit-learn, which the port does not use; it has its own:

    stratified_split   sklearn's train_test_split(test_size, random_state=seed,
                       stratify=y): StratifiedShuffleSplit's draws re-done on a
                       numpy RandomState(seed), so the index sets are sklearn's
    linear_svm         the optimum of LinearSVC()'s problem (L2 penalty,
                       squared hinge, C=1, the intercept a regularised
                       constant feature of 1, as liblinear has it), solved
                       exactly in float64 on the host by Newton's method on
                       the primal, which is strictly convex: its optimum is
                       unique, so any exact solver can be held against it
    svm_fingerprinting the two combined, with JAX's JSON keys
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np
import torch

from morphganformer_tpu_torch.losses.face_embedding import iresnet_embed
from morphganformer_tpu_torch.utils.image import load_target


def image_files(path):
    """The images of a folder in JAX's order (sorted PNGs and JPEGs); a JPEG
    raises, since the port reads PNG only."""
    files = sorted(glob.glob(os.path.join(path, "*.png")) + glob.glob(os.path.join(path, "*.jpg")))
    if not files:
        raise FileNotFoundError(f"no images in {path}")
    jpg = [f for f in files if f.endswith(".jpg")]
    if jpg:
        raise ValueError(f"{jpg[0]}: the port reads PNG only ({len(jpg)} JPEGs in {path}); "
                         f"convert them to PNG first (ROADMAP.md queue 1, \"The rest\")")
    return files


@torch.no_grad()
def extract_dir(params, path, size=112, batch=16, device="cuda"):
    """(files, embeddings [N, D] float32): every image of `path` loaded as
    JAX's load_target(size=112) loads it and embedded by `iresnet_embed`
    on `device`, `batch` images at a time."""
    files = image_files(path)
    feats = []
    for i in range(0, len(files), batch):
        imgs = np.concatenate([load_target(f, size=size) for f in files[i:i + batch]])
        feats.append(iresnet_embed(params, torch.from_numpy(imgs).to(device)).cpu().numpy())
    return files, np.concatenate(feats)


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn.utils.extmath._approximate_mode: the draws per class nearest
    the multivariate hypergeometric's mode, ties broken by `rng`."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y, test_size=0.3, seed=0):
    """(train indices, test indices) of sklearn's
    `train_test_split(..., test_size=test_size, random_state=seed,
    stratify=y)` (its StratifiedShuffleSplit, one split)."""
    y = np.asarray(y)
    n = y.shape[0]
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(f"every class needs two members at least: {classes[class_counts < 2]}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"{n_train} train and {n_test} test rows cannot hold each of "
                         f"{len(classes)} classes")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def linear_svm(x, y, C=1.0, max_iter=100):
    """(coef [D], intercept) of the optimum of LinearSVC(C)'s primal,

        min_w  w.w / 2 + C sum_i max(0, 1 - s_i w.[x_i, 1])^2,   s_i = 2 y_i - 1,

    (the last entry of w the intercept, regularised as liblinear's is), by
    Newton's method with a backtracking line search in float64: on each
    piece where the set of rows inside the margin is fixed the objective is
    quadratic, so a full step lands on that piece's minimum and the
    iteration ends at the exact optimum once the set stops changing."""
    x = np.asarray(x, np.float64)
    s = 2.0 * np.asarray(y, np.float64) - 1.0
    xt = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)

    def objective(w):
        m = np.maximum(1.0 - s * (xt @ w), 0.0)
        return 0.5 * w @ w + C * m @ m

    w = np.zeros(xt.shape[1])
    g0 = None
    for _ in range(max_iter):
        m = 1.0 - s * (xt @ w)
        act = m > 0
        xa = xt[act]
        g = w - 2.0 * C * xa.T @ (s[act] * m[act])
        gn = np.linalg.norm(g)
        g0 = gn if g0 is None else g0
        if gn <= 1e-12 * max(g0, 1.0):
            break
        h = np.eye(xt.shape[1]) + 2.0 * C * xa.T @ xa
        step = np.linalg.solve(h, -g)
        f0, slope, t = objective(w), g @ step, 1.0
        while objective(w + t * step) > f0 + 1e-4 * t * slope and t > 1e-10:
            t *= 0.5
        w = w + t * step
    return w[:-1], float(w[-1])


def svm_accuracy(coef, intercept, x, y):
    """The share of rows whose sign of coef.x + intercept gives their class
    (LinearSVC.score)."""
    pred = (np.asarray(x, np.float64) @ coef + intercept > 0).astype(np.int64)
    return float(np.mean(pred == np.asarray(y)))


def svm_fingerprinting(bona_feats, morph_feats, test_frac=0.3, seed=0):
    """Linear-SVM morph detection (reference Facenet_torch pipeline): bona
    fide rows class 0, morphs class 1, sklearn's stratified split, the SVM
    fit on the train rows; JAX's JSON fields."""
    x = np.concatenate([bona_feats, morph_feats])
    y = np.concatenate([np.zeros(len(bona_feats)), np.ones(len(morph_feats))]).astype(np.int64)
    tr, te = stratified_split(y, test_frac, seed)
    coef, intercept = linear_svm(x[tr], y[tr])
    return {"train_acc": svm_accuracy(coef, intercept, x[tr], y[tr]),
            "test_acc": svm_accuracy(coef, intercept, x[te], y[te]),
            "num_bona": len(bona_feats), "num_morph": len(morph_feats)}
