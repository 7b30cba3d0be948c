"""Procedural face-like images with analytically known 68-point landmarks
(port of morphganformer_tpu/losses/synthetic_faces.py, plain numpy).

The landmark net of losses/landmarks.py is trained on this stream
(`python -m morphganformer_tpu_torch.tools.train_landmarks`): faces with the
iBUG 68-point topology (jaw 0-16, brows 17-26, nose 27-35, eyes 36-47, mouth
48-67) and their exact landmarks, since the reference's dlib model and its
iBUG-300W data are not in the repository. A model trained on real faces
later is a weight swap (load_landmark_npz), no code change.

Rendering is numpy alone: anti-aliased ellipses and capsule strokes
composited on a noisy background, randomly affine-transformed and
colour-jittered. All landmark coordinates are (x, y) in [0, 1]. From the
same `RandomState` the JAX package's renderer and this one give the same
images and landmarks bit for bit.
"""

from __future__ import annotations

import numpy as np

NUM_LANDMARKS = 68


def template_landmarks() -> np.ndarray:
    """Canonical 68-point face template, (x, y) in [0, 1], y down."""
    pts = np.zeros((NUM_LANDMARKS, 2), np.float64)
    # Jaw 0-16: ellipse arc, left temple -> chin -> right temple.
    beta = np.pi - np.arange(17) * np.pi / 16          # pi .. 0
    pts[0:17, 0] = 0.5 + 0.33 * np.cos(beta)
    pts[0:17, 1] = 0.47 + 0.42 * np.sin(beta)
    # Brows 17-21 (left), 22-26 (right): shallow arcs.
    arch = 0.02 * np.array([0.0, 0.6, 1.0, 0.6, 0.0])
    pts[17:22, 0] = np.linspace(0.22, 0.42, 5)
    pts[17:22, 1] = 0.36 - arch
    pts[22:27, 0] = np.linspace(0.58, 0.78, 5)
    pts[22:27, 1] = 0.36 - arch[::-1]
    # Nose bridge 27-30, base 31-35.
    pts[27:31, 0] = 0.5
    pts[27:31, 1] = np.linspace(0.43, 0.60, 4)
    pts[31:36, 0] = np.linspace(0.44, 0.56, 5)
    pts[31:36, 1] = np.array([0.645, 0.66, 0.665, 0.66, 0.645])
    # Eyes 36-41 (left), 42-47 (right): 6-point hexagons,
    # order: outer corner, 2 top, inner corner, 2 bottom.
    def eye(cx, cy, rx=0.055, ry=0.022, flip=False):
        ang = np.deg2rad([180, 120, 60, 0, 300, 240])
        e = np.stack([cx + rx * np.cos(ang), cy - ry * np.sin(ang)], axis=1)
        return e[::-1] if flip else e
    pts[36:42] = eye(0.335, 0.455)
    pts[42:48] = eye(0.665, 0.455)
    # Mouth: outer 48-59 (12 points), inner 60-67 (8 points).
    ang12 = np.deg2rad(180 - np.arange(12) * 30)
    pts[48:60, 0] = 0.5 + 0.115 * np.cos(ang12)
    pts[48:60, 1] = 0.785 - 0.048 * np.sin(ang12)
    ang8 = np.deg2rad(180 - np.arange(8) * 45)
    pts[60:68, 0] = 0.5 + 0.075 * np.cos(ang8)
    pts[60:68, 1] = 0.785 - 0.022 * np.sin(ang8)
    return pts


def _grid(size):
    ys, xs = np.mgrid[0:size, 0:size]
    return (xs + 0.5) / size, (ys + 0.5) / size


def _ellipse_mask(xs, ys, cx, cy, rx, ry, rot=0.0, soft=0.004):
    ca, sa = np.cos(rot), np.sin(rot)
    dx, dy = xs - cx, ys - cy
    u = (ca * dx + sa * dy) / max(rx, 1e-6)
    v = (-sa * dx + ca * dy) / max(ry, 1e-6)
    d = np.sqrt(u * u + v * v)
    return np.clip((1.0 - d) / soft * max(rx, ry) + 0.5, 0.0, 1.0)


def _stroke_mask(xs, ys, pts, width, soft=0.004):
    """Anti-aliased polyline (capsule union) through pts [(x,y), ...]."""
    mask = np.zeros_like(xs)
    for a, b in zip(pts[:-1], pts[1:]):
        ax, ay = a
        bx, by = b
        vx, vy = bx - ax, by - ay
        ll = vx * vx + vy * vy + 1e-12
        t = np.clip(((xs - ax) * vx + (ys - ay) * vy) / ll, 0.0, 1.0)
        d = np.sqrt((xs - (ax + t * vx)) ** 2 + (ys - (ay + t * vy)) ** 2)
        mask = np.maximum(mask, np.clip((width - d) / soft + 0.5, 0.0, 1.0))
    return mask


def render_face(params: dict, size=128) -> np.ndarray:
    """Render one face given affine params; returns [size, size, 3] in [-1,1]."""
    rng = params["rng"]
    xs, ys = _grid(size)
    lm = params["landmarks"]

    img = np.empty((size, size, 3), np.float64)
    img[:] = params["bg_color"]
    img += rng.randn(size, size, 3) * 0.04

    def blend(mask, color):
        nonlocal img
        img = img * (1 - mask[:, :, None]) + mask[:, :, None] * color

    s, rot = params["scale"], params["rot"]
    cx, cy = params["center"]
    # Head: ellipse behind the jaw arc.
    blend(_ellipse_mask(xs, ys, cx, cy - 0.03 * s, 0.345 * s, 0.47 * s, rot),
          params["skin"])
    # Brows.
    blend(_stroke_mask(xs, ys, lm[17:22], 0.012 * s), params["hair"])
    blend(_stroke_mask(xs, ys, lm[22:27], 0.012 * s), params["hair"])
    # Eyes: sclera + iris at the eye-hexagon centers.
    for sl in (slice(36, 42), slice(42, 48)):
        ex, ey = lm[sl].mean(axis=0)
        blend(_ellipse_mask(xs, ys, ex, ey, 0.055 * s, 0.024 * s, rot),
              np.array([0.95, 0.95, 0.93]))
        blend(_ellipse_mask(xs, ys, ex, ey, 0.02 * s, 0.02 * s), params["iris"])
    # Nose: bridge stroke + base stroke.
    blend(_stroke_mask(xs, ys, lm[27:31], 0.008 * s),
          params["skin"] * 0.82)
    blend(_stroke_mask(xs, ys, lm[31:36], 0.008 * s),
          params["skin"] * 0.75)
    # Mouth: outer ring filled, inner darker.
    mouth_c = lm[48:60].mean(axis=0)
    blend(_ellipse_mask(xs, ys, mouth_c[0], mouth_c[1], 0.118 * s, 0.05 * s,
                        rot), params["lips"])
    blend(_ellipse_mask(xs, ys, mouth_c[0], mouth_c[1], 0.076 * s, 0.022 * s,
                        rot), params["lips"] * 0.55)
    # Jawline shading stroke for the CNN to anchor the contour points.
    blend(_stroke_mask(xs, ys, lm[0:17], 0.006 * s), params["skin"] * 0.7)

    img = np.clip(img, 0.0, 1.0) * 2.0 - 1.0
    return img.astype(np.float32)


def sample_face(rng: np.random.RandomState, size=128):
    """Random face -> (image [size,size,3] in [-1,1], landmarks [68,2] in
    [0,1])."""
    scale = rng.uniform(0.65, 1.05)
    rot = rng.uniform(-0.25, 0.25)
    cx = rng.uniform(0.42, 0.58)
    cy = rng.uniform(0.44, 0.56)

    t = template_landmarks() - np.array([0.5, 0.47])
    ca, sa = np.cos(rot), np.sin(rot)
    R = np.array([[ca, -sa], [sa, ca]])
    lm = (t * scale) @ R.T + np.array([cx, cy])
    # Small correlated per-feature jitter (keeps rendering consistent).
    for sl in (slice(17, 22), slice(22, 27), slice(36, 42), slice(42, 48),
               slice(48, 68)):
        lm[sl] += rng.randn(2) * 0.004

    skin = np.array([0.75, 0.6, 0.5]) + rng.randn(3) * 0.06
    params = dict(
        rng=rng, landmarks=lm, scale=scale, rot=rot, center=(cx, cy),
        bg_color=rng.uniform(0.05, 0.45, 3), skin=np.clip(skin, 0.2, 0.95),
        hair=rng.uniform(0.05, 0.3, 3), iris=rng.uniform(0.05, 0.4, 3),
        lips=np.array([0.65, 0.25, 0.25]) + rng.randn(3) * 0.05)
    return render_face(params, size), lm.astype(np.float32)


def sample_batch(rng: np.random.RandomState, batch, size=128):
    imgs, lms = zip(*[sample_face(rng, size) for _ in range(batch)])
    return np.stack(imgs), np.stack(lms)
