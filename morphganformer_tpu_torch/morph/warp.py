"""Landmark-Delaunay warping of GAN morphs (port of
morphganformer_tpu/morph/warp.py).

The reference's 1024_warp_morphs.py (:141-144, :157-210): average the two
bona fide landmark sets, Delaunay-triangulate the average (+12 border
anchors), and warp each triangle of the generated morph onto the averaged
geometry. The triangulation is scipy's (the same qhull call as JAX's, so
the same simplices) on the host. The rest runs on the image tensor's
device in float64, as JAX's numpy computes: each triangle's affine (one
batched solve), which triangle holds each pixel (barycentric coordinates),
the source position clipped to w - 1.001, and the bilinear sample. On an
edge that two triangles share their affines agree, so a pixel there takes
the same value, up to rounding, whichever triangle claims it.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import Delaunay

# Pixels tested against all triangles at once: the barycentric tests take
# 8 bytes for each pixel, triangle and coordinate.
_PIXEL_CHUNK = 1 << 16
# A pixel belongs to a triangle when each barycentric coordinate is at
# least -_EPS (qhull's find_simplex tests against 100 * DBL_EPSILON).
_EPS = 100 * np.finfo(np.float64).eps


def _points(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x, dtype=np.float64)


def border_anchor_points(size=1024):
    """The reference's 12 border anchors (1024_warp_morphs.py:141-144),
    scaled to `size`."""
    m = size - 1
    t1, t2 = size // 3, 2 * size // 3
    return np.asarray([
        [0, 0], [0, t1], [0, t2], [0, m],
        [t1, 0], [t2, 0], [m, 0], [m, t1],
        [m, t2], [m, m], [t1, m], [t2, m]], dtype=np.float64)


def _affines(dst_tri, src_tri):
    """[T, 2, 3] affines A with src = A @ [dst, 1] for each triangle;
    dst_tri, src_tri: [T, 3, 2] (x, y)."""
    d = torch.cat([dst_tri, torch.ones_like(dst_tri[..., :1])], dim=2)      # [T, 3, 3]
    return torch.linalg.solve(d, src_tri).transpose(1, 2)


def _containing_triangle(tris, pix):
    """For each pixel [P, 2] the index of the first triangle [T, 3, 2] that
    holds it, or -1."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]                              # [T, 2]
    det = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    out = []
    for p in pix.split(_PIXEL_CHUNK):
        dx = p[:, None, 0] - c[None, :, 0]                                    # [P, T]
        dy = p[:, None, 1] - c[None, :, 1]
        l1 = ((b[:, 1] - c[:, 1]) * dx + (c[:, 0] - b[:, 0]) * dy) / det
        l2 = ((c[:, 1] - a[:, 1]) * dx + (a[:, 0] - c[:, 0]) * dy) / det
        inside = (l1 >= -_EPS) & (l2 >= -_EPS) & (1 - l1 - l2 >= -_EPS)
        first = inside.to(torch.uint8).argmax(dim=1)
        out.append(torch.where(inside.any(dim=1), first, torch.full_like(first, -1)))
    return torch.cat(out)


def piecewise_affine_warp(img, src_points, dst_points, fill=None):
    """Warp `img` so that src_points land on dst_points, affine on each
    Delaunay triangle of dst_points. img: [H, W, C] tensor (on the device
    the warp runs on) or array; points: [N, 2] as (x, y). Pixels outside
    every triangle keep `fill` (default: the source image). Returns a
    float64 tensor on img's device."""
    img = torch.as_tensor(img).to(torch.float64)
    dev = img.device
    h, w, c = img.shape
    src_points, dst_points = _points(src_points), _points(dst_points)

    simplices = Delaunay(dst_points).simplices                               # [T, 3]
    dst_tri = torch.from_numpy(dst_points[simplices]).to(dev)
    affines = _affines(dst_tri, torch.from_numpy(src_points[simplices]).to(dev))

    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                            torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)               # [H * W, 2]
    tri_idx = _containing_triangle(dst_tri, pix)
    inside = tri_idx >= 0

    out = img.clone() if fill is None else torch.full_like(img, fill)
    p = pix[inside]
    a = affines[tri_idx[inside]]                                              # [M, 2, 3]
    sx = (a[:, 0, 0] * p[:, 0] + a[:, 0, 1] * p[:, 1]) + a[:, 0, 2]
    sy = (a[:, 1, 0] * p[:, 0] + a[:, 1, 1] * p[:, 1]) + a[:, 1, 2]
    sx = sx.clamp(0, w - 1.001)
    sy = sy.clamp(0, h - 1.001)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    vals = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    flat = out.reshape(-1, c)
    flat[inside] = vals
    return flat.reshape(h, w, c)


def warp_morph_to_average_landmarks(morph_img, morph_landmarks, landmarks_a, landmarks_b):
    """The reference's post-hoc refinement (1024_warp_morphs.py:157-210):
    warp the GAN morph so that its landmarks land on the average of the two
    bona fide landmark sets. Landmarks: [68, 2] (x, y). Returns a float64
    tensor on morph_img's device."""
    size = morph_img.shape[0]
    anchors = border_anchor_points(size)
    avg = (_points(landmarks_a) + _points(landmarks_b)) / 2.0
    src = np.concatenate([_points(morph_landmarks), anchors])
    dst = np.concatenate([avg, anchors])
    return piecewise_affine_warp(morph_img, src, dst)


def load_landmarks_csv(path):
    """A landmarks CSV, a row per point (x,y): the format of the
    reference's AdaptiveWingLoss/facial_landmarks_2.py batch extractor and
    of `losses.landmarks.save_landmarks_csv`."""
    pts = np.loadtxt(path, delimiter=",", dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"{path}: expected rows of x,y; got an array of shape {pts.shape}")
    return pts
