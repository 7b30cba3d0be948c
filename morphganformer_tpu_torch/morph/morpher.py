"""Face morphing and de-morphing by latent arithmetic (port of
morphganformer_tpu/morph/morpher.py; numpy and scipy only).

  * Morph: W = alpha*w1 + (1-alpha)*w2 (alpha 0.5), then regenerate.
  * De-morph: given the morph latent W and one accomplice latent w_acc, the
    other identity is w_rec = (W - alpha*w_acc) / (1 - alpha).
  * Latents persist as MATLAB .mat dicts {'w': array}.
"""

from __future__ import annotations

import numpy as np
import scipy.io as sio


def morph_latents(w1, w2, alpha=0.5):
    """W = alpha*w1 + (1-alpha)*w2."""
    return alpha * np.asarray(w1) + (1.0 - alpha) * np.asarray(w2)


def demorph_latent(w_morph, w_accomplice, alpha=0.5):
    """Invert the morph given the accomplice's latent: the second identity."""
    return (np.asarray(w_morph) - alpha * np.asarray(w_accomplice)) / (1.0 - alpha)


def save_latent_mat(path, w, key="w"):
    sio.savemat(str(path), {key: np.asarray(w)})


def load_latent_mat(path, key="w"):
    return np.asarray(sio.loadmat(str(path))[key])
