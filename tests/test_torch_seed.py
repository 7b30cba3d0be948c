"""`--seed` of the port's entry points picks z, the prior statistics and the
projection noise, never the `init:<res>` weights: JAX's `get_model`
(cli/generate.py:24-26) builds them from seed 0 for every entry point, so a
latent projected with one seed regenerates its image under `merge` with
another."""

import os

import numpy as np
import torch

from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.utils.image import read_png, to_uint8, write_png

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401


def test_project_with_a_seed_then_merge_with_the_default(tmp_path, one_torch_thread):
    cfg, G = cli.get_model("init:8", device="cpu")
    z = torch.randn((1, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(1))
    write_png(tmp_path / "a.png", to_uint8(cli.synthesize(G, z)[0].numpy()))
    cli.main(["project", "--model", "init:8", "--device", "cpu", "--step", "2",
              "--n_mean_latent", "32", "--seed", "5", "--img", str(tmp_path / "a.png"),
              "--path_to_gen", str(tmp_path / "p")])
    best = [f for f in os.listdir(tmp_path / "p") if f.endswith(".png")]
    assert len(best) == 1
    w = str(tmp_path / "p" / "w.mat")
    # project computes in bfloat16 by default and merge in float32, as in
    # JAX, whose merge help says to match project's type to reproduce its
    # image bit for bit (cli/merge.py:38-42).
    cli.main(["merge", "--model", "init:8", "--device", "cpu", "--latents", w, w,
              "--out", str(tmp_path / "m"), "--dtype", "bfloat16"])
    # Merging a latent with itself regenerates it: the same image, bit for
    # bit, only if both commands built the same weights.
    np.testing.assert_array_equal(read_png(tmp_path / "m" / "w_w.png"),
                                  read_png(tmp_path / "p" / best[0]))
    for name, p in cli.get_model("init:8", device="cpu")[1].state_dict().items():
        torch.testing.assert_close(p, G.state_dict()[name], rtol=0, atol=0)
