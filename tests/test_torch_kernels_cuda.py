"""K1 and K2 CUDA kernels against their plain PyTorch versions, on a card.

This file imports no JAX, so it runs on the GPU machine, where JAX is not
installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda -q

Without a card every test skips. The cases are the flag combinations of the
1024^2 path at small sizes (the CPU tests in test_torch_fused_conv.py hold
the plain versions against the JAX package on the same cases). Tolerance
1e-4: float32 sums of the same terms in another order."""

import math

import numpy as np
import pytest
import torch

from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

FIR = [1, 3, 3, 1]


def _k1_inputs(rng, n, h, c, o, noise, bias, resid):
    x = rng.randn(n, h, h, c).astype(np.float32)
    w = (rng.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    nz = (rng.randn(h, h) * 0.1).astype(np.float32) if noise else None
    b = (rng.randn(o) * 0.1).astype(np.float32) if bias else None
    r = rng.randn(n, h, h, o).astype(np.float32) if resid else None
    return x, w, s, nz, b, r


# conv1 (noise, bias, resid, lrelu), conv_last (none of them, linear), and
# the other combinations, with and without demodulation.
K1_CASES = [
    ((2, 16, 32, 32), True, True, True, 1.0, 0.2, True),
    ((1, 16, 32, 32), False, False, False, 1.0, 1.0, True),
    ((2, 8, 16, 8), True, False, False, math.sqrt(2), 0.2, True),
    ((1, 8, 16, 16), False, True, True, 1.0, 0.2, False),
    ((2, 8, 8, 8), True, True, False, 2.0, 0.2, False),
]


def _k2_inputs(rng, n, h, cin, cout, kh, styles, noise, bias):
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)).astype(np.float32)
    s = (rng.rand(n, cin) + 0.5).astype(np.float32) if styles else None
    nz = (rng.randn(2 * h, 2 * h) * 0.1).astype(np.float32) if noise else None
    b = (rng.randn(cout) * 0.1).astype(np.float32) if bias else None
    return x, w, s, nz, b


# conv0 (styles, demod, noise, bias, lrelu) and the skip (no styles, no
# demod, linear), plus the remaining flag combinations; Cin 64 and the
# 256 -> 128 form of the b256 block.
K2_CASES = [
    (64, 3, True, True, True, True, math.sqrt(2), 0.2),
    (64, 1, False, False, False, False, math.sqrt(0.5), 1.0),
    (64, 3, True, False, False, True, 1.0, 0.2),
    (64, 3, True, True, False, False, math.sqrt(2), 0.2),
    (256, 3, True, True, True, True, math.sqrt(2), 0.2),
    (256, 1, False, False, False, False, math.sqrt(0.5), 1.0),
]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_k1_kernel_matches_plain(cuda_device, shape, noise, bias, resid, gain, alpha, demod):
    n, h, c, o = shape
    args = [None if a is None else torch.from_numpy(a).to(cuda_device)
            for a in _k1_inputs(np.random.RandomState(0), n, h, c, o, noise, bias, resid)]
    before = fc.launch_counts["modconv3x3"]
    got = fc.fused_modconv3x3(*args, gain, alpha, demod)
    assert fc.launch_counts["modconv3x3"] == before + 1
    torch.testing.assert_close(got, fc.modconv3x3_plain(*args, gain, alpha, demod),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_k2_kernel_matches_plain(cuda_device, cin, kh, styles, noise, bias, demod, gain, alpha):
    h = 16 if cin == 64 else 8
    x, w, s, nz, b = [None if a is None else torch.from_numpy(a).to(cuda_device)
                      for a in _k2_inputs(np.random.RandomState(1), 2, h, cin, cin // 2,
                                          kh, styles, noise, bias)]
    f = setup_filter(FIR).to(cuda_device)
    before = fc.launch_counts["upconv2"]
    got = fc.fused_upconv2(x, w, s, f, nz, b, gain, alpha, demod, False)
    assert fc.launch_counts["upconv2"] == before + 1
    torch.testing.assert_close(got, fc.upconv2_plain(x, w, s, f, nz, b, gain, alpha, demod, False),
                               rtol=1e-4, atol=1e-4)
