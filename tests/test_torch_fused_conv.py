"""K1 and K2 of the port (ops/fused_conv.py) against the JAX package.

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX fused ops (Pallas in interpret mode, as the JAX suite runs
them) and against the pixel-space specs `modconv_ref` / `upconv_ref`, at the
JAX suite's tolerance of 2e-4 (tests/test_packed_pipeline.py:95). The same
cases hold the CUDA kernels against the plain versions on a card in
test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphganformer_tpu.ops import pallas_conv as jpc
from morphganformer_tpu.ops import second_order as jso
from morphganformer_tpu.ops import setup_filter as jsetup_filter
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops import setup_filter

from .test_torch_kernels_cuda import FIR, K1_CASES, K2_CASES, _k1_inputs, _k2_inputs

TOL = 2e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_k1_plain_matches_jax(shape, noise, bias, resid, gain, alpha, demod):
    n, h, c, o = shape
    x, w, s, nz, b, r = _k1_inputs(np.random.RandomState(0), n, h, c, o, noise, bias, resid)
    got = fc.fused_modconv3x3(_t(x), _t(w), _t(s), _t(nz), _t(b), _t(r), gain, alpha, demod)
    assert fc.launch_counts["modconv3x3"] == 0      # the CPU path launches no kernel
    want = jpc.fused_modconv3x3_lrelu(_j(x), _j(w), _j(s), _j(nz), _j(b), _j(r),
                                      gain, alpha, demod)
    _close(got, want)
    _close(got, jso.modconv_ref(_j(x), _j(w), _j(s), _j(nz), _j(b), _j(r), gain, alpha,
                                demod, False))


@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_k2_plain_matches_jax(cin, kh, styles, noise, bias, demod, gain, alpha):
    n, cout = 2, cin // 2
    h = 16 if cin == 64 else 8
    x, w, s, nz, b = _k2_inputs(np.random.RandomState(1), n, h, cin, cout, kh, styles, noise, bias)
    got = fc.fused_upconv2(_t(x), _t(w), _t(s), setup_filter(FIR), _t(nz), _t(b),
                           gain, alpha, demod, False)
    assert fc.launch_counts["upconv2"] == 0
    assert tuple(got.shape) == (n, 2 * h, 2 * h, cout)
    f = jsetup_filter(FIR)
    args = (_j(w), _j(s), f, _j(nz), _j(b), gain, alpha, demod, False)
    # Packed form: [N, H, G, 128] for Cin 64; pixel NHWC is already the
    # 256-lane packed form for Cin 256.
    xp = jnp.asarray(x) if cin == 256 else jnp.asarray(x).reshape(n, h, h * cin // 128, 128)
    if cin == 256:
        want = jpc.fused_packed_upconv2_c256(_j(x), *args)
    else:
        want = jpc.fused_packed_upconv2(xp, *args).reshape(n, 2 * h, 2 * h, cout)
    _close(got, want)
    _close(got, jso.upconv_ref(xp, *args).reshape(n, 2 * h, 2 * h, cout))


@pytest.mark.parametrize("kh,parity", [(3, (0, 0)), (3, (1, 0)), (3, (1, 1)), (1, (0, 1)),
                                       (1, (1, 1))])
def test_k2_phase_taps_by_hand(kh, parity):
    """One output pixel of each parity, summed tap by tap from the composed
    kernel and the zero-inserted input (the definition of the up-conv),
    against the plain K2 without epilogue."""
    from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir

    rng = np.random.RandomState(2)
    h, cin, cout = 5, 3, 2
    x = torch.from_numpy(rng.randn(1, h, h, cin).astype(np.float32))
    w = torch.from_numpy(rng.randn(kh, kh, cin, cout).astype(np.float32))
    f = setup_filter(FIR)
    y = fc.upconv2_plain(x, w, None, f, gain=1.0, alpha=1.0, demodulate=False)
    k = _compose_kernel_fir(w, f, False, False, gain=4.0)
    L, p0 = k.shape[0], kh // 2 + 2
    xd = torch.zeros(2 * h, 2 * h, cin)
    xd[::2, ::2] = x[0]
    oy, ox = 2 * 2 + parity[0], 2 * 1 + parity[1]
    want = torch.zeros(cout)
    for ty in range(L):
        for tx in range(L):
            uy, ux = oy + ty - p0, ox + tx - p0
            if 0 <= uy < 2 * h and 0 <= ux < 2 * h:
                want += xd[uy, ux] @ k[ty, tx]
    _close(y[0, oy, ox], want)


def test_wrappers_refuse_other_devices_and_shapes():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fc.fused_modconv3x3(x, x, x)
    with pytest.raises(ValueError, match="expected shape"):
        fc._check("noise", torch.zeros(3, 4), (4, 4), torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        fc._check("x", torch.zeros(4, 4).t(), (4, 4), torch.device("cpu"))
    # Operands that carry a gradient are taken: the autograd Functions pass
    # them to the kernels without the graph.
    t = torch.zeros(4, requires_grad=True)
    assert fc._check("x", t, (4,), torch.device("cpu")) == t.data_ptr()
