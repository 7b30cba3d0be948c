"""The CUDA kernels against their plain PyTorch versions, on a card: K1 and
K2, their adjoints (the K1 adjoint launch and K3), K3's D-tower forward,
K2's use_dw role (the D down-conv's dx), K1, K2 and K3 at sizes off their
tiles and K1 at its 1024^2 call shapes, the dw taps of all three weight
roles (K1's taps; the least-work dw of K3 and of the D down-conv, and no
fold on their backwards), per-sample noise, K4 (forward and dx) with its
route, generator forwards of configs whose blocks the gates send
unfused, and the bfloat16 kernels (K1's and K2's forwards and K1's and
K3's adjoints on the tensor cores also at sizes off their tiles and at
single pixels on every edge; K1's forward and the adjoints also at their
1024^2 call shapes, gd formed in the adjoints; HMMA in K1's forward), the
bfloat16 training roles (K3's D-tower forward, K2's use_dw role, the dw
kernels, D's conv0 and the grad Functions' terms; K3's forward and K1's dw
on the tensor cores also at sizes off their tiles, at their 1024^2 and
reg-route call shapes and at single pixels on every edge, with HMMA in
their SASS), the FIR dw's bfloat16 kernel on the tensor cores for both its
roles (odd sizes, the 1024^2 and reg-route call shapes, single pixels on
every tile edge, mixed types refused, HMMA in its SASS), K4 in bfloat16
(the tensor-core K1 kernels' degenerate launches, and its route), and the
float32 K1 and K4 bit-equal to the builds before K1's bfloat16 adjoint and
forward moved to the tensor cores, K2, K3 and the dw kernels to the build
before they took bfloat16 operands, and every float32 kernel to the builds
before K3's bfloat16 forward and K1's bfloat16 dw moved to the tensor cores
and before the FIR dw's did.

This file imports no JAX, so it runs on the GPU machine, where JAX is not
installed; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda -q

Without a card every test skips. The cases are the flag combinations of the
1024^2 path at small sizes (the CPU tests in test_torch_fused_conv.py hold
the plain versions against the JAX package on the same cases; the adjoint
tests in test_torch_adjoint_k1.py / _k3.py, the training roles in
test_torch_training_ops.py). Tolerance 1e-4: float32 sums of the same terms
in another order; for the adjoints and the dw taps relative to each output's
largest entry, since ds, dd1, dd2 and dw are sums over every pixel."""

import math

import numpy as np
import pytest
import torch

from morphganformer_tpu_torch.ops import conv3x3 as k4
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


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the CPU tests of small networks: the suite
    runs several worker processes at once, and torch's thread pool in each
    of them, contending for the cores, makes a loop of small ops tens of
    times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _rel_close(got, want, tol=1e-4):
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * max(scale, 1e-30), (got, want)


def _adjoint_close(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _rel_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_k1_adjoint_kernel_matches_plain(cuda_device, shape, noise, bias, resid, gain, alpha,
                                         demod):
    n, h, c, o = shape
    rng = np.random.RandomState(0)
    x, w, s, nz, b, r = [None if a is None else torch.from_numpy(a).to(cuda_device)
                         for a in _k1_inputs(rng, n, h, c, o, noise, bias, resid)]
    g = torch.from_numpy(rng.randn(n, h, h, o).astype(np.float32)).to(cuda_device)
    y = fc.modconv3x3_plain(x, w, s, nz, b, r, gain, alpha, demod)
    before = fc.launch_counts["modconv3x3_adj"]
    got = fc.modconv3x3_adjoint(g, x, w, s, y, nz, b, r, gain, alpha, demod)
    assert fc.launch_counts["modconv3x3_adj"] == before + 1
    _adjoint_close(got, fc.modconv3x3_adjoint_plain(g, x, w, s, y, nz, b, r, gain, alpha, demod))
    # Through the autograd Function: kernel path against plain=True.
    grads = []
    for plain in (False, True):
        xi, si = x.clone().requires_grad_(), s.clone().requires_grad_()
        out = fc.fused_modconv3x3(xi, w, si, nz, b, r, gain, alpha, demod, plain=plain)
        grads.append(torch.autograd.grad(out, [xi, si], g))
    _adjoint_close(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_k3_adjoint_kernel_matches_plain(cuda_device, cin, kh, styles, noise, bias, demod, gain,
                                         alpha):
    h = 16 if cin == 64 else 8
    rng = np.random.RandomState(1)
    x, w, s, nz, b = [None if a is None else torch.from_numpy(a).to(cuda_device)
                      for a in _k2_inputs(rng, 2, h, cin, cin // 2, kh, styles, noise, bias)]
    g = torch.from_numpy(rng.randn(2, 2 * h, 2 * h, cin // 2).astype(np.float32)).to(cuda_device)
    f = setup_filter(FIR).to(cuda_device)
    y = fc.upconv2_plain(x, w, s, f, nz, b, gain, alpha, demod, False)
    before = fc.launch_counts["upconv2_adj"]
    got = fc.upconv2_adjoint(g, x, w, s, f, y, nz, b, gain, alpha, demod, False)
    assert fc.launch_counts["upconv2_adj"] == before + 1
    _adjoint_close(got, fc.upconv2_adjoint_plain(g, x, w, s, f, y, nz, b, gain, alpha, demod,
                                                 False))
    grads = []
    for plain in (False, True):
        inputs = [x.clone().requires_grad_()] + ([s.clone().requires_grad_()] if styles else [])
        out = fc.fused_upconv2(inputs[0], w, inputs[1] if styles else None, f, nz, b, gain,
                               alpha, demod, False, plain=plain)
        grads.append(torch.autograd.grad(out, inputs, g))
    _adjoint_close(grads[0], grads[1])


# The D down-conv: conv1 (3x3, bias, lrelu, resid) and the skip (1x1, linear,
# no bias), at the 1024^2 path's channel doubling.
DCONV_CASES = [(32, 3, True, True, 1.0, 0.2), (32, 1, False, False, math.sqrt(0.5), 1.0),
               (64, 3, True, False, math.sqrt(2), 0.2)]


def _dconv_inputs(rng, dev, n, h, cin, kh, bias, resid):
    x = torch.from_numpy(rng.randn(n, 2 * h, 2 * h, cin).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.randn(kh, kh, cin, 2 * cin) / math.sqrt(kh * kh * cin))
                         .astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.randn(2 * cin) * 0.1).astype(np.float32)).to(dev) if bias else None
    r = (torch.from_numpy(rng.randn(n, h, h, 2 * cin).astype(np.float32)).to(dev)
         if resid else None)
    return x, w, b, r


@pytest.mark.cuda
@pytest.mark.parametrize("cin,kh,bias,resid,gain,alpha", DCONV_CASES)
def test_k3_forward_and_k2_use_dw_kernels_match_plain(cuda_device, cin, kh, bias, resid, gain,
                                                      alpha):
    rng = np.random.RandomState(2)
    x, w, b, r = _dconv_inputs(rng, cuda_device, 2, 9, cin, kh, bias, resid)
    f = setup_filter(FIR).to(cuda_device)
    before = dict(fc.launch_counts)
    y = fc.fused_downconv2(x, w, f, b, r, gain, alpha)
    assert fc.launch_counts["downconv2"] == before["downconv2"] + 1
    torch.testing.assert_close(y, fc.downconv2_plain(x, w, f, b, r, gain, alpha),
                               rtol=1e-4, atol=1e-4)
    gz = torch.randn(y.shape, generator=torch.Generator(cuda_device).manual_seed(0),
                     device=cuda_device)
    _rel_close(fc.downconv2_adjoint(gz, w, f), fc.downconv2_adjoint_plain(gz, w, f))
    assert fc.launch_counts["downconv2_adj"] == before["downconv2_adj"] + 1
    # Through the Function, every input differentiated: kernels against plain.
    grads = []
    for plain in (False, True):
        ins = [t.clone().requires_grad_() for t in (x, w, b, r) if t is not None]
        it = iter(ins)
        xi, wi = next(it), next(it)
        bi, ri = (next(it) if t is not None else None for t in (b, r))
        out = fc.fused_downconv2(xi, wi, f, bi, ri, gain, alpha, plain=plain)
        grads.append(torch.autograd.grad(out, ins, gz))
    _adjoint_close(grads[0], grads[1])
    assert fc.launch_counts["downconv2_dw"] == before["downconv2_dw"] + 1


# K3 at sizes off its tiles (8 x 16 base positions, 64 output channels, 8
# input channels a chunk): (N, H, W, up-conv Cin, Cout) for the adjoint role
# (the kernel's input channels are the up-conv's Cout), then the flag sets
# of the ds/dd path, the dx-only path without ds, and the skip; per-sample
# noise in the last conv0 case.
K3_ODD_ADJ = [(2, 20, 36, 20, 12, 3, "ds"), (1, 9, 17, 68, 36, 3, "ds"),
              (2, 20, 36, 20, 12, 3, "dx"), (1, 9, 17, 68, 36, 1, "skip"),
              (2, 11, 5, 8, 4, 3, "noise")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,path", K3_ODD_ADJ)
def test_k3_adjoint_kernel_at_odd_sizes(cuda_device, n, h, w, cin, cout, kh, path):
    """One launch per call; dx, ds, dd1 and dd2 within 1e-4 of each one's
    largest entry of the plain adjoint."""
    rng = np.random.RandomState(9)
    dev = cuda_device
    skip = path == "skip"
    x = torch.from_numpy(rng.randn(n, h, w, cin).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin))
                          .astype(np.float32)).to(dev)
    s = None if skip else torch.from_numpy((rng.rand(n, cin) + 0.5).astype(np.float32)).to(dev)
    nshape = (n, 2 * h, 2 * w) if path == "noise" else (2 * h, 2 * w)
    nz = None if skip else torch.from_numpy((rng.randn(*nshape) * 0.1).astype(np.float32)).to(dev)
    b = None if skip else torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(dev)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    f = setup_filter(FIR).to(dev)
    y = fc.upconv2_plain(x, wt, s, f, nz, b, gain, alpha, not skip, False)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32)).to(dev)
    args = (g, x, wt, s, f, y, nz, b, gain, alpha, not skip, False, True, path != "dx")
    before = fc.launch_counts["upconv2_adj"]
    got = fc.upconv2_adjoint(*args)
    assert fc.launch_counts["upconv2_adj"] == before + 1
    want = fc.upconv2_adjoint_plain(*args)
    assert (got[1] is None) == (path in ("dx", "skip"))
    _adjoint_close(got, want)


# (N, H, W of the output, Cin, Cout, kh, bias, resid): off the tiles and the
# chunk; the last with a single output row and column group.
K3_ODD_FWD = [(2, 20, 36, 12, 24, 3, True, True), (2, 20, 36, 12, 24, 1, False, False),
              (1, 9, 17, 20, 68, 3, True, False), (3, 5, 3, 4, 8, 1, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,bias,resid", K3_ODD_FWD)
def test_k3_forward_kernel_at_odd_sizes(cuda_device, n, h, w, cin, cout, kh, bias, resid):
    rng = np.random.RandomState(10)
    dev = cuda_device
    x = torch.from_numpy(rng.randn(n, 2 * h, 2 * w, cin).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin))
                          .astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).to(dev) if bias else None
    r = torch.from_numpy(rng.randn(n, h, w, cout).astype(np.float32)).to(dev) if resid else None
    f = setup_filter(FIR).to(dev)
    for flip_weight in (True, False):
        before = fc.launch_counts["downconv2"]
        y = fc.fused_downconv2(x, wt, f, b, r, 1.3, 0.2, flip_weight)
        assert fc.launch_counts["downconv2"] == before + 1
        torch.testing.assert_close(y, fc.downconv2_plain(x, wt, f, b, r, 1.3, 0.2, flip_weight),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k3_kernel_refuses_what_it_does_not_take(cuda_device):
    """Channel counts not in fours and a FIR that is not 4x4 raise; nothing
    launches and nothing falls back."""
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    before = dict(fc.launch_counts)
    with pytest.raises(ValueError, match="in fours"):
        fc.fused_downconv2(torch.randn(1, 8, 8, 6, device=dev),
                           torch.randn(3, 3, 6, 12, device=dev), f)
    with pytest.raises(ValueError, match="4x4 FIR"):
        fc.fused_downconv2(torch.randn(1, 8, 8, 4, device=dev),
                           torch.randn(3, 3, 4, 8, device=dev), setup_filter([1, 2, 1]).to(dev))
    assert dict(fc.launch_counts) == before


# K2 at sizes off its tiles (6 x 16 base positions, 32 output channels, 16
# input channels a chunk), both roles: (N, H, W of the input, Cin, Cout, kh,
# path). "conv0" has styles, demodulation, batch-shared noise, bias and
# lrelu; "noise" the same with per-sample noise; "skip" none of them;
# "use_dw" is the D down-conv's dx from gz [N,H,W,Cin] (the down-conv's
# Cout) to [N,2H,2W,Cout].
K2_ODD = [(2, 20, 36, 20, 12, 3, "conv0"), (1, 9, 17, 68, 36, 3, "conv0"),
          (2, 11, 5, 4, 36, 3, "noise"), (1, 9, 17, 12, 68, 1, "skip"),
          (2, 20, 36, 36, 4, 3, "use_dw"), (1, 9, 17, 12, 20, 1, "use_dw")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,path", K2_ODD)
def test_k2_kernel_at_odd_sizes(cuda_device, n, h, w, cin, cout, kh, path):
    """One launch per call, for both flip_weight values; the forward within
    1e-4 abs of the plain version, the use_dw role within 1e-4 of the
    largest entry of the plain dx."""
    rng = np.random.RandomState(11)
    dev = cuda_device

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    f = setup_filter(FIR).to(dev)
    x = rand(n, h, w, cin)
    if path == "use_dw":
        wd = rand(kh, kh, cout, cin, scale=1 / math.sqrt(kh * kh * cout))
        for flip_weight in (True, False):
            before = fc.launch_counts["downconv2_adj"]
            got = fc.downconv2_adjoint(x, wd, f, flip_weight)
            assert fc.launch_counts["downconv2_adj"] == before + 1
            _rel_close(got, fc.downconv2_adjoint_plain(x, wd, f, flip_weight))
        return
    skip = path == "skip"
    wt = rand(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    s = None if skip else torch.from_numpy((rng.rand(n, cin) + 0.5).astype(np.float32)).to(dev)
    nz = None if skip else rand(*((n,) if path == "noise" else ()), 2 * h, 2 * w, scale=0.1)
    b = None if skip else rand(cout, scale=0.1)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    for flip_weight in (False, True):
        args = (x, wt, s, f, nz, b, gain, alpha, not skip, flip_weight)
        before = fc.launch_counts["upconv2"]
        got = fc.fused_upconv2(*args)
        assert fc.launch_counts["upconv2"] == before + 1
        torch.testing.assert_close(got, fc.upconv2_plain(*args), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k2_kernel_refuses_what_it_does_not_take(cuda_device):
    """In both roles, channel counts not in fours and a FIR that is not 4x4
    raise; nothing launches and nothing falls back."""
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    f3 = setup_filter([1, 2, 1]).to(dev)
    before = dict(fc.launch_counts)
    with pytest.raises(ValueError, match="in fours"):
        fc.fused_upconv2(torch.randn(1, 8, 8, 6, device=dev), torch.randn(3, 3, 6, 12, device=dev),
                         None, f, demodulate=False)
    with pytest.raises(ValueError, match="4x4 FIR"):
        fc.fused_upconv2(torch.randn(1, 8, 8, 4, device=dev), torch.randn(3, 3, 4, 8, device=dev),
                         None, f3, demodulate=False)
    with pytest.raises(ValueError, match="in fours"):
        fc.downconv2_adjoint(torch.randn(1, 8, 8, 8, device=dev),
                             torch.randn(1, 1, 6, 8, device=dev), f)
    with pytest.raises(ValueError, match="4x4 FIR"):
        fc.downconv2_adjoint(torch.randn(1, 8, 8, 8, device=dev),
                             torch.randn(3, 3, 4, 8, device=dev), f3)
    assert dict(fc.launch_counts) == before


# (n, h, w, cin, cout, scaled): K1's dw taps (the least-work kernel, a block
# on 32 x channels and 64 gd channels, or 32 at widths 64 does not divide):
# the 1024^2 widths 32, 64 and 128, tiles that do and do not divide the
# image (4 x 16 at 64 gd channels, 8 x 16 at 32), odd and non-square sizes,
# images smaller than one tile, widths the kernel's 32-wide channel tiles do
# not divide (the wrapper pads), three gd channel tiles of 32, and no styles
# (D conv0).
DW_CASES = [
    (2, 16, 16, 32, 32, True), (2, 16, 32, 64, 64, True), (1, 12, 16, 128, 128, True),
    (2, 13, 13, 32, 64, True), (2, 13, 13, 16, 48, True), (1, 9, 21, 32, 32, False),
    (3, 7, 5, 64, 32, False), (1, 11, 19, 36, 100, True), (2, 5, 34, 96, 96, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,scaled", DW_CASES)
def test_dw_kernel_matches_plain(cuda_device, n, h, w, cin, cout, scaled):
    gen = torch.Generator(cuda_device).manual_seed(3)
    a = torch.randn((n, h, w, cin), generator=gen, device=cuda_device)
    b = torch.randn((n, h, w, cout), generator=gen, device=cuda_device)
    s = torch.rand((n, cin), generator=gen, device=cuda_device) + 0.5 if scaled else None
    before = fc.launch_counts["modconv3x3_dw"]
    got = fc.conv_dw(a, b, s)
    torch.cuda.synchronize()
    assert fc.launch_counts["modconv3x3_dw"] == before + 1
    want = fc.conv_dw_plain(a, b, s, 1, 1, 3, (0, 0))[0]
    assert got.shape == want.shape == (3, 3, cin, cout)
    _rel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "gd"])
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 64)])
def test_dw_kernel_single_pixels(cuda_device, cin, cout, operand):
    """One non-zero pixel of x or of gd at each corner and edge of a
    non-square image that the tiles do not divide, the other operand
    random: every tap of K1's dw kernel against the plain version, so a
    tap read from the wrong side of the halo shows."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    h, w = 11, 19
    s = torch.rand((1, cin), generator=gen, device=cuda_device) + 0.5
    for py, px in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (0, w // 2), (h - 1, w // 2),
                   (h // 2, 0), (h // 2, w - 1), (h // 2, w // 2)):
        a = torch.randn((1, h, w, cin), generator=gen, device=cuda_device)
        b = torch.randn((1, h, w, cout), generator=gen, device=cuda_device)
        one = a if operand == "x" else b
        keep = one[0, py, px].clone()
        one.zero_()
        one[0, py, px] = keep
        want = fc.conv_dw_plain(a, b, s, 1, 1, 3, (0, 0))[0]
        got = fc.conv_dw(a, b, s)
        torch.cuda.synchronize()
        assert want.abs().max() > 0
        # Zero where the plain version is zero: the taps that reach outside
        # the image from this pixel.
        assert torch.equal(got.abs().sum((2, 3)) == 0, want.abs().sum((2, 3)) == 0), (py, px)
        _rel_close(got, want)


# (role, n, h, w, cin, cout, kh, scaled, flip_weight): the least-work dw of
# K3 (the up-conv's weight; x at h x w, gd at 2h x 2w) and of the D
# down-conv (x at 2h x 2w, gz at h x w): the 1024^2 widths (K3 64 -> 32, D
# 32 -> 64), odd and non-square sizes (a ragged last tile), widths the
# kernel's tiles (32 filtered channels, 64 base channels) do not divide,
# kh 3 and 1, scaled and unscaled, both weight orientations.
FIR_DW_CASES = [
    ("up", 2, 16, 16, 64, 32, 3, True, False), ("up", 2, 16, 16, 64, 32, 1, False, False),
    ("up", 1, 13, 7, 64, 32, 3, True, True), ("up", 2, 9, 11, 24, 40, 1, True, False),
    ("up", 1, 5, 6, 100, 12, 3, False, False),
    ("down", 2, 16, 16, 32, 64, 3, False, True), ("down", 2, 16, 16, 32, 64, 1, False, True),
    ("down", 1, 13, 7, 32, 64, 3, False, False), ("down", 2, 9, 11, 12, 20, 1, False, True),
    ("down", 1, 6, 5, 40, 72, 3, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("role,n,h,w,cin,cout,kh,scaled,flip_weight", FIR_DW_CASES)
def test_fir_dw_kernel_matches_plain(cuda_device, role, n, h, w, cin, cout, kh, scaled,
                                     flip_weight):
    """`upconv2_dw` / `downconv2_dw` (one launch of the least-work dw
    kernel, the cotangent of the small weight flipped onto w) against the
    composed plain version (`conv_dw_plain` + `_fold`)."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    wt = torch.randn((kh, kh, cin, cout), generator=gen, device=dev)
    if role == "up":
        x = torch.randn((n, h, w, cin), generator=gen, device=dev)
        t = torch.randn((n, 2 * h, 2 * w, cout), generator=gen, device=dev)
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if scaled else None
        key, run = "upconv2_dw", lambda: fc.upconv2_dw(x, t, s, wt, f, flip_weight)  # noqa: E731
        want = fc.upconv2_dw_plain(x, t, s, wt, f, flip_weight)
    else:
        x = torch.randn((n, 2 * h, 2 * w, cin), generator=gen, device=dev)
        t = torch.randn((n, h, w, cout), generator=gen, device=dev)
        key, run = "downconv2_dw", lambda: fc.downconv2_dw(x, t, wt, f, flip_weight)  # noqa: E731
        want = fc.downconv2_dw_plain(x, t, wt, f, flip_weight)
    before = fc.launch_counts[key]
    got = run()
    torch.cuda.synchronize()
    assert fc.launch_counts[key] == before + 1
    assert got.shape == want.shape == (kh, kh, cin, cout)
    _rel_close(got, want)


@pytest.mark.cuda
def test_dw_backwards_run_no_fold(cuda_device, monkeypatch):
    """On the card the backwards of FusedUpConv2 and FusedDownConv2 take dw
    from the least-work kernel, with no autograd of the composed kernel
    (`_fold` raises here), and agree with the plain backwards."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(8)
    f = setup_filter(FIR).to(dev)
    x = torch.randn((2, 8, 8, 64), generator=gen, device=dev)
    s = torch.rand((2, 64), generator=gen, device=dev) + 0.5
    wu = torch.randn((3, 3, 64, 32), generator=gen, device=dev) / 24
    xd = torch.randn((2, 16, 16, 32), generator=gen, device=dev)
    wd = torch.randn((3, 3, 32, 64), generator=gen, device=dev) / 17
    runs = {"up": lambda w_, plain: fc.fused_upconv2(x, w_, s, f, None, None, math.sqrt(2), 0.2,
                                                     True, False, plain=plain),
            "down": lambda w_, plain: fc.fused_downconv2(xd, w_, f, None, None, 1.0, 0.2,
                                                         plain=plain)}
    want = {}
    for role, w_ in (("up", wu), ("down", wd)):
        w_ = w_.clone().requires_grad_()
        y = runs[role](w_, True)
        want[role] = torch.autograd.grad(y, w_, torch.ones_like(y))[0]

    def no_fold(*a, **k):
        raise AssertionError("the kernel path folded a composed-kernel cotangent")
    monkeypatch.setattr(fc, "_fold", no_fold)
    before = dict(fc.launch_counts)
    for role, w_ in (("up", wu), ("down", wd)):
        w_ = w_.clone().requires_grad_()
        y = runs[role](w_, False)
        _rel_close(torch.autograd.grad(y, w_, torch.ones_like(y))[0], want[role])
    assert fc.launch_counts["upconv2_dw"] == before["upconv2_dw"] + 1
    assert fc.launch_counts["downconv2_dw"] == before["downconv2_dw"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["k1", "k2", "k2_skip"])
def test_training_grads_with_per_sample_noise_match_plain(cuda_device, op):
    """Every input of K1 / K2 differentiated, with per-sample noise [N,H,W]:
    the kernels' forward, adjoint (dd taps over the per-sample noise) and dw
    taps against the plain versions."""
    rng = np.random.RandomState(4)
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    if op == "k1":
        x, w, s, _, b, r = [None if a is None else torch.from_numpy(a).to(dev)
                            for a in _k1_inputs(rng, 2, 16, 32, 32, False, True, True)]
        nz = torch.from_numpy((rng.randn(2, 16, 16) * 0.1).astype(np.float32)).to(dev)
        tensors = [x, w, s, nz, b, r]
        run = lambda t, plain: fc.fused_modconv3x3(*t, 1.0, 0.2, True, plain=plain)  # noqa: E731
        keys = ("modconv3x3", "modconv3x3_adj", "modconv3x3_dw")
    else:
        skip = op == "k2_skip"
        kh = 1 if skip else 3
        x, w, s, _, b = [None if a is None else torch.from_numpy(a).to(dev)
                         for a in _k2_inputs(rng, 2, 8, 64, 32, kh, not skip, False, not skip)]
        nz = None if skip else torch.from_numpy((rng.randn(2, 16, 16) * 0.1)
                                                .astype(np.float32)).to(dev)
        tensors = [x, w, s, nz, b]
        gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)

        def run(t, plain):
            return fc.fused_upconv2(t[0], t[1], t[2], f, t[3], t[4], gain, alpha, not skip,
                                    False, plain=plain)
        keys = ("upconv2", "upconv2_adj", "upconv2_dw")
    before = [fc.launch_counts[k] for k in keys]
    outs, grads = [], []
    for plain in (False, True):
        ins = [None if t is None else t.clone().requires_grad_() for t in tensors]
        out = run(ins, plain)
        g = torch.randn(out.shape, generator=torch.Generator(dev).manual_seed(5), device=dev)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, [t for t in ins if t is not None], g))
    assert [fc.launch_counts[k] - v for k, v in zip(keys, before)] == [1, 1, 1]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    _adjoint_close(grads[0], grads[1])


@pytest.mark.cuda
def test_d_gradients_at_unaligned_widths_match_plain(cuda_device, monkeypatch):
    """A D whose fused blocks have 8 and 16 input channels, widths that the
    dw kernel's 32-wide tiles do not divide: the image's and every
    parameter's gradient on the kernels against the plain path, to 1e-3 of
    each one's largest entry (several layers of float32 sums in another
    order)."""
    from morphganformer_tpu_torch.models import discriminator as tdisc
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig

    monkeypatch.setattr(tdisc, "packed_d_block_eligible",
                        lambda cfg, res: res >= 16 and tdisc.packed_d_structural_ok(cfg, res))
    cfg = DiscriminatorConfig(img_resolution=32, channel_base=256, channel_max=64,
                              mbstd_group_size=2)
    D = tdisc.init_discriminator(cfg, seed=0, device=cuda_device)
    img = torch.randn((2, 32, 32, 3), generator=torch.Generator(cuda_device).manual_seed(6),
                      device=cuda_device)
    before = dict(fc.launch_counts)
    grads = []
    for plain in (False, True):
        x = img.clone().requires_grad_()
        grads.append(torch.autograd.grad(D(x, plain=plain).sum(), [x, *D.parameters()]))
    assert fc.launch_counts["modconv3x3_dw"] == before["modconv3x3_dw"] + 2
    assert fc.launch_counts["downconv2_dw"] == before["downconv2_dw"] + 4
    for g, w in zip(*grads):
        _rel_close(g, w, tol=1e-3)


# K4: its call shapes at FFHQ-1024 widths (64 -> 64 at 512^2: G b512 conv1,
# D b512 conv0; 32 -> 32 at 1024^2: G b1024 conv1 and conv_last, D b1024
# conv0) and widths in fours off its tiles (C 4, 20, 48; O 8, 36, 12, 4).
K4_CASES = [(1, 512, 512, 64, 64), (1, 1024, 1024, 32, 32), (2, 24, 40, 4, 8),
            (1, 16, 16, 20, 36), (2, 12, 20, 48, 12), (1, 8, 8, 64, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o", K4_CASES)
def test_k4_kernel_and_dx_match_plain(cuda_device, n, h, w, c, o):
    """Forward and dx within 1e-5 of the output's largest entry (float32
    sums of the same nine taps in another order)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(n, h, w, c).astype(np.float32)).to(cuda_device)
    wt = torch.from_numpy((rng.randn(3, 3, c, o) / math.sqrt(9 * c)).astype(np.float32))
    wt = wt.to(cuda_device)
    g = torch.from_numpy(rng.randn(n, h, w, o).astype(np.float32)).to(cuda_device)
    before = dict(fc.launch_counts)
    y, dx = k4.conv3x3_forward(x, wt), k4.conv3x3_dx(g, wt)
    assert fc.launch_counts["conv3x3"] == before["conv3x3"] + 1
    assert fc.launch_counts["conv3x3_adj"] == before["conv3x3_adj"] + 1
    _rel_close(y, k4.conv3x3_same_plain(x, wt), 1e-5)
    _rel_close(dx, k4.conv3x3_same_plain(g, k4.conv3x3_adjoint_weights(wt)), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("flip_weight", [True, False])
def test_k4_route_and_gradients_match_the_cudnn_path(cuda_device, monkeypatch, flip_weight):
    """conv2d_resample under MGT_PALLAS_CONV=1 launches K4 forward and dx
    once each; the output, dx and dw equal the F.conv2d path's (switch off)
    within 1e-5, dw (a sum over every pixel) within 1e-4 of its largest
    entry. A second derivative through it raises."""
    from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample

    gen = torch.Generator(cuda_device).manual_seed(8)
    x = torch.randn((2, 512, 512, 16), generator=gen, device=cuda_device)
    w = torch.randn((3, 3, 16, 12), generator=gen, device=cuda_device) / 12
    g = torch.randn((2, 512, 512, 12), generator=gen, device=cuda_device)

    def run():
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = conv2d_resample(xt, wt, padding=1, flip_weight=flip_weight)
        return (y.detach(), *torch.autograd.grad(y, (xt, wt), g))

    monkeypatch.delenv("MGT_PALLAS_CONV", raising=False)
    want = run()
    monkeypatch.setenv("MGT_PALLAS_CONV", "1")
    before = dict(fc.launch_counts)
    got = run()
    assert fc.launch_counts["conv3x3"] == before["conv3x3"] + 1
    assert fc.launch_counts["conv3x3_adj"] == before["conv3x3_adj"] + 1
    for a, b, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        _rel_close(a, b, tol)
    # Channels not in fours, which the kernel does not take: cuDNN, no launch.
    before = dict(fc.launch_counts)
    conv2d_resample(x[..., :15], w[:, :, :15, :9], padding=1, flip_weight=flip_weight)
    assert dict(fc.launch_counts) == before
    xt = x.clone().requires_grad_(True)
    y = conv2d_resample(xt, w, padding=1, flip_weight=flip_weight)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(y.square().sum(), xt, create_graph=True)


# The K1 kernel (conv3x3_lw_kernel, both roles) at the 4 K1 call shapes of a
# 1024^2 forward at batch 1: (side, C = O, conv_last).
K1_CALLS = [(256, 128, False), (512, 64, False), (1024, 32, False), (1024, 32, True)]


def _k1_call(rng, dev, n, res, c, o, last, noise="shared"):
    """Random K1 operands at one G call: conv1 (noise, bias, resid, lrelu) or
    conv_last (none of them, linear); noise batch-shared or per-sample."""
    x, w, s, _, b, r = [None if a is None else torch.from_numpy(a).to(dev)
                        for a in _k1_inputs(rng, n, res, c, o, False, not last, not last)]
    nz = None
    if not last:
        shape = (n, res, res) if noise == "sample" else (res, res)
        nz = torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32)).to(dev)
    return x, w, s, nz, b, r, 1.0, (1.0 if last else 0.2)


def _k1_both_roles(x, w, s, nz, b, r, gain, alpha, demod=True):
    """One forward and one adjoint launch against the plain versions: y
    within 1e-4 abs, dx, ds, dd1, dd2 within 1e-4 of each one's largest
    entry (as chip_smoke.py holds them)."""
    args = (x, w, s, nz, b, r, gain, alpha, demod)
    before = dict(fc.launch_counts)
    y = fc.fused_modconv3x3(*args)
    torch.testing.assert_close(y, fc.modconv3x3_plain(*args), rtol=0, atol=1e-4)
    g = torch.randn(y.shape, generator=torch.Generator(y.device).manual_seed(9), device=y.device)
    adj = (g, x, w, s, y, nz, b, r, gain, alpha, demod)
    _adjoint_close(fc.modconv3x3_adjoint(*adj), fc.modconv3x3_adjoint_plain(*adj))
    assert fc.launch_counts["modconv3x3"] == before["modconv3x3"] + 1
    assert fc.launch_counts["modconv3x3_adj"] == before["modconv3x3_adj"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("res,c,last", K1_CALLS)
def test_k1_kernel_at_the_1024_call_shapes(cuda_device, res, c, last):
    _k1_both_roles(*_k1_call(np.random.RandomState(12), cuda_device, 1, res, c, c, last))


# K1 off its tiles (16 x 32 positions at up to 32 output channels, 16 x 16
# at more): (N, H, W, C, O, noise). Both roles, with resid and bias.
K1_ODD = [(2, 20, 37, 12, 8, "sample"), (1, 17, 19, 20, 40, "shared"),
          (3, 9, 50, 36, 36, None), (1, 33, 16, 4, 68, "shared")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,noise", K1_ODD)
def test_k1_kernel_at_odd_sizes(cuda_device, n, h, w, c, o, noise):
    rng = np.random.RandomState(13)
    dev = cuda_device

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    x, wt, r = rand(n, h, w, c), rand(3, 3, c, o, scale=1 / math.sqrt(9 * c)), rand(n, h, w, o)
    s = torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32)).to(dev)
    nz = None if noise is None else rand(*((n,) if noise == "sample" else ()), h, w, scale=0.1)
    _k1_both_roles(x, wt, s, nz, rand(o, scale=0.1), r, math.sqrt(2), 0.2)


@pytest.mark.cuda
def test_k1_training_at_batch_4_with_per_sample_noise(cuda_device):
    """G b512 conv1's widths at batch 4 with per-sample noise [4,H,W]: both
    roles, then every gradient through the Function (the dd taps over the
    per-sample noise, the dw taps) against plain=True."""
    x, w, s, nz, b, r, gain, alpha = _k1_call(np.random.RandomState(14), cuda_device, 4, 64,
                                              64, 64, False, noise="sample")
    _k1_both_roles(x, w, s, nz, b, r, gain, alpha)
    grads = []
    for plain in (False, True):
        ins = [t.clone().requires_grad_() for t in (x, w, s, nz, b, r)]
        out = fc.fused_modconv3x3(*ins, gain, alpha, True, plain=plain)
        g = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(15),
                        device=cuda_device)
        grads.append(torch.autograd.grad(out, ins, g))
    _adjoint_close(grads[0], grads[1])


@pytest.mark.cuda
def test_k1_without_styles_or_demodulation(cuda_device):
    """The D conv0 form (no styles, no demodulation, bias, lrelu, no noise):
    the forward, dx and dw through the Function against plain=True."""
    rng = np.random.RandomState(16)
    x, w, _, _, b, r = [None if a is None else torch.from_numpy(a).to(cuda_device)
                        for a in _k1_inputs(rng, 2, 40, 32, 32, False, True, True)]
    outs, grads = [], []
    for plain in (False, True):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fc.fused_modconv3x3(xi, wi, None, None, b, r, math.sqrt(2), 0.2, False,
                                  plain=plain)
        g = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(17),
                        device=cuda_device)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, [xi, wi], g))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-4)
    _adjoint_close(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("need_dx,need_ds", [(True, False), (False, True)])
def test_k1_adjoint_asks_for_dx_or_ds_alone(cuda_device, need_dx, need_ds):
    x, w, s, nz, b, r, gain, alpha = _k1_call(np.random.RandomState(18), cuda_device, 2, 48,
                                              32, 64, False)
    y = fc.modconv3x3_plain(x, w, s, nz, b, r, gain, alpha, True)
    g = torch.randn(y.shape, generator=torch.Generator(cuda_device).manual_seed(19),
                    device=cuda_device)
    adj = (g, x, w, s, y, nz, b, r, gain, alpha, True, need_dx, need_ds)
    got = fc.modconv3x3_adjoint(*adj)
    assert [t is None for t in got] == [not need_dx] + [not need_ds] * 3
    _adjoint_close(got, fc.modconv3x3_adjoint_plain(*adj))


@pytest.mark.cuda
def test_k1_adjoint_forms_gd_in_the_kernel(cuda_device):
    """On the projection path (dx and ds of conv1, no weight, noise or bias
    gradients) the backward dispatches no torch op over a tensor of the
    output's size but allocations: gd, the mask and y - resid are the
    kernel's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    x, w, s, nz, b, r, gain, alpha = _k1_call(np.random.RandomState(20), cuda_device, 1, 256,
                                              128, 128, False)
    xi, si, ri = x.clone().requires_grad_(), s.clone().requires_grad_(), r.clone().requires_grad_()
    out = fc.fused_modconv3x3(xi, w, si, nz, b, ri, gain, alpha, True)
    g = torch.randn(out.shape, generator=torch.Generator(cuda_device).manual_seed(21),
                    device=cuda_device)
    big = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            seen = [t for t in (*args, *(kwargs or {}).values(),
                                *(res if isinstance(res, (tuple, list)) else (res,)))
                    if isinstance(t, torch.Tensor)]
            if not func.__name__.startswith(("empty", "detach", "alias", "view")) and \
                    any(t.numel() >= out.numel() for t in seen):
                big.append(func.__name__)
            return res

    before = fc.launch_counts["modconv3x3_adj"]
    with Spy():
        grads = torch.autograd.grad(out, [xi, si, ri], g)
    assert fc.launch_counts["modconv3x3_adj"] == before + 1
    assert big == [], big
    want = fc.modconv3x3_adjoint_plain(g, x, w, s, out.detach(), nz, b, r, gain, alpha, True)
    _adjoint_close(grads[:2], want[:2])


@pytest.mark.cuda
def test_k1_kernel_refuses_what_it_does_not_take(cuda_device):
    """K1 and K4 with channel counts not in fours raise; nothing launches and
    nothing falls back."""
    dev = cuda_device
    before = dict(fc.launch_counts)
    x, w = torch.randn(1, 8, 8, 6, device=dev), torch.randn(3, 3, 6, 8, device=dev)
    with pytest.raises(ValueError, match="in fours"):
        fc.fused_modconv3x3(x, w, torch.ones(1, 6, device=dev))
    with pytest.raises(ValueError, match="in fours"):
        fc.modconv3x3_adjoint(torch.randn(1, 8, 8, 8, device=dev), x, w,
                              torch.ones(1, 6, device=dev), torch.randn(1, 8, 8, 8, device=dev))
    with pytest.raises(ValueError, match="in fours"):
        k4.conv3x3_forward(x, w)
    with pytest.raises(ValueError, match="in fours"):
        k4.conv3x3_dx(torch.randn(1, 8, 8, 8, device=dev), w)
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
@pytest.mark.parametrize("override", [dict(resample_kernel=(1, 2, 1)),
                                      dict(channel_base=1 << 11)])
def test_generator_of_configs_the_gates_send_unfused(cuda_device, override):
    """FFHQ-1024 with a 3-tap FIR (no block fused) and with channel_base
    2^11 (widths 8, 4, 2 at b256-b1024: b1024 unfused): one forward at batch
    1 on the kernels against plain=True, within 1e-3 of the image's largest
    entry (many layers of float32 sums in another order)."""
    from morphganformer_tpu_torch.models import config as tcfg
    from morphganformer_tpu_torch.models import init_generator
    from morphganformer_tpu_torch.models import synthesis as tsyn

    cfg = tcfg.ffhq1024_config(**override)
    fused = [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, "const")]
    assert fused == ([] if "resample_kernel" in override else [256, 512])
    G = init_generator(cfg, seed=0, device=cuda_device)
    z = torch.randn((1, cfg.k, cfg.z_dim), generator=torch.Generator(cuda_device).manual_seed(22),
                    device=cuda_device)
    fc.reset_launch_counts()
    with torch.no_grad():
        img = G(z, truncation_psi=0.7)
        counts = dict(fc.launch_counts)
        want = G(z, truncation_psi=0.7, plain=True)
    assert counts["modconv3x3"] == len(fused)               # conv1 (conv_last: b1024)
    assert counts["upconv2"] == 2 * len(fused)
    _rel_close(img, want, 1e-3)


# bfloat16: each bf16 role (K1, K2, K1's adjoint launch, K3's adjoint)
# against its plain bfloat16 version, each held against the float32 plain
# version on the same bfloat16-rounded activations; the kernel's error may
# be at most BF16_RATIO times the plain one's, or within BF16_FLOOR of each
# output's largest entry (one bfloat16 ulp there; chip_smoke.py's phase bf16
# holds the 1024^2 call shapes to the same).
BF16_RATIO, BF16_FLOOR = 1.5, 2.0 ** -7


def _bf16_close(got, plain, ref):
    got, plain, ref = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, plain, ref))
    for g, p, r in zip(got, plain, ref):
        assert (g is None) == (r is None) == (p is None)
        if r is None:
            continue
        scale = max(r.abs().max().item(), 1e-30)
        ek = (g.float() - r).abs().max().item() / scale
        ep = (p.float() - r).abs().max().item() / scale
        assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), (ek, ep)


def _widen(args):
    return tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
                 for a in args)


def _bf16_k1(dev, shape, noise, bias, resid):
    n, h, c, o = shape
    rng = np.random.RandomState(0)
    x, w, s, nz, b, r = [None if a is None else torch.from_numpy(a).to(dev)
                         for a in _k1_inputs(rng, n, h, c, o, noise, bias, resid)]
    g = torch.from_numpy(rng.randn(n, h, h, o).astype(np.float32)).to(dev)
    return x.bfloat16(), w, s, nz, b, (None if r is None else r.bfloat16()), g.bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,noise,bias,resid,gain,alpha,demod", K1_CASES)
def test_bf16_k1_and_its_adjoint_match_plain(cuda_device, shape, noise, bias, resid, gain,
                                             alpha, demod):
    x, w, s, nz, b, r, g = _bf16_k1(cuda_device, shape, noise, bias, resid)
    fwd = (x, w, s, nz, b, r, gain, alpha, demod)
    before = dict(fc.launch_counts)
    y = fc.fused_modconv3x3(*fwd)
    assert y.dtype == torch.bfloat16
    assert fc.launch_counts["modconv3x3_bf16"] == before["modconv3x3_bf16"] + 1
    assert fc.launch_counts["modconv3x3"] == before["modconv3x3"]
    _bf16_close(y, fc.modconv3x3_plain(*fwd), fc.modconv3x3_plain(*_widen(fwd)))
    args = (g, x, w, s, y, nz, b, r, gain, alpha, demod)
    got = fc.modconv3x3_adjoint(*args)
    assert fc.launch_counts["modconv3x3_adj_bf16"] == before["modconv3x3_adj_bf16"] + 1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _bf16_close(got, fc.modconv3x3_adjoint_plain(*args),
                fc.modconv3x3_adjoint_plain(*_widen(args)))
    # Through the autograd Function: the cotangents in their inputs' types.
    xi, si = x.clone().requires_grad_(), s.clone().requires_grad_()
    dx, ds = torch.autograd.grad(fc.fused_modconv3x3(xi, w, si, nz, b, r, gain, alpha, demod),
                                 [xi, si], g)
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    _bf16_close((dx, ds), fc.modconv3x3_adjoint_plain(*args)[:2],
                fc.modconv3x3_adjoint_plain(*_widen(args))[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,kh,styles,noise,bias,demod,gain,alpha", K2_CASES)
def test_bf16_k2_and_k3_adjoint_match_plain(cuda_device, cin, kh, styles, noise, bias, demod,
                                            gain, alpha):
    h = 16 if cin == 64 else 8
    rng = np.random.RandomState(1)
    x, w, s, nz, b = [None if a is None else torch.from_numpy(a).to(cuda_device)
                      for a in _k2_inputs(rng, 2, h, cin, cin // 2, kh, styles, noise, bias)]
    g = torch.from_numpy(rng.randn(2, 2 * h, 2 * h, cin // 2).astype(np.float32))
    x, g = x.bfloat16(), g.to(cuda_device).bfloat16()
    f = setup_filter(FIR).to(cuda_device)
    fwd = (x, w, s, f, nz, b, gain, alpha, demod, False)
    before = dict(fc.launch_counts)
    y = fc.fused_upconv2(*fwd)
    assert y.dtype == torch.bfloat16
    assert fc.launch_counts["upconv2_bf16"] == before["upconv2_bf16"] + 1
    _bf16_close(y, fc.upconv2_plain(*fwd), fc.upconv2_plain(*_widen(fwd)))
    args = (g, x, w, s, f, y, nz, b, gain, alpha, demod, False)
    got = fc.upconv2_adjoint(*args)
    assert fc.launch_counts["upconv2_adj_bf16"] == before["upconv2_adj_bf16"] + 1
    assert fc.launch_counts["upconv2_adj"] == before["upconv2_adj"]
    _bf16_close(got, fc.upconv2_adjoint_plain(*args), fc.upconv2_adjoint_plain(*_widen(args)))


@pytest.mark.cuda
def test_bf16_launchers_refuse_mixed_types(cuda_device):
    """A bfloat16 launch takes bfloat16 activations only (the weights,
    styles and noise are float32 parameters it casts, as JAX's wrappers);
    the training roles take one type for every activation they read; a
    bfloat16 tensor never reaches a float32 kernel."""
    x, w, s, nz, b, r, g = _bf16_k1(cuda_device, (1, 8, 16, 16), True, True, True)
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="resid"):
        fc.fused_modconv3x3(x, w, s, nz, b, r.float())
    with pytest.raises(TypeError, match="resid"):
        fc.fused_modconv3x3(x.float(), w, s, nz, b, r)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_modconv3x3(x.half(), w, s, nz, b, r.half())
    y = fc.modconv3x3_plain(x, w, s, nz, b, r)
    with pytest.raises(TypeError, match="y"):
        fc.modconv3x3_adjoint(g, x, w, s, y.float(), nz, b, r)
    with pytest.raises(TypeError, match="x"):
        fc.modconv3x3_adjoint(g, x.float(), w, s, y, nz, b, r)
    f = setup_filter(FIR).to(cuda_device)
    xd = torch.zeros(1, 16, 16, 16, device=cuda_device, dtype=torch.bfloat16)
    wd = torch.zeros(3, 3, 16, 32, device=cuda_device)
    with pytest.raises(TypeError, match="resid"):
        fc.fused_downconv2(xd, wd, f, resid=torch.zeros(1, 8, 8, 32, device=cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.downconv2_adjoint(torch.zeros(1, 8, 8, 32, device=cuda_device, dtype=torch.half),
                             wd, f)
    with pytest.raises(TypeError, match="gd"):
        fc.conv_dw(xd, torch.zeros(1, 16, 16, 32, device=cuda_device), None)
    with pytest.raises(TypeError, match="src"):
        fc.downconv2_dw(xd.float(), torch.zeros(1, 8, 8, 32, device=cuda_device,
                                                dtype=torch.bfloat16), wd, f)
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
def test_bf16_generator_runs_on_the_bf16_kernels(cuda_device):
    """A config with fused blocks in bfloat16: every fused launch is a bf16
    one, the image is float32 and close to the float32 generator's."""
    from morphganformer_tpu_torch.models import GANformerConfig, init_generator, set_compute_dtype
    from morphganformer_tpu_torch.models import synthesis as tsyn

    cfg = GANformerConfig(z_dim=8, w_dim=8, k=3, end_res=3, img_resolution=32,
                          channel_base=4096, channel_max=256)
    G = init_generator(cfg, seed=5, device=cuda_device)
    z = torch.randn(2, cfg.k, cfg.z_dim, device=cuda_device)
    with torch.no_grad():
        y32 = G(z=z, truncation_psi=0.7)
        set_compute_dtype(G, "bfloat16")
        fc.reset_launch_counts()
        yk = G(z=z, truncation_psi=0.7)
        counts = dict(fc.launch_counts)
        yp = G(z=z, truncation_psi=0.7, plain=True)
    fused = [r for r in cfg.block_resolutions if tsyn.packed_structural_ok(cfg, r, "const")]
    assert fused == [8, 16, 32]
    assert counts["modconv3x3_bf16"] == len(fused) + 1 and counts["upconv2_bf16"] == 2 * len(fused)
    assert counts["modconv3x3"] == counts["upconv2"] == 0
    assert yk.dtype == torch.float32 and torch.isfinite(yk).all()
    ek, ep = ((y - y32).abs().mean().item() for y in (yk, yp))
    assert ek <= BF16_RATIO * ep, (ek, ep)


# K2's bfloat16 forward on the tensor cores (upconv2_tc_kernel: 6 x 14 base
# positions and 32 output channels a block, 32 input channels a chunk for
# the 3x3 and 64 for the 1x1, k16 steps) at sizes off its tiles: (N, H, W of
# the input, Cin, Cout, kh, path).
# No Cin is a multiple of 16 (a chunk's last k16 step is zero-filled), Cin
# and Cout 4 and 12 take the 8-byte copies, 36 and 68 two chunks or two
# channel blocks. "conv0" has styles, demodulation, batch-shared noise,
# bias and lrelu; "noise" the same with per-sample noise; "nodemod" styles
# and bias alone; "skip" none of them (linear).
K2_BF16_ODD = [(2, 20, 36, 4, 12, 3, "conv0"), (1, 17, 17, 12, 36, 3, "noise"),
               (2, 11, 5, 36, 4, 3, "nodemod"), (1, 30, 30, 68, 36, 3, "skip"),
               (2, 13, 15, 68, 12, 1, "conv0"), (1, 9, 17, 12, 4, 1, "noise"),
               (2, 6, 29, 36, 36, 1, "nodemod"), (1, 20, 14, 4, 12, 1, "skip")]


def _k2_bf16_operands(rng, dev, n, h, w, cin, cout, kh, path):
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    skip = path == "skip"
    x = rand(n, h, w, cin).bfloat16()
    wt = rand(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    s = None if skip else torch.from_numpy((rng.rand(n, cin) + 0.5).astype(np.float32)).to(dev)
    nz = None
    if path in ("conv0", "noise"):
        nz = rand(*((n,) if path == "noise" else ()), 2 * h, 2 * w, scale=0.1)
    b = None if skip else rand(cout, scale=0.1)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    return x, wt, s, nz, b, gain, alpha, path in ("conv0", "noise")


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,path", K2_BF16_ODD)
def test_bf16_k2_tensor_core_kernel_at_odd_sizes(cuda_device, n, h, w, cin, cout, kh, path):
    """One bf16 launch per call, for both flip_weight values, within the
    bf16 rule of the float32 plain version on the same inputs."""
    x, wt, s, nz, b, gain, alpha, demod = _k2_bf16_operands(
        np.random.RandomState(17), cuda_device, n, h, w, cin, cout, kh, path)
    f = setup_filter(FIR).to(cuda_device)
    for flip_weight in (False, True):
        fwd = (x, wt, s, f, nz, b, gain, alpha, demod, flip_weight)
        before = dict(fc.launch_counts)
        y = fc.fused_upconv2(*fwd)
        assert y.dtype == torch.bfloat16 and y.shape == (n, 2 * h, 2 * w, cout)
        assert fc.launch_counts["upconv2_bf16"] == before["upconv2_bf16"] + 1
        assert fc.launch_counts["upconv2"] == before["upconv2"]
        assert torch.isfinite(y).all()
        _bf16_close(y, fc.upconv2_plain(*fwd), fc.upconv2_plain(*_widen(fwd)))


def _edge_pixels(hh, ww):
    """The four corners, a pixel inside each edge, one inside, and the
    pixels on both sides of the inner tile edges of upconv2_tc_kernel (rows
    5 | 6 and 11 | 12, columns 13 | 14)."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2), (5, 13), (6, 14), (11, 14),
            (12, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("kh", [3, 1])
def test_bf16_k2_tensor_core_kernel_single_pixels(cuda_device, kh):
    """One nonzero input pixel at a time on a 17 x 31 image (three tiles
    down, three across), a FIR with no symmetry, no epilogue: the output
    is that pixel's composed kernel in its place, which pins the
    orientation of each Z class (AA, AB, BA, BB) and the halo at the tile
    edges; within the bf16 rule of the float32 plain version."""
    dev = cuda_device
    rng = np.random.RandomState(23)
    h, w, cin, cout = 17, 31, 20, 36
    f = setup_filter(rng.rand(4, 4) + 0.1).to(dev)
    wt = torch.from_numpy(rng.randn(kh, kh, cin, cout).astype(np.float32)).to(dev)
    s = torch.from_numpy((rng.rand(1, cin) + 0.5).astype(np.float32)).to(dev)
    for py, px in _edge_pixels(h, w):
        x = torch.zeros(1, h, w, cin, device=dev)
        x[0, py, px] = torch.from_numpy(rng.randn(cin).astype(np.float32)).to(dev)
        fwd = (x.bfloat16(), wt, s, f, None, None, 1.0, 1.0, False, False)
        y = fc.fused_upconv2(*fwd)
        _bf16_close(y, fc.upconv2_plain(*fwd), fc.upconv2_plain(*_widen(fwd)))


# K3's bfloat16 adjoint on the tensor cores (downconv2_tc_kernel: 8 x 16 dx
# positions and 64 dx channels a block, 16 gd channels a chunk, gd formed
# from g, y and d in the kernel) at sizes off its tiles, then at the six
# call shapes of a 1024^2 forward: (N, H, W of dx, C, O, kh, path). C and O
# 4, 12, 20 and 36 take the 8-byte copies, 68 two channel groups, 36 a
# partial last chunk. "conv0": styles, demodulation, batch-shared noise,
# bias, lrelu (dx, ds and the dd taps); "noise": per-sample noise; "dx": dx
# alone; "lrelu": no styles, the mask from y; "skip": no styles, linear
# (no y read).
K3_BF16_ODD = [(2, 20, 36, 20, 12, 3, "conv0"), (1, 9, 17, 68, 36, 3, "noise"),
               (2, 11, 5, 36, 4, 3, "dx"), (1, 13, 19, 8, 16, 3, "lrelu"),
               (2, 17, 33, 12, 68, 1, "skip"), (1, 9, 17, 4, 12, 1, "lrelu")]
K3_BF16_CALLS = [(1, 128, 128, 256, 128, 3, "conv0"), (1, 128, 128, 256, 128, 1, "skip"),
                 (1, 256, 256, 128, 64, 3, "conv0"), (1, 256, 256, 128, 64, 1, "skip"),
                 (1, 512, 512, 64, 32, 3, "conv0"), (1, 512, 512, 64, 32, 1, "skip")]


def _k3_bf16_args(rng, dev, n, h, w, c, o, kh, path, flip_weight=False):
    """The adjoint's arguments (g, x, w, styles, f, y, noise, bias, gain,
    alpha, demod, flip_weight, need_dx, need_ds): y the plain bf16 forward."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    styles = path in ("conv0", "noise", "dx")
    x = rand(n, h, w, c).bfloat16()
    wt = rand(kh, kh, c, o, scale=1 / math.sqrt(kh * kh * c))
    s = torch.from_numpy((rng.rand(n, c) + 0.5).astype(np.float32)).to(dev) if styles else None
    nz = None
    if path in ("conv0", "noise"):
        nz = rand(*((n,) if path == "noise" else ()), 2 * h, 2 * w, scale=0.1)
    b = rand(o, scale=0.1) if styles else None
    gain, alpha = (math.sqrt(0.5), 1.0) if path == "skip" else (math.sqrt(2), 0.2)
    demod = path in ("conv0", "noise")
    f = setup_filter(FIR).to(dev)
    y = fc.upconv2_plain(x, wt, s, f, nz, b, gain, alpha, demod, flip_weight)
    g = rand(n, 2 * h, 2 * w, o).bfloat16()
    return (g, x, wt, s, f, y, nz, b, gain, alpha, demod, flip_weight, True, path != "dx")


def _k3_bf16_check(args):
    before = dict(fc.launch_counts)
    got = fc.upconv2_adjoint(*args)
    assert fc.launch_counts["upconv2_adj_bf16"] == before["upconv2_adj_bf16"] + 1
    assert fc.launch_counts["upconv2_adj"] == before["upconv2_adj"]
    assert got[0].dtype == torch.bfloat16 and torch.isfinite(got[0]).all()
    want = fc.upconv2_adjoint_plain(*args)
    assert [t is None for t in got] == [t is None for t in want]
    _bf16_close(got, want, fc.upconv2_adjoint_plain(*_widen(args)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,kh,path", K3_BF16_ODD)
def test_bf16_k3_tensor_core_adjoint_at_odd_sizes(cuda_device, n, h, w, c, o, kh, path):
    """One bf16 launch per call, for both flip_weight values; dx, ds and the
    dd taps within the bf16 rule of the float32 plain version on the same
    inputs."""
    for flip_weight in (False, True):
        _k3_bf16_check(_k3_bf16_args(np.random.RandomState(29), cuda_device, n, h, w, c, o, kh,
                                     path, flip_weight))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,kh,path", K3_BF16_CALLS)
def test_bf16_k3_tensor_core_adjoint_at_the_1024_call_shapes(cuda_device, n, h, w, c, o, kh,
                                                             path):
    _k3_bf16_check(_k3_bf16_args(np.random.RandomState(30), cuda_device, n, h, w, c, o, kh,
                                 path))


def _k3_edge_pixels(hh, ww):
    """Corners, edge midpoints and the centre of a 2H x 2W cotangent, and the
    pixels on both sides of downconv2_tc_kernel's inner tile edges (gd rows
    15 | 16, columns 31 | 32), with their FIR halo's reach (rows 13, 18)."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2), (15, 31), (16, 32), (13, 32),
            (18, 31), (15, 0), (16, ww - 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("kh", [3, 1])
def test_bf16_k3_tensor_core_adjoint_single_pixels(cuda_device, kh):
    """One nonzero g pixel at a time on a 34 x 70 cotangent (dx 17 x 35:
    three tiles down, three across), a FIR with no symmetry, no mask,
    styles or demodulation: dx is that pixel's composed kernel read back in
    its place, which pins each tap's plane and shift and the halo at the
    tile edges; the nonzero entries land where the plain version's do,
    within the bf16 rule of the float32 plain version."""
    dev = cuda_device
    rng = np.random.RandomState(31)
    h, w, c, o = 17, 35, 20, 36
    f = setup_filter(rng.rand(4, 4) + 0.1).to(dev)
    wt = torch.from_numpy(rng.randn(kh, kh, c, o).astype(np.float32)).to(dev)
    x = torch.zeros(1, h, w, c, device=dev, dtype=torch.bfloat16)
    y = torch.ones(1, 2 * h, 2 * w, o, device=dev, dtype=torch.bfloat16)
    for py, px in _k3_edge_pixels(2 * h, 2 * w):
        g = torch.zeros(1, 2 * h, 2 * w, o, device=dev)
        g[0, py, px] = torch.from_numpy(rng.randn(o).astype(np.float32)).to(dev)
        args = (g.bfloat16(), x, wt, None, f, y, None, None, 1.0, 1.0, False, False, True, False)
        got = fc.upconv2_adjoint(*args)
        want = fc.upconv2_adjoint_plain(*args)
        assert bool(((got[0] != 0) == (want[0] != 0)).all()), (py, px)
        _bf16_close(got, want, fc.upconv2_adjoint_plain(*_widen(args)))


@pytest.mark.cuda
def test_bf16_k3_adjoint_forms_gd_in_the_kernel(cuda_device):
    """On the projection path (dx and ds of conv0, no weight, noise or bias
    gradients) K2's bf16 backward dispatches no torch op over a tensor of
    the output's size but allocations: gd and the mask are the kernel's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    g, x, w, s, f, y, nz, b, gain, alpha, demod, _, _, _ = _k3_bf16_args(
        np.random.RandomState(32), cuda_device, 1, 64, 64, 128, 64, 3, "conv0")
    xi, si = x.clone().requires_grad_(), s.clone().requires_grad_()
    out = fc.fused_upconv2(xi, w, si, f, nz, b, gain, alpha, demod)
    big = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            seen = [t for t in (*args, *(kwargs or {}).values(),
                                *(res if isinstance(res, (tuple, list)) else (res,)))
                    if isinstance(t, torch.Tensor)]
            if not func.__name__.startswith(("empty", "detach", "alias", "view")) and \
                    any(t.numel() >= out.numel() for t in seen):
                big.append(func.__name__)
            return res

    before = fc.launch_counts["upconv2_adj_bf16"]
    with Spy():
        grads = torch.autograd.grad(out, [xi, si], g)
    assert fc.launch_counts["upconv2_adj_bf16"] == before + 1
    assert big == [], big
    args = (g, x, w, s, f, out.detach(), nz, b, gain, alpha, demod)
    _bf16_close(grads, fc.upconv2_adjoint_plain(*args)[:2],
                fc.upconv2_adjoint_plain(*_widen(args))[:2])


@pytest.mark.cuda
def test_bf16_k3_adjoint_refuses_mixed_types(cuda_device):
    """g, y and x in bfloat16 together or not at all: a float32 y or x with
    a bfloat16 g raises before any launch, and a float16 g is refused."""
    g, x, w, s, f, y, nz, b, gain, alpha, demod, fw, _, _ = _k3_bf16_args(
        np.random.RandomState(33), cuda_device, 1, 8, 16, 16, 8, 3, "conv0")
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="y"):
        fc.upconv2_adjoint(g, x, w, s, f, y.float(), nz, b, gain, alpha, demod)
    with pytest.raises(TypeError, match="x"):
        fc.upconv2_adjoint(g, x.float(), w, s, f, y, nz, b, gain, alpha, demod)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.upconv2_adjoint(g.half(), x.half(), w, s, f, y.half(), nz, b, gain, alpha, demod)
    assert dict(fc.launch_counts) == before


# K1's bfloat16 adjoint on the tensor cores (conv3x3_adj_tc_kernel: 16 x 16
# dx positions and 32 dx channels a tile for C <= 32, 8 x 16 and 64 for C <=
# 64, 8 x 16 and 128 beyond, in channel groups of 128; 16 gd channels a
# chunk; gd formed from g, y, resid and d in the kernel; flip(w)^T streamed
# by chunk) at sizes off its tiles, then at the four call shapes of a 1024^2
# step: (N, H, W, C, O, path). O 36, 68 and 100 take the 8-byte copies (and
# a partial last chunk), C 68 the 128-channel tile, C 132 two channel
# groups, O 120 and 100 many chunks. "conv1": styles, demodulation,
# batch-shared noise, bias, resid, lrelu (dx, ds and the dd taps); "noise":
# per-sample noise; "last": conv_last's form (no noise, bias or resid,
# alpha 1); "nodemod": styles without demodulation (no dd taps); "dx": dx
# alone.
K1_BF16_ODD = [(2, 20, 37, 12, 8, "conv1"), (1, 17, 19, 20, 36, "conv1"),
               (3, 9, 50, 36, 36, "noise"), (1, 33, 16, 4, 68, "conv1"),
               (2, 11, 21, 68, 12, "conv1"), (1, 9, 17, 132, 20, "conv1"),
               (1, 13, 18, 20, 120, "last"), (1, 10, 30, 48, 100, "nodemod"),
               (2, 7, 40, 40, 8, "dx")]
K1_BF16_CALLS = [(1, 256, 256, 128, 128, "conv1"), (1, 512, 512, 64, 64, "conv1"),
                 (1, 1024, 1024, 32, 32, "conv1"), (1, 1024, 1024, 32, 32, "last")]


def _k1_fwd_bf16_args(rng, dev, n, h, w, c, o, path):
    """K1's bf16 arguments (x, w, styles, noise, bias, resid, gain, alpha,
    demod): x and resid bfloat16, the rest float32 parameters. "conv1":
    styles, demodulation, batch-shared noise, bias, resid, lrelu; "noise":
    per-sample noise; "last": conv_last's form (no noise, bias or resid,
    alpha 1); "nodemod": styles without demodulation; "nostyle": no styles
    (no scale, no demodulation); anything else: conv1 without noise."""
    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)

    last = path == "last"
    x = rand(n, h, w, c).bfloat16()
    wt = rand(3, 3, c, o, scale=1 / math.sqrt(9 * c))
    s = None if path == "nostyle" else torch.from_numpy(
        (rng.rand(n, c) + 0.5).astype(np.float32)).to(dev)
    nz = None
    if path in ("conv1", "noise", "nodemod"):
        nz = rand(*((n,) if path == "noise" else ()), h, w, scale=0.1)
    b = None if last else rand(o, scale=0.1)
    r = None if last else rand(n, h, w, o).bfloat16()
    gain, alpha = (1.0, 1.0) if last else (math.sqrt(2), 0.2)
    return (x, wt, s, nz, b, r, gain, alpha, path not in ("nodemod", "nostyle"))


def _k1_bf16_args(rng, dev, n, h, w, c, o, path):
    """The adjoint's arguments (g, x, w, styles, y, noise, bias, resid, gain,
    alpha, demod, need_dx, need_ds): y the plain bf16 forward; "dx": dx
    alone."""
    fwd = _k1_fwd_bf16_args(rng, dev, n, h, w, c, o, path)
    y = fc.modconv3x3_plain(*fwd)
    g = torch.from_numpy(rng.randn(n, h, w, o).astype(np.float32)).to(dev).bfloat16()
    return (g, *fwd[:3], y, *fwd[3:], True, path != "dx")


def _k1_bf16_check(args):
    before = dict(fc.launch_counts)
    got = fc.modconv3x3_adjoint(*args)
    assert fc.launch_counts["modconv3x3_adj_bf16"] == before["modconv3x3_adj_bf16"] + 1
    assert fc.launch_counts["modconv3x3_adj"] == before["modconv3x3_adj"]
    assert got[0].dtype == torch.bfloat16 and torch.isfinite(got[0]).all()
    want = fc.modconv3x3_adjoint_plain(*args)
    assert [t is None for t in got] == [t is None for t in want]
    _bf16_close(got, want, fc.modconv3x3_adjoint_plain(*_widen(args)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,path", K1_BF16_ODD)
def test_bf16_k1_tensor_core_adjoint_at_odd_sizes(cuda_device, n, h, w, c, o, path):
    """One bf16 launch per call; dx, ds and the dd taps within the bf16 rule
    of the float32 plain version on the same inputs."""
    _k1_bf16_check(_k1_bf16_args(np.random.RandomState(34), cuda_device, n, h, w, c, o, path))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,path", K1_BF16_CALLS)
def test_bf16_k1_tensor_core_adjoint_at_the_1024_call_shapes(cuda_device, n, h, w, c, o, path):
    _k1_bf16_check(_k1_bf16_args(np.random.RandomState(35), cuda_device, n, h, w, c, o, path))


def _k1_tc_edge_pixels(hh, ww, th):
    """Corners, edge midpoints and the centre, and the pixels on both sides
    of conv3x3_adj_tc_kernel's inner tile edges (rows th - 1 | th and 2 th -
    1 | 2 th, columns 15 | 16 and 31 | 32)."""
    return [(0, 0), (0, ww - 1), (hh - 1, 0), (hh - 1, ww - 1), (0, ww // 2), (hh - 1, ww // 2),
            (hh // 2, 0), (hh // 2, ww - 1), (hh // 2, ww // 2), (th - 1, 15), (th, 16),
            (th - 1, 16), (th, 15), (2 * th - 1, 31), (2 * th, 32), (th, ww - 1), (hh - 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(20, 36), (36, 24), (68, 16)])
def test_bf16_k1_tensor_core_adjoint_single_pixels(cuda_device, c, o):
    """One nonzero g pixel at a time on a 2 th + 3 x 37 image (three tiles
    down, three across; th the tile's rows), no mask, styles or
    demodulation: dx is flip(w)^T around that pixel, which pins each tap's
    row offset and the halo at the tile edges; the nonzero entries land
    where the plain version's do, within the bf16 rule of the float32 plain
    version."""
    dev = cuda_device
    rng = np.random.RandomState(36)
    th = 16 if c <= 32 else 8
    h, w = 2 * th + 3, 37
    wt = torch.from_numpy(rng.randn(3, 3, c, o).astype(np.float32)).to(dev)
    x = torch.zeros(1, h, w, c, device=dev, dtype=torch.bfloat16)
    y = torch.ones(1, h, w, o, device=dev, dtype=torch.bfloat16)
    for py, px in _k1_tc_edge_pixels(h, w, th):
        g = torch.zeros(1, h, w, o, device=dev)
        g[0, py, px] = torch.from_numpy(rng.randn(o).astype(np.float32)).to(dev)
        args = (g.bfloat16(), x, wt, None, y, None, None, None, 1.0, 1.0, False, True, False)
        got = fc.modconv3x3_adjoint(*args)
        want = fc.modconv3x3_adjoint_plain(*args)
        assert bool(((got[0] != 0) == (want[0] != 0)).all()), (py, px)
        _bf16_close(got, want, fc.modconv3x3_adjoint_plain(*_widen(args)))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [20, 36])
def test_bf16_k1_tensor_core_adjoint_mask_at_exact_zeros(cuda_device, c):
    """y - resid exactly +0 (y equal to resid) and -0 (y -0, resid +0) at a
    third of the pixels each: the kernel's mask from the bits takes both as
    y >= 0, as JAX's `where(y >= 0)` and the plain version do, so dx, ds
    and the dd taps hold to the bf16 rule."""
    rng = np.random.RandomState(40)
    g, x, w, s, y, nz, b, r, gain, alpha, demod, _, _ = _k1_bf16_args(
        rng, cuda_device, 1, 19, 21, c, 12, "conv1")
    pick = torch.from_numpy(rng.randint(0, 3, size=tuple(y.shape))).to(cuda_device)
    r = torch.where(pick == 2, torch.zeros_like(r), r)
    y = torch.where(pick == 1, r, torch.where(pick == 2, torch.full_like(y, -0.0), y))
    _k1_bf16_check((g, x, w, s, y, nz, b, r, gain, alpha, demod, True, True))


@pytest.mark.cuda
def test_bf16_k1_adjoint_forms_gd_in_the_kernel(cuda_device):
    """On the projection path (dx and ds of conv1 with resid, no weight,
    noise or bias gradients) K1's bf16 backward dispatches no torch op over
    a tensor of the output's size but allocations: gd, the mask and y -
    resid are the kernel's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    g, x, w, s, _, nz, b, r, gain, alpha, demod, _, _ = _k1_bf16_args(
        np.random.RandomState(37), cuda_device, 1, 128, 128, 64, 64, "conv1")
    xi, si, ri = x.clone().requires_grad_(), s.clone().requires_grad_(), r.clone().requires_grad_()
    out = fc.fused_modconv3x3(xi, w, si, nz, b, ri, gain, alpha, demod)
    big = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            seen = [t for t in (*args, *(kwargs or {}).values(),
                                *(res if isinstance(res, (tuple, list)) else (res,)))
                    if isinstance(t, torch.Tensor)]
            if not func.__name__.startswith(("empty", "detach", "alias", "view")) and \
                    any(t.numel() >= out.numel() for t in seen):
                big.append(func.__name__)
            return res

    before = fc.launch_counts["modconv3x3_adj_bf16"]
    with Spy():
        grads = torch.autograd.grad(out, [xi, si, ri], g)
    assert fc.launch_counts["modconv3x3_adj_bf16"] == before + 1
    assert big == [], big
    args = (g, x, w, s, out.detach(), nz, b, r, gain, alpha, demod)
    _bf16_close(grads[:2], fc.modconv3x3_adjoint_plain(*args)[:2],
                fc.modconv3x3_adjoint_plain(*_widen(args))[:2])


@pytest.mark.cuda
def test_bf16_k1_adjoint_refuses_mixed_types(cuda_device):
    """g, y, resid and x in bfloat16 together or not at all: a float32 y,
    resid or x with a bfloat16 g raises before any launch, and a float16 g
    is refused."""
    g, x, w, s, y, nz, b, r, gain, alpha, demod, _, _ = _k1_bf16_args(
        np.random.RandomState(38), cuda_device, 1, 8, 16, 16, 8, "conv1")
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="y"):
        fc.modconv3x3_adjoint(g, x, w, s, y.float(), nz, b, r, gain, alpha, demod)
    with pytest.raises(TypeError, match="resid"):
        fc.modconv3x3_adjoint(g, x, w, s, y, nz, b, r.float(), gain, alpha, demod)
    with pytest.raises(TypeError, match="x"):
        fc.modconv3x3_adjoint(g, x.float(), w, s, y, nz, b, r, gain, alpha, demod)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.modconv3x3_adjoint(g.half(), x.half(), w, s, y.half(), nz, b, r.half(), gain, alpha,
                              demod)
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
def test_float32_k1_and_k4_bit_equal_to_the_build_before_the_tc_adjoint(cuda_device,
                                                                        monkeypatch):
    """The float32 K1 forward and adjoint and K4's forward and dx give the
    same bits as a build of fused_conv.cu from before conv3x3_adj_tc_kernel
    took the bfloat16 adjoint (commit 705c474; the float32 path of
    conv3x3_lw_kernel is unchanged): `git show
    705c474:morphganformer_tpu_torch/csrc/fused_conv.cu >
    build/k1_bf16_parent.cu`, or MGT_K1_PARENT_SOURCE names the file."""
    import os
    from pathlib import Path

    from morphganformer_tpu_torch.bench_k3 import load_parent
    from morphganformer_tpu_torch.ops import _build

    default = Path(__file__).resolve().parent.parent / "build" / "k1_bf16_parent.cu"
    src = Path(os.environ.get("MGT_K1_PARENT_SOURCE", default))
    if not src.exists():
        pytest.skip(f"needs the earlier source at {src}")
    names = ("mgt_modconv3x3_fwd", "mgt_modconv3x3_bwd", "mgt_bwd_tiles", "mgt_conv3x3_fwd",
             "mgt_conv3x3_dx")
    parent = load_parent(src, {k: _build._SIGNATURES[k] for k in names},
                         "libmgt_k1_bf16_parent_test.so")
    dev = cuda_device
    rng = np.random.RandomState(39)
    cases = []
    for res, c, last in ((64, 64, False), (48, 32, True), (40, 128, False), (33, 36, False)):
        x, w, s, nz, b, r, gain, alpha = _k1_call(rng, dev, 2, res, c, c, last)
        g = torch.from_numpy(rng.randn(2, res, res, c).astype(np.float32)).to(dev)
        cases.append((x, w, s, nz, b, r, gain, alpha, g))

    def run():
        outs = []
        for x, w, s, nz, b, r, gain, alpha, g in cases:
            y = fc.fused_modconv3x3(x, w, s, nz, b, r, gain, alpha, True)
            adj = fc.modconv3x3_adjoint(g, x, w, s, y, nz, b, r, gain, alpha, True)
            outs += [y, *[t for t in adj if t is not None], k4.conv3x3_forward(x, w),
                     k4.conv3x3_dx(g, w)]
        torch.cuda.synchronize()
        return outs

    new = run()
    monkeypatch.setattr(fc, "_library", lambda: parent)
    old = run()
    assert len(new) == len(old) == 4 * 7
    for i, (a, e) in enumerate(zip(new, old)):
        assert torch.equal(a, e), i


# K1's bfloat16 forward on the tensor cores (conv3x3_fwd_tc_kernel: TH x 16
# positions and NB output channels a tile, TH 16 and NB 32 for O <= 32, TH 8
# and NB 64 or 128 beyond, channel groups of 128; 16 input channels a
# chunk) at sizes off its tiles: (N, H, W, C, O, path). C 4, 12, 20, 36 and
# 100 end in a partial k16 step; C or O 4, 12, 20, 36 and 100 take the
# 8-byte copies (O 12, 20, 36 and 100 a half-filled last 8 channels); O 68
# the 128-channel tile, O 132 two channel groups. "conv1": styles,
# demodulation, batch-shared noise, bias, resid, lrelu; "noise": per-sample
# noise; "last": conv_last's form (no noise, bias or resid, alpha 1);
# "nodemod": styles without demodulation; "nostyle": no styles (no scale,
# no demodulation), bias and lrelu, the D conv0 form.
K1_FWD_BF16_ODD = [(2, 20, 37, 12, 8, "conv1"), (1, 17, 19, 20, 36, "noise"),
                   (3, 9, 50, 36, 36, "conv1"), (1, 33, 16, 4, 68, "conv1"),
                   (2, 11, 21, 68, 12, "last"), (1, 9, 17, 16, 132, "conv1"),
                   (1, 13, 18, 100, 20, "nodemod"), (1, 10, 30, 48, 100, "nostyle"),
                   (2, 7, 40, 8, 4, "noise")]


def _k1_fwd_bf16_check(args):
    before = dict(fc.launch_counts)
    y = fc.fused_modconv3x3(*args)
    assert fc.launch_counts["modconv3x3_bf16"] == before["modconv3x3_bf16"] + 1
    assert fc.launch_counts["modconv3x3"] == before["modconv3x3"]
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    _bf16_close(y, fc.modconv3x3_plain(*args), fc.modconv3x3_plain(*_widen(args)))
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,path", K1_FWD_BF16_ODD)
def test_bf16_k1_tensor_core_forward_at_odd_sizes(cuda_device, n, h, w, c, o, path):
    """One bf16 launch per call, within the bf16 rule of the float32 plain
    version on the same inputs."""
    _k1_fwd_bf16_check(_k1_fwd_bf16_args(np.random.RandomState(41), cuda_device, n, h, w, c,
                                         o, path))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,path", K1_BF16_CALLS)
def test_bf16_k1_tensor_core_forward_at_the_1024_call_shapes(cuda_device, n, h, w, c, o, path):
    _k1_fwd_bf16_check(_k1_fwd_bf16_args(np.random.RandomState(42), cuda_device, n, h, w, c,
                                         o, path))


@pytest.mark.cuda
def test_bf16_k1_tensor_core_forward_per_sample_noise_at_batch_4(cuda_device):
    """Per-sample noise [N, H, W] at batch 4 on the 64-channel tile."""
    _k1_fwd_bf16_check(_k1_fwd_bf16_args(np.random.RandomState(43), cuda_device, 4, 40, 48, 64,
                                         64, "noise"))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(20, 36), (36, 24), (12, 68), (16, 132)])
def test_bf16_k1_tensor_core_forward_single_pixels(cuda_device, c, o):
    """One nonzero x pixel at a time on a 2 th + 3 x 37 image (three tiles
    down, three across; th the tile's rows), at the corners, the edges'
    midpoints, the centre and both sides of each inner tile edge
    (`_k1_tc_edge_pixels`), no styles, demodulation or
    epilogue: y is w around that pixel, which pins each tap's row offset,
    the transposed weight fragments and the halo at the tile edges; the
    nonzero entries land where the plain version's do, within the bf16
    rule of the float32 plain version."""
    dev = cuda_device
    rng = np.random.RandomState(44)
    th = 16 if o <= 32 else 8
    h, w = 2 * th + 3, 37
    wt = torch.from_numpy(rng.randn(3, 3, c, o).astype(np.float32)).to(dev)
    for py, px in _k1_tc_edge_pixels(h, w, th):
        x = torch.zeros(1, h, w, c, device=dev)
        x[0, py, px] = torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev)
        args = (x.bfloat16(), wt, None, None, None, None, 1.0, 1.0, False)
        y = fc.fused_modconv3x3(*args)
        want = fc.modconv3x3_plain(*args)
        assert bool(((y != 0) == (want != 0)).all()), (py, px)
        _bf16_close(y, want, fc.modconv3x3_plain(*_widen(args)))


@pytest.mark.cuda
def test_bf16_k1_forward_refuses_mixed_types(cuda_device):
    """x and resid in bfloat16 together or not at all, x float32 or
    bfloat16 only: each mix raises before any launch."""
    x, w, s, nz, b, r, gain, alpha, demod = _k1_fwd_bf16_args(
        np.random.RandomState(45), cuda_device, 1, 8, 16, 16, 8, "conv1")
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="resid"):
        fc.fused_modconv3x3(x, w, s, nz, b, r.float(), gain, alpha, demod)
    with pytest.raises(TypeError, match="resid"):
        fc.fused_modconv3x3(x.float(), w, s, nz, b, r, gain, alpha, demod)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.fused_modconv3x3(x.half(), w, s, nz, b, r.half(), gain, alpha, demod)
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
def test_bf16_k1_forward_kernel_runs_on_the_tensor_cores(cuda_device):
    """The built library's SASS (cuobjdump -sass) holds HMMA instructions in
    every instantiation of conv3x3_fwd_tc_kernel."""
    from morphganformer_tpu_torch.bench_k2 import hmma_counts
    from morphganformer_tpu_torch.ops import _build

    _build.library()
    counts = hmma_counts(_build.library_path(), "conv3x3_fwd_tc_kernel")
    assert len(counts) == 6 and all(v > 0 for v in counts.values()), counts


@pytest.mark.cuda
def test_float32_k1_and_k4_bit_equal_to_the_build_before_the_tc_forward(cuda_device,
                                                                       monkeypatch):
    """The float32 K1 forward and adjoint and K4's forward and dx give the
    same bits as a build of fused_conv.cu from before conv3x3_fwd_tc_kernel
    took the bfloat16 forward and the bfloat16 instantiation of
    conv3x3_lw_kernel was removed (commit 32aa084): `git show
    32aa084:morphganformer_tpu_torch/csrc/fused_conv.cu >
    build/k1_fwd_bf16_parent.cu`, or MGT_K1_FWD_PARENT_SOURCE names the
    file."""
    import os
    from pathlib import Path

    from morphganformer_tpu_torch.bench_k3 import load_parent
    from morphganformer_tpu_torch.ops import _build

    default = Path(__file__).resolve().parent.parent / "build" / "k1_fwd_bf16_parent.cu"
    src = Path(os.environ.get("MGT_K1_FWD_PARENT_SOURCE", default))
    if not src.exists():
        pytest.skip(f"needs the earlier source at {src}")
    names = ("mgt_modconv3x3_fwd", "mgt_modconv3x3_bwd", "mgt_bwd_tiles", "mgt_conv3x3_fwd",
             "mgt_conv3x3_dx")
    parent = load_parent(src, {k: _build._SIGNATURES[k] for k in names},
                         "libmgt_k1_fwd_bf16_parent_test.so")
    dev = cuda_device
    rng = np.random.RandomState(46)
    cases = []
    for res, c, last in ((64, 64, False), (48, 32, True), (40, 128, False), (33, 36, False)):
        x, w, s, nz, b, r, gain, alpha = _k1_call(rng, dev, 2, res, c, c, last)
        g = torch.from_numpy(rng.randn(2, res, res, c).astype(np.float32)).to(dev)
        cases.append((x, w, s, nz, b, r, gain, alpha, g))

    def run():
        outs = []
        for x, w, s, nz, b, r, gain, alpha, g in cases:
            y = fc.fused_modconv3x3(x, w, s, nz, b, r, gain, alpha, True)
            adj = fc.modconv3x3_adjoint(g, x, w, s, y, nz, b, r, gain, alpha, True)
            outs += [y, *[t for t in adj if t is not None], k4.conv3x3_forward(x, w),
                     k4.conv3x3_dx(g, w)]
        torch.cuda.synchronize()
        return outs

    new = run()
    monkeypatch.setattr(fc, "_library", lambda: parent)
    old = run()
    assert len(new) == len(old) == 4 * 7
    for i, (a, e) in enumerate(zip(new, old)):
        assert torch.equal(a, e), i


# ---------------------------------------------------------------------------
# bfloat16 training: the D tower's K3 forward, K2's use_dw role and K1's dw
# on the tensor cores, the FIR dw on bfloat16 operands, D's conv0 and
# the second-order route's launches through the bfloat16 kernels, and the
# float32 kernels bit-equal to the build before these roles took bfloat16.
# ---------------------------------------------------------------------------

# (n, h, cin, cout, kh, bias, resid): D conv1 at b1024's and b512's widths
# with the skip added in, and their 1x1 skips; odd output sizes.
BF16_DCONV_CASES = [
    (2, 16, 32, 64, 3, True, True), (2, 16, 32, 64, 1, False, False),
    (1, 9, 64, 128, 3, True, True), (2, 7, 64, 128, 1, False, False),
    (1, 13, 32, 64, 3, True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,cin,cout,kh,bias,resid", BF16_DCONV_CASES)
def test_bf16_k3_forward_and_k2_use_dw_match_plain(cuda_device, n, h, cin, cout, kh, bias,
                                                   resid):
    """`mgt_downconv2_fwd_bf16` (downconv2_fwd_tc_kernel on bfloat16 x,
    small weight and resid) and K2's use_dw role on `upconv2_tc_kernel` against
    their plain bfloat16 versions, both held against float32 by the bf16
    rule; and the cotangents through FusedDownConv2 in their inputs'
    types."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(21)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa
    f = setup_filter(FIR).to(dev)
    x = randn(n, 2 * h, 2 * h, cin).bfloat16()
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    b = randn(cout, scale=0.1) if bias else None
    r = randn(n, h, h, cout).bfloat16() if resid else None
    gain, alpha = (1.0, 0.2) if kh == 3 else (math.sqrt(0.5), 1.0)
    fwd = (x, w, f, b, r, gain, alpha)
    before = dict(fc.launch_counts)
    y = fc.fused_downconv2(*fwd)
    assert y.dtype == torch.bfloat16
    assert fc.launch_counts["downconv2_bf16"] == before["downconv2_bf16"] + 1
    assert fc.launch_counts["downconv2"] == before["downconv2"]
    _bf16_close(y, fc.downconv2_plain(*fwd), fc.downconv2_plain(*_widen(fwd)))
    gz = randn(n, h, h, cout).bfloat16()
    dx = fc.downconv2_adjoint(gz, w, f)
    assert dx.dtype == torch.bfloat16
    assert fc.launch_counts["downconv2_adj_bf16"] == before["downconv2_adj_bf16"] + 1
    assert fc.launch_counts["upconv2_bf16"] == before["upconv2_bf16"]
    _bf16_close(dx, fc.downconv2_adjoint_plain(gz, w, f),
                fc.downconv2_adjoint_plain(gz.float(), w, f))
    inputs = [x.clone().requires_grad_(), w.clone().requires_grad_()]
    g = randn(n, h, h, cout).bfloat16()
    got = torch.autograd.grad(fc.fused_downconv2(inputs[0], inputs[1], f, b, r, gain, alpha),
                              inputs, g)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    plain = torch.autograd.grad(fc.fused_downconv2(inputs[0], inputs[1], f, b, r, gain, alpha,
                                                   plain=True), inputs, g)
    xf = inputs[0].detach().float().requires_grad_()
    ref = torch.autograd.grad(fc.fused_downconv2(xf, inputs[1], f, b, None if r is None
                                                 else r.float(), gain, alpha, plain=True),
                              [xf, inputs[1]], g.float())
    _bf16_close(got, plain, ref)


# (role, n, h, w, cin, cout, kh, scaled): K1's dw (x and gd at h x w), K3's
# (x at h x w, gd at 2h x 2w) and the D down-conv's (x at 2h x 2w, gz at h
# x w), at the 1024^2 widths, odd sizes and widths the tiles do not divide.
BF16_DW_CASES = [
    ("k1", 2, 16, 16, 32, 32, 3, True), ("k1", 2, 13, 11, 64, 64, 3, False),
    ("k1", 1, 9, 12, 36, 100, 3, True),
    ("up", 2, 16, 16, 64, 32, 3, True), ("up", 2, 9, 11, 64, 32, 1, False),
    ("down", 2, 16, 16, 32, 64, 3, False), ("down", 1, 7, 13, 64, 128, 1, False),
    ("down", 2, 6, 5, 40, 72, 3, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("role,n,h,w,cin,cout,kh,scaled", BF16_DW_CASES)
def test_bf16_dw_kernels_match_plain(cuda_device, role, n, h, w, cin, cout, kh, scaled):
    """`mgt_conv_dw_bf16` (on the tensor cores) and `mgt_fir_dw_bf16` (x * s
    or base * s rounded to bfloat16 as it lands, the FIR and the sums in
    float32) against the
    plain versions on the same bfloat16 operands, which round alike: to
    1e-4 of the largest entry, as the float32 kernels (float32 sums of the
    same products in another order)."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(22)
    f = setup_filter(FIR).to(dev)
    wt = torch.randn((kh, kh, cin, cout), generator=gen, device=dev)
    bf = torch.bfloat16
    if role == "k1":
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(bf)
        t = torch.randn((n, h, w, cout), generator=gen, device=dev).to(bf)
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if scaled else None
        key, run = "modconv3x3_dw", lambda: fc.conv_dw(x, t, s)  # noqa: E731
        want = fc.conv_dw_plain(x, t, s, 1, 1, 3, (0, 0))[0]
    elif role == "up":
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(bf)
        t = torch.randn((n, 2 * h, 2 * w, cout), generator=gen, device=dev).to(bf)
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if scaled else None
        key, run = "upconv2_dw", lambda: fc.upconv2_dw(x, t, s, wt, f)  # noqa: E731
        want = fc.upconv2_dw_plain(x, t, s, wt, f)
    else:
        x = torch.randn((n, 2 * h, 2 * w, cin), generator=gen, device=dev).to(bf)
        t = torch.randn((n, h, w, cout), generator=gen, device=dev).to(bf)
        key, run = "downconv2_dw", lambda: fc.downconv2_dw(x, t, wt, f)  # noqa: E731
        want = fc.downconv2_dw_plain(x, t, wt, f)
    before = dict(fc.launch_counts)
    got = run()
    torch.cuda.synchronize()
    assert fc.launch_counts[key + "_bf16"] == before[key + "_bf16"] + 1
    assert fc.launch_counts[key] == before[key]
    assert got.dtype == want.dtype == torch.float32
    _rel_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("res,c", [(32, 32), (24, 64)])
def test_bf16_k1_without_styles_matches_plain(cuda_device, res, c):
    """D's conv0 in bfloat16 (no styles, no demodulation, bias, lrelu) and
    the second-order route's degenerate launches (no bias, gain = alpha =
    1, a resid; the adjoint for dx alone) through the tensor-core kernels,
    against the plain versions by the bf16 rule."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(23)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa
    x = randn(4, res, res, c).bfloat16()
    w = randn(3, 3, c, c, scale=1 / math.sqrt(9 * c))
    b = randn(c, scale=0.1)
    g = randn(4, res, res, c).bfloat16()
    for fwd in ((x, w, None, None, b, None, math.sqrt(2), 0.2, False),
                (x, w, None, None, None, randn(4, res, res, c).bfloat16(), 1.0, 1.0, False)):
        before = dict(fc.launch_counts)
        y = fc.fused_modconv3x3(*fwd)
        assert fc.launch_counts["modconv3x3_bf16"] == before["modconv3x3_bf16"] + 1
        _bf16_close(y, fc.modconv3x3_plain(*fwd), fc.modconv3x3_plain(*_widen(fwd)))
        args = (g, x, w, None, y, None, fwd[4], fwd[5], fwd[6], fwd[7], False)
        got = fc.modconv3x3_adjoint(*args, need_ds=False)
        assert fc.launch_counts["modconv3x3_adj_bf16"] == before["modconv3x3_adj_bf16"] + 1
        assert got[1:] == (None, None, None)
        _bf16_close(got[0], fc.modconv3x3_adjoint_plain(*args, need_ds=False)[0],
                    fc.modconv3x3_adjoint_plain(*_widen(args), need_ds=False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K1", "K1-unstyled", "K2", "K2-skip", "down-conv1",
                                  "down-skip"])
def test_bf16_grad_vjps_match_plain(cuda_device, kind):
    """The second-order term of each grad Function in bfloat16 (x, y, g and
    the x-sized cotangents bfloat16) at the cotangents the reg stages feed
    (path length cdx and cds, R1 cdx), kernels against the plain versions,
    both against the plain version on the same values in float32, by the
    bf16 rule on every output."""
    from morphganformer_tpu_torch.ops import second_order as so

    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(24)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa
    f = setup_filter(FIR).to(dev)
    n, h, cin, cout = 2, 16, 64, 32
    styled = kind in ("K1", "K2")
    bf = torch.bfloat16
    if kind.startswith("K1"):
        cin = cout
        x = randn(n, h, h, cin).to(bf)
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if styled else None
        nz = randn(n, h, h, scale=0.1) if styled else None
        b, r = randn(cout, scale=0.1), randn(n, h, h, cout).to(bf)
        y = fc.modconv3x3_plain(x, w, s, nz, b, r, math.sqrt(2), 0.2, styled)
        g = randn(n, h, h, cout).to(bf)

        def vjp(a, plain):
            x_, y_, g_, r_, cots = a
            return so.modconv3x3_bwd_vjp(x_, w, s, nz, b, r_, y_, g_, cots, math.sqrt(2), 0.2,
                                         styled, plain)
        cots = (randn(*x.shape).to(bf), None, randn(n, cin) if styled else None, None, None)
        args = (x, y, g, r, cots)
    elif kind.startswith("K2"):
        kh = 3 if styled else 1
        x = randn(n, h, h, cin).to(bf)
        w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if styled else None
        nz = randn(n, 2 * h, 2 * h, scale=0.1) if styled else None
        b = randn(cout, scale=0.1) if styled else None
        gain, alpha = (math.sqrt(2), 0.2) if styled else (math.sqrt(0.5), 1.0)
        y = fc.upconv2_plain(x, w, s, f, nz, b, gain, alpha, styled)
        g = randn(n, 2 * h, 2 * h, cout).to(bf)

        def vjp(a, plain):
            x_, y_, g_, _, cots = a
            return so.upconv2_bwd_vjp(x_, w, s, f, nz, b, y_, g_, cots, gain, alpha, styled,
                                      False, plain)
        cots = (randn(*x.shape).to(bf), None, randn(n, cin) if styled else None, None, None)
        args = (x, y, g, None, cots)
    else:
        conv1 = kind == "down-conv1"
        kh, cin, cout = (3 if conv1 else 1), 32, 64
        x = randn(n, 2 * h, 2 * h, cin).to(bf)
        w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
        b = randn(cout, scale=0.1) if conv1 else None
        r = randn(n, h, h, cout).to(bf) if conv1 else None
        gain, alpha = (1.0, 0.2) if conv1 else (math.sqrt(0.5), 1.0)
        y = fc.downconv2_plain(x, w, f, b, r, gain, alpha)
        g = randn(n, h, h, cout).to(bf)

        def vjp(a, plain):
            x_, y_, g_, r_, cots = a
            return so.downconv2_bwd_vjp(x_, w, f, r_, y_, g_, cots, gain, alpha, True, plain)
        cots = (randn(*x.shape).to(bf), None, None)
        args = (x, y, g, r, cots)
    before = dict(fc.launch_counts)
    got = vjp(args, False)
    launched = {k: v - before[k] for k, v in fc.launch_counts.items() if v != before[k]}
    assert launched and all(k.endswith("_bf16") for k in launched), launched
    plain = vjp(args, True)
    wide = tuple(tuple(None if c is None else c.float() for c in a) if isinstance(a, tuple)
                 else (None if a is None else a.float()) for a in args)
    ref = vjp(wide, True)
    for k, p in zip(got, plain):
        assert (k is None) == (p is None)
        assert k is None or (k.dtype == p.dtype and torch.isfinite(k).all())
    _bf16_close(got, plain, ref)


@pytest.mark.cuda
def test_float32_kernels_bit_equal_to_the_build_before_the_bf16_training_roles(cuda_device,
                                                                              monkeypatch):
    """K2 (forward and use_dw), K3 (forward and adjoint), K1's dw and the
    FIR dw in float32 give the same bits as a build of fused_conv.cu from
    before these kernels took bfloat16 operands and upconv2_lw_kernel lost
    its bfloat16 branch (commit 1cbb5b8): `git show
    1cbb5b8:morphganformer_tpu_torch/csrc/fused_conv.cu >
    build/train_bf16_parent.cu`, or MGT_TRAIN_BF16_PARENT_SOURCE names the
    file."""
    import os
    from pathlib import Path

    from morphganformer_tpu_torch.bench_k3 import load_parent
    from morphganformer_tpu_torch.ops import _build

    default = Path(__file__).resolve().parent.parent / "build" / "train_bf16_parent.cu"
    src = Path(os.environ.get("MGT_TRAIN_BF16_PARENT_SOURCE", default))
    if not src.exists():
        pytest.skip(f"needs the earlier source at {src}")
    names = ("mgt_upconv2_fwd", "mgt_downconv2_fwd", "mgt_upconv2_bwd", "mgt_downconv2_tiles",
             "mgt_conv_dw", "mgt_conv_dw_tiles", "mgt_fir_dw", "mgt_fir_dw_tiles")
    parent = load_parent(src, {k: _build._SIGNATURES[k] for k in names},
                         "libmgt_train_bf16_parent_test.so")
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(25)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    f = setup_filter(FIR).to(dev)
    cases = []
    for h, cin, cout, kh in ((16, 64, 32, 3), (13, 64, 32, 1), (9, 128, 64, 3)):
        cases.append(dict(x=randn(2, h, h, cin), w=randn(kh, kh, cin, cout) / 8,
                          s=torch.rand((2, cin), generator=gen, device=dev) + 0.5,
                          nz=randn(2 * h, 2 * h), b=randn(cout), g=randn(2, 2 * h, 2 * h, cout),
                          xd=randn(2, 2 * h, 2 * h, cout), wd=randn(kh, kh, cout, cin) / 8,
                          bd=randn(cin), rd=randn(2, h, h, cin), gz=randn(2, h, h, cin)))

    def run():
        outs = []
        for c in cases:
            styled = c["w"].shape[0] == 3
            s = c["s"] if styled else None
            y = fc.fused_upconv2(c["x"], c["w"], s, f, c["nz"] if styled else None, c["b"],
                                 math.sqrt(2), 0.2, styled, False)
            adj = fc.upconv2_adjoint(c["g"], c["x"], c["w"], s, f, y,
                                     c["nz"] if styled else None, c["b"], math.sqrt(2), 0.2,
                                     styled, False)
            yd = fc.fused_downconv2(c["xd"], c["wd"], f, c["bd"], c["rd"], 1.0, 0.2)
            outs += [y, *[t for t in adj if t is not None], yd,
                     fc.downconv2_adjoint(c["gz"], c["wd"], f),
                     fc.upconv2_dw(c["x"], c["g"], s, c["w"], f),
                     fc.downconv2_dw(c["xd"], c["gz"], c["wd"], f),
                     fc.conv_dw(c["x"], c["x"], s)]
        torch.cuda.synchronize()
        return outs

    new = run()
    monkeypatch.setattr(fc, "_library", lambda: parent)
    old = run()
    assert len(new) == len(old)
    for i, (a, e) in enumerate(zip(new, old)):
        assert torch.equal(a, e), i


# ---------------------------------------------------------------------------
# K3's D-tower forward and K1's dw in bfloat16 on the tensor cores
# (downconv2_fwd_tc_kernel, conv_dw_tc_kernel), K4 in bfloat16 on the
# tensor-core K1 kernels, and the float32 kernels bit-equal to the build
# before these roles moved.
# ---------------------------------------------------------------------------

def _dconv_tc_args(gen, dev, n, h, w, cin, cout, kh, bias, resid, gain, alpha):
    """fused_downconv2's arguments: x [n, 2h, 2w, cin] and resid bfloat16,
    the weight, the FIR and the bias float32."""
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa
    x = randn(n, 2 * h, 2 * w, cin).bfloat16()
    wt = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    b = randn(cout, scale=0.1) if bias else None
    r = randn(n, h, w, cout).bfloat16() if resid else None
    return (x, wt, setup_filter(FIR).to(dev), b, r, gain, alpha)


def _dconv_tc_check(args):
    before = dict(fc.launch_counts)
    y = fc.fused_downconv2(*args)
    assert fc.launch_counts["downconv2_bf16"] == before["downconv2_bf16"] + 1
    assert fc.launch_counts["downconv2"] == before["downconv2"]
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    _bf16_close(y, fc.downconv2_plain(*args), fc.downconv2_plain(*_widen(args)))


# (n, h, w, cin, cout, kh, bias, resid): output sizes off the 8 x 16 tile,
# Cin off the 16-channel chunk, Cout off the 64-channel group, Cin or Cout
# not in eights (the 8-byte copies and stores).
K3_TC_FWD_ODD = [(1, 9, 13, 32, 64, 3, True, True), (2, 7, 17, 20, 36, 3, True, False),
                 (1, 8, 16, 16, 132, 3, False, True), (2, 5, 6, 12, 72, 1, False, False),
                 (1, 11, 9, 64, 128, 1, True, True), (1, 16, 33, 36, 64, 3, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,bias,resid", K3_TC_FWD_ODD)
def test_bf16_k3_tc_forward_at_odd_sizes(cuda_device, n, h, w, cin, cout, kh, bias, resid):
    gen = torch.Generator(cuda_device).manual_seed(50)
    gain, alpha = (1.0, 0.2) if kh == 3 else (math.sqrt(0.5), 1.0)
    _dconv_tc_check(_dconv_tc_args(gen, cuda_device, n, h, w, cin, cout, kh, bias, resid, gain,
                                   alpha))


# The D down-conv's calls of a 1024^2 iteration at batch 4 (b1024 and b512
# conv1 with the skip added in, their 1x1 skips), and the second-order
# route's (DownConv2Grad's chained forwards: no bias, gain = alpha = 1, a
# resid) at the same shapes.
K3_TC_FWD_CALLS = [(4, 512, 512, 32, 64, 3, True, True, 1.0, 0.2),
                   (4, 512, 512, 32, 64, 1, False, False, math.sqrt(0.5), 1.0),
                   (4, 256, 256, 64, 128, 3, True, True, 1.0, 0.2),
                   (4, 256, 256, 64, 128, 1, False, False, math.sqrt(0.5), 1.0),
                   (4, 512, 512, 32, 64, 3, False, True, 1.0, 1.0),
                   (4, 256, 256, 64, 128, 1, False, True, 1.0, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,kh,bias,resid,gain,alpha", K3_TC_FWD_CALLS)
def test_bf16_k3_tc_forward_at_the_1024_call_shapes(cuda_device, n, h, w, cin, cout, kh, bias,
                                                    resid, gain, alpha):
    gen = torch.Generator(cuda_device).manual_seed(51)
    _dconv_tc_check(_dconv_tc_args(gen, cuda_device, n, h, w, cin, cout, kh, bias, resid, gain,
                                   alpha))


@pytest.mark.cuda
@pytest.mark.parametrize("kh", [3, 1])
def test_bf16_k3_tc_forward_single_pixels(cuda_device, kh):
    """One nonzero x pixel at a time on a 34 x 70 input (y 17 x 35: three
    tiles down, three across; the pixels of `_k3_edge_pixels`, on both
    sides of the tiles' inner edges and at the border), a FIR with no
    symmetry, no bias, resid or activation: y is that pixel's composed
    kernel read back in its place, which pins each tap's plane and shift
    and the halo at the tile edges; the nonzero entries land where the
    plain version's do, within the bf16 rule of the float32 plain version."""
    dev = cuda_device
    rng = np.random.RandomState(52)
    h, w, cin, cout = 17, 35, 20, 36
    f = setup_filter(rng.rand(4, 4) + 0.1).to(dev)
    wt = torch.from_numpy(rng.randn(kh, kh, cin, cout).astype(np.float32)).to(dev)
    for py, px in _k3_edge_pixels(2 * h, 2 * w):
        x = torch.zeros(1, 2 * h, 2 * w, cin, device=dev)
        x[0, py, px] = torch.from_numpy(rng.randn(cin).astype(np.float32)).to(dev)
        args = (x.bfloat16(), wt, f, None, None, 1.0, 1.0)
        got = fc.fused_downconv2(*args)
        want = fc.downconv2_plain(*args)
        assert bool(((got != 0) == (want != 0)).all()), (py, px)
        _bf16_close(got, want, fc.downconv2_plain(*_widen(args)))


def _dw_tc_check(x, gd, s):
    before = dict(fc.launch_counts)
    got = fc.conv_dw(x, gd, s)
    torch.cuda.synchronize()
    assert fc.launch_counts["modconv3x3_dw_bf16"] == before["modconv3x3_dw_bf16"] + 1
    assert fc.launch_counts["modconv3x3_dw"] == before["modconv3x3_dw"]
    want = fc.conv_dw_plain(x, gd, s, 1, 1, 3, (0, 0))[0]
    assert got.dtype == want.dtype == torch.float32 and torch.isfinite(got).all()
    # The same bfloat16 products summed in float32 (in another order), and
    # against float32 on the same inputs (x * s unrounded) by the bf16 rule.
    _rel_close(got, want)
    _bf16_close(got, want, fc.conv_dw_plain(x.float(), gd.float(), s, 1, 1, 3, (0, 0))[0])


# (n, h, w, c, o, scaled): sizes off the tiles (16 columns; 8 rows at 64 gd
# channels a block, 16 at 32), both channel tilings, several channel
# groups, widths the kernel pads to 32.
K1_DW_TC_ODD = [(2, 16, 16, 32, 32, True), (1, 13, 21, 32, 64, False), (2, 9, 35, 64, 32, True),
                (1, 17, 18, 96, 128, True), (1, 10, 12, 36, 100, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o,scaled", K1_DW_TC_ODD)
def test_bf16_k1_dw_tc_at_odd_sizes(cuda_device, n, h, w, c, o, scaled):
    gen = torch.Generator(cuda_device).manual_seed(53)
    x = torch.randn((n, h, w, c), generator=gen, device=cuda_device).bfloat16()
    gd = torch.randn((n, h, w, o), generator=gen, device=cuda_device).bfloat16()
    s = torch.rand((n, c), generator=gen, device=cuda_device) + 0.5 if scaled else None
    _dw_tc_check(x, gd, s)


# K1's dw calls of a 1024^2 iteration at batch 4 (G b256, b512, b1024 conv1
# and conv_last with styles; D b1024 and b512 conv0 without) and the reg
# route's `wg` of G at batch 2 (no styles).
K1_DW_TC_CALLS = [(4, 256, 128, True), (4, 512, 64, True), (4, 1024, 32, True),
                  (4, 1024, 32, False), (4, 512, 64, False), (2, 256, 128, False),
                  (2, 512, 64, False), (2, 1024, 32, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,res,c,scaled", K1_DW_TC_CALLS)
def test_bf16_k1_dw_tc_at_the_1024_call_shapes(cuda_device, n, res, c, scaled):
    gen = torch.Generator(cuda_device).manual_seed(54)
    x = torch.randn((n, res, res, c), generator=gen, device=cuda_device).bfloat16()
    gd = torch.randn((n, res, res, c), generator=gen, device=cuda_device).bfloat16()
    s = torch.rand((n, c), generator=gen, device=cuda_device) + 0.5 if scaled else None
    _dw_tc_check(x, gd, s)


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "gd"])
@pytest.mark.parametrize("c,o", [(32, 32), (64, 64)])
def test_bf16_k1_dw_tc_single_pixels(cuda_device, c, o, operand):
    """One nonzero pixel of x (or of gd) at a time on a 33 x 35 image, the
    other operand random: each tap's cotangent is that pixel's outer
    product with the other operand's pixel the tap reaches, cut at the
    border, which pins the taps' shifts and the halo on both sides of
    every tile edge (rows 7 | 8 and 15 | 16 | 17, columns 15 | 16 | 17)."""
    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(55)
    h, w = 33, 35
    s = torch.rand((1, c), generator=gen, device=dev) + 0.5
    for py in (0, 7, 8, 15, 16, 17, h - 1):
        for px in (0, 15, 16, 17, w - 1):
            x = torch.randn((1, h, w, c), generator=gen, device=dev)
            gd = torch.randn((1, h, w, o), generator=gen, device=dev)
            one = x if operand == "x" else gd
            keep = one[0, py, px].clone()
            one.zero_()
            one[0, py, px] = keep
            _dw_tc_check(x.bfloat16(), gd.bfloat16(), s)


def _fir_dw_tc_check(role, x, t, s, wt, f, flip_weight):
    """The FIR dw role's wrapper on bfloat16 activations: one launch of
    `mgt_fir_dw_bf16` (`fir_dw_tc_kernel`) on the role's `_bf16` key and
    none on its float32 key; the float32 cotangent against the plain route
    on the same bfloat16 operands (the same products of the unrounded B,
    float32 sums in another order: 1e-4 of the largest entry) and against
    float32 on the same inputs (base * s unrounded) by the bf16 rule."""
    if role == "up":
        key, run = "upconv2_dw", lambda a, b: fc.upconv2_dw(a, b, s, wt, f, flip_weight)  # noqa
        plain = lambda a, b: fc.upconv2_dw_plain(a, b, s, wt, f, flip_weight)           # noqa
    else:
        key, run = "downconv2_dw", lambda a, b: fc.downconv2_dw(a, b, wt, f, flip_weight)  # noqa
        plain = lambda a, b: fc.downconv2_dw_plain(a, b, wt, f, flip_weight)             # noqa
    before = dict(fc.launch_counts)
    got = run(x, t)
    torch.cuda.synchronize()
    assert fc.launch_counts[key + "_bf16"] == before[key + "_bf16"] + 1
    assert fc.launch_counts[key] == before[key]
    want = plain(x, t)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    _rel_close(got, want)
    _bf16_close(got, want, plain(x.float(), t.float()))


def _fir_dw_tc_operands(dev, seed, role, n, h, w, cin, cout, kh, scaled):
    gen = torch.Generator(dev).manual_seed(seed)
    wt = torch.randn((kh, kh, cin, cout), generator=gen, device=dev) / math.sqrt(kh * kh * cin)
    s = torch.rand((n, cin), generator=gen, device=dev) + 0.5 if scaled else None
    if role == "up":
        x = torch.randn((n, h, w, cin), generator=gen, device=dev)
        t = torch.randn((n, 2 * h, 2 * w, cout), generator=gen, device=dev)
    else:
        x = torch.randn((n, 2 * h, 2 * w, cin), generator=gen, device=dev)
        t = torch.randn((n, h, w, cout), generator=gen, device=dev)
    return x.bfloat16(), t.bfloat16(), s, wt


# (role, n, h, w, cin, cout, kh, scaled, flip_weight): K3's dw ("up") and
# the D down-conv's ("down") at sizes off the tiles (4 base rows, 16
# columns), a 1 x 1 grid, widths the wrapper pads (32 B channels, 64 base
# channels a block), several channel groups, both weight orientations.
FIR_DW_TC_ODD = [
    ("up", 2, 9, 17, 64, 32, 3, True, False), ("up", 1, 5, 33, 100, 36, 3, False, True),
    ("up", 2, 7, 18, 64, 128, 1, True, False), ("up", 1, 1, 1, 32, 64, 3, True, False),
    ("down", 2, 6, 5, 40, 72, 3, False, True), ("down", 1, 13, 35, 64, 128, 1, False, True),
    ("down", 1, 4, 16, 32, 64, 3, False, False), ("down", 3, 11, 3, 96, 200, 3, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("role,n,h,w,cin,cout,kh,scaled,flip_weight", FIR_DW_TC_ODD)
def test_bf16_fir_dw_tc_at_odd_sizes(cuda_device, role, n, h, w, cin, cout, kh, scaled,
                                     flip_weight):
    x, t, s, wt = _fir_dw_tc_operands(cuda_device, 61, role, n, h, w, cin, cout, kh, scaled)
    _fir_dw_tc_check(role, x, t, s, wt, setup_filter(FIR).to(cuda_device), flip_weight)


# The FIR dw's calls of a 1024^2 iteration at batch 4 (the D down-conv's at
# D b1024 and b512, conv1 and skip; K3's at G b256, b512 and b1024, conv0
# with styles and skip without: base resolution h, Cin, Cout, kh) and the
# reg route's K3 dw calls of G at batch 2 (the D down-conv's reg calls are
# the batch-4 ones).
FIR_DW_TC_CALLS = ([("down", 4, res // 2, cin, 2 * cin, kh, False)
                    for res, cin in ((1024, 32), (512, 64)) for kh in (3, 1)]
                   + [("up", n, res // 2, cin, cout, kh, kh == 3) for n in (4, 2)
                      for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32))
                      for kh in (3, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("role,n,h,cin,cout,kh,scaled", FIR_DW_TC_CALLS)
def test_bf16_fir_dw_tc_at_the_1024_call_shapes(cuda_device, role, n, h, cin, cout, kh, scaled):
    x, t, s, wt = _fir_dw_tc_operands(cuda_device, 62, role, n, h, h, cin, cout, kh, scaled)
    _fir_dw_tc_check(role, x, t, s, wt, setup_filter(FIR).to(cuda_device), role == "down")


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["src", "base"])
@pytest.mark.parametrize("kh", [3, 1])
def test_bf16_fir_dw_tc_single_pixels(cuda_device, kh, operand):
    """One nonzero pixel of src (or of base) at a time on a 9 x 33 base grid
    (three tiles down, three across), the other operand random, a FIR with
    no zero tap and no symmetry: `fc._fir_dw_launch` keeps exactly the taps
    of `fir_dw_plain` that reach the pixel and agrees with it to 1e-4 of
    the largest entry, on both sides of every tile edge (base rows 3 | 4 |
    5 and 7 | 8, columns 15 | 16 | 17 and 31 | 32; src rows and columns
    twice those) and at the borders, through every tap, plane and shift."""
    dev = cuda_device
    rng = np.random.RandomState(63)
    n, h, w, c, k = 1, 9, 33, 32, 64
    f = setup_filter(rng.rand(4, 4) + 0.1).to(dev)
    _, fk, pad = fc.downconv2_dw_leastwork(torch.zeros(kh, kh, c, k, device=dev), f)
    s = torch.from_numpy((rng.rand(n, k) + 0.5).astype(np.float32)).to(dev)
    rows, cols = (h, w) if operand == "base" else (2 * h, 2 * w)
    step = 1 if operand == "base" else 2
    edges = lambda size, tile: sorted({0, size - 1} | {  # noqa: E731
        p for e in range(tile, size, tile) for p in (e - 1, e, e + 1) if p < size})
    for py in edges(rows, step * 4):
        for px in edges(cols, step * 16):
            src = torch.from_numpy(rng.randn(n, 2 * h, 2 * w, c).astype(np.float32)).to(dev)
            base = torch.from_numpy(rng.randn(n, h, w, k).astype(np.float32)).to(dev)
            one = src if operand == "src" else base
            keep = one[0, py, px].clone()
            one.zero_()
            one[0, py, px] = keep
            src, base = src.bfloat16(), base.bfloat16()
            got = fc._fir_dw_launch(src, base, s, fk, pad, kh)
            want = fc.fir_dw_plain(src, base, s, fk, pad, kh)
            torch.cuda.synchronize()
            assert want.abs().max() > 0
            assert torch.equal(got.abs().sum((2, 3)) == 0, want.abs().sum((2, 3)) == 0), (py, px)
            _rel_close(got, want)


@pytest.mark.cuda
def test_bf16_fir_dw_refuses_mixed_types(cuda_device):
    """The FIR dw takes one type for src and base and a float32 s, and
    raises, naming the operand, on another: a bfloat16 tensor never reaches
    the float32 kernel, nor a float32 one the tensor-core kernel."""
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    bf = torch.bfloat16
    w = torch.zeros(3, 3, 32, 64, device=dev)
    x, gd = torch.zeros(1, 8, 8, 32, device=dev), torch.zeros(1, 16, 16, 64, device=dev)
    xd, gz = torch.zeros(1, 16, 16, 32, device=dev), torch.zeros(1, 8, 8, 64, device=dev)
    s = torch.ones(1, 32, device=dev)
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="src"):
        fc.upconv2_dw(x.to(bf), gd, s, w, f)
    with pytest.raises(TypeError, match="src"):
        fc.upconv2_dw(x, gd.to(bf), s, w, f)
    with pytest.raises(TypeError, match="s:"):
        fc.upconv2_dw(x.to(bf), gd.to(bf), s.to(bf), w, f)
    with pytest.raises(TypeError, match="src"):
        fc.downconv2_dw(xd.to(bf), gz, w, f)
    with pytest.raises(TypeError, match="src"):
        fc.downconv2_dw(xd, gz.to(bf), w, f)
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
def test_bf16_fir_dw_runs_on_the_tensor_cores(cuda_device):
    """The built library's SASS (cuobjdump -sass) holds HMMA instructions in
    both instantiations of fir_dw_tc_kernel (KH 3 and 1), and fir_dw_kernel
    is instantiated for float32 alone (its two weight sizes, no HMMA)."""
    from morphganformer_tpu_torch.bench_k2 import hmma_counts
    from morphganformer_tpu_torch.ops import _build

    _build.library()
    counts = hmma_counts(_build.library_path(), "fir_dw")
    tc = {k: v for k, v in counts.items() if "fir_dw_tc_kernel" in k}
    fma = {k: v for k, v in counts.items() if "fir_dw_kernel" in k}
    assert len(tc) == 2 and all(v > 0 for v in tc.values()), counts
    assert len(fma) == 2 and not any(fma.values()) and not any("bfloat16" in k for k in fma), \
        counts


@pytest.mark.cuda
def test_bf16_tc_training_roles_refuse_mixed_types(cuda_device):
    """The tensor-core K3 forward and K1 dw take one type for every
    activation they read and raise, naming the operand, on another; a
    bfloat16 tensor never reaches a float32 kernel, nor a float32 one the
    bfloat16 kernels."""
    dev = cuda_device
    f = setup_filter(FIR).to(dev)
    x = torch.zeros(1, 32, 32, 32, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 32, 64, device=dev)
    before = dict(fc.launch_counts)
    with pytest.raises(TypeError, match="resid"):
        fc.fused_downconv2(x, w, f, resid=torch.zeros(1, 16, 16, 64, device=dev))
    with pytest.raises(TypeError, match="resid"):
        fc.fused_downconv2(x.float(), w, f, resid=torch.zeros(1, 16, 16, 64, device=dev,
                                                             dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="gd"):
        fc.conv_dw(x, torch.zeros(1, 32, 32, 32, device=dev), None)
    with pytest.raises(TypeError, match="gd"):
        fc.conv_dw(x.float(), torch.zeros(1, 32, 32, 32, device=dev, dtype=torch.bfloat16), None)
    with pytest.raises(TypeError, match="w"):
        k4.conv3x3_forward(x, torch.zeros(3, 3, 32, 32, device=dev))
    with pytest.raises(TypeError, match="w"):
        k4.conv3x3_dx(x, torch.zeros(3, 3, 32, 32, device=dev))
    assert dict(fc.launch_counts) == before


@pytest.mark.cuda
def test_bf16_tc_training_kernels_run_on_the_tensor_cores(cuda_device):
    """The built library's SASS (cuobjdump -sass) holds HMMA instructions in
    every instantiation of downconv2_fwd_tc_kernel and conv_dw_tc_kernel."""
    from morphganformer_tpu_torch.bench_k2 import hmma_counts
    from morphganformer_tpu_torch.ops import _build

    _build.library()
    for name, instantiations in (("downconv2_fwd_tc_kernel", 4), ("conv_dw_tc_kernel", 2)):
        counts = hmma_counts(_build.library_path(), name)
        assert len(counts) == instantiations and all(v > 0 for v in counts.values()), counts


def _k4_bf16_check(x, w, g):
    """K4's bfloat16 forward and dx, each one launch of its `_bf16` entry
    point, against the plain version by the bf16 rule."""
    before = dict(fc.launch_counts)
    y = k4.conv3x3_forward(x, w)
    dx = k4.conv3x3_dx(g, w)
    assert fc.launch_counts["conv3x3_bf16"] == before["conv3x3_bf16"] + 1
    assert fc.launch_counts["conv3x3_adj_bf16"] == before["conv3x3_adj_bf16"] + 1
    assert fc.launch_counts["conv3x3"] == before["conv3x3"]
    assert y.dtype == dx.dtype == torch.bfloat16
    wt = k4.conv3x3_adjoint_weights(w)
    _bf16_close(y, k4.conv3x3_same_plain(x, w), k4.conv3x3_same_plain(x.float(), w.float()))
    _bf16_close(dx, k4.conv3x3_same_plain(g, wt), k4.conv3x3_same_plain(g.float(), wt.float()))


# K4's odd sizes and its five call shapes of a 1024^2 iteration at batch 4.
K4_BF16_CASES = K4_CASES + [(4, 512, 512, 64, 64), (4, 1024, 1024, 32, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,o", K4_BF16_CASES)
def test_bf16_k4_kernel_and_dx_match_plain(cuda_device, n, h, w, c, o):
    gen = torch.Generator(cuda_device).manual_seed(56)
    x = torch.randn((n, h, w, c), generator=gen, device=cuda_device).bfloat16()
    wt = (torch.randn((3, 3, c, o), generator=gen, device=cuda_device) / math.sqrt(9 * c))
    g = torch.randn((n, h, w, o), generator=gen, device=cuda_device).bfloat16()
    _k4_bf16_check(x, wt.bfloat16(), g)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(20, 36), (36, 24)])
def test_bf16_k4_single_pixels(cuda_device, c, o):
    """A unit cotangent at one pixel (corners, the border, both sides of the
    tiles' inner edges) spreads w's taps over the 3 x 3 input window that
    pixel reads, cut at the border: one product each, so dx is w's bfloat16
    entries to the bit; and the forward of a unit pixel the same way."""
    dev = cuda_device
    h, w = 33, 35
    wt = torch.randn((3, 3, c, o), generator=torch.Generator(dev).manual_seed(57),
                     device=dev).bfloat16()
    for py, px in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1), (7, 15), (8, 16), (15, 16),
                   (16, 17), (17, 15), (h // 2, w - 1)):
        g = torch.zeros(1, h, w, o, device=dev, dtype=torch.bfloat16)
        g[0, py, px, 2] = 1.0
        want = torch.zeros(1, h, w, c, device=dev, dtype=torch.bfloat16)
        x = torch.zeros(1, h, w, c, device=dev, dtype=torch.bfloat16)
        x[0, py, px, 3] = 1.0
        want_y = torch.zeros(1, h, w, o, device=dev, dtype=torch.bfloat16)
        for dy in range(3):
            for dxx in range(3):
                iy, ix = py + dy - 1, px + dxx - 1
                if 0 <= iy < h and 0 <= ix < w:
                    want[0, iy, ix] = wt[dy, dxx, :, 2]
                oy, ox = py - dy + 1, px - dxx + 1
                if 0 <= oy < h and 0 <= ox < w:
                    want_y[0, oy, ox] = wt[dy, dxx, 3]
        assert torch.equal(k4.conv3x3_dx(g, wt), want), (py, px)
        assert torch.equal(k4.conv3x3_forward(x, wt), want_y), (py, px)


@pytest.mark.cuda
def test_bf16_k4_route_and_gradients_match_the_cudnn_path(cuda_device, monkeypatch):
    """conv2d_resample on bfloat16 x with MGT_PALLAS_CONV=1 at D b512's
    conv0 (batch 2): one K4 forward and one dx launch on the `_bf16` keys,
    the weight cast to bfloat16 and its cotangent float32; y, dx and dw
    within the bf16 rule of the same route in float32, beside cuDNN's
    bfloat16 route (MGT_PALLAS_CONV unset)."""
    from morphganformer_tpu_torch.ops.conv2d_resample import conv2d_resample

    dev = cuda_device
    gen = torch.Generator(dev).manual_seed(58)
    x = torch.randn((2, 512, 512, 64), generator=gen, device=dev)
    wt = torch.randn((3, 3, 64, 64), generator=gen, device=dev) / 24
    g = torch.randn((2, 512, 512, 64), generator=gen, device=dev).bfloat16()

    def route(k4_on, xs, gs):
        monkeypatch.setenv("MGT_PALLAS_CONV", "1") if k4_on else \
            monkeypatch.delenv("MGT_PALLAS_CONV", raising=False)
        xi, wi = xs.clone().requires_grad_(), wt.clone().requires_grad_()
        y = conv2d_resample(xi, wi, padding=1)
        return (y, *torch.autograd.grad(y, (xi, wi), gs))

    before = dict(fc.launch_counts)
    got = route(True, x.bfloat16(), g)
    torch.cuda.synchronize()
    assert fc.launch_counts["conv3x3_bf16"] == before["conv3x3_bf16"] + 1
    assert fc.launch_counts["conv3x3_adj_bf16"] == before["conv3x3_adj_bf16"] + 1
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    cudnn = route(False, x.bfloat16(), g)
    ref = route(True, x.bfloat16().float(), g.float())
    _bf16_close(got, cudnn, ref)


def _float32_kernels_bit_equal(dev, monkeypatch, env, file, libname):
    """Every float32 entry point (K1's forward and adjoint, K4's forward and
    dx, K2's forward and use_dw role, K3's forward and adjoint, K1's dw and
    the FIR dw) against a build of the earlier fused_conv.cu at
    build/`file` (or the file the environment variable `env` names): the
    same bits on the same inputs."""
    import os
    from pathlib import Path

    from morphganformer_tpu_torch.bench_k3 import load_parent
    from morphganformer_tpu_torch.ops import _build

    default = Path(__file__).resolve().parent.parent / "build" / file
    src = Path(os.environ.get(env, default))
    if not src.exists():
        pytest.skip(f"needs the earlier source at {src}")
    names = ("mgt_modconv3x3_fwd", "mgt_modconv3x3_bwd", "mgt_bwd_tiles", "mgt_conv3x3_fwd",
             "mgt_conv3x3_dx", "mgt_upconv2_fwd", "mgt_downconv2_fwd", "mgt_upconv2_bwd",
             "mgt_downconv2_tiles", "mgt_conv_dw", "mgt_conv_dw_tiles", "mgt_fir_dw",
             "mgt_fir_dw_tiles")
    parent = load_parent(src, {k: _build._SIGNATURES[k] for k in names}, libname)
    gen = torch.Generator(dev).manual_seed(59)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    f = setup_filter(FIR).to(dev)
    rng = np.random.RandomState(60)
    k1_cases = []
    for res, c, last in ((64, 64, False), (48, 32, True), (33, 36, False)):
        x, w, s, nz, b, r, gain, alpha = _k1_call(rng, dev, 2, res, c, c, last)
        g = torch.from_numpy(rng.randn(2, res, res, c).astype(np.float32)).to(dev)
        k1_cases.append((x, w, s, nz, b, r, gain, alpha, g))
    cases = []
    for h, cin, cout, kh in ((16, 64, 32, 3), (13, 64, 32, 1), (9, 128, 64, 3)):
        cases.append(dict(x=randn(2, h, h, cin), w=randn(kh, kh, cin, cout) / 8,
                          s=torch.rand((2, cin), generator=gen, device=dev) + 0.5,
                          nz=randn(2 * h, 2 * h), b=randn(cout), g=randn(2, 2 * h, 2 * h, cout),
                          xd=randn(2, 2 * h, 2 * h, cout), wd=randn(kh, kh, cout, cin) / 8,
                          bd=randn(cin), rd=randn(2, h, h, cin), gz=randn(2, h, h, cin)))

    def run():
        outs = []
        for x, w, s, nz, b, r, gain, alpha, g in k1_cases:
            y = fc.fused_modconv3x3(x, w, s, nz, b, r, gain, alpha, True)
            adj = fc.modconv3x3_adjoint(g, x, w, s, y, nz, b, r, gain, alpha, True)
            outs += [y, *[t for t in adj if t is not None], k4.conv3x3_forward(x, w),
                     k4.conv3x3_dx(g, w), fc.conv_dw(x, g, s)]
        for c in cases:
            styled = c["w"].shape[0] == 3
            s = c["s"] if styled else None
            y = fc.fused_upconv2(c["x"], c["w"], s, f, c["nz"] if styled else None, c["b"],
                                 math.sqrt(2), 0.2, styled, False)
            adj = fc.upconv2_adjoint(c["g"], c["x"], c["w"], s, f, y,
                                     c["nz"] if styled else None, c["b"], math.sqrt(2), 0.2,
                                     styled, False)
            yd = fc.fused_downconv2(c["xd"], c["wd"], f, c["bd"], c["rd"], 1.0, 0.2)
            outs += [y, *[t for t in adj if t is not None], yd,
                     fc.downconv2_adjoint(c["gz"], c["wd"], f),
                     fc.upconv2_dw(c["x"], c["g"], s, c["w"], f),
                     fc.downconv2_dw(c["xd"], c["gz"], c["wd"], f),
                     fc.conv_dw(c["x"], c["x"], s)]
        torch.cuda.synchronize()
        return outs

    new = run()
    monkeypatch.setattr(fc, "_library", lambda: parent)
    old = run()
    assert len(new) == len(old)
    for i, (a, e) in enumerate(zip(new, old)):
        assert torch.equal(a, e), i


@pytest.mark.cuda
def test_float32_kernels_bit_equal_to_the_build_before_the_tc_training_roles(cuda_device,
                                                                            monkeypatch):
    """Every float32 entry point gives the same bits as a build of
    fused_conv.cu from before K3's bfloat16 forward and K1's bfloat16 dw
    moved to the tensor cores and their float32 kernels lost their bfloat16
    instantiations (commit 3932729): `git show
    3932729:morphganformer_tpu_torch/csrc/fused_conv.cu >
    build/tc_train_parent.cu`, or MGT_TC_TRAIN_PARENT_SOURCE names the
    file."""
    _float32_kernels_bit_equal(cuda_device, monkeypatch, "MGT_TC_TRAIN_PARENT_SOURCE",
                               "tc_train_parent.cu", "libmgt_tc_train_parent_test.so")


@pytest.mark.cuda
def test_float32_kernels_bit_equal_to_the_build_before_the_tc_fir_dw(cuda_device, monkeypatch):
    """Every float32 entry point gives the same bits as a build of
    fused_conv.cu from before the FIR dw's bfloat16 role moved to the tensor
    cores and `fir_dw_kernel` lost its bfloat16 instantiation (commit
    d375170): `git show d375170:morphganformer_tpu_torch/csrc/fused_conv.cu
    > build/fir_dw_bf16_parent.cu`, or MGT_FIR_DW_PARENT_SOURCE names the
    file."""
    _float32_kernels_bit_equal(cuda_device, monkeypatch, "MGT_FIR_DW_PARENT_SOURCE",
                               "fir_dw_bf16_parent.cu", "libmgt_fir_dw_parent_test.so")
