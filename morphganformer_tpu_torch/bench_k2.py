"""K2 in both roles on one card: the least-work kernel against an earlier
build of K2 that takes every output from its parity's taps of the
FIR-composed kernel.

    mkdir -p build
    git show 943bcd1:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k2_parent.cu
    python -m morphganformer_tpu_torch.bench_k2 build/k2_parent.cu

The earlier source is that of commit 943bcd1, whose `mgt_upconv2_fwd` takes
the parity taps (`upconv2_phase_kernels`, `downconv2_adjoint_kernels`) and
their halo offsets. It is built with the same nvcc flags into
morphganformer_tpu_torch/_build/ under a name of its own, and reached only
from here.

At each call shape of the two roles (the 6 K2-forward shapes of a 1024^2
forward at batch 1; the 4 K2 use_dw shapes of a 1024^2 training iteration
at batch 4) both kernels are held against the plain version on the same
random inputs (the forward within 1e-4 abs, use_dw within 1e-4 of its
largest entry, as chip_smoke.py holds them), then timed with CUDA events in
the order earlier, new, new, earlier, beside the plain version, one cuDNN
call of the bare convolution without the FIR, and one `F.conv_transpose2d`
of the FIR-composed kernel at stride 2 (the same convolution in one
PyTorch call); one call of the new wrapper under torch.profiler splits its
device time into the kernel's own and the torch ops around it. Each row
carries the bound and, for the 3x3s, the halo factor of the new kernel's
tiling. Prints one JSON line per shape, then the card and the sums; exits
non-zero if a check fails or the new kernel is not faster than the earlier
one at some shape. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.bench_k3 import (PEAK_BYTES, PEAK_FP32_FLOPS, _call, _ptr,
                                               _rel_err, _stream, cuda_ms, device_split,
                                               load_parent, same_function_call)
from morphganformer_tpu_torch.ops import _build
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, wp, s, d, noise, bias, y, N, H, W, Cin, Cout, nt, hb0, hb1, gain, alpha, noise_ns,
# device, stream
PARENT_SIGNATURES = {"mgt_upconv2_fwd": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _I, _P]}
TILE = (6, 16)  # base rows x columns of a block of upconv2_lw_kernel


def halo_factor(h, w):
    """The 3x3's conv work on the new kernel's tiles over the least work:
    the Z halo of each tile ((3*7 + 1)(3*17 + 1) taps for 9*6*16) times
    the ragged last row and column of tiles."""
    th, tw = TILE
    cells = (3 * (th + 1) + 1) * (3 * (tw + 1) + 1) / (9 * th * tw)
    return cells * (-(-h // th) * th) * (-(-w // tw) * tw) / (h * w)


def parent_upconv(lib, x, wp, hb, styles, d, noise, bias, gain, alpha):
    """The earlier K2 launch (its wrapper at commit 943bcd1)."""
    n, h, wd, ci = x.shape
    co = wp.shape[-1]
    y = torch.empty((n, 2 * h, 2 * wd, co), device=x.device)
    _call(lib, "mgt_upconv2_fwd", x.data_ptr(), wp.data_ptr(), _ptr(styles), _ptr(d),
          _ptr(noise), _ptr(bias), y.data_ptr(), n, h, wd, ci, co, int(wp.shape[2]), hb[0],
          hb[1], float(gain), float(alpha), 0, *_stream(x.device))
    return y


def forward_case(lib, gen, res, cin, cout, skip):
    """K2 forward at the G call (res, cin -> cout), batch 1, as chip_smoke.py
    phase kernels makes it."""
    dev = torch.device("cuda")
    h, kh = res // 2, (1 if skip else 3)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    x = randn(1, h, h, cin)
    s = torch.rand((1, cin), generator=gen, device=dev) + 0.5
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter([1, 3, 3, 1]).to(dev)
    styles = None if skip else s
    noise = None if skip else randn(2 * h, 2 * h, scale=0.1)
    bias = None if skip else randn(cout, scale=0.1)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    args = (x, w, styles, f, noise, bias, gain, alpha, not skip, False)
    want = fc.upconv2_plain(*args)
    wp, hb = fc.upconv2_phase_kernels(w, f, False)
    d = None if skip else fc.demod_coef(w, styles).contiguous()
    runs = {"new": lambda: fc.fused_upconv2(*args),
            "earlier": lambda: parent_upconv(lib, x, wp, hb, styles, d, noise, bias, gain, alpha),
            "plain": lambda: fc.upconv2_plain(*args)}
    errs = {name: (runs[name]() - want).abs().max().item() for name in ("new", "earlier")}
    x_nchw = x.permute(0, 3, 1, 2)
    if skip:
        w_bare = w.permute(3, 2, 0, 1).contiguous()
        runs["library"] = lambda: F.conv2d(x_nchw, w_bare)
    else:
        w_bare = w.permute(2, 3, 0, 1).contiguous()
        runs["library"] = lambda: F.conv_transpose2d(x_nchw, w_bare, stride=2)
    op, k_same, pad = same_function_call("K2", w, f, False)
    runs["same_function"] = lambda: op(x_nchw, k_same, stride=2, padding=pad)
    assert runs["same_function"]().shape == (1, cout, 2 * h, 2 * h)
    flops = 2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout
    nbytes = 4 * (x.numel() + w.numel() + want.numel() +
                  (0 if skip else noise.numel() + s.numel() + bias.numel()))
    return dict(role="K2-forward", block=f"G b{res}", layer="skip" if skip else "conv0",
                batch=1, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-4,
                rel=False, halo=None if skip else halo_factor(h, h)), runs, flops, nbytes


def use_dw_case(lib, gen, res, cin, skip):
    """K2 use_dw at the D call (res, cin -> 2 cin: gz [4, res/2, res/2, 2 cin]
    -> dx [4, res, res, cin]), as chip_smoke.py phase train makes it."""
    dev = torch.device("cuda")
    n, h, cout, kh = 4, res // 2, 2 * cin, (1 if skip else 3)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter([1, 3, 3, 1]).to(dev)
    gz = randn(n, h, h, cout)
    want = fc.downconv2_adjoint_plain(gz, w, f)
    wt, hb = fc.downconv2_adjoint_kernels(w, f)
    runs = {"new": lambda: fc.downconv2_adjoint(gz, w, f),
            "earlier": lambda: parent_upconv(lib, gz, wt, hb, None, None, None, None, 1.0, 1.0),
            "plain": lambda: fc.downconv2_adjoint_plain(gz, w, f)}
    errs = {name: _rel_err(runs[name](), want) for name in ("new", "earlier")}
    gz_nchw = gz.permute(0, 3, 1, 2)
    w_bare = w.permute(3, 2, 0, 1).contiguous()
    runs["library"] = lambda: F.conv_transpose2d(gz_nchw, w_bare, stride=2, padding=kh // 2,
                                                 output_padding=1)
    op, k_same, pad = same_function_call("K2-use_dw", w, f, True)
    runs["same_function"] = lambda: op(gz_nchw, k_same, stride=2, padding=pad)
    assert runs["same_function"]().shape == (n, cin, 2 * h, 2 * h)
    fir = 2 * n * (2 * h) ** 2 * (3 if skip else 8) * cin
    flops = 2 * n * h * h * kh * kh * cin * cout + fir
    nbytes = 4 * (gz.numel() + w.numel() + want.numel())
    return dict(role="K2-use_dw", block=f"D b{res}", layer="skip" if skip else "conv1",
                batch=n, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-4,
                rel=True, halo=None if skip else halo_factor(h, h)), runs, flops, nbytes


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = load_parent(Path(argv[1]), PARENT_SIGNATURES, "libmgt_k2_parent.so")
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [forward_case(lib, gen, res, cin, cout, skip)
             for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32))
             for skip in (False, True)]
    cases += [use_dw_case(lib, gen, res, cin, skip)
              for res, cin in ((1024, 32), (512, 64)) for skip in (False, True)]
    rows, failed = [], []
    for row, runs, flops, nbytes in cases:
        t = {}
        for name in ("earlier", "new", "new", "earlier"):
            t.setdefault(name, []).append(cuda_ms(runs[name]))
        for name in ("plain", "library", "same_function"):
            t[name] = [cuda_ms(runs[name], reps=5, warmup=1)]
        kernel_ms, device_ms = device_split(runs["new"], "upconv2_lw_kernel")
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                   new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                   new_kernel_device_ms=kernel_ms, new_all_device_ms=device_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        for k in ("err_new", "err_earlier"):
            if not row[k] <= row["tol"]:
                failed.append(f"{row['role']} {row['block']} {row['layer']} {k} {row[k]}")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{row['role']} {row['block']} {row['layer']}: new {t['new']} "
                          f"not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    sums = {role: {k: sum(r[k] for r in rows if r["role"] == role)
                   for k in ("new_ms", "earlier_ms", "plain_ms", "library_ms",
                             "same_function_ms", "bound_ms", "new_kernel_device_ms")}
            for role in ("K2-forward", "K2-use_dw")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
