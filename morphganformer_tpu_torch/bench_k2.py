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

With --bf16, K2's bfloat16 forward (`mgt_upconv2_fwd_bf16`, on the tensor
cores: `upconv2_tc_kernel`) against an earlier build of the same entry
point, whose signature is the same:

    git show cd98f3f:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k2_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_k2 --bf16 build/k2_bf16_parent.cu

(cd98f3f's is the float32 FMA kernel with bfloat16 loads.) At the six K2
shapes of a 1024^2 forward at batch 1, on the inputs chip_smoke.py's
`check_bf16` makes (seed 16), both builds are held against the float32
plain version on the same bfloat16 inputs by its rule (error at most
BF16_RATIO times the plain bfloat16 version's, or within BF16_FLOOR of
the largest entry). Then, in the order earlier, new, new, earlier, each
build's bare launch on operands made once (CUDA events; the kernel
alone), and as check_bf16 times them the wrapper `fused_upconv2` (which
also casts the weight, styles and noise and forms d), the plain bfloat16
version, cuDNN's bfloat16 call of the bare convolution and the
same-function call in bfloat16; the kernel's own device time in one
wrapper call under torch.profiler; the bf16 bound (2 bytes an element over
HBM, or the FLOP over the bf16 dense tensor-core peak). The float32
forward (`mgt_upconv2_fwd`, whose kernel the new build leaves as it was)
runs on the same inputs in float32 in both builds, its outputs bit-equal
and its bare launches timed in the same turns. Prints the count of HMMA
instructions in each build's K2 kernels (cuobjdump -sass). Exits non-zero
if a check fails, if the new kernel has no HMMA, if the float32 outputs
differ, or if the new bf16 launch is not faster than the earlier build's
at some shape.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
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


BF16_RATIO, BF16_FLOOR = 1.5, 2.0 ** -7    # chip_smoke.py's bfloat16 rule
PEAK_BF16_FLOPS = 989e12
TC_KERNEL = "upconv2_tc_kernel"


def hmma_counts(lib_path, part="upconv2"):
    """{kernel function: HMMA instructions} of the kernels whose names hold
    `part` (K2's by default) in a built library's SASS (cuobjdump -sass,
    from the toolkit beside nvcc)."""
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if part in fn:
                counts[fn] = 0
        elif fn in counts and "HMMA" in line:
            counts[fn] += 1
    return counts


def _bf16_err(got, ref):
    return (got.float() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


def bf16_case(gen, res, cin, cout, skip):
    """K2's bf16 forward at the G call (res, cin -> cout), batch 1, on the
    inputs chip_smoke.py's check_bf16 makes: (row, the wrapper's arguments,
    the bare launches' arguments by type (float32 or bfloat16: the pointers
    before the output, the arguments after it, the tensors they point
    into), the runs by name, flops, elements)."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    h, kh = res // 2, (1 if skip else 3)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    x = randn(1, h, h, cin).to(bf)
    s = torch.rand((1, cin), generator=gen, device=dev) + 0.5
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter([1, 3, 3, 1]).to(dev)
    styles = None if skip else s
    noise = None if skip else randn(2 * h, 2 * h, scale=0.1)
    bias = None if skip else randn(cout, scale=0.1)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
    fwd = (x, w, styles, f, noise, bias, gain, alpha, not skip, False)
    wk, fk, pad = fc.upconv2_leastwork(w, f, False)
    d = None if skip else fc.demod_coef(w, styles).contiguous()
    tail = (1, h, h, cin, cout, kh, pad, float(gain), float(alpha), 0, *_stream(dev))
    bare = {}
    for dt in (bf, torch.float32):
        cast = [None if t is None else t.to(dt).contiguous() for t in (x, wk, styles, noise)]
        ptrs = [cast[0].data_ptr(), cast[1].data_ptr(), fk.data_ptr(), _ptr(cast[2]), _ptr(d),
                _ptr(cast[3]), _ptr(bias)]
        bare[dt] = (ptrs, tail, (*cast, fk, d, bias))   # the tensors stay alive
    x_nchw = x.permute(0, 3, 1, 2)
    if skip:
        w_lib = w.permute(3, 2, 0, 1).to(bf).contiguous()
        lib_call = lambda: F.conv2d(x_nchw, w_lib)  # noqa: E731
    else:
        w_lib = w.permute(2, 3, 0, 1).to(bf).contiguous()
        lib_call = lambda: F.conv_transpose2d(x_nchw, w_lib, stride=2)  # noqa: E731
    op, w_same, pad_same = same_function_call("K2", w, f, False)
    w_same = w_same.to(bf)
    runs = {"wrapper": lambda: fc.fused_upconv2(*fwd),
            "plain": lambda: fc.upconv2_plain(*fwd),
            "library": lib_call,
            "same_function": lambda: op(x_nchw, w_same, stride=2, padding=pad_same)}
    flops = 2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout
    elements = sum(t.numel() for t in (x, w, styles, noise) if t is not None) + 4 * h * h * cout
    row = dict(role="K2-forward bf16", block=f"G b{res}", layer="skip" if skip else "conv0",
               batch=1)
    return row, fwd, bare, runs, flops, elements


def bf16_main(parent_source):
    """`--bf16`: see the module's docstring."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    fn, fn32 = "mgt_upconv2_fwd_bf16", "mgt_upconv2_fwd"
    parent = load_parent(Path(parent_source), {k: _build._SIGNATURES[k] for k in (fn, fn32)},
                         "libmgt_k2_bf16_parent.so")
    libs = {"new": _build.library(), "earlier": parent}
    hmma = {"new": hmma_counts(_build.library_path()),
            "earlier": hmma_counts(_build.BUILD_DIR / "libmgt_k2_bf16_parent.so")}
    new_hmma = sum(v for k, v in hmma["new"].items() if TC_KERNEL in k)
    print(json.dumps({"hmma": hmma, "new_kernel_hmma": new_hmma}), flush=True)
    failed = [] if new_hmma > 0 else [f"no HMMA in {TC_KERNEL}"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        for skip in (False, True):
            row, fwd, launch, runs, flops, elements = bf16_case(gen, res, cin, cout, skip)
            ref = fc.upconv2_plain(*(a.float() if isinstance(a, torch.Tensor) and
                                     a.dtype == torch.bfloat16 else a for a in fwd))
            ys = {(k, dt): torch.empty(ref.shape, device="cuda", dtype=dt)
                  for k in libs for dt in (torch.bfloat16, torch.float32)}

            def bare(k, dt=torch.bfloat16):
                ptrs, tail, _ = launch[dt]
                name = fn if dt == torch.bfloat16 else fn32
                return lambda: _call(libs[k], name, *ptrs, ys[k, dt].data_ptr(), *tail)

            for k in libs:
                bare(k)()
                bare(k, torch.float32)()
            got = runs["wrapper"]()
            plain = runs["plain"]()
            torch.cuda.synchronize()
            bf = torch.bfloat16
            row.update(err_new=_bf16_err(ys["new", bf], ref),
                       err_earlier=_bf16_err(ys["earlier", bf], ref),
                       err_plain=_bf16_err(plain, ref),
                       wrapper_equals_bare=bool(torch.equal(got, ys["new", bf])),
                       f32_equal=bool(torch.equal(ys["new", torch.float32],
                                                  ys["earlier", torch.float32])))
            t = {}
            for k in ("earlier", "new", "new", "earlier"):
                t.setdefault(k, []).append(cuda_ms(bare(k), reps=20))
                t.setdefault(f"f32_{k}", []).append(cuda_ms(bare(k, torch.float32), reps=20))
            for name, run in runs.items():
                t[name] = [cuda_ms(run)]
            own, _ = device_split(runs["wrapper"], TC_KERNEL)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
            row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                       new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                       f32_new_ms_runs=t["f32_new"], f32_earlier_ms_runs=t["f32_earlier"],
                       new_kernel_device_ms=own, bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
            row["speedup"] = row["earlier_ms"] / row["new_ms"]
            print(json.dumps(row), flush=True)
            rows.append(row)
            tol = max(BF16_RATIO * row["err_plain"], BF16_FLOOR)
            where = f"{row['block']} {row['layer']}"
            for k in ("err_new", "err_earlier"):
                if not row[k] <= tol:
                    failed.append(f"{where} {k} {row[k]} > {tol}")
            if not row["wrapper_equals_bare"]:
                failed.append(f"{where}: the wrapper's output differs from the bare launch's")
            if not row["f32_equal"]:
                failed.append(f"{where}: the float32 forward differs between the builds")
            if not max(t["new"]) < min(t["earlier"]):
                failed.append(f"{where}: new {t['new']} not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    sums = {k: sum(r[k] for r in rows)
            for k in ("new_ms", "earlier_ms", "wrapper_ms", "plain_ms", "library_ms",
                      "same_function_ms", "bound_ms", "new_kernel_device_ms", "f32_new_ms",
                      "f32_earlier_ms")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


def main(argv):
    if len(argv) == 3 and argv[1] == "--bf16" and torch.cuda.is_available():
        return bf16_main(argv[2])
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
