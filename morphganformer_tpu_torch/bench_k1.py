"""K1 in both roles, and K4, on one card: the tree's kernels against an
earlier build of the same library.

    mkdir -p build
    git show 4256d78:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k1_parent.cu
    python -m morphganformer_tpu_torch.bench_k1 build/k1_parent.cu

The earlier source is that of commit 4256d78, whose K1 forward, K1 adjoint
and K4 launches are one template (`fused_conv_kernel`): its adjoint takes
gd = g * lrelu' * d formed in torch and a torch copy of flip(w)^T. It is
built with the same nvcc flags into morphganformer_tpu_torch/_build/ under a
name of its own and reached only from here, through a copy of that commit's
wrapper.

At each call shape (the K1 forward and adjoint at the 4 K1 call shapes of a
1024^2 forward at batch 1; K4's forward and dx at its 5 call shapes of the
`skip` layouts at batch 4) both builds are held against the plain version
on the same random inputs (the K1 forward within 1e-4 abs, its adjoint's
dx, ds, dd1 and dd2 within 1e-4 of each one's largest entry, K4 within
1e-5 of its largest entry, as chip_smoke.py holds them), then timed with
CUDA events in the order earlier, new, new, earlier, beside the plain
version and one cuDNN call of the bare convolution (`F.conv2d`; for the
adjoint and K4's dx the same call on the cotangent with flip(w)^T). One
call of each wrapper under torch.profiler splits its device time into the
kernel's own and the torch ops around it. Prints the compiler's register
and spill report of the tree's kernels, one JSON line per shape, then the
card and the sums; exits non-zero if a check fails or the tree's kernel is
not faster than the earlier one at some shape. Needs a CUDA card.

With --bf16, K1's bfloat16 adjoint (`mgt_modconv3x3_bwd_bf16`, on the
tensor cores: `conv3x3_adj_tc_kernel`) against an earlier build of the same
entry point, the bfloat16 instantiation of the float32 FMA template
`conv3x3_lw_kernel`:

    git show 705c474:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k1_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_k1 --bf16 build/k1_bf16_parent.cu

Both form gd from g, y, resid and d in the kernel. It prints the compiler's
register and spill lines of the new kernel and the HMMA count of each
build's K1 kernels (cuobjdump -sass). At the four K1 call shapes of a
1024^2 projection step at batch 1, on inputs made as chip_smoke.py's
`check_bf16` makes them (seed 16), both builds are held against the float32
plain version on the same bfloat16 inputs by its rule (error at most
BF16_RATIO times the plain bfloat16 version's, or within BF16_FLOOR of the
largest entry), dx, ds and the dd taps, the largest and the mean error
each beside the plain version's. Then, in the order earlier, new, new,
earlier: each build's bare bfloat16 launch on operands made once (CUDA
events; the kernel alone), and the float32 adjoint (`mgt_modconv3x3_bwd`,
whose kernel the new build keeps) of both builds on the same inputs in
float32, its outputs bit-equal; the float32 forward of both builds,
bit-equal; then the new wrapper `modconv3x3_adjoint`, the plain bfloat16
version and cuDNN's bfloat16 call of the bare convolution of g with
flip(w)^T; the kernel's own device time in one wrapper call under
torch.profiler; the bf16 bound (g, x, y, resid, noise in, dx out, 2 bytes
an element). Last, traced bfloat16 1024^2 projection steps (init:1024, one
MSE step as chip_smoke.py traces it), each followed by a traced bfloat16
forward at batch 1, earlier, new, new, earlier, the earlier route
launching the earlier build's bf16 adjoint through the same wrapper:
device ms, device ops, each kernel's device ms and the host ms of an
untraced call. Exits non-zero if a check fails, if the new kernel has
no HMMA, if a float32 output differs, or if the new bf16 launch is not
faster than the earlier build's at some shape.

With --bf16-fwd, K1's bfloat16 forward (`mgt_modconv3x3_fwd_bf16`, on the
tensor cores: `conv3x3_fwd_tc_kernel`) against an earlier build of the same
entry point, the bfloat16 instantiation of `conv3x3_lw_kernel`:

    git show 32aa084:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k1_fwd_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_k1 --bf16-fwd build/k1_fwd_bf16_parent.cu

Both builds are compiled at once. It prints the compiler's register and
spill lines of the new kernel and the HMMA count of each build's K1
kernels. At the four K1 call shapes of a 1024^2 projection step at batch
1, on inputs made as chip_smoke.py's `check_bf16` makes them (seed 16),
each build's bare bfloat16 launch is held against the float32 plain
version on the same bfloat16 inputs by its rule, the largest and the mean
error beside the plain bfloat16 version's; the float32 K1 forward and
adjoint and K4's forward and dx of both builds, on the same float32
inputs, are bit-equal. Then, in the order earlier, new, new, earlier, each
build's bare launch (CUDA events); the new wrapper `fused_modconv3x3`, the
plain bfloat16 version and cuDNN's bfloat16 call of the bare convolution;
the kernel's own device time in one wrapper call under torch.profiler; the
bf16 bound (x, w, noise, resid in, y out, 2 bytes an element). Last,
traced bfloat16 1024^2 projection steps and forwards at batch 1, earlier,
new, new, earlier, the earlier route launching the earlier build's bf16
forward through the same wrapper. Exits non-zero if a check fails, if the
new kernel has no HMMA, if a float32 output differs, or if the new bf16
launch is not faster than the earlier build's at some shape.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from morphganformer_tpu_torch.bench_k3 import (PEAK_BYTES, PEAK_FP32_FLOPS, _call, _errs, _ptr,
                                               _rel_err, _stream, cuda_ms, device_split,
                                               load_parent)
from morphganformer_tpu_torch.ops import _build
from morphganformer_tpu_torch.ops import conv3x3 as k4
from morphganformer_tpu_torch.ops import fused_conv as fc

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    # x, w, s, d, noise, bias, resid, y, N, H, W, C, O, gain, alpha, noise_ns, device, stream
    "mgt_modconv3x3_fwd": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # x, w, y, N, H, W, C, O, device, stream
    "mgt_conv3x3_fwd": [_P] * 3 + [_I] * 5 + [_I, _P],
    "mgt_bwd_tiles": [_I, _I],
    # gd, wt, s, x, y, noise, dx, dot, dd1, dd2, N, H, W, O, C, gain, alpha, noise_ns,
    # device, stream
    "mgt_modconv3x3_bwd": [_P] * 10 + [_I] * 5 + [_F, _F, _I, _I, _P],
}
PARENT_KERNEL = "fused_conv_kernel"
KERNEL = "conv3x3_lw_kernel"


def parent_forward(lib, x, w, s, noise, bias, resid, gain, alpha, demod):
    """The earlier K1 forward launch (its wrapper at commit 4256d78)."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    d = fc.demod_coef(w, s).contiguous() if demod else None
    y = torch.empty((n, h, wd, o), device=x.device)
    _call(lib, "mgt_modconv3x3_fwd", x.data_ptr(), w.data_ptr(), _ptr(s), _ptr(d), _ptr(noise),
          _ptr(bias), _ptr(resid), y.data_ptr(), n, h, wd, c, o, float(gain), float(alpha), 0,
          *_stream(x.device))
    return y


def parent_adjoint(lib, g, x, w, s, y, noise, bias, resid, gain, alpha, demod):
    """The earlier K1 adjoint (its wrapper at commit 4256d78): y - resid, gd
    and flip(w)^T in torch, one launch, the partials summed in torch."""
    if resid is not None:
        y = y - resid
    mask, gd, d = fc._adjoint_gd(g, y, w, s, gain, alpha, demod)
    need_dd = d is not None
    n, h, wd, c = x.shape
    o = gd.shape[-1]
    dev = x.device
    wt = fc.modconv3x3_adjoint_weights(w)
    nblk = lib.mgt_bwd_tiles(h, wd)
    dx = torch.empty((n, h, wd, c), device=dev)
    dot = torch.empty((n, nblk, c), device=dev)
    dd = [torch.empty((n, nblk, o), device=dev) if need_dd else None for _ in range(2)]
    _call(lib, "mgt_modconv3x3_bwd", gd.contiguous().data_ptr(), wt.data_ptr(), _ptr(s),
          x.data_ptr(), _ptr(y.contiguous() if need_dd else None),
          _ptr(noise if need_dd else None), dx.data_ptr(), dot.data_ptr(), _ptr(dd[0]),
          _ptr(dd[1]), n, h, wd, o, c, float(gain), float(alpha), 0, *_stream(dev))
    ds, dd1, dd2 = dot.sum(1), None, None
    if need_dd:
        dd1, dd2 = dd[0].sum(1), dd[1].sum(1)
        ds = fc._demod_chain(ds, fc._demod_de(dd1, dd2, d, bias), w, s)
    return dx, ds, dd1, dd2


def parent_k4(lib, x, w):
    """The earlier K4 launch (forward, or dx on the cotangent with flip(w)^T)."""
    n, h, wd, c = x.shape
    o = w.shape[-1]
    y = torch.empty((n, h, wd, o), device=x.device)
    _call(lib, "mgt_conv3x3_fwd", x.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(), n, h, wd,
          c, o, *_stream(x.device))
    return y


def _k1_operands(gen, res, c, last):
    """Random K1 operands at one G call (conv1 or conv_last), batch 1, as
    chip_smoke.py phase kernels makes them."""
    dev = torch.device("cuda")
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    x = randn(1, res, res, c)
    s = torch.rand((1, c), generator=gen, device=dev) + 0.5
    w = randn(3, 3, c, c, scale=1 / math.sqrt(9 * c))
    noise = None if last else randn(res, res, scale=0.1)
    bias = None if last else randn(c, scale=0.1)
    resid = None if last else randn(1, res, res, c)
    gain, alpha = 1.0, (1.0 if last else 0.2)
    return x, w, s, noise, bias, resid, gain, alpha


def forward_case(lib, gen, res, c, last):
    x, w, s, noise, bias, resid, gain, alpha = _k1_operands(gen, res, c, last)
    args = (x, w, s, noise, bias, resid, gain, alpha, True)
    want = fc.modconv3x3_plain(*args)
    runs = {"new": lambda: fc.fused_modconv3x3(*args),
            "earlier": lambda: parent_forward(lib, *args),
            "plain": lambda: fc.modconv3x3_plain(*args)}
    errs = {name: (runs[name]() - want).abs().max().item() for name in ("new", "earlier")}
    x_nchw, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    runs["library"] = lambda: F.conv2d(x_nchw, w_lib, padding=1)
    flops = 2 * res * res * 9 * c * c
    nbytes = 4 * (sum(t.numel() for t in (x, w, s, noise, bias, resid) if t is not None)
                  + want.numel())
    return dict(role="K1-forward", block=f"G b{res}", layer="conv_last" if last else "conv1",
                batch=1, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-4,
                rel=False), runs, flops, nbytes


def adjoint_case(lib, gen, res, c, last):
    x, w, s, noise, bias, resid, gain, alpha = _k1_operands(gen, res, c, last)
    y = fc.modconv3x3_plain(x, w, s, noise, bias, resid, gain, alpha, True)
    g = torch.randn(y.shape, generator=gen, device=y.device)
    args = (g, x, w, s, y, noise, bias, resid, gain, alpha, True)
    want = fc.modconv3x3_adjoint_plain(*args)
    runs = {"new": lambda: fc.modconv3x3_adjoint(*args),
            "earlier": lambda: parent_adjoint(lib, *args),
            "plain": lambda: fc.modconv3x3_adjoint_plain(*args)}
    errs = {}
    for name in ("new", "earlier"):
        got = runs[name]()
        errs[name] = max(_rel_err(a, b) for a, b in zip(got, want) if b is not None)
    g_nchw = g.permute(0, 3, 1, 2)
    w_lib = fc.modconv3x3_adjoint_weights(w).permute(3, 2, 0, 1).contiguous()
    runs["library"] = lambda: F.conv2d(g_nchw, w_lib, padding=1)
    # One 3x3 conv, the ds dot (2 per dx value) and the dd taps (4 per gd
    # value); g, y, resid, noise and x in, dx out.
    flops = 2 * res * res * 9 * c * c + 2 * res * res * c + 4 * res * res * c
    nbytes = 4 * (sum(t.numel() for t in (g, y, resid, noise, x, w, s) if t is not None)
                  + x.numel())
    return dict(role="K1-adjoint", block=f"G b{res}", layer="conv_last" if last else "conv1",
                batch=1, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-4,
                rel=True), runs, flops, nbytes


def k4_case(lib, gen, block, layer, res, c, o, dx):
    """K4 at one call shape of the `skip` layouts, batch 4: the forward, or
    dx (the launch on the cotangent with flip(w)^T)."""
    dev = torch.device("cuda")
    n = 4
    w = torch.randn((3, 3, c, o), generator=gen, device=dev) / math.sqrt(9 * c)
    wt = k4.conv3x3_adjoint_weights(w)
    if dx:
        t = torch.randn((n, res, res, o), generator=gen, device=dev)
        runs = {"new": lambda: k4.conv3x3_dx(t, w),
                "earlier": lambda: parent_k4(lib, t, wt.contiguous()),
                "plain": lambda: k4.conv3x3_same_plain(t, wt)}
        w_lib = wt.permute(3, 2, 0, 1).contiguous()
    else:
        t = torch.randn((n, res, res, c), generator=gen, device=dev)
        runs = {"new": lambda: k4.conv3x3_forward(t, w),
                "earlier": lambda: parent_k4(lib, t, w),
                "plain": lambda: k4.conv3x3_same_plain(t, w)}
        w_lib = w.permute(3, 2, 0, 1).contiguous()
    want = runs["plain"]()
    errs = {name: _rel_err(runs[name](), want) for name in ("new", "earlier")}
    t_nchw = t.permute(0, 3, 1, 2)
    runs["library"] = lambda: F.conv2d(t_nchw, w_lib, padding=1)
    flops = 2 * n * res * res * 9 * c * o
    nbytes = 4 * (t.numel() + w.numel() + want.numel())
    return dict(role="K4-dx" if dx else "K4-forward", block=block, layer=layer, batch=n,
                err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-5,
                rel=True), runs, flops, nbytes


def traced(fn, kernel):
    """`device_split`, once more if a trace came back without the kernel's
    device events (the profiler drops them now and then)."""
    own, total = device_split(fn, kernel)
    return device_split(fn, kernel) if own == 0.0 else (own, total)


def ptxas_report(log):
    """The compiler's lines on registers, shared memory and spills."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = load_parent(Path(argv[1]), PARENT_SIGNATURES, "libmgt_k1_parent.so")
    _, build_s, log = _build.build()
    print(json.dumps({"build_s": build_s, "ptxas": ptxas_report(log)}), flush=True)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_shapes = [(256, 128, False), (512, 64, False), (1024, 32, False), (1024, 32, True)]
    cases = [forward_case(lib, gen, *shape) for shape in k1_shapes]
    cases += [adjoint_case(lib, gen, *shape) for shape in k1_shapes]
    k4_shapes = [("G b512", "conv1", 512, 64, 64), ("G b1024", "conv1", 1024, 32, 32),
                 ("G b1024", "conv_last", 1024, 32, 32), ("D b1024", "conv0", 1024, 32, 32),
                 ("D b512", "conv0", 512, 64, 64)]
    cases += [k4_case(lib, gen, *shape, dx) for dx in (False, True) for shape in k4_shapes]
    rows, failed = [], []
    for row, runs, flops, nbytes in cases:
        t = {}
        for name in ("earlier", "new", "new", "earlier"):
            t.setdefault(name, []).append(cuda_ms(runs[name]))
        for name in ("plain", "library"):
            t[name] = [cuda_ms(runs[name], reps=5, warmup=1)]
        kernel_ms, device_ms = traced(runs["new"], KERNEL)
        earlier_kernel_ms, earlier_device_ms = traced(runs["earlier"], PARENT_KERNEL)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                   new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                   new_kernel_device_ms=kernel_ms, new_all_device_ms=device_ms,
                   earlier_kernel_device_ms=earlier_kernel_ms,
                   earlier_all_device_ms=earlier_device_ms,
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
    keys = ("new_ms", "earlier_ms", "plain_ms", "library_ms", "bound_ms", "new_kernel_device_ms",
            "new_all_device_ms", "earlier_kernel_device_ms", "earlier_all_device_ms")
    sums = {role: {k: sum(r[k] for r in rows if r["role"] == role) for k in keys}
            for role in ("K1-forward", "K1-adjoint", "K4-forward", "K4-dx")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


TC_KERNEL = "conv3x3_adj_tc_kernel"
_BF16_NAMES = ("mgt_modconv3x3_bwd_bf16", "mgt_modconv3x3_bwd", "mgt_modconv3x3_fwd",
               "mgt_modconv3x3_fwd_bf16", "mgt_bwd_tiles", "mgt_conv3x3_fwd", "mgt_conv3x3_dx")
K1_CALLS = ((256, 128, False), (512, 64, False), (1024, 32, False), (1024, 32, True))


class Routed:
    """The tree's kernel library with some entry points taken from an
    earlier build: `routes` maps each such name to the earlier build's
    function (K1's bfloat16 adjoint and its count of partials, which that
    build counts by mgt_bwd_tiles; or K1's bfloat16 forward)."""

    def __init__(self, new, earlier, routes):
        self.new, self.earlier, self.routes = new, earlier, routes

    def __getattr__(self, name):
        if name in self.routes:
            return getattr(self.earlier, self.routes[name])
        return getattr(self.new, name)


def bf16_forward_args(gen, res, c, last):
    """K1's bfloat16 forward at one G call (conv1 or conv_last), batch 1,
    made as chip_smoke.py's check_bf16 makes it: the arguments of
    fused_modconv3x3."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    x = randn(1, res, res, c).to(bf)
    s = torch.rand((1, c), generator=gen, device=dev) + 0.5
    w = randn(3, 3, c, c, scale=1 / math.sqrt(9 * c))
    noise = None if last else randn(res, res, scale=0.1)
    bias = None if last else randn(c, scale=0.1)
    resid = None if last else randn(1, res, res, c).to(bf)
    gain, alpha = 1.0, (1.0 if last else 0.2)
    return (x, w, s, noise, bias, resid, gain, alpha, True)


def bf16_adjoint_args(gen, res, c, last):
    """K1's bfloat16 adjoint at one G call (conv1 or conv_last), batch 1,
    made as chip_smoke.py's check_bf16 makes it: the arguments of
    modconv3x3_adjoint, y the plain bfloat16 forward."""
    fwd = bf16_forward_args(gen, res, c, last)
    y = fc.modconv3x3_plain(*fwd)
    g = torch.randn(y.shape, generator=gen, device=y.device).to(torch.bfloat16)
    return (g, *fwd[:3], y, *fwd[3:])


def bare_adjoint(lib, tiles, args, dt):
    """A bare launch of `lib`'s K1 adjoint in type dt (bfloat16:
    mgt_modconv3x3_bwd_bf16; float32: mgt_modconv3x3_bwd) on operands made
    once, its partials counted by `tiles`: (launch, its outputs, the
    tensors it points into, d)."""
    g, x, w, s, y, noise, bias, resid, gain, alpha, demod = args
    n, h, wd, o = g.shape
    c = int(w.shape[2])
    d = fc.demod_coef(w, s).contiguous()
    gt, xt, yt, wt = (t.to(dt).contiguous() for t in (g, x, y, w))
    rt, nz = (None if t is None else t.to(dt).contiguous() for t in (resid, noise))
    outs = fc._adjoint_outputs(n, h, wd, c, o, tiles(h, wd, c), True, True, True, g.device, dt)
    fn = "mgt_modconv3x3_bwd" + ("_bf16" if dt == torch.bfloat16 else "")
    launch = functools.partial(_call, lib, fn, gt.data_ptr(), wt.data_ptr(), s.data_ptr(),
                               d.data_ptr(), xt.data_ptr(), yt.data_ptr(), _ptr(rt), _ptr(nz),
                               *(_ptr(t) for t in outs), n, h, wd, o, c, float(gain),
                               float(alpha), 0, *_stream(g.device))
    return launch, outs, (gt, xt, yt, rt, wt, nz), d


def _closed(outs, args, d):
    """(dx, ds, dd1, dd2) from a launch's outputs, summed and closed through
    the demodulation as modconv3x3_adjoint closes them."""
    w, s, bias = args[2], args[3], args[6]
    dx, dot, dd1, dd2 = fc._summed(*outs)
    return dx, fc._demod_chain(dot, fc._demod_de(dd1, dd2, d, bias), w, s), dd1, dd2


def _with_library(lib, fn):
    """fn() with the wrappers launching `lib`'s kernels."""
    keep = fc._library
    fc._library = lambda: lib
    try:
        return fn()
    finally:
        fc._library = keep


def bf16_step_ab(libs):
    """Traced bfloat16 1024^2 projection steps, each followed by a traced
    bfloat16 forward at batch 1 on the same route, earlier, new, new,
    earlier (see the module's docstring)."""
    from morphganformer_tpu_torch import cli
    from morphganformer_tpu_torch.bench_dw import traced_run
    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, loss_and_grad

    cfg, G = cli.get_model("init:1024", device="cuda", dtype="bfloat16")
    G.requires_grad_(False)            # the latent's gradient alone, as a projection takes it
    pcfg = ProjectionConfig(steps=100)
    mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
    latent = (mean[None] + torch.randn((1, cfg.k, cfg.z_dim),
                                       generator=torch.Generator().manual_seed(1))
              * std * pcfg.noise).cuda()
    with torch.no_grad():
        target = cli.synthesize(G, torch.randn((1, cfg.k, cfg.z_dim),
                                               generator=torch.Generator().manual_seed(2)))
    loss_fn = build_loss_stack({"mse": 1.0})
    kernels = (TC_KERNEL, FWD_TC_KERNEL, KERNEL, "upconv2_tc_kernel", "downconv2_tc_kernel")
    z = torch.randn((1, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(3)).cuda()
    runs = {"step": lambda: loss_and_grad(G, latent, target, loss_fn, pcfg),
            "forward": lambda: cli.synthesize(G, z)}
    rows = []
    for name in ("earlier", "new", "new", "earlier"):
        for what, run in runs.items():
            def one():
                run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, traced_run(run, kernels)[2]
            host_ms, out = _with_library(libs[name], one)
            row = dict(route=name, what=what, step_ms=host_ms, window_ms=out["window_ms"],
                       busy_ms=out["busy_ms"], device_ops=out["launches"],
                       kernels=out["kernels"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def bf16_main(parent_source):
    """`--bf16`: see the module's docstring."""
    from morphganformer_tpu_torch.bench_k2 import BF16_FLOOR, BF16_RATIO, PEAK_BF16_FLOPS
    from morphganformer_tpu_torch.bench_k2 import hmma_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = "libmgt_k1_bf16_parent.so"
    parent = load_parent(Path(parent_source), {k: _build._SIGNATURES[k] for k in _BF16_NAMES},
                         name)
    _, build_s, log = _build.build()
    new = _build.library()
    lines = ptxas_report(log)
    print(json.dumps({"build_s": build_s, "ptxas": [
        line for i, line in enumerate(lines)
        if any(TC_KERNEL in lines[j] for j in range(max(0, i - 2), i + 1))]}), flush=True)
    hmma = {"new": hmma_counts(_build.library_path(), "conv3x3"),
            "earlier": hmma_counts(_build.BUILD_DIR / name, "conv3x3")}
    new_hmma = sum(v for k, v in hmma["new"].items() if TC_KERNEL in k)
    print(json.dumps({"hmma": hmma, "new_kernel_hmma": new_hmma}), flush=True)
    failed = [] if new_hmma > 0 else [f"no HMMA in {TC_KERNEL}"]
    tiles = {"new": new.mgt_bwd_tiles_bf16, "earlier": parent.mgt_bwd_tiles}
    libs = {"new": new, "earlier": Routed(new, parent, {
        "mgt_modconv3x3_bwd_bf16": "mgt_modconv3x3_bwd_bf16",
        "mgt_bwd_tiles_bf16": "mgt_bwd_tiles"})}
    gen = torch.Generator(device="cuda").manual_seed(16)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for res, c, last in K1_CALLS:
        args = bf16_adjoint_args(gen, res, c, last)
        g, x, w, s, y, noise, bias, resid = args[:8]
        where = f"G b{res} {'conv_last' if last else 'conv1'}"
        row = dict(role="K1-adjoint bf16", block=f"G b{res}",
                   layer="conv_last" if last else "conv1", batch=1)
        lib_of = {"new": new, "earlier": parent}
        launch = {(k, dt): bare_adjoint(lib_of[k], tiles[k] if dt == bf else
                                        parent.mgt_bwd_tiles, args, dt)
                  for k in ("earlier", "new") for dt in (bf, f32)}
        for v in launch.values():
            v[0]()
        plain = fc.modconv3x3_adjoint_plain(*args)
        wide = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == bf else a
                     for a in args)
        ref = fc.modconv3x3_adjoint_plain(*wide)
        wrapper = fc.modconv3x3_adjoint(*args)
        fwd = (x.float(), w, s, noise, bias, None if resid is None else resid.float(), *args[8:])
        fwd_out = {k: _with_library(lib_of[k], lambda: fc.fused_modconv3x3(*fwd))
                   for k in ("earlier", "new")}
        torch.cuda.synchronize()
        got = {k: _closed(launch[k, bf][1], args, launch[k, bf][3]) for k in ("earlier", "new")}
        ep = _errs(plain, ref)
        for k in ("earlier", "new"):
            row[f"err_{k}"], row[f"err_mean_{k}"] = _errs(got[k], ref)
        row["err_plain"], row["err_mean_plain"] = ep
        row["err_ratio"] = row["err_new"] / max(ep[0], 1e-30)
        row["err_mean_ratio"] = row["err_mean_new"] / max(ep[1], 1e-30)
        row["wrapper_equals_bare"] = bool(torch.equal(wrapper[0], got["new"][0]))
        row["f32_equal"] = all(
            bool(torch.equal(a, b)) for a, b in zip(launch["earlier", f32][1],
                                                    launch["new", f32][1]))
        row["f32_forward_equal"] = bool(torch.equal(fwd_out["earlier"], fwd_out["new"]))
        t = {}
        for k in ("earlier", "new", "new", "earlier"):
            t.setdefault(k, []).append(cuda_ms(launch[k, bf][0], reps=20))
            t.setdefault(f"f32_{k}", []).append(cuda_ms(launch[k, f32][0], reps=20))
        g_nchw = g.permute(0, 3, 1, 2)
        w_lib = fc.modconv3x3_adjoint_weights(w).permute(3, 2, 0, 1).to(bf).contiguous()
        for k, run in (("wrapper", lambda: fc.modconv3x3_adjoint(*args)),
                       ("plain", lambda: fc.modconv3x3_adjoint_plain(*args)),
                       ("library", lambda: F.conv2d(g_nchw, w_lib, padding=1))):
            t[k] = [cuda_ms(run)]
        own, _ = device_split(lambda: fc.modconv3x3_adjoint(*args), TC_KERNEL)
        flops = 2 * res * res * 9 * c * c + 2 * res * res * c + 4 * res * res * c
        elements = sum(t_.numel() for t_ in (g, x, y, resid, noise) if t_ is not None) + x.numel()
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                   new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                   f32_new_ms_runs=t["f32_new"], f32_earlier_ms_runs=t["f32_earlier"],
                   new_kernel_device_ms=own, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        row["bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        tol = max(BF16_RATIO * ep[0], BF16_FLOOR)
        for k in ("err_new", "err_earlier"):
            if not row[k] <= tol:
                failed.append(f"{where} {k} {row[k]} > {tol}")
        for k, what in (("wrapper_equals_bare", "the wrapper's dx differs from the bare launch's"),
                        ("f32_equal", "the float32 adjoint differs between the builds"),
                        ("f32_forward_equal", "the float32 forward differs between the builds")):
            if not row[k]:
                failed.append(f"{where}: {what}")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{where}: new {t['new']} not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    sums = {k: sum(r[k] for r in rows)
            for k in ("new_ms", "earlier_ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                      "new_kernel_device_ms", "f32_new_ms", "f32_earlier_ms")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    print_step_means(bf16_step_ab(libs), smi)
    return 1 if failed else 0


def print_step_means(rows, smi):
    """The card, then the traced runs' means by route and kind."""
    print(smi, flush=True)
    means = {}
    for what in dict.fromkeys(r["what"] for r in rows):
        for route in ("earlier", "new"):
            mine = [r for r in rows if r["route"] == route and r["what"] == what]
            means.setdefault(what, {})[route] = {
                k: sum(r[k] for r in mine) / len(mine) for k in ("step_ms", "busy_ms",
                                                                 "device_ops")}
    print(json.dumps({"traced": means}), flush=True)


FWD_TC_KERNEL = "conv3x3_fwd_tc_kernel"
_BF16_FWD_NAMES = ("mgt_modconv3x3_fwd_bf16", "mgt_modconv3x3_fwd", "mgt_modconv3x3_bwd",
                   "mgt_bwd_tiles", "mgt_conv3x3_fwd", "mgt_conv3x3_dx")


def bare_forward(lib, args):
    """A bare launch of `lib`'s `mgt_modconv3x3_fwd_bf16` on operands made
    once, as `_modconv3x3_forward` makes them: (launch, y, the tensors it
    points into)."""
    x, w, s, noise, bias, resid, gain, alpha, demod = args
    n, h, wd, c = x.shape
    o = int(w.shape[-1])
    bf = torch.bfloat16
    d = fc.demod_coef(w, s).contiguous() if demod else None
    wt, st, nz = (None if t is None else t.to(bf).contiguous() for t in (w, s, noise))
    y = torch.empty((n, h, wd, o), device=x.device, dtype=bf)
    launch = functools.partial(_call, lib, "mgt_modconv3x3_fwd_bf16", x.data_ptr(),
                               wt.data_ptr(), _ptr(st), _ptr(d), _ptr(nz), _ptr(bias),
                               _ptr(resid), y.data_ptr(), n, h, wd, c, o, float(gain),
                               float(alpha), 0, *_stream(x.device))
    return launch, y, (wt, st, nz, d)


def bf16_fwd_main(parent_source):
    """`--bf16-fwd`: see the module's docstring."""
    from concurrent.futures import ThreadPoolExecutor

    from morphganformer_tpu_torch.bench_k2 import BF16_FLOOR, BF16_RATIO, PEAK_BF16_FLOPS
    from morphganformer_tpu_torch.bench_k2 import hmma_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = "libmgt_k1_fwd_bf16_parent.so"
    with ThreadPoolExecutor(1) as pool:   # both builds at once
        earlier = pool.submit(load_parent, Path(parent_source),
                              {k: _build._SIGNATURES[k] for k in _BF16_FWD_NAMES}, name)
        _, build_s, log = _build.build()
        parent = earlier.result()
    new = _build.library()
    lines = ptxas_report(log)
    print(json.dumps({"build_s": build_s, "ptxas": [
        line for i, line in enumerate(lines)
        if any(FWD_TC_KERNEL in lines[j] for j in range(max(0, i - 2), i + 1))]}), flush=True)
    hmma = {"new": hmma_counts(_build.library_path(), "conv3x3"),
            "earlier": hmma_counts(_build.BUILD_DIR / name, "conv3x3")}
    new_hmma = {k: v for k, v in hmma["new"].items() if FWD_TC_KERNEL in k}
    print(json.dumps({"hmma": hmma, "new_kernel_hmma": new_hmma}), flush=True)
    failed = [] if new_hmma and all(new_hmma.values()) else [f"no HMMA in {FWD_TC_KERNEL}"]
    libs = {"new": new, "earlier": Routed(new, parent, {
        "mgt_modconv3x3_fwd_bf16": "mgt_modconv3x3_fwd_bf16"})}
    gen = torch.Generator(device="cuda").manual_seed(16)
    f32 = torch.float32
    rows = []
    for res, c, last in K1_CALLS:
        args = bf16_forward_args(gen, res, c, last)
        x, w, s, noise, bias, resid = args[:6]
        where = f"G b{res} {'conv_last' if last else 'conv1'}"
        row = dict(role="K1-forward bf16", block=f"G b{res}",
                   layer="conv_last" if last else "conv1", batch=1)
        lib_of = {"new": new, "earlier": parent}
        launch = {k: bare_forward(lib_of[k], args) for k in ("earlier", "new")}
        for v in launch.values():
            v[0]()
        plain = fc.modconv3x3_plain(*args)
        wide = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                     else a for a in args)
        ref = fc.modconv3x3_plain(*wide)
        wrapper = fc.fused_modconv3x3(*args)
        # The float32 forward, adjoint and K4 of both builds on the same float32 inputs.
        g = torch.randn(x.shape[:3] + (c,), generator=gen, device=x.device)
        f32_out = {}
        for k in ("earlier", "new"):
            def f32_run():
                y = fc.fused_modconv3x3(*wide)
                adj = fc.modconv3x3_adjoint(g, *wide[:3], y, *wide[3:])
                return [y, *[t for t in adj if t is not None], k4.conv3x3_forward(wide[0], w),
                        k4.conv3x3_dx(g, w)]
            f32_out[k] = _with_library(lib_of[k], f32_run)
        torch.cuda.synchronize()
        ep = _errs((plain,), (ref,))
        for k in ("earlier", "new"):
            row[f"err_{k}"], row[f"err_mean_{k}"] = _errs((launch[k][1],), (ref,))
        row["err_plain"], row["err_mean_plain"] = ep
        row["err_ratio"] = row["err_new"] / max(ep[0], 1e-30)
        row["err_mean_ratio"] = row["err_mean_new"] / max(ep[1], 1e-30)
        row["wrapper_equals_bare"] = bool(torch.equal(wrapper, launch["new"][1]))
        row["f32_equal"] = all(bool(torch.equal(a, b))
                               for a, b in zip(f32_out["earlier"], f32_out["new"]))
        t = {}
        for k in ("earlier", "new", "new", "earlier"):
            t.setdefault(k, []).append(cuda_ms(launch[k][0], reps=20))
        x_nchw = x.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
        for k, run in (("wrapper", lambda: fc.fused_modconv3x3(*args)),
                       ("plain", lambda: fc.modconv3x3_plain(*args)),
                       ("library", lambda: F.conv2d(x_nchw, w_lib, padding=1))):
            t[k] = [cuda_ms(run)]
        own, _ = device_split(lambda: fc.fused_modconv3x3(*args), FWD_TC_KERNEL)
        flops = 2 * res * res * 9 * c * c
        elements = sum(t_.numel() for t_ in (x, w, noise, resid) if t_ is not None) + x.numel()
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                   new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                   new_kernel_device_ms=own, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        row["bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        tol = max(BF16_RATIO * ep[0], BF16_FLOOR)
        for k in ("err_new", "err_earlier"):
            if not row[k] <= tol:
                failed.append(f"{where} {k} {row[k]} > {tol}")
        for k, what in (("wrapper_equals_bare", "the wrapper's y differs from the bare launch's"),
                        ("f32_equal", "the float32 K1 or K4 differs between the builds")):
            if not row[k]:
                failed.append(f"{where}: {what}")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{where}: new {t['new']} not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    sums = {k: sum(r[k] for r in rows)
            for k in ("new_ms", "earlier_ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
                      "new_kernel_device_ms")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    print_step_means(bf16_step_ab(libs), smi)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and torch.cuda.is_available():
        if sys.argv[1] == "--bf16":
            sys.exit(bf16_main(sys.argv[2]))
        if sys.argv[1] == "--bf16-fwd":
            sys.exit(bf16_fwd_main(sys.argv[2]))
    sys.exit(main(sys.argv))
