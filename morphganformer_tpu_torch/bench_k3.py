"""K3 in both roles on one card: the least-work kernel against an earlier
build of K3 that evaluates the FIR-composed kernel per input parity.

    mkdir -p build
    git show c15953e:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k3_parent.cu
    python -m morphganformer_tpu_torch.bench_k3 build/k3_parent.cu

The earlier source is that of commit c15953e, whose `mgt_upconv2_bwd` and
`mgt_downconv2_fwd` take the parity taps of the composed kernel
(`upconv2_adjoint_kernels`, `downconv2_parity_kernels`). It is built with
the same nvcc flags into morphganformer_tpu_torch/_build/ under a name of
its own, and reached only from here.

At each call shape of the two roles (the 6 K3-adjoint shapes of a 1024^2
projection step at batch 1; the 4 K3-forward shapes of a 1024^2 training
iteration at batch 4) both kernels are held against the plain version on the
same random inputs (dx and ds/dd within 1e-4 of each one's largest entry;
the forward within 1e-3 abs, as chip_smoke.py holds them), then timed with
CUDA events in the order earlier, new, new, earlier, beside the plain
version, one cuDNN call of the bare convolution without the FIR, and one
`F.conv2d` of the FIR-composed kernel at stride 2 (the same convolution in
one PyTorch call); one call of the new wrapper under torch.profiler splits
its device time into the kernel's own and the torch ops around it. Prints one JSON line per shape, then the card and the
sums; exits non-zero if a check fails. Needs a CUDA card.

With --bf16, K3's bfloat16 adjoint (`mgt_upconv2_bwd_bf16`, on the tensor
cores: `downconv2_tc_kernel`, which forms gd from g, y and d itself)
against an earlier build of the same entry point, which takes gd formed in
torch:

    git show de47318:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k3_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_k3 --bf16 build/k3_bf16_parent.cu

(de47318's is the float32 least-work kernel with bfloat16 loads.) At the
six K3-adjoint shapes of a 1024^2 projection step at batch 1, on inputs made
as chip_smoke.py's `check_bf16` makes them (seed 16), both builds are held
against the float32 plain version on the same bfloat16 inputs by its rule
(error at most BF16_RATIO times the plain bfloat16 version's, or within
BF16_FLOOR of the largest entry), dx, the ds dot and the dd taps, the
largest and the mean error each beside the plain version's. Then, in the
order earlier, new, new, earlier: each build's bare launch on operands
made once (CUDA events; the kernel alone; the earlier one on gd formed
once), the earlier route with gd formed in torch each call, and the float32
adjoint (`mgt_upconv2_bwd`, whose kernel the new build leaves as it was)
of both builds on the same inputs in float32, its outputs bit-equal; then
the new wrapper `upconv2_adjoint`, the plain bfloat16 version, cuDNN's
bfloat16 call of the bare convolution, and the same-function call in
bfloat16 with torch.backends.cudnn.benchmark off and on; the kernel's own
device time in one wrapper call under torch.profiler; the bf16 bound. It
prints the HMMA count of each build's K3 kernels (cuobjdump -sass). Last,
traced bfloat16 1024^2 projection steps (init:1024, one MSE step as
chip_smoke.py traces it), earlier, new, new, earlier: on the earlier route
K3's adjoint forms gd in torch and launches the earlier build (the wrapper
of de47318): device ms, device ops and each kernel's device ms, and the
host ms of an untraced step. Exits non-zero if a check fails, if the new
kernel has no HMMA, if the float32 outputs differ, or if the new bf16
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

from morphganformer_tpu_torch.ops import _build
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.conv2d_resample import _compose_kernel_fir
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    "mgt_downconv2_fwd": [_P] * 5 + [_I] * 8 + [_F, _F, _I, _P],
    "mgt_bwd_tiles": [_I, _I],
    "mgt_upconv2_bwd": [_P] * 10 + [_I] * 8 + [_F, _F, _I, _I, _P],
}


def same_function_call(role, w, f, flip_weight):
    """The one PyTorch call that computes a K2/K3 role's convolution with the
    FIR composed in: (op, weight, padding) for op(t, weight, stride=2,
    padding=padding) on an NCHW t. A yardstick only: the port never calls it.

      "K3-forward"  F.conv2d of x [N,I,2H,2W] -> [N,O,H,W] (the D down-conv)
      "K3-adjoint"  F.conv2d of gd [N,O,2H,2W] -> du [N,I,H,W] (K2's adjoint)
      "K2"          F.conv_transpose2d of x [N,I,H,W] -> [N,O,2H,2W]
      "K2-use_dw"   F.conv_transpose2d of gz [N,O,H,W] -> dx [N,I,2H,2W]

    The up-conv's composed correlation K (gain 4, left pad p0 = kh//2 + 2)
    read from the other end is the stride-2 correlation of its adjoint and
    the kernel of its transposed-conv form, padding L - 1 - p0; the
    down-conv's (left pad q0 = kh//2 + 1) serves its forward and, as a
    transposed conv, its adjoint."""
    kh = int(w.shape[0])
    if role in ("K3-adjoint", "K2"):
        k = _compose_kernel_fir(w, f, flip_weight, False, gain=4.0)
        op = F.conv2d if role == "K3-adjoint" else F.conv_transpose2d
        return op, k.flip((0, 1)).permute(2, 3, 0, 1).contiguous(), int(k.shape[0]) - 3 - kh // 2
    k = _compose_kernel_fir(w, f, flip_weight, False)
    op = F.conv2d if role == "K3-forward" else F.conv_transpose2d
    return op, k.permute(3, 2, 0, 1).contiguous(), kh // 2 + 1


def load_parent(source, signatures=PARENT_SIGNATURES, name="libmgt_k3_parent.so"):
    """Build an earlier fused_conv.cu with the same nvcc flags into
    morphganformer_tpu_torch/_build/`name` and set `signatures` on it."""
    out = _build.BUILD_DIR / name
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(_build.build_command(out, _build.nvcc_path(), source),
                          capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return dev.index or 0, torch.cuda.current_stream(dev).cuda_stream


def _call(lib, fn, *args):
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} (earlier build) failed to launch: CUDA error {rc}")


def parent_adjoint(lib, g, x, w, styles, f, y, noise, bias, gain, alpha, demod):
    """The earlier K3 adjoint launch (its wrapper at commit c15953e)."""
    need_ds = styles is not None
    mask, gd, d = fc._adjoint_gd(g, y, w, styles, gain, alpha, demod)
    need_dd = need_ds and d is not None
    n, h, wd, c = x.shape
    o = gd.shape[-1]
    dev = x.device
    wt, (hb0, hb1) = fc.upconv2_adjoint_kernels(w, f, False)
    nblk = lib.mgt_bwd_tiles(h, wd)
    dx = torch.empty((n, h, wd, c), device=dev)
    dot = torch.empty((n, nblk, c), device=dev) if need_ds else None
    dd = [torch.empty((n, nblk, o), device=dev) if need_dd else None for _ in range(2)]
    _call(lib, "mgt_upconv2_bwd", gd.data_ptr(), wt.data_ptr(), _ptr(styles),
          _ptr(x if need_ds else None), _ptr(y if need_dd else None),
          _ptr(noise if need_dd else None), dx.data_ptr(), _ptr(dot), _ptr(dd[0]), _ptr(dd[1]),
          n, h, wd, o, c, int(wt.shape[2]), hb0, hb1, float(gain), float(alpha), 0, *_stream(dev))
    ds = dd1 = dd2 = None
    if need_ds:
        ds = dot.sum(1)
    if need_dd:
        dd1, dd2 = dd[0].sum(1), dd[1].sum(1)
        ds = fc._demod_chain(ds, fc._demod_de(dd1, dd2, d, bias), w, styles)
    return dx, ds, dd1, dd2


def parent_forward(lib, x, w, f, bias, resid, gain, alpha):
    """The earlier K3-forward launch (its wrapper at commit c15953e)."""
    n, h2, w2, ci = x.shape
    h, wd = h2 // 2, w2 // 2
    wf, hb = fc.downconv2_parity_kernels(w, f, True)
    nt, co = int(wf.shape[2]), int(wf.shape[-1])
    y = torch.empty((n, h, wd, co), device=x.device)
    _call(lib, "mgt_downconv2_fwd", x.data_ptr(), wf.data_ptr(), _ptr(bias), _ptr(resid),
          y.data_ptr(), n, h, wd, ci, co, nt, hb[0], hb[1], float(gain), float(alpha),
          *_stream(x.device))
    return y


def cuda_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_split(fn, kernel="downconv2_lw_kernel"):
    """(the device ms of the kernel named `kernel`, every device op's ms) of
    one call of `fn` under torch.profiler, after one warm call: how much of
    the wrapper's time is the kernel and how much the torch around it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    own = total = 0.0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        ms = (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) / 1e3
        total += ms
        own += ms if kernel in e.key else 0.0
    return own, total


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def adjoint_case(lib, gen, res, cin, cout, skip):
    """K3 adjoint at the K2 call (res, cin -> cout), batch 1, as chip_smoke.py
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
    y = fc.upconv2_plain(x, w, styles, f, noise, bias, gain, alpha, not skip, False)
    g = randn(*y.shape)
    args = (g, x, w, styles, f, y, noise, bias, gain, alpha, not skip, False)
    want = fc.upconv2_adjoint_plain(*args)
    runs = {"new": lambda: fc.upconv2_adjoint(*args),
            "earlier": lambda: parent_adjoint(lib, g, x, w, styles, f, y, noise, bias, gain,
                                              alpha, not skip),
            "plain": lambda: fc.upconv2_adjoint_plain(*args)}
    errs = {}
    for name in ("new", "earlier"):
        got = runs[name]()
        errs[name] = max(_rel_err(a, b) for a, b in zip(got, want) if b is not None)
    g_nchw = g.permute(0, 3, 1, 2)
    w_bare = w.permute(2, 3, 0, 1).contiguous()
    if skip:
        g_bare = torch.randn((1, cout, h, h), generator=gen, device=dev)
        runs["library"] = lambda: F.conv2d(g_bare, w_bare)
    else:
        runs["library"] = lambda: F.conv2d(g_nchw, w_bare, stride=2, padding=1)
    op, k_same, pad = same_function_call("K3-adjoint", w, f, False)
    runs["same_function"] = lambda: op(g_nchw, k_same, stride=2, padding=pad)
    assert runs["same_function"]().shape == (1, cin, h, h)
    flops = 2 * (2 * h) ** 2 * 8 * cout + 2 * h * h * kh * kh * cin * cout
    nbytes = 4 * (g.numel() + x.numel())
    if not skip:
        flops += 2 * h * h * cin + 4 * (2 * h) ** 2 * cout
        nbytes += 4 * (x.numel() + y.numel() + noise.numel())
    return dict(role="K3-adjoint", block=f"G b{res}", layer="skip" if skip else "conv0",
                batch=1, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-4,
                rel=True), runs, flops, nbytes


def forward_case(lib, gen, res, cin, skip):
    """K3 forward at the D call (res, cin -> 2 cin), batch 4, as chip_smoke.py
    phase train makes it."""
    dev = torch.device("cuda")
    n, h, cout, kh = 4, res // 2, 2 * cin, (1 if skip else 3)
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    f = setup_filter([1, 3, 3, 1]).to(dev)
    x = randn(n, 2 * h, 2 * h, cin)
    b = None if skip else randn(cout, scale=0.1)
    r = None if skip else randn(n, h, h, cout)
    gain, alpha = (math.sqrt(0.5), 1.0) if skip else (1.0, 0.2)
    want = fc.downconv2_plain(x, w, f, b, r, gain, alpha)
    runs = {"new": lambda: fc.fused_downconv2(x, w, f, b, r, gain, alpha),
            "earlier": lambda: parent_forward(lib, x, w, f, b, r, gain, alpha),
            "plain": lambda: fc.downconv2_plain(x, w, f, b, r, gain, alpha)}
    errs = {name: (runs[name]() - want).abs().max().item() for name in ("new", "earlier")}
    x_nchw = x.permute(0, 3, 1, 2)
    w_bare = w.permute(3, 2, 0, 1).contiguous()
    runs["library"] = lambda: F.conv2d(x_nchw, w_bare, stride=2, padding=kh // 2)
    op, k_same, pad = same_function_call("K3-forward", w, f, True)
    runs["same_function"] = lambda: op(x_nchw, k_same, stride=2, padding=pad)
    assert runs["same_function"]().shape == (n, cout, h, h)
    fir = 2 * n * (2 * h) ** 2 * (3 if skip else 8) * cin
    flops = 2 * n * h * h * kh * kh * cin * cout + fir
    nbytes = 4 * (x.numel() + w.numel() + n * h * h * cout * (1 if skip else 2) +
                  (0 if skip else cout))
    return dict(role="K3-forward", block=f"D b{res}", layer="skip" if skip else "conv1",
                batch=n, err_new=errs["new"], err_earlier=errs["earlier"], tol=1e-3,
                rel=False), runs, flops, nbytes


def main(argv):
    if len(argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = load_parent(Path(argv[1]))
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [adjoint_case(lib, gen, res, cin, cout, skip)
             for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32))
             for skip in (False, True)]
    cases += [forward_case(lib, gen, res, cin, skip)
              for res, cin in ((1024, 32), (512, 64)) for skip in (False, True)]
    rows, failed = [], []
    for row, runs, flops, nbytes in cases:
        t = {}
        for name in ("earlier", "new", "new", "earlier"):
            t.setdefault(name, []).append(cuda_ms(runs[name]))
        for name in ("plain", "library", "same_function"):
            t[name] = [cuda_ms(runs[name], reps=5, warmup=1)]
        kernel_ms, device_ms = device_split(runs["new"])
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
            for role in ("K3-adjoint", "K3-forward")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


# The earlier build's K3 adjoints: gd, wk, fir, s, x, y, noise, dx, dot, dd1, dd2, N, H, W,
# O, C, kh, pad, gain, alpha, noise_ns, device, stream (the float32 one unchanged).
_BWD = [_P] * 11 + [_I] * 7 + [_F, _F, _I, _I, _P]
BF16_PARENT_SIGNATURES = {"mgt_upconv2_bwd_bf16": _BWD, "mgt_upconv2_bwd": _BWD,
                          "mgt_downconv2_tiles": [_I, _I]}
TC_KERNEL, EARLIER_KERNEL = "downconv2_tc_kernel", "downconv2_lw_kernel"


def bf16_adjoint_args(gen, res, cin, cout, skip):
    """K3's bf16 adjoint at the K2 call (res, cin -> cout), batch 1, made as
    chip_smoke.py's check_bf16 makes it: the arguments of upconv2_adjoint."""
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
    y = fc.upconv2_plain(x, w, styles, f, noise, bias, gain, alpha, not skip, False)
    g = randn(*y.shape).to(bf)
    return (g, x, w, styles, f, y, noise, bias, gain, alpha, not skip, False)


def parent_bf16_taps(lib, gd, x, w, styles, f, flip_weight, y, noise, gain, alpha, need_dx,
                     need_ds, need_dd):
    """The earlier bf16 K3 adjoint launch on gd (its wrapper at de47318)."""
    wk, fk, pad = fc.upconv2_adjoint_leastwork(w, f, flip_weight)
    n, ho, wo, o = gd.shape
    h, wd, c = ho // 2, wo // 2, w.shape[2]
    dev, dt = gd.device, gd.dtype
    outs = fc._adjoint_outputs(n, h, wd, c, o, lib.mgt_downconv2_tiles(h, wd), need_dx, need_ds,
                               need_dd, dev, dt)
    wk, nz = fc._as(wk, dt), fc._as(noise if need_dd else None, dt)
    noise_p, noise_ns = fc._check_noise("noise", nz, n, ho, wo, dev, dt)
    _call(lib, "mgt_upconv2_bwd_bf16", gd.data_ptr(), wk.data_ptr(), fk.data_ptr(), _ptr(styles),
          _ptr(x if need_ds else None), _ptr(y.contiguous() if need_dd else None), noise_p,
          *(_ptr(t) for t in outs), n, h, wd, o, c, int(wk.shape[0]), pad, float(gain),
          float(alpha), noise_ns, *_stream(dev))
    return fc._summed(*outs)


def _closed(outs, args, d):
    """(dx, ds, dd1, dd2) from a launch's outputs, summed and closed through
    the demodulation as upconv2_adjoint closes them."""
    g, x, w, styles, f, y, noise, bias = args[:8]
    dx, dot, dd1, dd2 = fc._summed(*outs)
    if dd1 is not None:
        dot = fc._demod_chain(dot, fc._demod_de(dd1, dd2, d, bias), w, styles)
    return dx, dot, dd1, dd2


def _errs(got, ref):
    """(largest, mean) error over the outputs: each output's largest
    absolute difference over its largest entry, and its mean absolute
    difference over its mean magnitude."""
    ex = em = 0.0
    for a, r in zip(got, ref):
        if r is not None:
            diff = (a.float() - r).abs()
            ex = max(ex, diff.max().item() / max(r.abs().max().item(), 1e-30))
            em = max(em, diff.mean().item() / max(r.abs().mean().item(), 1e-30))
    return ex, em


def _operands(lib, args, dt):
    """The least-work operands of a K3 adjoint launch of `lib` in type dt: (gt, xt,
    yt, gd formed in torch, wk, fk, noise for the dd taps, d, the arguments
    after the outputs, the partials' blocks)."""
    g, x, w, styles, f, y, noise, bias, gain, alpha, demod, flip = args
    wk, fk, pad = fc.upconv2_adjoint_leastwork(w, f, flip)
    n, ho, wo, o = g.shape
    h, wd, c = ho // 2, wo // 2, int(w.shape[2])
    d = fc.demod_coef(w, styles).contiguous() if (styles is not None and demod) else None
    gt, xt, yt = (t.to(dt).contiguous() for t in (g, x, y))
    gd = fc._adjoint_gd(gt, yt, w, styles, gain, alpha, demod)[1].contiguous()
    nz = noise.to(dt).contiguous() if d is not None else None
    tail = (n, h, wd, o, c, int(wk.shape[0]), pad, float(gain), float(alpha), 0,
            *_stream(g.device))
    nblk = lib.mgt_downconv2_tiles(h, wd)
    return gt, xt, yt, gd, wk.to(dt).contiguous(), fk, nz, d, tail, nblk


def bare_bf16(lib, args):
    """A bare launch of `mgt_upconv2_bwd_bf16` (downconv2_tc_kernel) of `lib`
    on operands made once: (launch, its outputs, the tensors it points
    into)."""
    styles, alpha = args[3], args[9]
    gt, xt, yt, gd, wk, fk, nz, d, tail, nblk = _operands(lib, args, torch.bfloat16)
    n, h, wd, o, c = tail[:5]
    outs = fc._adjoint_outputs(n, h, wd, c, o, nblk, True, styles is not None, d is not None,
                               gt.device, gt.dtype)
    ptrs = [gt.data_ptr(), wk.data_ptr(), fk.data_ptr(), _ptr(styles), _ptr(d),
            _ptr(xt if styles is not None else None),
            _ptr(yt if d is not None or alpha != 1.0 else None), _ptr(nz)]
    launch = functools.partial(_call, lib, "mgt_upconv2_bwd_bf16", *ptrs,
                               *(_ptr(t) for t in outs), *tail)
    return launch, outs, (gt, xt, yt, wk, fk, nz, d)


def bf16_launches(libs, args):
    """Bare launches of each build's K3 adjoint on operands made once, in
    bfloat16 and float32: {(build, dtype): (launch, its outputs)}, and
    "earlier_route": the earlier bf16 launch with gd formed in torch each
    call; d; the tensors the launches point into."""
    g, x, w, styles, f, y, noise, bias, gain, alpha, demod, flip = args
    bf = torch.bfloat16
    runs, keep = {}, []
    launch, outs, kept = bare_bf16(libs["new"], args)
    runs["new", bf] = (launch, outs)
    keep.append(kept)
    for dt in (bf, torch.float32):
        gt, xt, yt, gd, wk, fk, nz, d, tail, nblk = _operands(libs["new"], args, dt)
        n, h, wd, o, c = tail[:5]
        keep.append((gt, xt, yt, gd, wk, fk, nz))
        ptrs = [wk.data_ptr(), fk.data_ptr(), _ptr(styles),
                _ptr(xt if styles is not None else None), _ptr(yt if d is not None else None),
                _ptr(nz)]
        fn = "mgt_upconv2_bwd" + ("_bf16" if dt == bf else "")
        for build in ("earlier", "new") if dt == torch.float32 else ("earlier",):
            outs = fc._adjoint_outputs(n, h, wd, c, o, nblk, True, styles is not None,
                                       d is not None, g.device, dt)
            out_ptrs = [_ptr(t) for t in outs]
            runs[build, dt] = (functools.partial(_call, libs[build], fn, gd.data_ptr(), *ptrs,
                                                 *out_ptrs, *tail), outs)
        if dt == bf:
            runs["earlier_route"] = lambda gt=gt, yt=yt, ptrs=ptrs, out_ptrs=out_ptrs, tail=tail: (
                _call(libs["earlier"], "mgt_upconv2_bwd_bf16",
                      fc._adjoint_gd(gt, yt, w, styles, gain, alpha, demod)[1].data_ptr(),
                      *ptrs, *out_ptrs, *tail))
    return runs, d, keep


def bf16_step_ab(parent):
    """Traced bfloat16 1024^2 projection steps, earlier, new, new, earlier
    (see the module's docstring)."""
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
    new_taps = fc._k3_taps

    def earlier_taps(g, gd_of, x, w, styles, f, flip_weight, d, y, noise, gain, alpha, *need):
        return parent_bf16_taps(parent, gd_of().contiguous(), x, w, styles, f, flip_weight, y,
                                noise, gain, alpha, *need)

    kernels = (TC_KERNEL, EARLIER_KERNEL, "upconv2_tc_kernel", "conv3x3_lw_kernel")
    rows = []
    try:
        for name in ("earlier", "new", "new", "earlier"):
            fc._k3_taps = earlier_taps if name == "earlier" else new_taps
            loss_and_grad(G, latent, target, loss_fn, pcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_and_grad(G, latent, target, loss_fn, pcfg)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
            _, _, out = traced_run(lambda: loss_and_grad(G, latent, target, loss_fn, pcfg),
                                   kernels)
            row = dict(route=name, step_ms=host_ms, window_ms=out["window_ms"],
                       busy_ms=out["busy_ms"], device_ops=out["launches"],
                       kernels=out["kernels"])
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        fc._k3_taps = new_taps
    return rows


def bf16_main(parent_source):
    """`--bf16`: see the module's docstring."""
    from morphganformer_tpu_torch.bench_k2 import BF16_FLOOR, BF16_RATIO, PEAK_BF16_FLOPS
    from morphganformer_tpu_torch.bench_k2 import hmma_counts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = "libmgt_k3_bf16_parent.so"
    parent = load_parent(Path(parent_source), BF16_PARENT_SIGNATURES, name)
    libs = {"new": _build.library(), "earlier": parent}
    hmma = {"new": hmma_counts(_build.library_path(), "downconv2"),
            "earlier": hmma_counts(_build.BUILD_DIR / name, "downconv2")}
    new_hmma = sum(v for k, v in hmma["new"].items() if TC_KERNEL in k)
    print(json.dumps({"hmma": hmma, "new_kernel_hmma": new_hmma}), flush=True)
    failed = [] if new_hmma > 0 else [f"no HMMA in {TC_KERNEL}"]
    gen = torch.Generator(device="cuda").manual_seed(16)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        for skip in (False, True):
            args = bf16_adjoint_args(gen, res, cin, cout, skip)
            g, x, w, styles, f, y, noise = args[:7]
            h, kh = res // 2, (1 if skip else 3)
            where = f"G b{res} {'skip' if skip else 'conv0'}"
            row = dict(role="K3-adjoint bf16", block=f"G b{res}",
                       layer="skip" if skip else "conv0", batch=1)
            launch, d, _keep = bf16_launches(libs, args)
            for k in ("earlier", "new"):
                for dt in (bf, f32):
                    launch[k, dt][0]()
            plain = fc.upconv2_adjoint_plain(*args)
            wide = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == bf else a
                         for a in args)
            ref = fc.upconv2_adjoint_plain(*wide)
            wrapper = fc.upconv2_adjoint(*args)
            torch.cuda.synchronize()
            got = {k: _closed(launch[k, bf][1], args, d) for k in ("earlier", "new")}
            ep = _errs(plain, ref)
            for k in ("earlier", "new"):
                row[f"err_{k}"], row[f"err_mean_{k}"] = _errs(got[k], ref)
            row["err_plain"], row["err_mean_plain"] = ep
            row["err_ratio"] = row["err_new"] / max(ep[0], 1e-30)
            row["err_mean_ratio"] = row["err_mean_new"] / max(ep[1], 1e-30)
            row["wrapper_equals_bare"] = all(
                (a is None and b is None) or bool(torch.equal(a, b))
                for a, b in zip(wrapper[:1], got["new"][:1]))
            row["f32_equal"] = all(
                (a is None and b is None) or bool(torch.equal(a, b))
                for a, b in zip(launch["earlier", f32][1], launch["new", f32][1]))
            t = {}
            for k in ("earlier", "new", "new", "earlier"):
                t.setdefault(k, []).append(cuda_ms(launch[k, bf][0], reps=20))
                t.setdefault(f"f32_{k}", []).append(cuda_ms(launch[k, f32][0], reps=20))
                if k == "earlier":
                    t.setdefault("earlier_route", []).append(cuda_ms(launch["earlier_route"]))
            g_nchw = g.permute(0, 3, 1, 2)
            w_lib = w.permute(2, 3, 0, 1).to(bf).contiguous()
            if skip:
                g_lib = torch.randn((1, cout, h, h), generator=gen, device="cuda").to(bf)
                lib_call = lambda: F.conv2d(g_lib, w_lib)  # noqa: E731
            else:
                lib_call = lambda: F.conv2d(g_nchw, w_lib, stride=2, padding=1)  # noqa: E731
            op, w_same, pad_same = same_function_call("K3-adjoint", w, f, False)
            w_same = w_same.to(bf)
            same = lambda: op(g_nchw, w_same, stride=2, padding=pad_same)  # noqa: E731
            for k, run in (("wrapper", lambda: fc.upconv2_adjoint(*args)),
                           ("plain", lambda: fc.upconv2_adjoint_plain(*args)),
                           ("library", lib_call), ("same_function", same)):
                t[k] = [cuda_ms(run)]
            torch.backends.cudnn.benchmark = True
            t["same_function_benchmark"] = [cuda_ms(same, warmup=3)]
            torch.backends.cudnn.benchmark = False
            own, _ = device_split(lambda: fc.upconv2_adjoint(*args), TC_KERNEL)
            flops = 2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout
            elements = g.numel() + x.numel()                        # g in, dx out
            if not skip:
                flops += 2 * h * h * cin + 4 * (2 * h) ** 2 * cout
                elements += x.numel() + y.numel() + noise.numel()
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
            if not row["wrapper_equals_bare"]:
                failed.append(f"{where}: the wrapper's dx differs from the bare launch's")
            if not row["f32_equal"]:
                failed.append(f"{where}: the float32 adjoint differs between the builds")
            if not max(t["new"]) < min(t["earlier"]):
                failed.append(f"{where}: new {t['new']} not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    sums = {k: sum(r[k] for r in rows)
            for k in ("new_ms", "earlier_ms", "earlier_route_ms", "wrapper_ms", "plain_ms",
                      "library_ms", "same_function_ms", "same_function_benchmark_ms",
                      "bound_ms", "new_kernel_device_ms", "f32_new_ms", "f32_earlier_ms")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    step = bf16_step_ab(parent)
    print(smi, flush=True)
    print(json.dumps({"step": {r: {k: sum(x[k] for x in step if x["route"] == r) / 2
                                   for k in ("step_ms", "busy_ms", "device_ops")}
                               for r in ("earlier", "new")}}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--bf16" and torch.cuda.is_available():
        sys.exit(bf16_main(sys.argv[2]))
    sys.exit(main(sys.argv))
