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


if __name__ == "__main__":
    sys.exit(main(sys.argv))
