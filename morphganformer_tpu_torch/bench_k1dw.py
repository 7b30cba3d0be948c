"""K1's weight cotangent (`conv_dw`, the least-work `conv_dw_lw_kernel`) on
one card, against an earlier build whose kernel (`conv_dw_kernel`) takes one
tap a block.

    mkdir -p build
    git show 9b95557:morphganformer_tpu_torch/csrc/fused_conv.cu > build/k1dw_parent.cu
    python -m morphganformer_tpu_torch.bench_k1dw build/k1dw_parent.cu
    python -m morphganformer_tpu_torch.bench_k1dw build/k1dw_parent.cu --iteration

The earlier source is that of commit 9b95557; it is built with the same
nvcc flags into morphganformer_tpu_torch/_build/ under a name of its own
and reached only from here, through a copy of that commit's wrapper.

At each of the 6 call shapes of K1's dw in a 1024^2 training iteration at
batch 4 (G b256, b512, b1024 conv1 and b1024 conv_last with styles; D b1024
and b512 conv0 without; chip_smoke.py `train_calls`) both builds are held
against `conv_dw_plain` on the same random inputs (within 1e-4 of its
largest entry, as chip_smoke.py holds them; the same-function call within
1e-3), then timed with CUDA events in the order earlier, new, new,
earlier, beside the plain version, one cuDNN `conv2d_weight` of the bare x
and gd, and the same function in one PyTorch call (`same_function_call`:
`conv2d_weight` of x * s and gd, the multiply included). One call of each
under torch.profiler splits its device time into the kernel's own and the
torch around it (the partials' sum). Prints the compiler's register and
spill report, one JSON line per shape, then the card and the sums; exits
non-zero if a check fails or the new kernel is not faster than the earlier
one at some shape.

With --iteration it times, instead, whole first-order training iterations
(bench_dw `iteration_ab`: FFHQ-1024 and a 1024^2 D from seed 0, batch 4,
steps that run G_main and D_main only, in turns earlier, new, new, earlier
of one untraced and two traced iterations), where "earlier" routes K1's
dw through the earlier build (everything else the same): the device's
busy time and each hand-written kernel's device time. Needs a CUDA card.

With --bf16, K1's bfloat16 dw (`mgt_conv_dw_bf16`, on the tensor cores:
`conv_dw_tc_kernel`) against the build of 3932729, whose entry point of the
same signature runs the float32 least-work kernel on bfloat16 operands
(`conv_dw_lw_kernel`, FMA):

    git show 3932729:morphganformer_tpu_torch/csrc/fused_conv.cu > build/tc_train_parent.cu
    python -m morphganformer_tpu_torch.bench_k1dw --bf16 build/tc_train_parent.cu
    python -m morphganformer_tpu_torch.bench_k1dw --bf16 build/tc_train_parent.cu --iteration

At the same 6 shapes at batch 4 and at the reg route's `wg` of G at batch
2 (no styles; D's are the batch-4 shapes without styles), on bfloat16 x and
gd, both builds' bare launches (their partials, each build's slices) are
held against the float32 sum of the same bfloat16 products
(`conv_dw_plain`, to 1e-4 of its largest entry) and against float32 on
the same inputs by chip_smoke.py's bf16 rule beside the plain version's
error, then timed with CUDA events in the order earlier, new, new,
earlier, with the float32 `mgt_conv_dw` of both builds on the same inputs
in float32 (bit-equal, and timed in the same turns); then the new wrapper
(the launch and the partials' sum), the plain version, cuDNN's bfloat16
`conv2d_weight` of the bare x and gd and the same-function call in
bfloat16 (`conv2d_weight` of bf16(x * s), formed once outside the timed
call, and gd) with
torch.backends.cudnn.benchmark off and on; the kernel's own device time in
one wrapper call under torch.profiler; the bf16 bound. It prints the
builds' ptxas lines and HMMA counts (cuobjdump -sass). Exits non-zero if a
check fails, if the new kernel has no HMMA, if the float32 outputs differ,
or if the new launch is not faster than the earlier build's at some shape.
With --iteration it times, instead, traced bfloat16 iterations (G_main and
D_main, `iteration_ab` on bfloat16 G and D), where "earlier" routes both
roles that moved to the tensor cores here, K1's dw and K3's D-tower
forward, through the earlier build.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.nn.grad import conv2d_weight

from morphganformer_tpu_torch.bench_dw import PARENT_DW_BLOCKS, iteration_ab
from morphganformer_tpu_torch.bench_k1 import ptxas_report, traced
from morphganformer_tpu_torch.bench_k3 import (PEAK_BYTES, PEAK_FP32_FLOPS, _call, _stream,
                                               cuda_ms, load_parent)
from morphganformer_tpu_torch.ops import _build
from morphganformer_tpu_torch.ops import fused_conv as fc

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    # x, gd, s, part, N, H, W, Cin, Cout, slices, chunks_per_slice, device, stream
    "mgt_conv_dw": [_P] * 4 + [_I] * 7 + [_I, _P],
    "mgt_dw_chunk": [],
}
PARENT_KERNEL = "conv_dw_kernel"
KERNEL = "conv_dw_lw_kernel"
# The hand-written kernels whose device time a traced iteration reports.
ITERATION_KERNELS = (KERNEL, PARENT_KERNEL, "conv3x3_lw_kernel", "upconv2_lw_kernel",
                     "downconv2_lw_kernel", "fir_dw_kernel")
BATCH = 4
# The same-function call is held only to show that it computes K1's dw:
# cuDNN's weight-gradient algorithm at 64 and 128 channels rounds to about
# 1e-4 of the largest entry on its own (1.2e-4 and 1.4e-4 at G b512 and D
# b512 on an H100), where both builds' kernels stay within 3e-6.
SAME_FUNCTION_TOL = 1e-3
# (block, layer, resolution, C = O, styles): chip_smoke.py's `train_calls`
# of K1's dw.
SHAPES = [("G b256", "conv1", 256, 128, True), ("G b512", "conv1", 512, 64, True),
          ("G b1024", "conv1", 1024, 32, True), ("G b1024", "conv_last", 1024, 32, True),
          ("D b1024", "conv0", 1024, 32, False), ("D b512", "conv0", 512, 64, False)]


def same_function_call(x, gd, s):
    """The one PyTorch call that computes K1's dw taps: `conv2d_weight` of
    x * s (the multiply included) and gd, NCHW, -> [O, C, 3, 3]. A
    yardstick only: the port never calls it. x [N,H,W,C], gd [N,H,W,O], s
    [N,C] or None; returns the call."""
    shape = (gd.shape[-1], x.shape[-1], 3, 3)

    def call():
        xs = x if s is None else x * s[:, None, None, :]
        return conv2d_weight(xs.permute(0, 3, 1, 2), shape, gd.permute(0, 3, 1, 2), padding=1)
    return call


def parent_dw(lib, x, gd, s):
    """The earlier dw launch, one tap a block (its wrapper at commit
    9b95557, for channel counts in 32s)."""
    n, h, wd, ci = x.shape
    co = gd.shape[-1]
    chunks = -(-n * h * wd // lib.mgt_dw_chunk())
    per_slice = 9 * (ci // 32) * (co // 32)
    per = -(-chunks // max(1, min(chunks, -(-PARENT_DW_BLOCKS // per_slice))))
    slices = -(-chunks // per)
    part = torch.empty((slices, 3, 3, ci, co), device=x.device)
    _call(lib, "mgt_conv_dw", x.data_ptr(), gd.data_ptr(), None if s is None else s.data_ptr(),
          part.data_ptr(), n, h, wd, ci, co, slices, per, *_stream(x.device))
    return part.sum(0)


def case(lib, gen, shape):
    """One call shape, as chip_smoke.py `check_train_kernel` makes it."""
    block, layer, res, c, styles = shape
    dev = torch.device("cuda")
    x = torch.randn((BATCH, res, res, c), generator=gen, device=dev)
    gd = torch.randn((BATCH, res, res, c), generator=gen, device=dev)
    s = torch.rand((BATCH, c), generator=gen, device=dev) + 0.5 if styles else None
    nchw = lambda t: t.permute(0, 3, 1, 2)                                          # noqa: E731
    same = same_function_call(x, gd, s)
    runs = {"new": lambda: fc.conv_dw(x, gd, s),
            "earlier": lambda: parent_dw(lib, x, gd, s),
            "plain": lambda: fc.conv_dw_plain(x, gd, s, 1, 1, 3, (0, 0))[0],
            "library": lambda: conv2d_weight(nchw(x), (c, c, 3, 3), nchw(gd), padding=1),
            "same_function": same}
    want = runs["plain"]()
    scale = want.abs().max().item()
    errs = {name: (runs[name]() - want).abs().max().item() / scale for name in ("new", "earlier")}
    errs["same_function"] = (same().permute(2, 3, 1, 0) - want).abs().max().item() / scale
    flops = 2 * BATCH * res * res * 9 * c * c
    nbytes = 4 * (x.numel() + gd.numel() + (0 if s is None else s.numel()) + 9 * c * c)
    row = dict(block=block, layer=layer, batch=BATCH, **{f"err_{k}": v for k, v in errs.items()},
               tol=1e-4)
    return row, runs, flops, nbytes


BF16_PARENT_SIGNATURES = {"mgt_conv_dw_bf16": PARENT_SIGNATURES["mgt_conv_dw"][:4] +
                          [_I] * 8 + [_I, _P],
                          "mgt_conv_dw_tiles": [_I] * 4,
                          "mgt_downconv2_fwd_bf16": [_P] * 6 + [_I] * 7 + [ctypes.c_float] * 2 +
                          [_I, _P]}
BF16_PARENT_SIGNATURES["mgt_conv_dw"] = BF16_PARENT_SIGNATURES["mgt_conv_dw_bf16"]
TC_KERNEL = "conv_dw_tc_kernel"
# The hand-written kernels whose device time a traced bfloat16 iteration reports.
BF16_ITERATION_KERNELS = (TC_KERNEL, KERNEL, "downconv2_fwd_tc_kernel", "downconv2_lw_kernel",
                          "downconv2_tc_kernel", "conv3x3_fwd_tc_kernel", "conv3x3_adj_tc_kernel",
                          "upconv2_tc_kernel", "fir_dw_kernel")
# (label, batch, resolution, C = O, styles): the 6 shapes, then the reg
# route's wg of G at batch 2.
BF16_SHAPES = [(f"{b} {layer}", BATCH, res, c, styles) for b, layer, res, c, styles in SHAPES] + \
    [(f"G b{res} (reg wg)", 2, res, c, False) for res, c in ((256, 128), (512, 64), (1024, 32))]


def dw_launch(lib, x, gd, s):
    """One bare launch of `lib`'s K1 dw in x's type (`mgt_conv_dw` or
    `mgt_conv_dw_bf16`), its slices as the wrapper cuts them for that
    build's tiles: (the launch, its partials)."""
    n, h, wd, ci = x.shape
    co = gd.shape[-1]
    bf = x.dtype == torch.bfloat16
    ot = fc.k1_dw_ot(co)
    tiles_fn = "mgt_conv_dw_tiles_bf16" if bf and hasattr(lib, "mgt_conv_dw_tiles_bf16") \
        else "mgt_conv_dw_tiles"
    slices, per = fc.dw_slices(getattr(lib, tiles_fn)(n, h, wd, ot), (ci // 32) * (co // ot))
    part = torch.empty((slices, 3, 3, ci, co), device=x.device)
    fn = "mgt_conv_dw_bf16" if bf else "mgt_conv_dw"
    return (lambda: _call(lib, fn, x.data_ptr(), gd.data_ptr(),
                          None if s is None else s.data_ptr(), part.data_ptr(), n, h, wd, ci,
                          co, ot, slices, per, *_stream(x.device))), part


def parent_conv_dw_bf16(lib, x, gd, s):
    """`fc.conv_dw` on `lib` (the earlier build's route) for bfloat16 x and
    gd whose widths are in 32s."""
    launch, part = dw_launch(lib, x.contiguous(), gd.contiguous(), s)
    launch()
    return part.sum(0)


def bf16_main(parent_source, iteration):
    """`--bf16`: see the module's docstring."""
    from morphganformer_tpu_torch.bench_k2 import (BF16_FLOOR, BF16_RATIO, PEAK_BF16_FLOPS,
                                                   hmma_counts)
    from morphganformer_tpu_torch.bench_k3 import device_split, parent_downconv2_forward

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = "libmgt_k1dw_bf16_parent.so"
    parent = load_parent(Path(parent_source), BF16_PARENT_SIGNATURES, name)
    _, build_s, log = _build.build()
    print(json.dumps({"build_s": build_s, "ptxas": ptxas_report(log)}), flush=True)
    libs = {"new": _build.library(), "earlier": parent}
    if iteration:
        iteration_ab({"conv_dw": fc.conv_dw, "_downconv2_forward": fc._downconv2_forward},
                     {"conv_dw": lambda x, gd, s: parent_conv_dw_bf16(parent, x, gd, s),
                      "_downconv2_forward": lambda *a: parent_downconv2_forward(parent, *a)},
                     BF16_ITERATION_KERNELS, dtype="bfloat16")
        print(smi, flush=True)
        return 0
    hmma = {"new": hmma_counts(_build.library_path(), "conv_dw"),
            "earlier": hmma_counts(_build.BUILD_DIR / name, "conv_dw")}
    new_hmma = {k: v for k, v in hmma["new"].items() if TC_KERNEL in k}
    print(json.dumps({"hmma": hmma}), flush=True)
    failed = [] if new_hmma and all(new_hmma.values()) else [f"no HMMA in {TC_KERNEL}"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    nchw = lambda t: t.permute(0, 3, 1, 2)                                          # noqa: E731
    rows = []
    for label, n, res, c, styles in BF16_SHAPES:
        x = torch.randn((n, res, res, c), generator=gen, device="cuda")
        gd = torch.randn((n, res, res, c), generator=gen, device="cuda")
        s = torch.rand((n, c), generator=gen, device="cuda") + 0.5 if styles else None
        xb, gb = x.to(bf), gd.to(bf)
        launch = {(k, dt): dw_launch(libs[k], xt, gt, s) for k in ("earlier", "new")
                  for dt, xt, gt in ((bf, xb, gb), (f32, x, gd))}
        for v in launch.values():
            v[0]()
        got = {k: launch[k, bf][1].sum(0) for k in ("earlier", "new")}
        plain = fc.conv_dw_plain(xb, gb, s, 1, 1, 3, (0, 0))[0]
        ref = fc.conv_dw_plain(xb.float(), gb.float(), s, 1, 1, 3, (0, 0))[0]
        torch.cuda.synchronize()
        scale_p, scale_r = plain.abs().max().item(), ref.abs().max().item()
        row = dict(role="K1-dw bf16", shape=label, batch=n)
        for k in ("earlier", "new"):
            row[f"err_{k}_vs_plain"] = (got[k] - plain).abs().max().item() / scale_p
            row[f"err_{k}"] = (got[k] - ref).abs().max().item() / scale_r
        row["err_plain"] = (plain - ref).abs().max().item() / scale_r
        row["wrapper_equals_bare"] = bool(torch.equal(fc.conv_dw(xb, gb, s), got["new"]))
        row["f32_equal"] = bool(torch.equal(launch["earlier", f32][1], launch["new", f32][1]))
        t = {}
        for k in ("earlier", "new", "new", "earlier"):
            t.setdefault(k, []).append(cuda_ms(launch[k, bf][0], reps=5, warmup=1))
            t.setdefault(f"f32_{k}", []).append(cuda_ms(launch[k, f32][0], reps=5, warmup=1))
        shape = (c, c, 3, 3)
        xs = xb if s is None else (xb * s[:, None, None, :]).to(bf)
        same = lambda: conv2d_weight(nchw(xs), shape, nchw(gb), padding=1)  # noqa: E731
        for k, run in (("wrapper", lambda: fc.conv_dw(xb, gb, s)),
                       ("plain", lambda: fc.conv_dw_plain(xb, gb, s, 1, 1, 3, (0, 0))[0]),
                       ("library", lambda: conv2d_weight(nchw(xb), shape, nchw(gb), padding=1)),
                       ("same_function", same)):
            t[k] = [cuda_ms(run, reps=3, warmup=1)]
        torch.backends.cudnn.benchmark = True
        t["same_function_benchmark"] = [cuda_ms(same, reps=3, warmup=3)]
        torch.backends.cudnn.benchmark = False
        own = device_split(lambda: fc.conv_dw(xb, gb, s), TC_KERNEL)[0]
        if own == 0.0:    # the profiler drops a kernel's events now and then
            own = device_split(lambda: fc.conv_dw(xb, gb, s), TC_KERNEL)[0]
        flops = 2 * n * res * res * 9 * c * c
        elements = 2 * n * res * res * c + (0 if s is None else s.numel()) + 9 * c * c
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()},
                   new_ms_runs=t["new"], earlier_ms_runs=t["earlier"],
                   new_kernel_device_ms=own, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        row["bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        tol = max(BF16_RATIO * row["err_plain"], BF16_FLOOR)
        for k in ("new", "earlier"):
            if not row[f"err_{k}"] <= tol or not row[f"err_{k}_vs_plain"] <= 1e-4:
                failed.append(f"{label}: err_{k} {row[f'err_{k}']} (tol {tol}), vs plain "
                              f"{row[f'err_{k}_vs_plain']}")
        if not row["wrapper_equals_bare"]:
            failed.append(f"{label}: the wrapper's dw differs from the bare launch's")
        if not row["f32_equal"]:
            failed.append(f"{label}: the float32 dw differs between the builds")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{label}: new {t['new']} not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    keys = ("new_ms", "earlier_ms", "wrapper_ms", "plain_ms", "library_ms", "same_function_ms",
            "same_function_benchmark_ms", "bound_ms", "new_kernel_device_ms", "f32_new_ms",
            "f32_earlier_ms")
    sums = {part: {k: sum(r[k] for r in rows if ("(reg wg)" in r["shape"]) == (part == "reg"))
                   for k in keys} for part in ("train", "reg")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


def main(argv):
    if len(argv) >= 3 and argv[1] == "--bf16" and torch.cuda.is_available() and (
            len(argv) == 3 or argv[3:] == ["--iteration"]):
        return bf16_main(argv[2], len(argv) == 4)
    if len(argv) not in (2, 3) or not torch.cuda.is_available() or (
            len(argv) == 3 and argv[2] != "--iteration"):
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = load_parent(Path(argv[1]), PARENT_SIGNATURES, "libmgt_k1dw_parent.so")
    _, build_s, log = _build.build()
    print(json.dumps({"build_s": build_s, "ptxas": ptxas_report(log)}), flush=True)
    _build.library()
    if len(argv) == 3:
        iteration_ab({"conv_dw": fc.conv_dw},
                     {"conv_dw": lambda x, gd, s: parent_dw(lib, x.contiguous(), gd, s)},
                     ITERATION_KERNELS)
        print(smi, flush=True)
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failed = [], []
    for shape in SHAPES:
        row, runs, flops, nbytes = case(lib, gen, shape)
        t = {}
        for name in ("earlier", "new", "new", "earlier"):
            t.setdefault(name, []).append(cuda_ms(runs[name], reps=5, warmup=1))
        for name in ("plain", "library", "same_function"):
            t[name] = [cuda_ms(runs[name], reps=3, warmup=1)]
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
        row["bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        for k, tol in (("err_new", row["tol"]), ("err_earlier", row["tol"]),
                       ("err_same_function", SAME_FUNCTION_TOL)):
            if not row[k] <= tol:
                failed.append(f"{row['block']} {row['layer']} {k} {row[k]}")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{row['block']} {row['layer']}: new {t['new']} not faster than "
                          f"earlier {t['earlier']}")
    print(smi, flush=True)
    keys = ("new_ms", "earlier_ms", "plain_ms", "library_ms", "same_function_ms", "bound_ms",
            "new_kernel_device_ms", "new_all_device_ms", "earlier_kernel_device_ms",
            "earlier_all_device_ms")
    sums = {k: sum(r[k] for r in rows) for k in keys}
    sums["bound_share"] = sums["bound_ms"] / sums["new_ms"]
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
