"""The least-work dw kernel (`fir_dw_kernel`: K3's dw and the D down-conv's)
on one card, against an earlier build whose dw kernel takes the per-parity
taps of the FIR-composed kernel, folded back onto w in autograd.

    mkdir -p build
    git show b4619e2:morphganformer_tpu_torch/csrc/fused_conv.cu > build/dw_parent.cu
    python -m morphganformer_tpu_torch.bench_dw build/dw_parent.cu
    python -m morphganformer_tpu_torch.bench_dw build/dw_parent.cu --iteration

The earlier source is that of commit b4619e2, whose `mgt_conv_dw` takes the
parity weights' taps (`upconv2_phase_kernels`, `downconv2_parity_kernels`);
its route is reached here through a copy of that commit's wrapper and the
composed plain route's fold (`fc._fold`). It is built with the same nvcc
flags into morphganformer_tpu_torch/_build/ under a name of its own.

At each call shape of the two roles in a 1024^2 training iteration at batch
4 (K3's dw at G b256, b512, b1024 conv0 and skip; the D down-conv's at D
b1024 and b512 conv1 and skip, as chip_smoke.py `train_calls`) both routes
are held against the composed plain version on the same random inputs
(within 1e-4 of its largest entry, as chip_smoke.py holds them), then timed
with CUDA events in the order earlier, new, new, earlier (each route whole:
the earlier one's kernel and fold), beside the plain version, one cuDNN
`conv2d_weight` of the bare convolution without the FIR, and one
`conv2d_weight` of the FIR-composed kernel at stride 2 (the same function
in one PyTorch call; its small fold onto w untimed). Each route's host time
per call (the enqueue, no synchronisation) is taken on the host clock, and
one call of each under torch.profiler splits its device time into the dw
kernel's own and the torch ops around it. Prints the compiler's register
and spill report, one JSON line per shape, then the card and the sums;
exits non-zero if a check fails or the new route is not faster than the
earlier one at some shape.

With --iteration it times, instead, whole first-order training iterations
(`GANTrainer.train_iteration`, FFHQ-1024 and a 1024^2 D from seed 0, batch
4, steps that run G_main and D_main only), each under torch.profiler
(`traced_run`), in turns earlier, new, new, earlier of one untraced and two
traced iterations, where "earlier" routes the two dw roles through the
earlier build and its fold (everything else the same): the device's busy
time, the dw kernels' device time and the host time of the FusedUpConv2 and
FusedDownConv2 backwards. Needs a CUDA card.

With --bf16, the FIR dw in bfloat16 (`mgt_fir_dw_bf16`, on the tensor
cores: `fir_dw_tc_kernel`) against the build of d375170, whose entry point
of the same signature runs the float32 least-work kernel on bfloat16
operands (`fir_dw_kernel`, FMA):

    git show d375170:morphganformer_tpu_torch/csrc/fused_conv.cu > build/fir_dw_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_dw --bf16 build/fir_dw_bf16_parent.cu
    python -m morphganformer_tpu_torch.bench_dw --bf16 build/fir_dw_bf16_parent.cu --iteration

Both builds compile at once. At the 10 call shapes above at batch 4 and at
the reg route's K3 dw calls (G's conv0 and skip at batch 2; the D
down-conv's reg calls are the batch-4 shapes), on bfloat16 operands, both
builds' bare launches (their partials, each build's slices) are held
against `fir_dw_plain` on the same operands (B unrounded, to 1e-4 of its
largest entry) and against it on the float32 values of the same inputs
(base * s unrounded) by chip_smoke.py's bf16 rule beside the plain
version's error, then timed with CUDA events in the order earlier, new,
new, earlier, with the float32 `mgt_fir_dw` of both builds on the same
inputs in float32 (bit-equal, and timed in the same turns); then the new
wrapper (the launch and the partials' sum), the plain version, cuDNN's
bfloat16 `conv2d_weight` of the bare convolution and the same-function call
in bfloat16 (`conv2d_weight` of the FIR-composed kernel, its operands
formed outside the timed call) with torch.backends.cudnn.benchmark off and
on; the kernel's own device time in one wrapper call under torch.profiler;
the bf16 bound. It prints both builds' ptxas lines for the dw kernels and
their HMMA counts (cuobjdump -sass). Exits non-zero if a check fails, if
the new kernel has no HMMA, if the float32 outputs differ, or if the new
launch is not faster than the earlier build's at some shape. With
--iteration it times, instead, traced bfloat16 iterations (G_main and
D_main, `iteration_ab` on bfloat16 G and D), where "earlier" routes both
FIR dw roles through the earlier build.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.nn.grad import conv2d_weight

from morphganformer_tpu_torch.bench_k1 import ptxas_report, traced
from morphganformer_tpu_torch.bench_k3 import (PEAK_BYTES, PEAK_FP32_FLOPS, _call, _stream,
                                               cuda_ms, load_parent, same_function_call)
from morphganformer_tpu_torch.ops import _build
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    # a, b, s, part, N, H, W, Cin, Cout, pa, pb, nt, hb0, hb1, slices, chunks_per_slice,
    # device, stream
    "mgt_conv_dw": [_P] * 4 + [_I] * 12 + [_I, _P],
    "mgt_dw_chunk": [],
}
PARENT_KERNEL = "conv_dw_kernel"
# The slice target of the earlier dw wrappers (commits b4619e2 and
# 9b95557): 8 blocks per SM of an H100.
PARENT_DW_BLOCKS = 8 * 132
KERNEL = "fir_dw_kernel"
BATCH = 4
# (role, block, layer, base resolution, Cin, Cout, kh): chip_smoke.py's
# `train_calls` of the two roles.
SHAPES = [("K2-use_dw-dw", f"D b{res}", layer, res // 2, cin, 2 * cin, kh)
          for res, cin in ((1024, 32), (512, 64)) for layer, kh in (("conv1", 3), ("skip", 1))]
SHAPES += [("K3-dw", f"G b{res}", layer, res // 2, cin, cout, kh)
           for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32))
           for layer, kh in (("conv0", 3), ("skip", 1))]


def same_function_dw_call(role, w, f, flip_weight):
    """The one PyTorch call that computes a dw role's weight cotangent of
    the FIR-composed kernel, and the small map of its result onto w: (call,
    fold) with call(inp, grad_out) on NCHW tensors. A yardstick only: the
    port never calls it.

      "K3-dw"         call(gd, x * s): the up-conv is `F.conv_transpose2d`
                      of x with the composed kernel (`same_function_call`
                      "K2"), the adjoint of `F.conv2d` of gd, so its
                      cotangent is `conv2d_weight(gd, ., x * s)`.
      "K2-use_dw-dw"  call(x, gz): the down-conv is `F.conv2d` of x
                      (`same_function_call` "K3-forward").

    `fold` is the vjp of w -> the composed kernel at the call's result."""
    sf_role = "K2" if role == "K3-dw" else "K3-forward"
    _, k, pad = same_function_call(sf_role, w, f, flip_weight)

    def call(inp, grad_out):
        return conv2d_weight(inp, tuple(k.shape), grad_out, stride=2, padding=pad)

    def fold(dk):
        return fc._fold(lambda w_: same_function_call(sf_role, w_, f, flip_weight)[1], w, dk)
    return call, fold


def parent_dw(lib, a, b, s, pa, pb, nt, hb):
    """The earlier dw launch with its per-parity taps (its wrapper at
    commit b4619e2, for channel counts in 32s)."""
    n, ci, co = a.shape[0], a.shape[-1], b.shape[-1]
    h, wd = a.shape[1] // pa, a.shape[2] // pa
    chunks = -(-n * h * wd // lib.mgt_dw_chunk())
    per_slice = 4 * nt * nt * (ci // 32) * (co // 32)
    per = -(-chunks // max(1, min(chunks, -(-PARENT_DW_BLOCKS // per_slice))))
    slices = -(-chunks // per)
    part = torch.empty((slices, 4, nt, nt, ci, co), device=a.device)
    _call(lib, "mgt_conv_dw", a.data_ptr(), b.data_ptr(), None if s is None else s.data_ptr(),
          part.data_ptr(), n, h, wd, ci, co, pa, pb, nt, hb[0], hb[1], slices, per,
          *_stream(a.device))
    return part.sum(0)


def parent_route(lib, role, x, t, s, w, f, flip_weight=None):
    """The earlier route whole: the parity taps' launch, then the fold onto
    w through the vjp of the composed kernel's parity weights. flip_weight
    defaults to the role's (False for K3's up-conv, True for the D's)."""
    if role == "K3-dw":
        fw = False if flip_weight is None else flip_weight
        wp, hb = fc.upconv2_phase_kernels(w, f, fw)
        dwp = parent_dw(lib, x, t, s, 1, 2, int(wp.shape[2]), hb)
        return fc._fold(lambda w_: fc.upconv2_phase_kernels(w_, f, fw)[0], w,
                        dwp.reshape(wp.shape))
    fw = True if flip_weight is None else flip_weight
    wf, hb = fc.downconv2_parity_kernels(w, f, fw)
    dwf = parent_dw(lib, x, t, None, 2, 1, int(wf.shape[2]), hb)
    return fc._fold(lambda w_: fc.downconv2_parity_kernels(w_, f, fw)[0], w,
                    dwf.reshape(wf.shape))


def case(lib, gen, shape):
    """One call shape, as chip_smoke.py `check_train_kernel` makes it."""
    role, block, layer, h, cin, cout, kh = shape
    dev = torch.device("cuda")
    randn = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=dev) * scale  # noqa: E731
    nchw = lambda t: t.permute(0, 3, 1, 2)                                          # noqa: E731
    f = setup_filter([1, 3, 3, 1]).to(dev)
    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    call, fold = same_function_dw_call(role, w, f, role == "K2-use_dw-dw")
    if role == "K3-dw":
        x = randn(BATCH, h, h, cin)
        t = randn(BATCH, 2 * h, 2 * h, cout)
        s = torch.rand((BATCH, cin), generator=gen, device=dev) + 0.5
        xs = x * s[:, None, None, :]
        runs = {"new": lambda: fc.upconv2_dw(x, t, s, w, f),
                "plain": lambda: fc.upconv2_dw_plain(x, t, s, w, f),
                "library": lambda: conv2d_weight(nchw(t), (cin, cout, kh, kh), nchw(x),
                                                 stride=2, padding=kh // 2),
                "same_function": lambda: call(nchw(t), nchw(xs))}
        # The separable FIR at every gd value for a 3x3, at the even
        # positions only (3 per gd value) for the 1x1 skip.
        fir = 2 * BATCH * (2 * h) ** 2 * (8 if kh == 3 else 3) * cout
        flops = 2 * BATCH * h * h * kh * kh * cin * cout + fir
        nbytes = 4 * (x.numel() + t.numel() + s.numel() + kh * kh * cin * cout)
        same_in = (nchw(t), nchw(xs))
    else:
        x = randn(BATCH, 2 * h, 2 * h, cin)
        t = randn(BATCH, h, h, cout)
        s = None
        runs = {"new": lambda: fc.downconv2_dw(x, t, w, f),
                "plain": lambda: fc.downconv2_dw_plain(x, t, w, f),
                "library": lambda: conv2d_weight(nchw(x), (cout, cin, kh, kh), nchw(t),
                                                 stride=2, padding=kh // 2),
                "same_function": lambda: call(nchw(x), nchw(t))}
        fir = 2 * BATCH * (2 * h) ** 2 * (8 if kh == 3 else 3) * cin
        flops = 2 * BATCH * h * h * kh * kh * cin * cout + fir
        nbytes = 4 * (x.numel() + t.numel() + kh * kh * cin * cout)
        same_in = (nchw(x), nchw(t))
    runs["earlier"] = lambda: parent_route(lib, role, x, t, s, w, f)
    want = runs["plain"]()
    scale = want.abs().max().item()
    errs = {name: (runs[name]() - want).abs().max().item() / scale for name in ("new", "earlier")}
    errs["same_function"] = (fold(call(*same_in)) - want).abs().max().item() / scale
    row = dict(role=role, block=block, layer=layer, batch=BATCH,
               **{f"err_{k}": v for k, v in errs.items()}, tol=1e-4)
    return row, runs, flops, nbytes


def host_ms(fn, reps=10):
    """The host's time per call of `fn`, without synchronising inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


# The autograd Functions whose host time a traced training iteration gives:
# the backwards of the fused up- and down-convs.
HOST_TIMED = ("FusedUpConv2Backward", "FusedDownConv2Backward")


def traced_run(fn, kernels, host_of=(), shapes=False):
    """One call of `fn` under torch.profiler: (the profile, its key averages,
    a dict). The dict holds the host window (window_ms), the device's busy
    time (busy_ms: its kernels and copies, summed, from the same run; the
    tracer's host overhead widens the window, so an idle share from the two
    is an upper bound), its device ops (launches), the device ms and
    launches of each of `kernels` that ran, by substring of the event's name
    (kernels), and the calls, host ms with children and own host ms of each
    host event (autograd Function) named in `host_of` (host). chip_smoke.py's
    traced phases and --iteration both take their numbers from it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    out = dict(window_ms=window_ms, busy_ms=0.0, launches=0, kernels={}, host={})
    for e in averages:
        if e.device_type.name == "CUDA":
            ms = (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) / 1e3
            out["busy_ms"] += ms
            out["launches"] += e.count
            name = next((k for k in kernels if k in e.key), None)
            if name:
                ms0, n0 = out["kernels"].get(name, (0.0, 0))
                out["kernels"][name] = (ms0 + ms, n0 + e.count)
        elif e.key in host_of:
            out["host"][e.key] = dict(calls=e.count, host_ms=e.cpu_time_total / 1e3,
                                      self_host_ms=e.self_cpu_time_total / 1e3)
    return prof, averages, out


def iteration_ab(new, earlier, kernels, dtype="float32"):
    """Traced first-order iterations, earlier, new, new, earlier: `new` and
    `earlier` map names of `fc`'s wrappers to the functions that stand in
    them on each route; `kernels` are the kernel names whose device time
    each traced iteration reports; G and D compute in `dtype`."""
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    trainer = GANTrainer(ffhq1024_config(dtype=dtype), DiscriminatorConfig(dtype=dtype),
                         TrainConfig(batch_size=BATCH, batch_gpu=BATCH))
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    reals = torch.rand((BATCH, 1024, 1024, 3), generator=gen, device="cuda") * 2 - 1
    rows = []
    for i, name in enumerate(("earlier", "new", "new", "earlier")):
        for k, fn in (earlier if name == "earlier" else new).items():
            setattr(fc, k, fn)
        step = 1 + 4 * i           # steps 1 + 4i to 3 + 4i: G_main and D_main only
        trainer.train_iteration(state, reals, step)
        torch.cuda.synchronize()
        for traced_step in (step + 1, step + 2):
            _, _, out = traced_run(lambda: trainer.train_iteration(state, reals, traced_step),
                                   kernels, HOST_TIMED)
            row = dict(route=name, step=traced_step, **out)
            print(json.dumps(row), flush=True)
            rows.append(row)
    for k, fn in new.items():
        setattr(fc, k, fn)
    return rows


def dw_routes(lib):
    """(new, earlier) for `iteration_ab`: the two dw wrappers, or the
    earlier build's route with its fold."""
    new = {"upconv2_dw": fc.upconv2_dw, "downconv2_dw": fc.downconv2_dw}
    earlier = {
        "upconv2_dw": lambda x, gd, s, w, f, fw=False: parent_route(lib, "K3-dw", x, gd, s, w,
                                                                    f, fw),
        "downconv2_dw": lambda x, gz, w, f, fw=True: parent_route(lib, "K2-use_dw-dw", x, gz,
                                                                  None, w, f, fw)}
    return new, earlier


BF16_PARENT_SIGNATURES = {
    # src, base, s, fir, part, N, H, W, CB, CK, kh, pad, slices, tiles_per_slice, device,
    # stream; N, H, W of the base grid -> its tiles
    "mgt_fir_dw_bf16": [_P] * 5 + [_I] * 9 + [_I, _P],
    "mgt_fir_dw": [_P] * 5 + [_I] * 9 + [_I, _P],
    "mgt_fir_dw_tiles": [_I, _I, _I],
}
TC_KERNEL = "fir_dw_tc_kernel"
# The hand-written kernels whose device time a traced bfloat16 iteration reports.
BF16_ITERATION_KERNELS = (TC_KERNEL, KERNEL, "conv_dw_tc_kernel", "downconv2_fwd_tc_kernel",
                          "downconv2_tc_kernel", "conv3x3_fwd_tc_kernel", "conv3x3_adj_tc_kernel",
                          "upconv2_tc_kernel")
# The 10 shapes at batch 4, then the reg route's K3 dw calls of G at batch 2.
BF16_SHAPES = [(*shape, BATCH) for shape in SHAPES] + \
    [(role, f"{block} (reg)", layer, h, cin, cout, kh, 2)
     for role, block, layer, h, cin, cout, kh in SHAPES if role == "K3-dw"]


def fir_dw_launch(lib, src, base, s, fk, pad, kh):
    """One bare launch of `lib`'s FIR dw in src's type (`mgt_fir_dw` or
    `mgt_fir_dw_bf16`), its slices as the wrapper cuts them for that build's
    tiles, for widths in the kernels' tiles: (the launch, its partials)."""
    n, h, wd, cv = base.shape
    cu = src.shape[-1]
    bf = src.dtype == torch.bfloat16
    tiles_fn = "mgt_fir_dw_tiles_bf16" if bf and hasattr(lib, "mgt_fir_dw_tiles_bf16") \
        else "mgt_fir_dw_tiles"
    slices, per = fc.dw_slices(getattr(lib, tiles_fn)(n, h, wd), (cu // 32) * (cv // 64))
    part = torch.empty((slices, kh, kh, cu, cv), device=src.device)
    fn = "mgt_fir_dw_bf16" if bf else "mgt_fir_dw"
    return (lambda: _call(lib, fn, src.data_ptr(), base.data_ptr(),
                          None if s is None else s.data_ptr(), fk.data_ptr(), part.data_ptr(),
                          n, h, wd, cu, cv, kh, pad, slices, per, *_stream(src.device))), part


def parent_fir_dw(lib, src, base, s, fk, pad, kh):
    """`fc._fir_dw_launch` on `lib` (the earlier build's route), for widths
    in the kernels' tiles."""
    launch, part = fir_dw_launch(lib, src.contiguous(), base.contiguous(), s, fk, pad, kh)
    launch()
    return part.sum(0)


def bf16_main(parent_source, iteration):
    """`--bf16`: see the module's docstring."""
    from concurrent.futures import ThreadPoolExecutor

    from morphganformer_tpu_torch.bench_k2 import (BF16_FLOOR, BF16_RATIO, PEAK_BF16_FLOPS,
                                                   hmma_counts)
    from morphganformer_tpu_torch.bench_k3 import device_split

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = "libmgt_fir_dw_bf16_parent.so"
    with ThreadPoolExecutor(2) as pool:      # both nvcc runs at once
        parent_job = pool.submit(load_parent, Path(parent_source), BF16_PARENT_SIGNATURES, name)
        _, build_s, log = _build.build()
        parent = parent_job.result()
    print(json.dumps({"build_s": build_s, "ptxas": [
        line for line in ptxas_report(log) if "fir_dw" in line or "registers" in line
        or "spill" in line]}), flush=True)
    libs = {"new": _build.library(), "earlier": parent}
    if iteration:
        iteration_ab({"_fir_dw_launch": fc._fir_dw_launch},
                     {"_fir_dw_launch": lambda *a: parent_fir_dw(parent, *a)},
                     BF16_ITERATION_KERNELS, dtype="bfloat16")
        print(smi, flush=True)
        return 0
    hmma = {"new": hmma_counts(_build.library_path(), "fir_dw"),
            "earlier": hmma_counts(_build.BUILD_DIR / name, "fir_dw")}
    new_hmma = {k: v for k, v in hmma["new"].items() if TC_KERNEL in k}
    print(json.dumps({"hmma": hmma}), flush=True)
    failed = [] if len(new_hmma) == 2 and all(new_hmma.values()) else [f"no HMMA in {TC_KERNEL}"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    nchw = lambda t: t.permute(0, 3, 1, 2)                                          # noqa: E731
    f = setup_filter([1, 3, 3, 1]).to("cuda")
    rows = []
    for role, block, layer, h, cin, cout, kh, n in BF16_SHAPES:
        randn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")       # noqa: E731
        w = randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)
        if role == "K3-dw":
            x, t = randn(n, h, h, cin), randn(n, 2 * h, 2 * h, cout)
            s = torch.rand((n, cin), generator=gen, device="cuda") + 0.5
            _, fk, pad = fc.upconv2_dw_leastwork(w, f, False)
            src, base = t, x
        else:
            x, t = randn(n, 2 * h, 2 * h, cin), randn(n, h, h, cout)
            s = None
            _, fk, pad = fc.downconv2_dw_leastwork(w, f, True)
            src, base = x, t
        sb, bb = src.to(bf), base.to(bf)
        launch = {(k, dt): fir_dw_launch(libs[k], st, bt, s, fk, pad, kh)
                  for k in ("earlier", "new") for dt, st, bt in ((bf, sb, bb), (f32, src, base))}
        for v in launch.values():
            v[0]()
        got = {k: launch[k, bf][1].sum(0) for k in ("earlier", "new")}
        plain = fc.fir_dw_plain(sb, bb, s, fk, pad, kh)
        ref = fc.fir_dw_plain(sb.float(), bb.float(), s, fk, pad, kh)
        torch.cuda.synchronize()
        scale_p, scale_r = plain.abs().max().item(), ref.abs().max().item()
        row = dict(role=f"{role} bf16", block=block, layer=layer, batch=n)
        for k in ("earlier", "new"):
            row[f"err_{k}_vs_plain"] = (got[k] - plain).abs().max().item() / scale_p
            row[f"err_{k}"] = (got[k] - ref).abs().max().item() / scale_r
        row["err_plain"] = (plain - ref).abs().max().item() / scale_r
        row["err_ratio"] = row["err_new"] / row["err_plain"] if row["err_plain"] else None
        row["wrapper_equals_bare"] = bool(torch.equal(
            fc._fir_dw_launch(sb, bb, s, fk, pad, kh), got["new"]))
        row["f32_equal"] = bool(torch.equal(launch["earlier", f32][1], launch["new", f32][1]))
        tm = {}
        for k in ("earlier", "new", "new", "earlier"):
            tm.setdefault(k, []).append(cuda_ms(launch[k, bf][0], reps=5, warmup=1))
            tm.setdefault(f"f32_{k}", []).append(cuda_ms(launch[k, f32][0], reps=5, warmup=1))
        call, _ = same_function_dw_call(role, w, f, role == "K2-use_dw-dw")
        if role == "K3-dw":
            xs = (x.to(bf) * s[:, None, None, :]).to(bf)
            same_in, lib_in = (nchw(t.to(bf)), nchw(xs)), (nchw(t.to(bf)), nchw(x.to(bf)))
            lib_shape = (cin, cout, kh, kh)
        else:
            same_in, lib_in = (nchw(x.to(bf)), nchw(t.to(bf))), (nchw(x.to(bf)), nchw(t.to(bf)))
            lib_shape = (cout, cin, kh, kh)
        same = lambda: call(*same_in)                                          # noqa: E731
        for k, run in (("wrapper", lambda: fc._fir_dw_launch(sb, bb, s, fk, pad, kh)),
                       ("plain", lambda: fc.fir_dw_plain(sb, bb, s, fk, pad, kh)),
                       ("library", lambda: conv2d_weight(lib_in[0], lib_shape, lib_in[1],
                                                         stride=2, padding=kh // 2)),
                       ("same_function", same)):
            tm[k] = [cuda_ms(run, reps=3, warmup=1)]
        torch.backends.cudnn.benchmark = True
        tm["same_function_benchmark"] = [cuda_ms(same, reps=3, warmup=3)]
        torch.backends.cudnn.benchmark = False
        own = device_split(lambda: fc._fir_dw_launch(sb, bb, s, fk, pad, kh), TC_KERNEL)[0]
        if own == 0.0:    # the profiler drops a kernel's events now and then
            own = device_split(lambda: fc._fir_dw_launch(sb, bb, s, fk, pad, kh), TC_KERNEL)[0]
        # chip_smoke.py's count: the taps, and the separable FIR at every src
        # value for a 3x3, at the even positions only for the 1x1.
        fir = 2 * n * (2 * h) ** 2 * (8 if kh == 3 else 3) * src.shape[-1]
        flops = 2 * n * h * h * kh * kh * cin * cout + fir
        elements = src.numel() + base.numel() + (0 if s is None else s.numel()) + \
            kh * kh * cin * cout
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in tm.items()},
                   new_ms_runs=tm["new"], earlier_ms_runs=tm["earlier"],
                   new_kernel_device_ms=own, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        row["bound_share"] = row["bound_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        tol = max(BF16_RATIO * row["err_plain"], BF16_FLOOR)
        label = f"{role} {block} {layer}"
        for k in ("new", "earlier"):
            if not row[f"err_{k}"] <= tol or not row[f"err_{k}_vs_plain"] <= 1e-4:
                failed.append(f"{label}: err_{k} {row[f'err_{k}']} (tol {tol}), vs plain "
                              f"{row[f'err_{k}_vs_plain']}")
        if not row["wrapper_equals_bare"]:
            failed.append(f"{label}: the wrapper's dw differs from the bare launch's")
        if not row["f32_equal"]:
            failed.append(f"{label}: the float32 dw differs between the builds")
        if not max(tm["new"]) < min(tm["earlier"]):
            failed.append(f"{label}: new {tm['new']} not faster than earlier {tm['earlier']}")
    print(smi, flush=True)
    keys = ("new_ms", "earlier_ms", "wrapper_ms", "plain_ms", "library_ms", "same_function_ms",
            "same_function_benchmark_ms", "bound_ms", "new_kernel_device_ms", "f32_new_ms",
            "f32_earlier_ms")
    sums = {part: {k: sum(r[k] for r in rows if r["role"] == f"{part.split()[0]} bf16"
                          and ("(reg)" in r["block"]) == part.endswith("reg")) for k in keys}
            for part in ("K2-use_dw-dw", "K3-dw", "K3-dw reg")}
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
    lib = load_parent(Path(argv[1]), PARENT_SIGNATURES, "libmgt_dw_parent.so")
    _, build_s, log = _build.build()
    print(json.dumps({"build_s": build_s, "ptxas": ptxas_report(log)}), flush=True)
    _build.library()
    if len(argv) == 3:
        iteration_ab(*dw_routes(lib), (KERNEL, PARENT_KERNEL))
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
                   new_host_ms=host_ms(runs["new"]), earlier_host_ms=host_ms(runs["earlier"]),
                   new_kernel_device_ms=kernel_ms, new_all_device_ms=device_ms,
                   earlier_kernel_device_ms=earlier_kernel_ms,
                   earlier_all_device_ms=earlier_device_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        row["speedup"] = row["earlier_ms"] / row["new_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        for k in ("err_new", "err_earlier", "err_same_function"):
            if not row[k] <= row["tol"]:
                failed.append(f"{row['role']} {row['block']} {row['layer']} {k} {row[k]}")
        if not max(t["new"]) < min(t["earlier"]):
            failed.append(f"{row['role']} {row['block']} {row['layer']}: new {t['new']} "
                          f"not faster than earlier {t['earlier']}")
    print(smi, flush=True)
    keys = ("new_ms", "earlier_ms", "plain_ms", "library_ms", "same_function_ms", "bound_ms",
            "new_host_ms", "earlier_host_ms", "new_kernel_device_ms", "new_all_device_ms",
            "earlier_kernel_device_ms", "earlier_all_device_ms")
    sums = {role: {k: sum(r[k] for r in rows if r["role"] == role) for k in keys}
            for role in ("K3-dw", "K2-use_dw-dw")}
    print(json.dumps({"sums": sums, "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
