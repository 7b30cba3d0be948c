#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its wall time:

  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; TF32 off for cuDNN and matmul.
  2. build    one nvcc call for csrc/fused_conv.cu (ops/_build.py).
  3. kernels  K1 and K2 against their plain PyTorch versions at the 10 call
              shapes of one 1024^2 forward (batch 1), to 1e-4 max abs error,
              and their adjoints (the K1 adjoint launch, and K3 for K2) at
              the same shapes against the plain adjoints, to 1e-4 of each
              output's largest entry (dx; ds, dd1, dd2); CUDA-event times of
              the kernel, the plain version and one cuDNN call of the bare
              convolution (the yardstick, never used by the port), beside
              the least time the card could take for the function's least
              work.
  4. generate FFHQ-1024 (`init:1024`, random weights from seed 0) through the
              generate entry point: 2 images, exactly 4 K1 and 6 K2 launches
              per forward, agreement with the same forward on the plain
              versions to 1e-3; forward times at batch 1 and 2, and one
              forward each under torch.profiler (device time by kernel and
              the device's idle share).
  5. project  a 100-step 1024^2 projection at batch 1 through the project
              entry point onto a reachable target (G(z) written as a PNG):
              finite losses, a best loss below the first step's, exactly 4
              K1, 6 K2, 4 K1-adjoint and 6 K3 launches per step plus one
              forward for the best image; one step's latent gradient on the
              kernels against the plain path to 1e-3 of its largest entry;
              steps/s, peak memory, and one step under torch.profiler.
  6. morph    merge and demorph through their entry points on .mat latents in
              a temporary directory (the recovered latent equals the original
              to 1e-5); a 50-step batch-2 projected morph of two G(z)
              targets and an image-mode demorph of its result, with their
              launch counts; pair-steps/s.

The last line is {"ok": true, "device": {...}}; any failure raises before it
and exits non-zero. Nothing is written inside the repository except the
kernel build in morphganformer_tpu_torch/_build/.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: fp32 on the FMA pipes, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
K1_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:114"
K2_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1143"
K3_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1263"
SOURCE = "morphganformer_tpu_torch/csrc/fused_conv.cu"
PROJECT_STEPS = 100
MORPH_STEPS = 50
DEMORPH_STEPS = 5


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.seconds = time.perf_counter() - self.t0
            print(f"phase {self.name}: {self.seconds:.3f} s", flush=True)


def cuda_ms(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def traced_forward(torch, fn, label):
    """One call of `fn` (a forward, or a projection step) under
    torch.profiler. The device's busy time (its kernels and copies, summed)
    and the host window it lies in come from the same traced run; the
    tracer's host overhead widens the window, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type.name == "CUDA"]
    busy_ms = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                  for e in device) / 1e3
    launches = sum(e.count for e in device)
    print(averages.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
    print(f"  traced {label}: window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / window_ms:.4f}, "
          f"{launches} device ops", flush=True)
    assert 0 < busy_ms <= window_ms, f"device busy {busy_ms} ms outside its {window_ms} ms window"


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_calls():
    """The 10 call shapes of one FFHQ-1024 forward on the fused blocks:
    (kernel, block, role, input res, Cin, Cout)."""
    calls = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        calls += [("K2", f"b{res}", "conv0", res // 2, cin, cout),
                  ("K2", f"b{res}", "skip", res // 2, cin, cout),
                  ("K1", f"b{res}", "conv1", res, cout, cout)]
    calls.append(("K1", "b1024", "conv_last", 1024, 32, 32))
    return calls


def check_kernel(torch, fc, gen, call):
    """Kernel vs plain on random inputs at one call shape; times and bound."""
    import torch.nn.functional as F

    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    kernel, block, role, h, cin, cout = call
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(1, h, h, cin)
    s = torch.rand((1, cin), generator=gen, device=dev) + 0.5
    if kernel == "K1":
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        last = role == "conv_last"
        noise = None if last else randn(h, h, scale=0.1)
        bias = None if last else randn(cout, scale=0.1)
        resid = None if last else randn(1, h, h, cout)
        gain, alpha = 1.0, (1.0 if last else 0.2)
        args = (x, w, s, noise, bias, resid, gain, alpha, True)
        run_k = lambda: fc.fused_modconv3x3(*args)
        run_p = lambda: fc.modconv3x3_plain(*args)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        run_lib = lambda: F.conv2d(x_nchw, w_oihw, padding=1)
        flops = 2 * h * h * 9 * cin * cout
        tensors = [x, w, s, noise, bias, resid]
        ho = h
    else:
        skip = role == "skip"
        kh = 1 if skip else 3
        w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
        f = setup_filter([1, 3, 3, 1]).cuda()
        styles = None if skip else s
        noise = None if skip else randn(2 * h, 2 * h, scale=0.1)
        bias = None if skip else randn(cout, scale=0.1)
        gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
        args = (x, w, styles, f, noise, bias, gain, alpha, not skip, False)
        run_k = lambda: fc.fused_upconv2(*args)
        run_p = lambda: fc.upconv2_plain(*args)
        # Yardstick: the bare convolution at input resolution, as the
        # unfused path runs it before its FIR pass (conv2d_resample.py): a
        # stride-2 transposed 3x3 conv for conv0, a 1x1 conv for the skip.
        x_nchw = x.permute(0, 3, 1, 2)
        if skip:
            w_lib = w.permute(3, 2, 0, 1).contiguous()
            run_lib = lambda: F.conv2d(x_nchw, w_lib)
        else:
            w_lib = w.permute(2, 3, 0, 1).contiguous()
            run_lib = lambda: F.conv_transpose2d(x_nchw, w_lib, stride=2)
        # Least work of the function: that convolution at input resolution,
        # then the separable 4-tap FIR (4 + 4 multiply-adds per output value).
        flops = 2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout
        tensors = [x, w, styles, noise, bias]
        ho = 2 * h

    yk = run_k()
    yp = run_p()
    torch.cuda.synchronize()
    err = (yk - yp).abs().max().item()
    rel = err / max(yp.abs().max().item(), 1e-30)
    print(f"  {kernel} {block} {role}: y {tuple(yk.shape)} max_abs_err {err:.3e} "
          f"max_rel_err {rel:.3e}", flush=True)
    assert yk.shape == yp.shape == (1, ho, ho, cout), yk.shape
    assert torch.isfinite(yk).all().item()
    assert err <= 1e-4, f"{kernel} {block} {role}: max abs err {err} > 1e-4"

    nbytes = 4 * (sum(t.numel() for t in tensors if t is not None) + yk.numel())
    bound_ms, bound_by = bound(flops, nbytes)
    ms = cuda_ms(torch, run_k)
    plain_ms = cuda_ms(torch, run_p)
    library_ms = cuda_ms(torch, run_lib)
    row = dict(kernel=kernel, block=block, role=role, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {kernel} {block} {role}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return row


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def check_adjoint(torch, fc, gen, call):
    """The adjoint kernel of one forward call shape (K1 -> its adjoint
    launch, K2 -> K3) against the plain adjoint on random inputs; times and
    the bound of the function's least work."""
    import torch.nn.functional as F

    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    kernel, block, role, h, cin, cout = call
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(1, h, h, cin)
    s = torch.rand((1, cin), generator=gen, device=dev) + 0.5
    if kernel == "K1":
        name = "K1-adjoint"
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        last = role == "conv_last"
        noise = None if last else randn(h, h, scale=0.1)
        bias = None if last else randn(cout, scale=0.1)
        resid = None if last else randn(1, h, h, cout)
        gain, alpha = 1.0, (1.0 if last else 0.2)
        y = fc.modconv3x3_plain(x, w, s, noise, bias, resid, gain, alpha, True)
        g = randn(*y.shape)
        args = (g, x, w, s, y, noise, bias, resid, gain, alpha, True)
        run_k = lambda: fc.modconv3x3_adjoint(*args)
        run_p = lambda: fc.modconv3x3_adjoint_plain(*args)
        # Yardstick: the bare transposed conv, gd with flip(w)^T.
        g_nchw = g.permute(0, 3, 1, 2)
        w_lib = fc.modconv3x3_adjoint_weights(w).permute(3, 2, 0, 1).contiguous()
        run_lib = lambda: F.conv2d(g_nchw, w_lib, padding=1)
        # One 3x3 conv, the ds dot (2 per dx value) and the dd taps (4 per
        # gd value); gd, x, y, noise in, dx out.
        flops = 2 * h * h * 9 * cin * cout + 2 * h * h * cin + 4 * h * h * cout
        tensors = [g, x, y, noise, x]                          # the last: dx
        ho = h
    else:
        name = "K3-adjoint"
        skip = role == "skip"
        kh = 1 if skip else 3
        w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
        f = setup_filter([1, 3, 3, 1]).cuda()
        styles = None if skip else s
        noise = None if skip else randn(2 * h, 2 * h, scale=0.1)
        bias = None if skip else randn(cout, scale=0.1)
        gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
        y = fc.upconv2_plain(x, w, styles, f, noise, bias, gain, alpha, not skip, False)
        g = randn(*y.shape)
        args = (g, x, w, styles, f, y, noise, bias, gain, alpha, not skip, False)
        run_k = lambda: fc.upconv2_adjoint(*args)
        run_p = lambda: fc.upconv2_adjoint_plain(*args)
        # Yardstick: the bare convolution from output to input resolution,
        # without the FIR: a stride-2 3x3 conv for conv0, a 1x1 conv at
        # input resolution for the skip.
        if skip:
            g_lib = torch.randn((1, cout, h, h), generator=gen, device=dev)
            w_lib = w.permute(2, 3, 0, 1).contiguous()
            run_lib = lambda: F.conv2d(g_lib, w_lib)
        else:
            g_nchw = g.permute(0, 3, 1, 2)
            w_lib = w.permute(2, 3, 0, 1).contiguous()
            run_lib = lambda: F.conv2d(g_nchw, w_lib, stride=2, padding=1)
        # Least work: the FIR's adjoint at output resolution (separable
        # 4-tap), the conv at input resolution, and for conv0 the dot and dd
        # taps; gd in and dx out, and for conv0 x, y and noise in.
        flops = 2 * (2 * h) ** 2 * 8 * cout + 2 * h * h * kh * kh * cin * cout
        tensors = [g, x]
        if not skip:
            flops += 2 * h * h * cin + 4 * (2 * h) ** 2 * cout
            tensors += [x, y, noise]
        ho = h

    launches = fc.launch_counts[{"K1": "modconv3x3_adj", "K2": "upconv2_adj"}[kernel]]
    got = run_k()
    assert fc.launch_counts[{"K1": "modconv3x3_adj", "K2": "upconv2_adj"}[kernel]] == launches + 1
    want = run_p()
    torch.cuda.synchronize()
    dx_err = _rel_err(got[0], want[0])
    red_err = max((_rel_err(a, b) for a, b in zip(got[1:], want[1:]) if b is not None),
                  default=0.0)
    max_abs = max((a - b).abs().max().item() for a, b in zip(got, want) if b is not None)
    print(f"  {name} {block} {role}: dx {tuple(got[0].shape)} rel err {dx_err:.3e}; "
          f"ds/dd1/dd2 rel err {red_err:.3e}; max abs err {max_abs:.3e}", flush=True)
    assert got[0].shape == (1, ho, ho, cin)
    assert all(torch.isfinite(t).all().item() for t in got if t is not None)
    assert (got[1] is None) == (kernel == "K2" and skip)     # the skip gives dx only
    assert dx_err <= 1e-4, f"{name} {block} {role}: dx rel err {dx_err} > 1e-4"
    assert red_err <= 1e-4, f"{name} {block} {role}: ds/dd rel err {red_err} > 1e-4"

    nbytes = 4 * (sum(t.numel() for t in tensors if t is not None))
    bound_ms, bound_by = bound(flops, nbytes)
    ms = cuda_ms(torch, run_k)
    plain_ms = cuda_ms(torch, run_p)
    library_ms = cuda_ms(torch, run_lib)
    row = dict(kernel=name, block=block, role=role, max_abs_err=max_abs, dx_rel_err=dx_err,
               reduction_rel_err=red_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {name} {block} {role}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return row


def _timed_progress(stamps):
    def progress(step, loss, best):
        stamps.append((step, time.perf_counter()))
        print(f"    step {step}: loss {loss:.5f} best {best:.5f}", flush=True)
    return progress


def _steady_rate(stamps):
    """Steps per second between the first and the last progress call (the
    first window holds the warm-up)."""
    (s0, t0), (s1, t1) = stamps[0], stamps[-1]
    return (s1 - s0) / (t1 - t0)


def _per_step(steps, forwards):
    return {"modconv3x3": 4 * (steps + forwards), "upconv2": 6 * (steps + forwards),
            "modconv3x3_adj": 4 * steps, "upconv2_adj": 6 * steps}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from morphganformer_tpu_torch import cli
    from morphganformer_tpu_torch.ops import _build
    from morphganformer_tpu_torch.ops import fused_conv as fc

    t_start = time.perf_counter()
    phases = {}

    with Phase("device") as ph:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        print(smi[0], flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}", flush=True)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    phases["device"] = ph.seconds

    with Phase("build") as ph:
        path, build_s, log = _build.build()
        _build.library()
        print(f"  {os.path.relpath(path, REPO)}: nvcc {build_s:.3f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    phases["build"] = ph.seconds

    with Phase("kernels") as ph:
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows = [check_kernel(torch, fc, gen, call) for call in kernel_calls()]
        rows += [check_adjoint(torch, fc, gen, call) for call in kernel_calls()]
    phases["kernels"] = ph.seconds

    with tempfile.TemporaryDirectory(prefix="mgt_smoke_") as tmp:
        with Phase("generate") as ph:
            t0 = time.perf_counter()
            cfg, G = cli.get_model("init:1024", device="cuda", seed=0)
            torch.cuda.synchronize()
            print(f"  init:1024 on cuda: {time.perf_counter() - t0:.3f} s, "
                  f"{sum(p.numel() for p in G.parameters())} parameters", flush=True)
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            imgs = cli.run_generate(G, os.path.join(tmp, "gen"), images_num=2,
                                    truncation_psi=0.7, batch_size=2, seed=0)
            gen_s = time.perf_counter() - t0
            launches = dict(fc.launch_counts)
            print(f"  run_generate: 2 images in {gen_s:.3f} s (first call, PNGs included); "
                  f"launches {launches}", flush=True)
            assert imgs.shape == (2, 1024, 1024, 3), imgs.shape
            assert np.isfinite(imgs).all()
            assert launches == _per_step(0, 1), launches
            assert len(os.listdir(os.path.join(tmp, "gen"))) == 2

            z = torch.randn((2, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(0))
            y_kernel = cli.synthesize(G, z)
            y_plain = cli.synthesize(G, z, plain=True)
            torch.cuda.synchronize()
            diff = (y_kernel - y_plain).abs().max().item()
            print(f"  kernel vs plain forward: max abs diff {diff:.3e} "
                  f"(|img| max {y_plain.abs().max().item():.3f})", flush=True)
            again = (y_kernel.cpu() - torch.from_numpy(imgs)).abs().max().item()
            assert again <= 1e-5, f"run_generate and synthesize differ by {again} on one z"
            assert diff <= 1e-3, f"kernel vs plain forward differ by {diff}"

            for b in (1, 2):
                zb = z[:b].cuda()
                for plain in (False, True):
                    ms = cuda_ms(torch, lambda: cli.synthesize(G, zb, plain=plain), reps=3, warmup=1)
                    print(f"  forward batch {b} {'plain' if plain else 'kernels'}: "
                          f"{ms:.3f} ms, {1e3 * b / ms:.3f} imgs/s", flush=True)
                traced_forward(torch, lambda: cli.synthesize(G, zb), f"forward batch {b}")
        phases["generate"] = ph.seconds

        from morphganformer_tpu_torch.losses import build_loss_stack
        from morphganformer_tpu_torch.projection import (ProjectionConfig, latent_stats,
                                                         loss_and_grad)
        from morphganformer_tpu_torch.utils.image import load_target, to_uint8, write_png

        def g_of_z_png(seed, path):
            z = torch.randn((1, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(seed))
            write_png(path, to_uint8(cli.synthesize(G, z)[0].cpu().numpy()))
            return path

        with Phase("project") as ph:
            target_png = g_of_z_png(7, os.path.join(tmp, "target.png"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stamps = []
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            res = cli.run_project(G, target_png, os.path.join(tmp, "proj"), steps=PROJECT_STEPS,
                                  n_mean_latent=10000, chunk=25, seed=0,
                                  progress=_timed_progress(stamps))
            proj_s = time.perf_counter() - t0
            proj_launches = dict(fc.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            history = res.loss_history.numpy()
            rate = _steady_rate(stamps)
            print(f"  run_project: {PROJECT_STEPS} steps at batch 1 in {proj_s:.3f} s "
                  f"(set-up, PNG and the best image's forward included); steady "
                  f"{rate:.3f} steps/s ({1e3 / rate:.3f} ms/step) over steps "
                  f"{stamps[0][0]}-{stamps[-1][0]}; peak memory {peak / 2**30:.3f} GiB; "
                  f"loss {history[0]:.5f} -> best {res.best_loss:.5f} at step "
                  f"{res.best_step}; launches {proj_launches}", flush=True)
            assert np.isfinite(history).all() and history.shape == (PROJECT_STEPS,)
            assert res.best_loss < history[0], (res.best_loss, history[0])
            assert proj_launches == _per_step(PROJECT_STEPS, 1), proj_launches
            assert res.best_img.shape == (1, 1024, 1024, 3)
            assert torch.isfinite(res.best_img).all().item()
            assert len(os.listdir(os.path.join(tmp, "proj"))) == 2

            # One step's latent gradient: kernels against the plain path.
            pcfg = ProjectionConfig(steps=PROJECT_STEPS)
            mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
            latent_n = (mean[None] + torch.randn((1, cfg.k, cfg.z_dim),
                                                 generator=torch.Generator().manual_seed(1))
                        * std * pcfg.noise).cuda()
            target = torch.from_numpy(load_target(target_png, 1024)).cuda()
            loss_fn = build_loss_stack({"mse": 1.0})
            step_ms = {}
            grads = {}
            for plain in (False, True):
                loss_and_grad(G, latent_n, target, loss_fn, pcfg, plain)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _, grads[plain] = loss_and_grad(G, latent_n, target, loss_fn, pcfg, plain)
                torch.cuda.synchronize()
                step_ms[plain] = (time.perf_counter() - t0) * 1e3
            traced_forward(torch, lambda: loss_and_grad(G, latent_n, target, loss_fn, pcfg),
                           "projection step batch 1")
            grad_err = _rel_err(grads[False], grads[True])
            print(f"  one step's latent gradient, kernels vs plain: rel err {grad_err:.3e} "
                  f"(|grad| max {grads[True].abs().max().item():.4e}); forward+backward "
                  f"{step_ms[False]:.3f} ms on the kernels, {step_ms[True]:.3f} ms plain",
                  flush=True)
            assert torch.isfinite(grads[False]).all().item()
            assert grad_err <= 1e-3, f"latent gradient kernels vs plain: {grad_err}"
        phases["project"] = ph.seconds
        proj_stats = dict(steps_per_s=rate, peak_gib=peak / 2**30, wall_s=proj_s,
                          grad_rel_err=grad_err, step_ms_kernels=step_ms[False],
                          step_ms_plain=step_ms[True])

        with Phase("morph") as ph:
            rng = torch.Generator().manual_seed(1)
            za, zb = (torch.randn((cfg.k, cfg.z_dim), generator=rng).numpy() for _ in range(2))
            from morphganformer_tpu_torch.morph import save_latent_mat

            save_latent_mat(os.path.join(tmp, "a.mat"), za)
            save_latent_mat(os.path.join(tmp, "b.mat"), zb)
            fc.reset_launch_counts()
            (stem, img_m, w_m), = cli.run_merge(
                G, [os.path.join(tmp, "a.mat"), os.path.join(tmp, "b.mat")],
                os.path.join(tmp, "merged"))
            merge_launches = dict(fc.launch_counts)
            fc.reset_launch_counts()
            img_d, w_rec = cli.run_demorph(G, os.path.join(tmp, "merged", f"{stem}.mat"),
                                           os.path.join(tmp, "a.mat"),
                                           os.path.join(tmp, "demorph"))
            demorph_launches = dict(fc.launch_counts)
            rec_err = float(abs(w_rec - zb).max())
            print(f"  merge {stem}: launches {merge_launches}; demorph: launches "
                  f"{demorph_launches}, recovered latent max abs err {rec_err:.3e}", flush=True)
            assert merge_launches == demorph_launches == _per_step(0, 1)
            assert rec_err <= 1e-5, rec_err
            for img in (img_m, img_d):
                assert img.shape == (1024, 1024, 3) and np.isfinite(img).all()
            assert os.path.exists(os.path.join(tmp, "demorph", "demorph.png"))

            # Projected morph of two reachable targets (batch 2, kernels only:
            # the plain K2 at batch 2 meets a slow cuDNN algorithm).
            png_a = g_of_z_png(11, os.path.join(tmp, "alice.png"))
            png_b = g_of_z_png(12, os.path.join(tmp, "bob.png"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stamps = []
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            res_m, img_pm, w_pm = cli.run_morph_pair(G, png_a, png_b, os.path.join(tmp, "pm"),
                                                     steps=MORPH_STEPS, chunk=10, seed=0,
                                                     progress=_timed_progress(stamps))
            pair_s = time.perf_counter() - t0
            pair_launches = dict(fc.launch_counts)
            pair_peak = torch.cuda.max_memory_allocated()
            pair_rate = _steady_rate(stamps)
            print(f"  run_morph_pair: {MORPH_STEPS} steps at batch 2 in {pair_s:.3f} s; steady "
                  f"{pair_rate:.3f} pair-steps/s; peak memory {pair_peak / 2**30:.3f} GiB; "
                  f"per-image best {res_m.per_image_loss.tolist()}; launches {pair_launches}",
                  flush=True)
            # Steps, the best images' forward (batch 2), the morph's forward.
            assert pair_launches == _per_step(MORPH_STEPS, 2), pair_launches
            assert np.isfinite(res_m.loss_history.numpy()).all()
            assert img_pm.shape == (1024, 1024, 3) and np.isfinite(img_pm).all()
            assert len(os.listdir(os.path.join(tmp, "pm"))) == 6

            fc.reset_launch_counts()
            t0 = time.perf_counter()
            img_di, w_di = cli.run_demorph(
                G, out_dir=os.path.join(tmp, "demorph_img"),
                morph_img=os.path.join(tmp, "pm", "alice_bob_morph.png"),
                accomplice_img=png_a, steps=DEMORPH_STEPS, seed=0)
            demorph_img_s = time.perf_counter() - t0
            demorph_img_launches = dict(fc.launch_counts)
            print(f"  image-mode demorph: {DEMORPH_STEPS} steps for each of 2 projections in "
                  f"{demorph_img_s:.3f} s; launches {demorph_img_launches}", flush=True)
            # Two projections, each with its best image's forward, and the
            # recovered identity's forward.
            want = _per_step(2 * DEMORPH_STEPS, 3)
            assert demorph_img_launches == want, (demorph_img_launches, want)
            assert img_di.shape == (1024, 1024, 3) and np.isfinite(img_di).all()
            assert np.isfinite(w_di).all()
        phases["morph"] = ph.seconds
        morph_stats = dict(pair_steps_per_s=pair_rate, peak_gib=pair_peak / 2**30,
                           wall_s=pair_s, demorph_image_s=demorph_img_s)

    print("kernel_calls " + json.dumps(rows), flush=True)
    print("projection " + json.dumps(proj_stats), flush=True)
    print("morph " + json.dumps(morph_stats), flush=True)
    kernels = []
    for kernel, name, replaces, key in (
            ("K1", "fused_modconv3x3", K1_REPLACES, "modconv3x3"),
            ("K2", "fused_upconv2", K2_REPLACES, "upconv2"),
            ("K1-adjoint", "mgt_modconv3x3_bwd (adjoint launch, pallas_conv.py:858-908)",
             K1_REPLACES, "modconv3x3_adj"),
            ("K3-adjoint", "mgt_upconv2_bwd (adjoint of K2, pallas_conv.py:1786-1851)",
             K3_REPLACES, "upconv2_adj")):
        mine = [r for r in rows if r["kernel"] == kernel]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{kernel} {name} (the call shapes of one 1024^2 forward, batch 1: "
                    + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + f"; launches over the {PROJECT_STEPS}-step projection)",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": proj_launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
        })
    phases["total"] = time.perf_counter() - t_start
    print("phases " + json.dumps(phases), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
