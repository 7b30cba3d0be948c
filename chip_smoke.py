#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing its wall time:

  1. device   the card's name and power limit (nvidia-smi), torch/CUDA
              versions; TF32 off for cuDNN and matmul.
  2. build    one nvcc call for csrc/fused_conv.cu (ops/_build.py).
  3. kernels  K1 and K2 against their plain PyTorch versions at the 10 call
              shapes of one 1024^2 forward (batch 1), to 1e-4 max abs error;
              CUDA-event times of the kernel, the plain version and one cuDNN
              call of the bare convolution (the yardstick, never used by the
              port), beside the least time the card could take for the
              function's least work.
  4. generate FFHQ-1024 (`init:1024`, random weights from seed 0) through the
              generate entry point: 2 images, exactly 4 K1 and 6 K2 launches
              per forward, agreement with the same forward on the plain
              versions to 1e-3; forward times at batch 1 and 2, and one
              forward each under torch.profiler (device time by kernel and
              the device's idle share).
  5. morph    merge and demorph through their entry points on .mat latents in
              a temporary directory; the recovered latent equals the original
              to 1e-5.

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
SOURCE = "morphganformer_tpu_torch/csrc/fused_conv.cu"


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


def traced_forward(torch, fn, batch):
    """One forward under torch.profiler. The device's busy time (its kernels
    and copies, summed) and the host window it lies in come from the same
    traced run; the tracer's host overhead widens the window, so the idle
    share is an upper bound."""
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
    print(f"  traced forward batch {batch}: window {window_ms:.3f} ms, device busy "
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
            assert launches == {"modconv3x3": 4, "upconv2": 6}, launches
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
                traced_forward(torch, lambda: cli.synthesize(G, zb), b)
        phases["generate"] = ph.seconds

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
            assert merge_launches == demorph_launches == {"modconv3x3": 4, "upconv2": 6}
            assert rec_err <= 1e-5, rec_err
            for img in (img_m, img_d):
                assert img.shape == (1024, 1024, 3) and np.isfinite(img).all()
            assert os.path.exists(os.path.join(tmp, "demorph", "demorph.png"))
        phases["morph"] = ph.seconds

    print("kernel_calls " + json.dumps(rows), flush=True)
    kernels = []
    for kernel, name, replaces, key in (
            ("K1", "fused_modconv3x3", K1_REPLACES, "modconv3x3"),
            ("K2", "fused_upconv2", K2_REPLACES, "upconv2")):
        mine = [r for r in rows if r["kernel"] == kernel]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{kernel} {name} (one 1024^2 forward, batch 1: "
                    + ", ".join(f"{r['block']} {r['role']}" for r in mine) + ")",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[key],
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
