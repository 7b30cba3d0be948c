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
              the kernel, the plain version, one cuDNN call of the bare
              convolution and, for K2 and K3, one call of the same
              convolution with the FIR composed in (`F.conv_transpose2d` /
              `F.conv2d` at stride 2, `bench_k3.same_function_call`): the
              yardsticks, never used by the port; beside the least time the
              card could take for the function's least work.
  4. generate FFHQ-1024 (`init:1024`, random weights from seed 0) through the
              generate entry point: 2 images, exactly 4 K1 and 6 K2 launches
              per forward, agreement with the same forward on the plain
              versions to 1e-3; forward times at batch 1 and 2, and one
              forward each under torch.profiler (device time by kernel and
              the device's idle share).
  4b. vis    the attention maps at FFHQ-1024, batch 4: G(z, return_att=True)
              bit-equal in its image to the forward without it, with the
              same 4 K1 and 6 K2 launches; maps [4, 16, 11, 1, 1024, 1024]
              whose every layer sums to 1 over the components within 1e-5;
              the same forward on the plain versions within 1e-3; seconds
              and peak memory; attention_blends (4 sample and 4 attention
              PNGs, the same launches); make_video of the 4 blends, its GIF
              walked block by block (frames, delays, NETSCAPE loop 0).
  5. project  a 50-step 1024^2 projection at batch 1 through the project
              entry point onto a reachable target (G(z) written as a PNG):
              finite losses, a best loss below the first step's, exactly 4
              K1, 6 K2, 4 K1-adjoint and 6 K3 launches per step plus one
              forward for the best image; one step's latent gradient on the
              kernels against the plain path to 1e-3 of its largest entry;
              steps/s, peak memory, and one step under torch.profiler.
              Then `noise_reg_check`: project --noise_regularize 1e5 on
              the bfloat16 synthesis with non-zero noise strengths,
              against the same call without it (10 steps each): exact
              tensor-core launches per step, unchanged; the
              <latent>.noises.npz; merge --noises writing the best PNG
              byte for byte; the latent and noise-map gradients, kernels
              and plain route against float32's (phase bf16's rule); one
              traced step with and one without.
  6. morph    merge and demorph through their entry points on .mat latents in
              a temporary directory (the recovered latent equals the original
              to 1e-5); a 25-step batch-2 projected morph of two G(z)
              targets and an image-mode demorph of its result, with their
              launch counts; pair-steps/s.
              Then `morph_csv_check`: the four bfloat16 tensor-core roles
              at the 10 call shapes at batch 8 against their plain
              versions; morph --pairs-csv in bfloat16 on a CSV of 4 pairs
              (and one row under --min-similarity) at --pairs-per-batch 4
              (one batch-8 projection), and at 1 on the first pair: exact
              launches, every file, pair-steps/s and peak memory.
  6b. warp   warp_morphs on phase morph's morph PNG and its two targets:
              --predict-landmarks on the card, then the same warp through
              --batch-list on landmark CSVs of save_landmarks_csv (within
              one level of the first); the card's float64 warp against the
              CPU path on the same landmarks within 1e-6 (0-255 scale), the
              CSV route's PNG equal to the CPU warp truncated away from
              integers; the card's warp in CUDA-event ms, the CPU path's s.
  7. bf16     the synthesis path in bfloat16 (JAX's default for project,
              morph and demorph): the four bfloat16 roles (K1, K2, K1's
              adjoint launch, K3's adjoint; the `_bf16` entry points, each
              a kernel on the tensor cores, K1's and K2's forming x * s and
              the adjoints gd in the kernel)
              at the 10 call shapes, the kernel's own
              device time under torch.profiler beside the wrapper's, the
              kernel and the plain bfloat16 version each
              against the float32 plain version on the same bfloat16-rounded
              activations, the kernel's error at most 1.5 times the plain
              one's or within 2^-7 of each output's largest entry, with
              kernel, plain, cuDNN's bfloat16 bare-convolution and (K2, K3)
              same-function times beside the bound (2 bytes an element, the
              bf16 tensor-core peak); then on cli.get_model("init:1024",
              dtype="bfloat16"): generation of two images (exact launches,
              every one a bf16 one), the forward on the kernels and on the
              plain versions against the float32 forward (the kernels' mean
              and max error at most 1.5 times the plain ones'), forward
              times and peak memory at batch 1 and 2 in both types, one
              traced bfloat16 forward (exactly 4 launches of K1's forward
              kernel, none of conv3x3_lw_kernel) and one traced bfloat16
              projection step (device ms, device ops, exactly 4 launches of
              K1's forward kernel, 4 of K1's adjoint kernel and 6 of K3's,
              none of conv3x3_lw_kernel); a 50-step projection (exact
              launches, the loss descending, steps/s and peak memory beside
              phase project's float32 ones); step 0's latent gradient on the
              kernels and on the plain route against float32's (the same
              bound); a 25-step batch-2 projected morph and an image-mode
              demorph with their launches.
  8. losses   project's whole loss stack on the bfloat16 init:1024 generator:
              a 1000 x 1200 PNG (a generated face, its sides reflected, its
              top and bottom cut) through load_target (Lanczos to 1024 x
              1229, the centre crop); run_project for LOSS_STEPS steps under
              each of LOSS_SPECS (mse alone as the yardstick,
              "lpips+0.01*wing+1*mse" at --size 256, then awing, facenet,
              arcface, mdf, lbp and ssim alone), random perceptual weights
              and the bundled landmark model: every loss and term finite,
              exactly phase bf16's tensor-core launches per step, ms per
              step; the latent gradient at one noised latent on the kernels
              and on the plain route against float32's, held as phase bf16
              holds it; one step of the default stack and one of mdf under
              torch.profiler; each loss net's forward + backward ms on a
              1024^2 image; the list of the terms run.
  9. checkpoint
              the FFHQ-1024 generator of phase generate and a 1024^2 D
              (seed 4) saved with save_generator / save_discriminator, loaded
              back through cli.get_model(<dir>) and load_discriminator: every
              leaf bit-equal; run_generate from the loaded generator writes
              phase generate's two PNGs byte for byte; bytes, save and load
              seconds.
  9b. convert phase checkpoint's G (as G and Gs) and D in three pickles
              in the reference's formats (tests/torch_reference_pickles.py:
              the persistence dict through pickle and through torch.save,
              the TF-legacy tuple; about 386 MB each), each converted by
              `python -m morphganformer_tpu_torch.tools.convert_checkpoint`
              in a subprocess and loaded through cli.get_model(<dir>) and
              load_discriminator: configs equal (the TF form's G with
              normalize_global False, which that form cannot carry), every
              leaf bit-equal, run_generate's two PNGs byte for byte with
              one forward's launches; pickle bytes, convert and load
              seconds. Beside them, in its own process,
              `python -m morphganformer_tpu_torch.tools.train_landmarks`
              with JAX's defaults on the card: dataset seconds, steps/s,
              validation error, and the held-out error of the trained and
              the bundled net under 6 px at 256 scale.
  10. metrics the float32 K1 and K2 forwards at the 10 call shapes at
              batch 16 against their plain versions (times, bound);
              fid2k_full through run_calc_metrics over 32 G(z) PNGs with a
              random-weight InceptionV3 (.npz) and with the raw detector:
              exactly 4 K1 and 6 K2 launches per batch-16 forward, the
              metric-fid2k_full.jsonl lines; a batch-16 forward on the
              kernels against the plain versions to 1e-3; imgs/s of
              features_for_generator, G's and the detector's ms;
              ppl2_wend over 4 samples on the kernels and plain.
  11. train   the training roles at every call shape of a 1024^2 training
              step at batch 4 against their plain versions: K3-forward (the
              D down-conv, to 1e-3 max abs), K2's use_dw role (its dx), the
              dw taps of K1, K3 and the down-conv (relative to the largest
              entry, 1e-4; K3's and the down-conv's against the composed
              plain route, conv_dw_plain and its fold onto w), with kernel,
              plain and one cuDNN call's times (and the same-function
              call's for K3-forward, K2 use_dw and the dw of K3 and the
              down-conv: `conv2d_weight` of the FIR-composed kernel, its
              fold onto w untimed; for K1's dw `conv2d_weight` of x * s and
              gd, the multiply included) beside the bound; K1 and K2 forward and
              adjoint with per-sample noise [4,H,W] at the noisy call
              shapes; the second-order term of each grad Function
              (ModConv3x3Grad, UpConv2Grad, DownConv2Grad:
              `ops/second_order.py`) at its 16 call shapes in the reg
              stages (G's at batch 2, D's at batch 4), at the cotangents
              its stage feeds, on the kernels against the plain versions
              (each output within 1e-4 of its largest entry, beside a
              control of w nudged by 1e-6 at the same y), kernel and
              plain times. Then
              GANTrainer on FFHQ-1024 and a 1024^2 D from seed 0: one
              G_main and one D_main round's gradients, with non-zero noise
              strengths, on the kernels against the plain path (every leaf
              within 1e-3 of its largest entry; the noise strengths as one
              vector leaf) and the backward alone against the plain
              backward (every leaf on its own), beside a control of the
              plain path with its weights nudged by 1e-6; train_iteration
              steps 1-3 at batch 4 (G_main, D_main, EMA) with finite losses
              and exact launch counts per iteration, one iteration in two
              accumulation rounds (batch 8), stage times and peak memory,
              and one iteration under torch.profiler (with the host time of
              the FusedUpConv2 and FusedDownConv2 backwards).
              Then training in bfloat16 (`train --dtype bfloat16`): the
              training roles' bfloat16 entry points at the same call shapes
              (K3-forward, K1's dw, K2's use_dw role and the FIR dw of K3
              and of the D down-conv, all on the tensor cores), each against its plain
              bfloat16 version by phase bf16's rule, with kernel, plain,
              cuDNN's bfloat16 and same-function times beside the bf16
              bound; D's conv0 and the second-order route's degenerate K1
              launches through the tensor-core kernels; each grad
              Function's term in bfloat16 at its 16 call shapes; each
              stage's gradients (G_main, G_reg, D_main, D_reg) on the
              kernels and on the plain bfloat16 route against the float32
              plain route (`bf16_train_checks`); a bfloat16 and a float32
              train_iteration with all four stages (seconds, stage ms, peak
              memory, exact launches on the `_bf16` entry points) and one
              traced bfloat16 iteration (device busy time, idle share, the
              five training roles' bfloat16 launches, each on its kernel,
              no float32 least-work kernel).
  11b. dataset
              dataset_tool on six PNGs of non-square sizes cut from G's
              images: create_from_images --resolution 1024 --lods 2, display,
              compare of the folder with itself (exit 0) and with a copy
              with one pixel changed (exit 1, one difference), extract; one
              batch of the result through the native feed, each image one
              of the dataset's.
  12. loop    16 images of 1024^2 (G(z) from seeds; half of them with every
              row Paeth-filtered, half Sub-filtered, by the encoder below)
              under <tmp>/data/1024/; one 1024^2 PNG decoded by the native
              loader and by read_png, Paeth and Sub; then training_loop at
              FFHQ-1024 with a 1024^2 D from seed 0, batch 4, 2 iterations a
              tick, snapshots every tick, tensorboard on: two ticks with
              image snapshots (grid and interp), then a resumed tick
              (msgpack), then a resumed tick with the async backend. Checks:
              the run's files; every iteration launches exactly phase
              train's kernels of one iteration and, where a reg stage is
              due (steps 0 and 4), that stage's scoped launches of phase
              reg; each resumed run starts at
              the saved cur_nimg from a state bit-equal to the saved one;
              cli.get_model(<snapshot>) gives G_ema's image; then `train
              --dtype bfloat16` through cli.main for one tick on the same
              PNGs (a bfloat16 snapshot, every role on its bf16 entry
              point, no float32 launch). Each
              iteration's seconds inside train_iteration and around it (the
              feed, the stats copy, the tick), the feed it took, the
              snapshot's bytes and its synchronous, asynchronous and load
              seconds.
  13. layouts K4 (`mgt_conv3x3_fwd`) and its dx role against the plain
              version at its five call shapes (G b512 conv1, b1024 conv1 and
              conv_last; D b1024 and b512 conv0) at batch 1 and 4, to 1e-5
              of the output's largest entry, with kernel, plain and one
              cuDNN call's times (`F.conv2d`; `conv2d_input` for dx) beside
              the bound. Then, with MGT_PALLAS_CONV=1, the `skip` layouts at
              FFHQ-1024 widths from seed 0: one forward at batch 1 with
              exactly 3 K4 launches, agreeing with the switch off (cuDNN) to
              1e-3; train_iteration at batch 4 on main-only steps with
              finite losses and exact K4 forward and dx launches per
              iteration; one G_main and one D_main round's gradients, K4 on
              against K4 off (every leaf within 1e-3 of its largest entry,
              floored; the noise strengths as one); stage times, peak memory.
              Then K4 in bfloat16 (`mgt_conv3x3_fwd_bf16` and its dx, the
              tensor-core K1 kernels' degenerate launches) at the five call
              shapes at batch 4 against the plain bfloat16 version by phase
              bf16's rule, with kernel (and its own device), plain and
              cuDNN's bfloat16 times beside the bf16 bound; and two
              bfloat16 train_iteration steps of the skip layouts with
              MGT_PALLAS_CONV=1: finite losses, exactly the float32
              iteration's K4 launches, on the `_bf16` keys.
  14. reg     train_iteration at steps 0 and 16, where all four stages are
              due, at batch 4, on the resnet pair of phase train and on the
              skip pair, the reg stages on their default scoped
              second-order route: finite losses, pl_mean moved off 0, the
              exact launches of G_reg and D_reg by role on the resnet pair
              (`reg_launches`, printed) and none on the skip pair (K4 is
              off inside the scope), no dw launch in either stage's inner
              gradient, the exact main-stage launches, G_reg and D_reg
              times and peak memory; each reg stage's parameter gradients
              in float32 on the scoped route against the same stage in
              float64 on the unpacked route (MGT_PACKED_SECOND_ORDER=0;
              penalties within 1e-3, every leaf within 1e-2 (R1) and 5e-2
              (path length) of the stage's largest entry; each leaf's own
              error printed beside two controls, the float32 unpacked route
              and float64 with the weights nudged by 1e-7), and the float32
              stage's time and peak memory on either route; central
              differences in float64 along random directions against the
              autograd directional derivative (held to 1e-5 where no lrelu
              follows the parameters: G's torgb, D's output layer); one
              scoped G_reg and one scoped D_reg of the resnet pair under
              torch.profiler.
              cuDNN runs in deterministic mode through this phase, so the
              trained state that the checks see is the same on every run.
  15. dist    data parallelism on torch.distributed: a world-1 NCCL group
              met through initialize_distributed at a free localhost port;
              two 1024^2 iterations at batch 4 on phase train's resnet pair
              (step 0 with G_reg and D_reg due, step 1) from one state on
              one set of z and reals, by the plain trainer and by the
              trainer over make_data_mesh(), whose stages all-reduce their
              gradients: G, D, G_ema and both Adams bit-equal, each
              iteration exactly phase train's launches (cuDNN in
              deterministic mode, phase reg's reason); then in the default
              mode one main-stage iteration's all-reduces alone (CUDA
              events; in a group of one rank a local copy, not the cost
              at world > 1, which dist_probe.py measures on several
              cards) against four main-only iterations each way, in
              turns, beside the card's name and power limit; a 2-row
              projection through mesh=[cuda:0] and mesh=None, latents and
              losses equal, the same launches.
  15b. tp     tensor parallelism on this card: a world-1 NCCL group through
              make_mesh(model_parallel=1), the trainer over it bit-equal to
              the plain trainer in a step-0 iteration (all four stages);
              then every fused call shape of FFHQ-1024 and a 1024^2 D at
              batch 4 (`tp_calls`: K1 forward and adjoint, K2 forward, K3
              adjoint, K3-forward, K2's use_dw, the three dw roles) launched
              at both halves of its output channels, as a 2-way model axis
              runs them, and at the full width, in float32 and bfloat16:
              each half against its plain version by its role's rule, the
              halves concatenated (per output channel) or summed (dx, ds)
              against the full-width launch; exactly three launches a case
              (`tp_launches` in the kernels line).
  16. options four sets of GANformer options at FFHQ-1024 widths, each G
              from seed 0 (`OPTION_SETS`): gated (k 17, ltnt_gate and
              img_gate, the mapping's ltnt_gate, kmeans_iters 2, the
              trainable encoding), iterative-conditional (k 9, the
              iterative carry, kmeans_iters 2, c_dim 8 with the non-resnet
              mapping, the linear encoding), stylegan2 (no transformer,
              k 1: every block from 8^2 fused) and shared (k 2, the
              trainable2d encoding). Per set: a batch-2 forward with const
              noise, exact K1 and K2 launches, kernels against plain to
              1e-3, ms; a 5-step projection at batch 1 onto G's own image
              (run_project; the conditional set in W+ from its labelled ws
              through `project`), exact launches with the adjoints, the
              latent gradient kernels against plain to 1e-3; the gated set
              in bfloat16 by phase bf16's rule; the iterative-conditional
              set with a conditional 1024^2 D: one G_main and one D_main
              round with labels held by phase train's check
              (`main_round_checks`: backward alone and kernels against
              plain, every leaf within 1e-3), where a check misses 1e-3 the
              kernels no further from a plain float64 run than 2x plain
              float32 is (float32 rounding alone moves this set's stages
              past it); the path-length penalty at the same weights in
              float32 and in float64; train_iteration at step 0 with
              labels (all four stages, phase reg's exact launches).
  17. apl     one APL episode on the card (an Encoder of 32^2 images and an
              RSAFFDecoder from seeded weights; 16 steps, each writing 16
              entries to a 128-slot memory, which wraps, and reading 8
              neighbours of 8 queries, then the decoder's logits) against the same episode
              on the CPU: distances and logits within 1e-5 of their largest
              entry, the labels equal where no distances tie.
  18. demo    tools/train_demo_synfaces at a reduced size (32 faces at 64^2,
              one tick of 2 kimg, no metric; each cut printed) through `cli
              train` in this process: one snapshot, the fakes grid PNG,
              finite losses.

The phase `extract` runs after metrics, in phase morph's directory:
extract_features (random iresnet18 on the card) with --bona on
morph_csv_check's 8 G(z) faces and --morph on its 4 morphs (JAX's JSON:
accuracies in [0, 1], the counts), then --images on the faces to an npz of
512-d rows in file order; no fused-kernel launch; seconds of each.

The phase `formats` runs after extract: every fixture of tests/data/formats
decoded by the port (PNG, JPEG, BMP, Netpbm) with no Pillow, each array and
its RGB conversion equal to Pillow's recorded SHA-256; the host's decode
time of the face JPEG (800 x 640) and of a 1024^2 JPEG; load_target of the
face JPEG equal to that of its pixels as a PNG; the JPEG projected at
FFHQ-1024 widths in bfloat16 for 20 steps (exact tensor-core launches per
step, the loss descending); the latent gradient at one noised latent on
the kernels against the plain path, float32 within 1e-3 of its largest
entry and bfloat16 by phase bf16's rule.

The line before the last lists every kernel (name, route, source, the TPU
kernel it replaces, launches on the main path, error, ms, plain, bound,
library); the last line is {"ok": true, "device": {...}}; any failure raises before it
and exits non-zero. Nothing is written inside the repository except the
kernel build in morphganformer_tpu_torch/_build/.
"""

import contextlib
import io
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"

# H100 SXM data-sheet peaks: fp32 on the FMA pipes, bf16 dense on the
# tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
K1_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:114"
K2_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1143"
K3_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1263"
K1_DW_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:256"
K3_DW_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1387"
K2_DW_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:1225"
K4_REPLACES = "morphganformer_tpu/ops/pallas_conv.py:74"
SOURCE = "morphganformer_tpu_torch/csrc/fused_conv.cu"
HAND_WRITTEN = ("conv3x3_lw_kernel", "conv3x3_fwd_tc_kernel", "conv3x3_adj_tc_kernel",
                "upconv2_lw_kernel", "upconv2_tc_kernel", "downconv2_lw_kernel",
                "downconv2_tc_kernel", "downconv2_fwd_tc_kernel", "conv_dw_lw_kernel",
                "conv_dw_tc_kernel", "fir_dw_kernel", "fir_dw_tc_kernel")
PROJECT_STEPS = 50
MORPH_STEPS = 25
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


def traced_forward(torch, fn, label, shapes=False, host_of=()):
    """One call of `fn` (a forward, or a projection step) under
    torch.profiler, through bench_dw.traced_run: the device's busy time and
    the host window it lies in, from the same traced run (the idle share is
    an upper bound), and the hand-written kernels' device time. `shapes`
    also prints the ops' device time by input shape; `host_of` names host
    events (autograd Functions) whose host time, with their children, is
    printed and returned."""
    from morphganformer_tpu_torch.bench_dw import traced_run

    prof, averages, r = traced_run(fn, HAND_WRITTEN, host_of, shapes)
    busy_ms, window_ms, host = r["busy_ms"], r["window_ms"], r["host"]
    print(averages.table(sort_by="self_cuda_time_total", row_limit=12), flush=True)
    if shapes:
        print(prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=10, max_name_column_width=30,
            max_shapes_column_width=140), flush=True)
    print(f"  traced {label}: window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / window_ms:.4f}, "
          f"{r['launches']} device ops", flush=True)
    print(f"  traced {label}, hand-written kernels (device ms, launches): "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in r["kernels"].items()), flush=True)
    if host_of:
        print(f"  traced {label}, host time of " + ", ".join(
            f"{k}: {v['host_ms']:.3f} ms in {v['calls']} calls "
            f"({v['host_ms'] / v['calls']:.3f} a call)" for k, v in host.items()), flush=True)
    assert 0 < busy_ms <= window_ms, f"device busy {busy_ms} ms outside its {window_ms} ms window"
    return dict(window_ms=window_ms, busy_ms=busy_ms, device_ops=r["launches"],
                kernels=r["kernels"], host=host)


def _same_sum(rows):
    """The same-function call's time summed over rows, or None where a role
    has none (K1, K4)."""
    ms = [r.get("same_function_ms") for r in rows]
    return None if None in ms else sum(ms)


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


def check_kernel(torch, fc, gen, call, batch=1):
    """Kernel vs plain on random inputs at one call shape and `batch`; times
    and bound."""
    import torch.nn.functional as F

    from morphganformer_tpu_torch.bench_k3 import same_function_call
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    kernel, block, role, h, cin, cout = call
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(batch, h, h, cin)
    s = torch.rand((batch, cin), generator=gen, device=dev) + 0.5
    if kernel == "K1":
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        last = role == "conv_last"
        noise = None if last else randn(h, h, scale=0.1)
        bias = None if last else randn(cout, scale=0.1)
        resid = None if last else randn(batch, h, h, cout)
        gain, alpha = 1.0, (1.0 if last else 0.2)
        args = (x, w, s, noise, bias, resid, gain, alpha, True)
        run_k = lambda: fc.fused_modconv3x3(*args)
        run_p = lambda: fc.modconv3x3_plain(*args)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        run_lib = lambda: F.conv2d(x_nchw, w_oihw, padding=1)
        flops = 2 * batch * h * h * 9 * cin * cout
        tensors = [x, w, s, noise, bias, resid]
        ho = h
        run_same = None
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
        # The same function's convolution in one call: the transposed conv
        # with the FIR-composed kernel.
        op, w_same, pad_same = same_function_call("K2", w, f, False)
        run_same = lambda: op(x_nchw, w_same, stride=2, padding=pad_same)
        # Least work of the function: that convolution at input resolution,
        # then the separable 4-tap FIR (4 + 4 multiply-adds per output value).
        flops = batch * (2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout)
        tensors = [x, w, styles, noise, bias]
        ho = 2 * h

    yk = run_k()
    yp = run_p()
    torch.cuda.synchronize()
    err = (yk - yp).abs().max().item()
    rel = err / max(yp.abs().max().item(), 1e-30)
    print(f"  {kernel} {block} {role} batch {batch}: y {tuple(yk.shape)} max_abs_err {err:.3e} "
          f"max_rel_err {rel:.3e}", flush=True)
    assert yk.shape == yp.shape == (batch, ho, ho, cout), yk.shape
    assert torch.isfinite(yk).all().item()
    assert err <= 1e-4, f"{kernel} {block} {role}: max abs err {err} > 1e-4"

    nbytes = 4 * (sum(t.numel() for t in tensors if t is not None) + yk.numel())
    bound_ms, bound_by = bound(flops, nbytes)
    reps = (10, 2) if batch == 1 else (3, 1)      # (reps, warmup)
    ms = cuda_ms(torch, run_k, *reps)
    plain_ms = cuda_ms(torch, run_p, *reps)
    library_ms = cuda_ms(torch, run_lib, *reps)
    same_ms = None if run_same is None else cuda_ms(torch, run_same, *reps)
    row = dict(kernel=kernel, block=block, role=role, batch=batch, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, same_function_ms=same_ms,
               bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {kernel} {block} {role} batch {batch}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f}{_same(same_ms)} bound_ms {bound_ms:.4f} ({bound_by})",
          flush=True)
    return row


def host(stats):
    """A stage's or an iteration's stats (0-d device tensors) as floats."""
    return {k: float(v) for k, v in stats.items()}


def _same(ms):
    return "" if ms is None else f" same_function_ms {ms:.4f}"


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)


def check_adjoint(torch, fc, gen, call):
    """The adjoint kernel of one forward call shape (K1 -> its adjoint
    launch, K2 -> K3) against the plain adjoint on random inputs; times and
    the bound of the function's least work."""
    import torch.nn.functional as F

    from morphganformer_tpu_torch.bench_k3 import same_function_call
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
        run_same = None
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
        # The same function's convolution in one call: the stride-2
        # correlation with the FIR-composed kernel read back.
        g_same = g.permute(0, 3, 1, 2)
        op, w_same, pad_same = same_function_call("K3-adjoint", w, f, False)
        run_same = lambda: op(g_same, w_same, stride=2, padding=pad_same)
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
    same_ms = None if run_same is None else cuda_ms(torch, run_same)
    row = dict(kernel=name, block=block, role=role, max_abs_err=max_abs, dx_rel_err=dx_err,
               reduction_rel_err=red_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               same_function_ms=same_ms, bound_ms=bound_ms, bound_by=bound_by,
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {name} {block} {role}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f}{_same(same_ms)} bound_ms {bound_ms:.4f} ({bound_by})",
          flush=True)
    return row


BF16_RATIO = 1.5          # a bf16 kernel's error against float32: at most 1.5x the plain one's
BF16_FLOOR = 2.0 ** -7    # ... or within one bfloat16 ulp of the output's largest entry


def bf16_bound(flops, elements):
    """The least time of a bfloat16 call: its elements at 2 bytes over HBM, or
    its FLOP on the bf16 dense tensor-core peak, whichever is larger."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * elements / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _bf16_errs(got, plain, ref):
    """(kernel error, plain error, kernel vs plain), each output's largest
    absolute difference relative to the float32 reference's largest entry."""
    ek = ep = kp = 0.0
    for g, p, r in zip(got, plain, ref):
        if r is None:
            assert g is None and p is None
            continue
        scale = max(r.abs().max().item(), 1e-30)
        ek = max(ek, (g.float() - r).abs().max().item() / scale)
        ep = max(ep, (p.float() - r).abs().max().item() / scale)
        kp = max(kp, (g.float() - p.float()).abs().max().item() / scale)
    return ek, ep, kp


def check_bf16(torch, fc, gen, call, adjoint, batch=1):
    """A bfloat16 role at one call shape of a 1024^2 forward at `batch` (K1,
    K2; with `adjoint` K1's adjoint launch and K3): the kernel and the plain bfloat16
    version, each against the float32 plain version on the same
    bfloat16-rounded activations (x, resid, the forward's y, the cotangent;
    the weights, styles, noise and bias are float32 parameters that the
    bfloat16 route rounds itself). The kernel's error may be at most
    BF16_RATIO times the plain version's, or within BF16_FLOOR of each
    output's largest entry. Times of the kernel (its wrapper, CUDA events;
    and the kernel's own device time in one call under torch.profiler), the
    plain version, cuDNN's bfloat16 call of the bare convolution and, for K2
    and K3, the same-function call in bfloat16; the bound at 2 bytes an
    element and the bf16 tensor-core peak."""
    import torch.nn.functional as F

    from morphganformer_tpu_torch.bench_k3 import device_split, same_function_call
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    kernel, block, role, h, cin, cout = call
    dev, bf = torch.device("cuda"), torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def f32(args):
        return tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == bf else a
                     for a in args)

    x = randn(batch, h, h, cin).to(bf)
    s = torch.rand((batch, cin), generator=gen, device=dev) + 0.5
    if kernel == "K1":
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        last = role == "conv_last"
        noise = None if last else randn(h, h, scale=0.1)
        bias = None if last else randn(cout, scale=0.1)
        resid = None if last else randn(batch, h, h, cout).to(bf)
        gain, alpha = 1.0, (1.0 if last else 0.2)
        fwd = (x, w, s, noise, bias, resid, gain, alpha, True)
        flops = 2 * batch * h * h * 9 * cin * cout
        elements = [x, w, noise, resid, batch * h * h * cout]    # the last: y
        if adjoint:
            name, key = "K1-adjoint", "modconv3x3_adj"
            y = fc.modconv3x3_plain(*fwd)
            g = randn(*y.shape).to(bf)
            args = (g, x, w, s, y, noise, bias, resid, gain, alpha, True)
            run_k = lambda: fc.modconv3x3_adjoint(*args)
            run_p = lambda: fc.modconv3x3_adjoint_plain(*args)
            ref = fc.modconv3x3_adjoint_plain(*f32(args))
            g_nchw = g.permute(0, 3, 1, 2)
            w_lib = fc.modconv3x3_adjoint_weights(w).permute(3, 2, 0, 1).to(bf).contiguous()
            run_lib = lambda: F.conv2d(g_nchw, w_lib, padding=1)
            flops += batch * (2 * h * h * cin + 4 * h * h * cout)
            elements = [g, x, y, resid, noise, x.numel()]         # the last: dx
        else:
            name, key = "K1", "modconv3x3"
            run_k = lambda: fc.fused_modconv3x3(*fwd)
            run_p = lambda: fc.modconv3x3_plain(*fwd)
            ref = fc.modconv3x3_plain(*f32(fwd))
            x_nchw, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(bf)
            run_lib = lambda: F.conv2d(x_nchw, w_lib, padding=1)
        run_same = None
    else:
        skip = role == "skip"
        kh = 1 if skip else 3
        w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
        f = setup_filter([1, 3, 3, 1]).cuda()
        styles = None if skip else s
        noise = None if skip else randn(2 * h, 2 * h, scale=0.1)
        bias = None if skip else randn(cout, scale=0.1)
        gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
        fwd = (x, w, styles, f, noise, bias, gain, alpha, not skip, False)
        flops = batch * (2 * h * h * kh * kh * cin * cout + 2 * (2 * h) ** 2 * 8 * cout)
        if adjoint:
            name, key = "K3-adjoint", "upconv2_adj"
            y = fc.upconv2_plain(*fwd)
            g = randn(*y.shape).to(bf)
            args = (g, x, w, styles, f, y, noise, bias, gain, alpha, not skip, False)
            run_k = lambda: fc.upconv2_adjoint(*args)
            run_p = lambda: fc.upconv2_adjoint_plain(*args)
            ref = fc.upconv2_adjoint_plain(*f32(args))
            w_lib = w.permute(2, 3, 0, 1).to(bf).contiguous()
            if skip:
                g_lib = torch.randn((batch, cout, h, h), generator=gen, device=dev).to(bf)
                run_lib = lambda: F.conv2d(g_lib, w_lib)
            else:
                g_nchw = g.permute(0, 3, 1, 2)
                run_lib = lambda: F.conv2d(g_nchw, w_lib, stride=2, padding=1)
            g_same = g.permute(0, 3, 1, 2)
            op, w_same, pad_same = same_function_call("K3-adjoint", w, f, False)
            w_same = w_same.to(bf)
            run_same = lambda: op(g_same, w_same, stride=2, padding=pad_same)
            elements = [g, x.numel()]                               # the last: dx
            if not skip:
                flops += batch * (2 * h * h * cin + 4 * (2 * h) ** 2 * cout)
                elements += [x, y, noise]
        else:
            name, key = "K2", "upconv2"
            run_k = lambda: fc.fused_upconv2(*fwd)
            run_p = lambda: fc.upconv2_plain(*fwd)
            ref = fc.upconv2_plain(*f32(fwd))
            x_nchw = x.permute(0, 3, 1, 2)
            if skip:
                w_lib = w.permute(3, 2, 0, 1).to(bf).contiguous()
                run_lib = lambda: F.conv2d(x_nchw, w_lib)
            else:
                w_lib = w.permute(2, 3, 0, 1).to(bf).contiguous()
                run_lib = lambda: F.conv_transpose2d(x_nchw, w_lib, stride=2)
            op, w_same, pad_same = same_function_call("K2", w, f, False)
            w_same = w_same.to(bf)
            run_same = lambda: op(x_nchw, w_same, stride=2, padding=pad_same)
            elements = [x, w, styles, noise, 4 * batch * h * h * cout]  # the last: y

    before = fc.launch_counts[BF16_KEYS[key]]
    got = run_k()
    assert fc.launch_counts[BF16_KEYS[key]] == before + 1, f"{name} bf16 did not launch"
    plain = run_p()
    torch.cuda.synchronize()
    got, plain, ref = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, plain, ref))
    assert got[0].dtype == bf and plain[0].dtype == bf and ref[0].dtype == torch.float32
    assert all(torch.isfinite(t).all().item() for t in got if t is not None)
    ek, ep, kp = _bf16_errs(got, plain, ref)
    ok = ek <= max(BF16_RATIO * ep, BF16_FLOOR)
    print(f"  {name} bf16 {block} {role} batch {batch}: vs float32 on the same inputs, "
          f"kernel {ek:.3e}, "
          f"plain {ep:.3e} (of the largest entry); kernel vs plain {kp:.3e}", flush=True)
    assert ok, f"{name} bf16 {block} {role}: kernel err {ek} > max({BF16_RATIO} x {ep}, " \
               f"{BF16_FLOOR})"
    bound_ms, bound_by = bf16_bound(flops, sum(t if isinstance(t, int) else t.numel()
                                               for t in elements if t is not None))
    reps = (10, 2) if batch == 1 else (3, 1)      # (reps, warmup)
    ms = cuda_ms(torch, run_k, *reps)
    plain_ms = cuda_ms(torch, run_p, *reps)
    library_ms = cuda_ms(torch, run_lib, *reps)
    same_ms = None if run_same is None else cuda_ms(torch, run_same, *reps)
    kernel_ms = device_split(run_k, BF16_KERNELS[key])[0]
    print(f"  {name} bf16 {block} {role}: ms {ms:.4f} (kernel's device ms {kernel_ms:.4f}) "
          f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f}{_same(same_ms)} "
          f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return dict(kernel=f"{name} bf16", block=block, role=role, batch=batch, max_abs_err=kp,
                err_kernel=ek, err_plain=ep, ms=ms, kernel_device_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms, same_function_ms=same_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def bf16_phase(torch, fc, cli, G, target_png, png_a, png_b, tmp):
    """The synthesis path in bfloat16 (JAX's default for project, morph and
    demorph): the four bfloat16 roles at the 10 call shapes of a 1024^2
    forward (`check_bf16`); then through the entry points on
    `cli.get_model("init:1024", dtype="bfloat16")`: generation of two images
    (exact launches, all on the bf16 instantiations), the forward on the
    kernels against the plain bfloat16 forward, each against the float32
    forward of G (mean and max abs error, the kernel's at most BF16_RATIO
    times the plain one's); forward times and peak memory at batch 1 and 2
    in float32 and bfloat16; one traced bfloat16 forward; a 50-step
    projection (exact launches, a best loss below the first step's, steps/s
    and peak memory beside float32's), step 0's latent gradient on the
    kernels and on the plain route against float32's (the kernel's error
    at most BF16_RATIO times the plain one's, or within BF16_FLOOR); a
    25-step batch-2 projected morph and an image-mode demorph with their
    launches."""
    import numpy as np

    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, loss_and_grad
    from morphganformer_tpu_torch.utils.image import load_target

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = [check_bf16(torch, fc, gen, call, False) for call in kernel_calls()]
    rows += [check_bf16(torch, fc, gen, call, True) for call in kernel_calls()]

    cfg, Gb = cli.get_model("init:1024", device="cuda", dtype="bfloat16")
    assert cfg.dtype == "bfloat16" and Gb.synthesis.b1024.cfg.dtype == "bfloat16"
    fc.reset_launch_counts()
    imgs = cli.run_generate(Gb, os.path.join(tmp, "gen_bf16"), images_num=2,
                            truncation_psi=0.7, batch_size=2, seed=0)
    launches = dict(fc.launch_counts)
    print(f"  run_generate bfloat16: 2 images, launches {launches}", flush=True)
    assert imgs.shape == (2, 1024, 1024, 3) and np.isfinite(imgs).all()
    assert launches == _per_step(0, 1, bf16=True), launches

    z = torch.randn((2, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(0))
    y32 = cli.synthesize(G, z)
    yk, yp = cli.synthesize(Gb, z), cli.synthesize(Gb, z, plain=True)
    torch.cuda.synchronize()
    assert yk.dtype == yp.dtype == torch.float32          # the RGB accumulates in float32
    gaps = {k: ((y - y32).abs().mean().item(), (y - y32).abs().max().item())
            for k, y in (("kernels", yk), ("plain", yp))}
    kp = (yk - yp).abs().max().item()
    print(f"  bfloat16 forward vs float32 (mean, max abs): kernels {gaps['kernels']}, plain "
          f"{gaps['plain']}; kernels vs plain max {kp:.3e}", flush=True)
    for i, what in enumerate(("mean", "max")):
        assert gaps["kernels"][i] <= BF16_RATIO * gaps["plain"][i], (what, gaps)
    out["forward_vs_f32"] = gaps

    rates = {}
    for dt, model in (("float32", G), ("bfloat16", Gb)):
        for b in (1, 2):
            zb = z[:b].cuda()
            cli.synthesize(model, zb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: cli.synthesize(model, zb), reps=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            rates[f"{dt} batch {b}"] = dict(ms=ms, imgs_per_s=1e3 * b / ms, peak_gib=peak)
            print(f"  forward {dt} batch {b}: {ms:.3f} ms, {1e3 * b / ms:.3f} imgs/s, peak "
                  f"{peak:.3f} GiB", flush=True)
    out["forward"] = rates
    fwd = traced_forward(torch, lambda: cli.synthesize(Gb, z[:1].cuda()),
                         "bfloat16 forward batch 1")
    assert fwd["kernels"].get("conv3x3_fwd_tc_kernel", (0, 0))[1] == 4, fwd["kernels"]
    assert "conv3x3_lw_kernel" not in fwd["kernels"], fwd["kernels"]
    out["traced_forward"] = {k: fwd[k] for k in ("window_ms", "busy_ms", "device_ops")}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    res = cli.run_project(Gb, target_png, os.path.join(tmp, "proj_bf16"), steps=PROJECT_STEPS,
                          n_mean_latent=10000, chunk=25, seed=0,
                          progress=_timed_progress(stamps))
    proj_s = time.perf_counter() - t0
    proj_launches = dict(fc.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    history = res.loss_history.numpy()
    rate = _steady_rate(stamps)
    print(f"  run_project bfloat16: {PROJECT_STEPS} steps in {proj_s:.3f} s; steady {rate:.3f} "
          f"steps/s ({1e3 / rate:.3f} ms/step); peak memory {peak / 2**30:.3f} GiB; loss "
          f"{history[0]:.5f} -> best {res.best_loss:.5f} at step {res.best_step}; launches "
          f"{proj_launches}", flush=True)
    assert np.isfinite(history).all() and res.best_loss < history[0], (res.best_loss, history[0])
    assert proj_launches == _per_step(PROJECT_STEPS, 1, bf16=True), proj_launches
    assert torch.isfinite(res.best_img).all().item()
    out["project"] = dict(steps_per_s=rate, peak_gib=peak / 2**30, wall_s=proj_s,
                          first_loss=float(history[0]), best_loss=res.best_loss)

    pcfg = ProjectionConfig(steps=PROJECT_STEPS)
    mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
    latent_n = (mean[None] + torch.randn((1, cfg.k, cfg.z_dim),
                                         generator=torch.Generator().manual_seed(1))
                * std * pcfg.noise).cuda()
    target = torch.from_numpy(load_target(target_png, 1024)).cuda()
    loss_fn = build_loss_stack({"mse": 1.0})
    grads = {k: loss_and_grad(model, latent_n, target, loss_fn, pcfg, plain)[2]
             for k, model, plain in (("float32", G, False), ("kernels", Gb, False),
                                     ("plain", Gb, True))}
    scale = grads["float32"].abs().max().item()
    gk, gp = ((grads[k] - grads["float32"]).abs().max().item() / scale
              for k in ("kernels", "plain"))
    print(f"  step 0's latent gradient in bfloat16 against float32's (of its largest entry "
          f"{scale:.4e}): kernels {gk:.3e}, plain {gp:.3e}", flush=True)
    assert torch.isfinite(grads["kernels"]).all().item()
    assert gk <= max(BF16_RATIO * gp, BF16_FLOOR), (gk, gp)
    out["grad_vs_f32"] = dict(kernels=gk, plain=gp)
    fc.reset_launch_counts()
    step = traced_forward(torch, lambda: loss_and_grad(Gb, latent_n, target, loss_fn, pcfg),
                          "bfloat16 projection step batch 1")
    assert dict(fc.launch_counts) == _per_step(1, 0, bf16=True), fc.launch_counts
    assert step["kernels"].get("downconv2_tc_kernel", (0, 0))[1] == 6, step["kernels"]
    assert step["kernels"].get("conv3x3_adj_tc_kernel", (0, 0))[1] == 4, step["kernels"]
    assert step["kernels"].get("conv3x3_fwd_tc_kernel", (0, 0))[1] == 4, step["kernels"]
    assert "conv3x3_lw_kernel" not in step["kernels"], step["kernels"]
    out["traced_step"] = {k: step[k] for k in ("window_ms", "busy_ms", "device_ops")}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    fc.reset_launch_counts()
    (res_m, imgs_pm, _), = cli.run_morph_pairs(Gb, [(png_a, png_b)],
                                               os.path.join(tmp, "pm_bf16"), steps=MORPH_STEPS,
                                               chunk=5, seed=0, progress=_timed_progress(stamps))
    img_pm = imgs_pm[0]
    pair_launches = dict(fc.launch_counts)
    hist_m = res_m.loss_history.numpy()
    pair_rate = _steady_rate(stamps)
    pair_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  run_morph_pairs bfloat16, one pair: {MORPH_STEPS} steps at batch 2, "
          f"{pair_rate:.3f} "
          f"pair-steps/s, peak {pair_peak:.3f} GiB; loss {hist_m[0]:.5f} -> best "
          f"{res_m.best_loss:.5f}; launches {pair_launches}", flush=True)
    assert pair_launches == _per_step(MORPH_STEPS, 2, bf16=True), pair_launches
    assert np.isfinite(hist_m).all() and res_m.best_loss < hist_m[0]
    assert img_pm.shape == (1024, 1024, 3) and np.isfinite(img_pm).all()
    fc.reset_launch_counts()
    img_di, w_di = cli.run_demorph(Gb, out_dir=os.path.join(tmp, "demorph_bf16"),
                                   morph_img=os.path.join(tmp, "pm_bf16", "alice_bob_morph.png"),
                                   accomplice_img=png_a, steps=DEMORPH_STEPS, seed=0)
    demorph_launches = dict(fc.launch_counts)
    print(f"  image-mode demorph bfloat16: launches {demorph_launches}", flush=True)
    assert demorph_launches == _per_step(2 * DEMORPH_STEPS, 3, bf16=True), demorph_launches
    assert np.isfinite(img_di).all() and np.isfinite(w_di).all()
    out["morph"] = dict(pair_steps_per_s=pair_rate, peak_gib=pair_peak)
    del Gb
    torch.cuda.empty_cache()
    return rows, proj_launches, out


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


def _per_step(steps, forwards, bf16=False, k1=4, k2=6):
    """Exact launches of `steps` projection steps and `forwards` forwards on
    the fused blocks, `k1` K1 and `k2` K2 launches a forward (FFHQ-1024's
    three fused blocks: 4 and 6); `bf16` counts them on the bfloat16
    instantiations."""
    main = {"modconv3x3": k1 * (steps + forwards), "upconv2": k2 * (steps + forwards),
            "modconv3x3_adj": k1 * steps, "upconv2_adj": k2 * steps}
    counts = {**dict.fromkeys(main, 0), **dict.fromkeys(BF16_KEYS.values(), 0),
              **dict.fromkeys(TRAIN_KEYS.values(), 0), **dict.fromkeys(K4_KEYS, 0),
              **dict.fromkeys(TRAIN_BF16_KEYS.values(), 0)}
    counts.update({(BF16_KEYS[k] if bf16 else k): v for k, v in main.items()})
    return counts


LOSS_STEPS = 8
# (spec, --size) of phase losses: mse alone (the yardstick of the same
# call), project's default perceptual stack at the reference's lower loss
# resolution, then every other term alone. The traced ones run one step
# under torch.profiler.
LOSS_SPECS = (("mse", None), ("lpips+0.01*wing+1*mse", 256), ("awing", None),
              ("facenet", None), ("arcface", None), ("mdf", None), ("lbp", None),
              ("ssim", None))
LOSS_TRACED = ("lpips+0.01*wing+1*mse", "mdf")


def photo_png(np, face, path):
    """A photo around a square face, 1000 x 1200 (h x w) for a 1024^2 one:
    its sides extended by reflection, its top and bottom cut; neither
    square nor the face's size on either side, so load_target resizes and
    crops it."""
    from morphganformer_tpu_torch.utils.image import write_png

    r = face.shape[0]
    pad, cut = 88 * r // 1024, 12 * r // 1024
    wide = np.pad(face, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    write_png(path, wide[cut:cut + 1000 * r // 1024])
    return path


def losses_phase(torch, fc, cli, G, tmp):
    """project's whole loss stack on `cli.get_model("init:1024",
    dtype="bfloat16")`: a 1000 x 1200 PNG through load_target; for each of
    LOSS_SPECS (random perceptual weights, the bundled landmark model) a
    LOSS_STEPS-step run_project with finite losses and every term finite,
    exactly phase bf16's tensor-core launches per step, ms per step (mse
    alone the yardstick); the latent gradient at one noised latent on the
    kernels and on the plain route against float32's, held as phase bf16
    holds it; one traced step of each of LOSS_TRACED; then each loss net's
    forward + backward ms on a 1024^2 image."""
    import numpy as np

    from morphganformer_tpu_torch.losses import landmarks, pixel
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, loss_and_grad
    from morphganformer_tpu_torch.utils.image import load_target, read_png, to_uint8

    out = {}
    dev, res = next(G.parameters()).device, G.cfg.img_resolution
    z = torch.randn((1, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(21))
    png = photo_png(np, to_uint8(cli.synthesize(G, z)[0].cpu().numpy()),
                    os.path.join(tmp, "photo.png"))
    t0 = time.perf_counter()
    target = load_target(png, res)
    out["load_target_s"] = time.perf_counter() - t0
    print(f"  load_target of a {'x'.join(map(str, read_png(png).shape[:2]))} PNG (Lanczos, "
          f"centre crop): {out['load_target_s']:.3f} s", flush=True)
    assert target.shape == (1, res, res, 3) and np.isfinite(target).all()
    assert target.min() >= -1.0 and target.max() <= 1.0
    target = torch.from_numpy(target).to(dev)

    bundled = landmarks.bundled_landmark_path()
    assert bundled and os.path.exists(bundled), bundled
    nets = cli.LossNets(random_perceptual=True, landmark_weights=bundled)
    cfg, Gb = cli.get_model(f"init:{res}", device=dev, dtype="bfloat16")
    pcfg = ProjectionConfig(steps=PROJECT_STEPS)
    mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
    latent_n = (mean[None] + torch.randn((1, cfg.k, cfg.z_dim),
                                         generator=torch.Generator().manual_seed(1))
                * std * pcfg.noise).to(dev)
    terms, specs = set(), {}
    for spec, size in LOSS_SPECS:
        stamps = []
        fc.reset_launch_counts()
        result = cli.run_project(Gb, png, os.path.join(tmp, "proj_losses"), loss=spec,
                                 steps=LOSS_STEPS, chunk=1, seed=0, size=size, nets=nets,
                                 progress=_timed_progress(stamps))
        launches = dict(fc.launch_counts)
        comps = {k: v.numpy() for k, v in result.components_history.items()}
        history = result.loss_history.numpy()
        ms = 1e3 / _steady_rate(stamps)
        assert np.isfinite(history).all(), (spec, history)
        assert all(np.isfinite(v).all() for v in comps.values()), (spec, comps)
        assert launches == _per_step(LOSS_STEPS, 1, bf16=True), (spec, launches)
        loss_fn = cli.projection_loss(spec, res, dev, size=size, nets=nets)
        grads = {k: loss_and_grad(model, latent_n, target, loss_fn, pcfg, plain)[2]
                 for k, model, plain in (("float32", G, False), ("kernels", Gb, False),
                                         ("plain", Gb, True))}
        scale = grads["float32"].abs().max().item()
        gk, gp = ((grads[k] - grads["float32"]).abs().max().item() / scale
                  for k in ("kernels", "plain"))
        print(f"  {spec}" + (f" at --size {size}" if size else "") + f": {ms:.3f} ms/step "
              f"over steps 2-{LOSS_STEPS}; loss {history[0]:.5f} -> best {result.best_loss:.5f}; "
              f"terms at step 1 " + ", ".join(f"{k} {v[0, 0]:.5g}" for k, v in comps.items())
              + f"; latent gradient against float32's (of its largest entry {scale:.4e}): "
              f"kernels {gk:.3e}, plain {gp:.3e}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        assert torch.isfinite(grads["kernels"]).all().item() and scale > 0, spec
        assert gk <= max(BF16_RATIO * gp, BF16_FLOOR), (spec, gk, gp)
        terms |= set(comps)
        specs[spec] = dict(size=size, ms_per_step=ms, first_loss=float(history[0]),
                           best_loss=result.best_loss, grad_kernels=gk, grad_plain=gp)
        if spec in LOSS_TRACED:
            step = traced_forward(torch, lambda: loss_and_grad(Gb, latent_n, target, loss_fn,
                                                               pcfg),
                                  f"bfloat16 projection step under {spec}")
            specs[spec]["traced_step"] = {k: step[k] for k in ("window_ms", "busy_ms",
                                                                "device_ops")}
    out["specs"] = specs
    del Gb
    torch.cuda.empty_cache()

    img = torch.rand((1, res, res, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    img = (img * 2 - 1).requires_grad_(True)
    extra = {"mse": pixel.mse_loss, "ssim": pixel.dssim_loss,
             **cli.make_extra_terms({t: 1.0 for t in terms}, nets, dev)}
    net_ms = {}
    for name in sorted(terms):
        def fwd_bwd(term=extra[name]):
            torch.autograd.grad(term(img, target), img)
        net_ms[name] = cuda_ms(torch, fwd_bwd, reps=5, warmup=1)
    print(f"  forward + backward at {res}^2, batch 1 (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in net_ms.items()), flush=True)
    out["net_ms"] = net_ms
    print(f"  losses: terms run {sorted(terms)} (random perceptual weights; the landmark net "
          f"bundled: {os.path.relpath(bundled, REPO)})", flush=True)
    assert terms == {"lpips", "wing", "mse", "awing", "facenet", "arcface", "mdf", "lbp",
                     "ssim"}, terms
    return out


TRAIN_BATCH = 4


def train_calls():
    """The call shapes of the training roles in one 1024^2 iteration at batch
    4: (role, block, layer, base resolution, Cin, Cout, kh). The base
    resolution is the conv's output resolution for K3-forward, K2 use_dw and
    the down-conv's dw, and its input resolution for K1 dw and K3 dw."""
    calls = []
    for res, cin in ((1024, 32), (512, 64)):          # D b1024, b512 (fused)
        for role in ("K3-forward", "K2-use_dw", "K2-use_dw-dw"):
            calls += [(role, f"D b{res}", "conv1", res // 2, cin, 2 * cin, 3),
                      (role, f"D b{res}", "skip", res // 2, cin, 2 * cin, 1)]
        calls.append(("K1-dw", f"D b{res}", "conv0", res, cin, cin, 3))
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        calls += [("K3-dw", f"G b{res}", "conv0", res // 2, cin, cout, 3),
                  ("K3-dw", f"G b{res}", "skip", res // 2, cin, cout, 1),
                  ("K1-dw", f"G b{res}", "conv1", res, cout, cout, 3)]
    calls.append(("K1-dw", "G b1024", "conv_last", 1024, 32, 32, 3))
    return calls


TRAIN_KEYS = {"K3-forward": "downconv2", "K2-use_dw": "downconv2_adj",
              "K2-use_dw-dw": "downconv2_dw", "K1-dw": "modconv3x3_dw", "K3-dw": "upconv2_dw"}
# The training roles' bfloat16 entry points: their launch counts, and the
# kernel each launches (its name in a profiler trace).
TRAIN_BF16_KEYS = {role: f"{key}_bf16" for role, key in TRAIN_KEYS.items()}
TRAIN_BF16_KERNELS = {"K3-forward": "downconv2_fwd_tc_kernel", "K2-use_dw": "upconv2_tc_kernel",
                      "K2-use_dw-dw": "fir_dw_tc_kernel", "K1-dw": "conv_dw_tc_kernel",
                      "K3-dw": "fir_dw_tc_kernel"}
# The float32 least-work kernels, which no bfloat16 iteration launches
# (none has a bfloat16 instantiation).
F32_LW_KERNELS = ("downconv2_lw_kernel", "conv_dw_lw_kernel", "fir_dw_kernel",
                  "conv3x3_lw_kernel", "upconv2_lw_kernel")
K4_KEYS = ("conv3x3", "conv3x3_adj", "conv3x3_bf16", "conv3x3_adj_bf16")
# The kernel each bfloat16 role launches (its name in a profiler trace).
BF16_KERNELS = {"modconv3x3": "conv3x3_fwd_tc_kernel", "upconv2": "upconv2_tc_kernel",
                "modconv3x3_adj": "conv3x3_adj_tc_kernel", "upconv2_adj": "downconv2_tc_kernel"}
# The bfloat16 instantiations' launch counts, by their float32 role's key.
BF16_KEYS = {"modconv3x3": "modconv3x3_bf16", "upconv2": "upconv2_bf16",
             "modconv3x3_adj": "modconv3x3_adj_bf16", "upconv2_adj": "upconv2_adj_bf16"}


def train_case(torch, fc, gen, call, dt):
    """One training role at one call shape, batch 4, on random activations
    of type `dt` (the weights float32 parameters): (key, run_k, run_p,
    run_ref, run_lib, run_same, flops, elements, rel). run_k launches the
    kernel, run_p is its plain version, run_ref the plain version on the
    activations widened to float32; run_lib one cuDNN call of the bare
    convolution (without the FIR) and run_same the same-function call
    (`conv2d_weight` of the FIR-composed kernel, its fold onto w untimed;
    for K1's dw `conv2d_weight` of x * s and gd, the multiply included),
    both in `dt`; elements those of the inputs and of the output, for the
    bound; rel whether the output is held relative to its largest entry."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    from morphganformer_tpu_torch.bench_dw import same_function_dw_call
    from morphganformer_tpu_torch.bench_k3 import same_function_call
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    role, block, layer, h, cin, cout, kh = call
    dev = torch.device("cuda")
    n = TRAIN_BATCH
    f = setup_filter([1, 3, 3, 1]).cuda()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    nchw = lambda t: t.permute(0, 3, 1, 2)                              # noqa: E731
    pad = kh // 2
    if role in ("K3-forward", "K2-use_dw", "K2-use_dw-dw"):
        conv1 = layer == "conv1"
        x = randn(n, 2 * h, 2 * h, cin).to(dt)
        gz = randn(n, h, h, cout).to(dt)
        # Least work: the separable 4-tap FIR (at every input pixel before a
        # strided 3x3; at the output pixels only for the 1x1 skip) and the
        # stride-2 conv at output resolution.
        fir = 2 * n * (2 * h) ** 2 * (8 if conv1 else 3) * cin
        flops = 2 * n * h * h * kh * kh * cin * cout + fir
        if role == "K3-forward":
            b = randn(cout, scale=0.1) if conv1 else None
            r = randn(n, h, h, cout).to(dt) if conv1 else None
            gain, alpha = (1.0, 0.2) if conv1 else (math.sqrt(0.5), 1.0)
            kern, plain, args = fc.fused_downconv2, fc.downconv2_plain, (x, w, f, b, r, gain,
                                                                         alpha)
            w_lib = w.permute(3, 2, 0, 1).to(dt).contiguous()
            run_lib = lambda: F.conv2d(nchw(x), w_lib, stride=2, padding=pad)    # noqa: E731
            op, w_same, pad_same = same_function_call("K3-forward", w, f, True)
            w_same = w_same.to(dt)
            run_same = lambda: op(nchw(x), w_same, stride=2, padding=pad_same)   # noqa: E731
            elements, rel = [x, w, b, r, n * h * h * cout], False             # the last: y
        elif role == "K2-use_dw":
            kern, plain, args = fc.downconv2_adjoint, fc.downconv2_adjoint_plain, (gz, w, f)
            w_lib = w.permute(3, 2, 0, 1).to(dt).contiguous()
            run_lib = lambda: F.conv_transpose2d(nchw(gz), w_lib, stride=2, padding=pad,  # noqa
                                                 output_padding=1)
            op, w_same, pad_same = same_function_call("K2-use_dw", w, f, True)
            w_same = w_same.to(dt)
            run_same = lambda: op(nchw(gz), w_same, stride=2, padding=pad_same)  # noqa: E731
            elements, rel = [gz, w, n * 4 * h * h * cin], True               # the last: dx
        else:
            kern, plain, args = fc.downconv2_dw, fc.downconv2_dw_plain, (x, gz, w, f)
            run_lib = lambda: conv2d_weight(nchw(x), (cout, cin, kh, kh), nchw(gz),  # noqa
                                            stride=2, padding=pad)
            op, _ = same_function_dw_call(role, w, f, True)
            run_same = lambda: op(nchw(x), nchw(gz))                                # noqa: E731
            elements, rel = [x, gz, kh * kh * cin * cout], True
    else:
        x = randn(n, h, h, cin).to(dt)
        s = (torch.rand((n, cin), generator=gen, device=dev) + 0.5) if block[0] == "G" else None
        if role == "K1-dw":
            gd = randn(n, h, h, cout).to(dt)
            kern, args = fc.conv_dw, (x, gd, s)
            plain = lambda *a: fc.conv_dw_plain(*a, 1, 1, 3, (0, 0))[0]           # noqa: E731
            run_lib = lambda: conv2d_weight(nchw(x), (cout, cin, 3, 3), nchw(gd),   # noqa: E731
                                            padding=1)

            def run_same():
                xs = x if s is None else (x * s[:, None, None, :]).to(dt)
                return conv2d_weight(nchw(xs), (cout, cin, 3, 3), nchw(gd), padding=1)
            flops = 2 * n * h * h * 9 * cin * cout
            elements = [x, gd, s, 9 * cin * cout]
        else:
            gd = randn(n, 2 * h, 2 * h, cout).to(dt)
            kern, plain, args = fc.upconv2_dw, fc.upconv2_dw_plain, (x, gd, s, w, f)
            run_lib = lambda: conv2d_weight(nchw(gd), (cin, cout, kh, kh), nchw(x),  # noqa
                                            stride=2, padding=pad)
            op, _ = same_function_dw_call(role, w, f, False)
            xs = (x * s[:, None, None, :]).to(dt)
            run_same = lambda: op(nchw(gd), nchw(xs))                               # noqa: E731
            # The weight gradient of a transposed conv at input resolution
            # and the FIR's adjoint, separable: at every output-resolution
            # gd value before a 3x3's taps, at the even positions only
            # (3 per gd value) before the 1x1 skip's one tap.
            fir = 2 * n * (2 * h) ** 2 * (8 if kh == 3 else 3) * cout
            flops = 2 * n * h * h * kh * kh * cin * cout + fir
            elements = [x, gd, s, kh * kh * cin * cout]
        rel = True
    wide = tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == dt else a for a in args)
    key = TRAIN_KEYS[role] + ("" if dt == torch.float32 else "_bf16")
    return (key, lambda: kern(*args), lambda: plain(*args), lambda: plain(*wide), run_lib,
            run_same, flops, elements, rel)


def check_train_kernel(torch, fc, gen, call):
    """One training role at one call shape, batch 4 (`train_case`), in
    float32: kernel against plain on random inputs (1e-3 max abs, or 1e-4
    of the largest entry), times, bound, one cuDNN call of the bare
    convolution (without the FIR) and the same-function call as
    yardsticks."""
    role, block, layer = call[:3]
    key, run_k, run_p, _, run_lib, run_same, flops, elements, rel = train_case(
        torch, fc, gen, call, torch.float32)
    before = fc.launch_counts[key]
    got = run_k()
    assert fc.launch_counts[key] == before + 1, (role, fc.launch_counts)
    want = run_p()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"  {role} {block} {layer}: out {tuple(got.shape)} max_abs_err {err:.3e} "
          f"(largest entry {scale:.3e})", flush=True)
    assert torch.isfinite(got).all().item() and got.shape == want.shape
    if rel:
        assert err <= 1e-4 * scale, f"{role} {block} {layer}: err {err} > 1e-4 of {scale}"
    else:
        assert err <= 1e-3, f"{role} {block} {layer}: max abs err {err} > 1e-3"
    nbytes = 4 * sum(t if isinstance(t, int) else t.numel() for t in elements if t is not None)
    bound_ms, bound_by = bound(flops, nbytes)
    ms = cuda_ms(torch, run_k, reps=5, warmup=1)
    plain_ms = cuda_ms(torch, run_p, reps=3, warmup=1)
    library_ms = cuda_ms(torch, run_lib, reps=5, warmup=1)
    same_ms = cuda_ms(torch, run_same, reps=5, warmup=1)
    print(f"  {role} {block} {layer}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f}{_same(same_ms)} bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return dict(kernel=role, block=block, role=layer, max_abs_err=err, ref_scale=scale, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, same_function_ms=same_ms,
                bound_ms=bound_ms, bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6)


def per_iteration(rounds=1):
    """Exact launches of one training iteration, derived from the fused
    blocks. G_main: G's forward (4 K1, 6 K2) and backward with dw (4 K1-adj,
    6 K3-adj, 4 K1-dw, 6 K3-dw); D's two fused blocks forward (per block 1
    K1 for conv0, 2 K3-forward for skip and conv1) and backward to its input
    only (per block 1 K1-adj, 2 K2-use_dw). D_main: G's forward without a
    graph, then D forward and backward with dw on fakes and on reals (per
    block and pass 1 K1-adj, 2 K2-use_dw, 1 K1-dw, 2 K2-use_dw-dw)."""
    g_main = {"modconv3x3": 4 + 2, "upconv2": 6, "downconv2": 4, "modconv3x3_adj": 4 + 2,
              "upconv2_adj": 6, "downconv2_adj": 4, "modconv3x3_dw": 4, "upconv2_dw": 6,
              "downconv2_dw": 0}
    d_main = {"modconv3x3": 4 + 2 * 2, "upconv2": 6, "downconv2": 2 * 4,
              "modconv3x3_adj": 2 * 2, "upconv2_adj": 0, "downconv2_adj": 2 * 4,
              "modconv3x3_dw": 2 * 2, "upconv2_dw": 0, "downconv2_dw": 2 * 4}
    counts = {k: rounds * (g_main[k] + d_main[k]) for k in g_main}
    return {**counts, **dict.fromkeys(K4_KEYS, 0), **dict.fromkeys(BF16_KEYS.values(), 0),
            **dict.fromkeys(TRAIN_BF16_KEYS.values(), 0)}


def as_bf16(counts):
    """Launch counts by role as a bfloat16 run makes them: each role's
    under its `_bf16` key."""
    out = dict.fromkeys(counts, 0)
    for k, v in counts.items():
        out[f"{k}_bf16" if f"{k}_bf16" in counts else k] += v
    return out


def check_per_sample_noise(torch, fc, gen):
    """K1 and K2 forward and their adjoints (the K1 adjoint launch, K3) with
    per-sample noise [N,H,W] of non-zero strength, at the noisy call shapes
    of a 1024^2 training iteration (batch 4), against the plain versions:
    forwards to 1e-4 max abs, adjoints to 1e-4 of each output's largest
    entry, as in phase kernels. Returns the worst of each."""
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    dev = torch.device("cuda")
    n = TRAIN_BATCH
    f = setup_filter([1, 3, 3, 1]).cuda()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    worst = {"forward": 0.0, "adjoint": 0.0}
    for kernel, block, role, h, cin, cout in kernel_calls():
        if role in ("skip", "conv_last"):                  # no noise there
            continue
        x, w = randn(n, h, h, cin), randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        s = torch.rand((n, cin), generator=gen, device=dev) + 0.5
        bias = randn(cout, scale=0.1)
        before = dict(fc.launch_counts)
        if kernel == "K1":
            noise, resid = randn(n, h, h, scale=0.1), randn(n, h, h, cout)
            fwd = (x, w, s, noise, bias, resid, 1.0, 0.2, True)
            yk, yp = fc.fused_modconv3x3(*fwd), fc.modconv3x3_plain(*fwd)
            adj = (randn(*yp.shape), x, w, s, yp, noise, bias, resid, 1.0, 0.2, True)
            got, want = fc.modconv3x3_adjoint(*adj), fc.modconv3x3_adjoint_plain(*adj)
            keys = ("modconv3x3", "modconv3x3_adj")
        else:
            noise = randn(n, 2 * h, 2 * h, scale=0.1)
            fwd = (x, w, s, f, noise, bias, math.sqrt(2), 0.2, True, False)
            yk, yp = fc.fused_upconv2(*fwd), fc.upconv2_plain(*fwd)
            adj = (randn(*yp.shape), x, w, s, f, yp, noise, bias, math.sqrt(2), 0.2, True, False)
            got, want = fc.upconv2_adjoint(*adj), fc.upconv2_adjoint_plain(*adj)
            keys = ("upconv2", "upconv2_adj")
        torch.cuda.synchronize()
        assert [fc.launch_counts[k] - before[k] for k in keys] == [1, 1], fc.launch_counts
        fwd_err = (yk - yp).abs().max().item()
        adj_err = max(_rel_err(a, b) for a, b in zip(got, want) if b is not None)
        print(f"  per-sample noise {tuple(noise.shape)}: {kernel} {block} {role} forward max "
              f"abs err {fwd_err:.3e}; adjoint (dx, ds, dd1, dd2) rel err {adj_err:.3e}",
              flush=True)
        assert fwd_err <= 1e-4, f"{kernel} {block} {role} per-sample noise forward: {fwd_err}"
        assert adj_err <= 1e-4, f"{kernel} {block} {role} per-sample noise adjoint: {adj_err}"
        worst["forward"] = max(worst["forward"], fwd_err)
        worst["adjoint"] = max(worst["adjoint"], adj_err)
    return worst


PL_BATCH = TRAIN_BATCH // 2


def grad_calls():
    """The call shapes of the grad Functions in the reg stages at 1024^2:
    (kind, block, layer, base resolution, Cin, Cout, kh, batch). Path length
    runs G's fused blocks at batch 2 (pl_batch_shrink), R1 D's at batch 4.
    The base resolution is the input's for K1 and K2 and the output's for
    the D down-conv."""
    calls = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        calls += [("K2", f"G b{res}", "conv0", res // 2, cin, cout, 3, PL_BATCH),
                  ("K2", f"G b{res}", "skip", res // 2, cin, cout, 1, PL_BATCH),
                  ("K1", f"G b{res}", "conv1", res, cout, cout, 3, PL_BATCH)]
    calls.append(("K1", "G b1024", "conv_last", 1024, 32, 32, 3, PL_BATCH))
    for res, cin in ((1024, 32), (512, 64)):
        calls += [("K1", f"D b{res}", "conv0", res, cin, cin, 3, TRAIN_BATCH),
                  ("down", f"D b{res}", "conv1", res // 2, cin, 2 * cin, 3, TRAIN_BATCH),
                  ("down", f"D b{res}", "skip", res // 2, cin, 2 * cin, 1, TRAIN_BATCH)]
    return calls


def grad_case(torch, so, gen, call, dt):
    """One grad Function's second-order term at one call shape: random
    activations of type `dt` (x, the forward's resid, g and the x-sized
    cotangent cdx; the weights, styles, noise, bias and cds float32) at the
    cotangents its stage feeds (path length cdx and cds, R1 cdx alone).
    Returns (names, w, acts, fwd, vjp): fwd(w_, acts) is the plain forward's
    y, vjp(w_, y, acts, plain) the term's outputs (`modconv3x3_bwd_vjp`,
    `upconv2_bwd_vjp` or `downconv2_bwd_vjp`, the backwards of
    ModConv3x3Grad, UpConv2Grad and DownConv2Grad); acts = (x, g, resid,
    cots)."""
    from morphganformer_tpu_torch.ops import fused_conv as fc
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    kind, block, layer, h, cin, cout, kh, n = call
    dev = torch.device(DEV)
    f = setup_filter([1, 3, 3, 1]).to(dev)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    styled = block[0] == "G" and layer != "skip"
    s = (torch.rand((n, cin), generator=gen, device=dev) + 0.5) if styled else None
    if kind == "K1":
        x = randn(n, h, h, cin).to(dt)
        noisy = layer == "conv1"
        noise = randn(n, h, h, scale=0.1) if noisy else None
        bias = randn(cout, scale=0.1) if layer != "conv_last" else None
        resid = randn(n, h, h, cout).to(dt) if noisy else None
        gain, alpha = (math.sqrt(2), 0.2) if layer != "conv_last" else (1.0, 1.0)
        names = ("c_x", "c_w", "c_s", "c_noise", "c_bias", "c_resid", "c_y", "c_g")

        def fwd(w_, a):
            return fc.modconv3x3_plain(a[0], w_, s, noise, bias, a[2], gain, alpha, styled)

        def vjp(w_, y, a, plain):
            x_, g_, r_, cots = a
            return so.modconv3x3_bwd_vjp(x_, w_, s, noise, bias, r_, y, g_, cots, gain, alpha,
                                         styled, plain)
        g = randn(n, h, h, cout).to(dt)
    elif kind == "K2":
        x = randn(n, h, h, cin).to(dt)
        noise = randn(n, 2 * h, 2 * h, scale=0.1) if styled else None
        bias = randn(cout, scale=0.1) if styled else None
        resid = None
        gain, alpha = (math.sqrt(2), 0.2) if styled else (math.sqrt(0.5), 1.0)
        names = ("c_x", "c_w", "c_s", "c_noise", "c_bias", "c_y", "c_g")

        def fwd(w_, a):
            return fc.upconv2_plain(a[0], w_, s, f, noise, bias, gain, alpha, styled)

        def vjp(w_, y, a, plain):
            x_, g_, _, cots = a
            return so.upconv2_bwd_vjp(x_, w_, s, f, noise, bias, y, g_, cots, gain, alpha,
                                      styled, False, plain)
        g = randn(n, 2 * h, 2 * h, cout).to(dt)
    else:
        x = randn(n, 2 * h, 2 * h, cin).to(dt)
        conv1 = layer == "conv1"
        bias = randn(cout, scale=0.1) if conv1 else None
        resid = randn(n, h, h, cout).to(dt) if conv1 else None
        gain, alpha = (1.0, 0.2) if conv1 else (math.sqrt(0.5), 1.0)
        names = ("c_x", "c_w", "c_g")

        def fwd(w_, a):
            return fc.downconv2_plain(a[0], w_, f, bias, a[2], gain, alpha)

        def vjp(w_, y, a, plain):
            x_, g_, r_, cots = a
            return so.downconv2_bwd_vjp(x_, w_, f, r_, y, g_, cots, gain, alpha, True, plain)
        g = randn(n, h, h, cout).to(dt)
    cdx = randn(*x.shape).to(dt)
    if kind == "down":
        cots = (cdx, None, None)
    else:
        cots = (cdx, None, randn(n, cin) if styled else None, None, None)
    return names, w, (x, g, resid, cots), fwd, vjp


def check_grad_vjp(torch, so, gen, call):
    """The second-order term of one grad Function at one call shape
    (`grad_case`, float32) on the kernels against the plain versions, with
    y the plain forward's output: each output (c_x, c_w, c_s, c_noise,
    c_bias, c_resid, c_y, c_g) within 1e-4 of its largest entry. Printed
    beside it, a control of float32 rounding: plain with w nudged by 1e-6
    of itself and the same y (so the same lrelu masks), against plain.
    Times of either route (CUDA events)."""
    kind, block, layer, n = call[0], call[1], call[2], call[7]
    names, w, acts, fwd, vjp = grad_case(torch, so, gen, call, torch.float32)
    y = fwd(w, acts)
    got, want = vjp(w, y, acts, False), vjp(w, y, acts, True)
    ctrl = vjp(w * (1 + 1e-6 * torch.randn(w.shape, generator=gen, device=w.device)), y, acts,
               True)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, c in zip(names, got, want, ctrl):
        assert (a is None) == (b is None), (block, layer, name)
        if b is None:
            continue
        assert torch.isfinite(a).all().item(), (block, layer, name)
        scale = max(b.abs().max().item(), 1e-30)
        errs[name] = ((a - b).abs().max().item() / scale, (c - b).abs().max().item() / scale)
    ms = cuda_ms(torch, lambda: vjp(w, y, acts, False), reps=3, warmup=1)
    plain_ms = cuda_ms(torch, lambda: vjp(w, y, acts, True), reps=2, warmup=1)
    print(f"  grad VJP {kind} {block} {layer} batch {n}: rel err (control) "
          + ", ".join(f"{k} {e:.3e} ({c:.3e})" for k, (e, c) in errs.items())
          + f"; ms kernels {ms:.3f}, plain {plain_ms:.3f}", flush=True)
    for name, (e, c) in errs.items():
        assert e <= 1e-4, f"grad VJP {kind} {block} {layer} {name}: {e} (control {c})"
    return dict(kind=kind, block=block, layer=layer, batch=n, errors=errs, ms=ms,
                plain_ms=plain_ms)


@contextlib.contextmanager
def plain_backwards(fc):
    """The fused Functions' backwards on the plain versions while their
    forwards stay on the kernels: each backward helper takes `plain` as its
    last positional argument."""
    saved = {n: getattr(fc, n) for n in
             ("modconv3x3_backward", "upconv2_backward", "downconv2_backward")}
    try:
        for n, fn in saved.items():
            setattr(fc, n, lambda *a, _fn=fn: _fn(*a[:-1], True))
        yield
    finally:
        for n, fn in saved.items():
            setattr(fc, n, fn)


@contextlib.contextmanager
def nudged(torch, nets, gen, rel):
    """Every parameter of `nets` times (1 + rel * N(0, 1)), restored after."""
    params = [p for net in nets for p in net.parameters()]
    saved = [p.detach().clone() for p in params]
    try:
        with torch.no_grad():
            for p in params:
                p.mul_(1 + rel * torch.randn(p.shape, generator=gen, device=p.device))
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)


def leaf_errors(names, got, want, floor):
    """Each leaf's max abs error relative to its largest entry, floored at
    `floor`: [(relative error, name, largest entry, abs error, is a noise
    strength)], worst first."""
    rows = []
    for name, a, b in zip(names, got, want):
        err, scale = (a - b).abs().max().item(), b.abs().max().item()
        rows.append((err / max(scale, floor), name, scale, err, name.endswith("noise_strength")))
    return sorted(rows, reverse=True)


def pooled_strengths(rows):
    """The noise strengths (one scalar per layer) as one vector leaf: the
    largest abs error over its largest entry."""
    strengths = [r for r in rows if r[4]]
    if not strengths:
        return 0.0
    return max(r[3] for r in strengths) / max(r[2] for r in strengths)


def _fmt(rows, k=3):
    return [(r[1], f"{r[0]:.3e}", f"{r[2]:.3e}") for r in rows[:k]]


F64_RATIO = 2   # a check float32 misses: the kernels no further from float64 than 2x plain


def main_round_checks(torch, fc, trainer, state, z, real, gen, c=None, f64_rule=False):
    """One G_main and one D_main round (z [1, B, k, z_dim], real [1, B, R,
    R, 3], labels c [1, B, c_dim] or None) at the state's weights with the
    noise strengths (0 at init) set to U(0.05, 0.15) from `gen`, so the
    per-sample noise reaches the kernels' epilogues and dd taps; both put
    back after. Every run draws from a generator seeded alike, in an order
    that does not depend on the path. Four runs per stage: on the kernels;
    plain; the kernels' forward with the plain backward (one forward, so
    only the backward differs); and plain with every weight nudged by 1e-6
    of itself, printed only: how far the stage moves under a perturbation
    of every weight the size of the kernels' forward rounding. Errors are
    relative to each leaf's largest entry, floored at 1e-3 of the stage's
    largest entry (leaves of zero true gradient: the key biases before a
    softmax). Checks: backward alone, every leaf on its own within 1e-3;
    kernels against plain, every other leaf on its own within 1e-3 and the
    noise strengths as one vector leaf within 1e-3 of its largest entry
    (each is a sum of g * noise over its layer that cancels down to a small
    value, which pre-activations rounding to the other side of zero move by
    about 1e-3 of itself); the loss within 1e-4.

    With `f64_rule`, a fifth run, plain on float64 copies of the nets (the
    same draws, made in float32), judges what misses those bounds: such a
    leaf, the pooled strengths or the loss passes when the kernels' run is
    no further from float64 than F64_RATIO times the run it was held
    against (plain, or the kernels' forward with the plain backward): a
    stage that float32 rounding alone moves past the bound, to which the
    kernels add no error that float32 does not. Returns (errors by stage,
    ms by run)."""
    import copy
    import dataclasses

    w_avg = state.G.mapping.w_avg.clone()
    strengths = set_noise_strengths(torch, state.G, gen)
    assert strengths
    state64 = (dataclasses.replace(state, G=copy.deepcopy(state.G).double(),
                                   D=copy.deepcopy(state.D).double())
               if f64_rule else None)

    def one_round(stage, plain=False, st=state):
        dt = st.G.mapping.w_avg.dtype
        st.G.mapping.w_avg.copy_(w_avg)
        rng = torch.Generator(device="cuda").manual_seed(11)
        zz, cc = z.to(dt), (None if c is None else c.to(dt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if stage == "g":
            grads, stats = trainer.g_main_grads(st, zz, gen=rng, plain=plain, c=cc)
        else:
            grads, stats = trainer.d_main_grads(st, real.to(dt), zz, gen=rng, plain=plain, c=cc)
        torch.cuda.synchronize()
        return (grads, host(stats)), (time.perf_counter() - t0) * 1e3

    errs, round_ms = {}, {}
    for stage, net in (("g", state.G), ("d", state.D)):
        runs = {"kernels": one_round(stage), "plain": one_round(stage, plain=True)}
        before = dict(fc.launch_counts)
        with plain_backwards(fc):
            runs["kernel_fwd_plain_bwd"] = one_round(stage)
        assert all(fc.launch_counts[k] == before[k] for k in before
                   if k.endswith(("_adj", "_dw"))), "a backward kernel ran under plain_backwards"
        with nudged(torch, (state.G, state.D), torch.Generator(device="cuda").manual_seed(3),
                    1e-6):
            runs["plain_nudged"] = one_round(stage, plain=True)
        if f64_rule:
            runs["plain_float64"] = one_round(stage, plain=True, st=state64)
        names = [n for n, _ in net.named_parameters()]
        (got, stats_k), (want, stats_p) = runs["kernels"][0], runs["plain"][0]
        bwd_ref = runs["kernel_fwd_plain_bwd"][0][0]
        assert all(torch.isfinite(t).all().item() for t in got)
        floor = 1e-3 * max(t.abs().max().item() for t in want)
        bwd = leaf_errors(names, got, bwd_ref, floor)
        full = leaf_errors(names, got, want, floor)
        ctrl = leaf_errors(names, runs["plain_nudged"][0][0], want, floor)
        others = [r for r in full if not r[4]]
        strength_worst = {k: max((r[0] for r in rows if r[4]), default=0.0)
                          for k, rows in (("bwd", bwd), ("full", full), ("ctrl", ctrl))}
        loss_key = next(k for k in stats_p if k.endswith("/loss"))
        loss_err = abs(stats_k[loss_key] - stats_p[loss_key])
        e = errs[stage] = dict(backward=bwd[0][0], other_leaves=others[0][0],
                               noise_strengths_pooled=pooled_strengths(full),
                               noise_strength_worst=strength_worst, control_worst=ctrl[0][0],
                               loss_abs_err=loss_err)
        for k, (_, ms) in runs.items():
            round_ms[f"{stage}_{k}"] = ms
        print(f"  one {stage.upper()}_main round ({len(names)} leaves; floor {floor:.3e}), "
              f"{loss_key} kernels {stats_k[loss_key]:.6f} plain {stats_p[loss_key]:.6f}:\n"
              f"    backward alone (kernels vs plain backward, one forward): worst "
              f"{bwd[0][0]:.3e} {_fmt(bwd)}; worst noise strength {strength_worst['bwd']:.3e}\n"
              f"    kernels vs plain: other leaves worst {others[0][0]:.3e} {_fmt(others)}; "
              f"noise strengths as one {e['noise_strengths_pooled']:.3e}, worst on "
              f"its own {strength_worst['full']:.3e} {_fmt([r for r in full if r[4]])}\n"
              f"    control (plain, weights nudged by 1e-6, vs plain): worst {ctrl[0][0]:.3e} "
              f"{_fmt(ctrl)}; worst noise strength {strength_worst['ctrl']:.3e} "
              f"{_fmt([r for r in ctrl if r[4]])}\n"
              f"    ms: " + ", ".join(f"{k} {ms:.3f}" for k, (_, ms) in runs.items()),
              flush=True)
        # (what, the error, its bound, the run under test and the run it is
        # held against as (grads, loss), and the leaves the error covers)
        over = [(f"{stage} backward {r[1]}", r[0], 1e-3, "kernels", "kernel_fwd_plain_bwd",
                 [r[1]]) for r in bwd if r[0] > 1e-3]
        over += [(f"{stage} {r[1]}", r[0], 1e-3, "kernels", "plain", [r[1]])
                 for r in others if r[0] > 1e-3]
        if e["noise_strengths_pooled"] > 1e-3:
            over.append((f"{stage} noise strengths", e["noise_strengths_pooled"], 1e-3,
                         "kernels", "plain", [r[1] for r in full if r[4]]))
        if loss_err > 1e-4 * max(1.0, abs(stats_p[loss_key])):
            over.append((f"{stage} {loss_key}", loss_err, 1e-4, "kernels", "plain", None))
        if not f64_rule:
            assert not over, f"{stage.upper()}_main kernels vs plain: {over}; {e}"
            continue
        want64, stats64 = runs["plain_float64"][0]
        floor64 = 1e-3 * max(t.abs().max().item() for t in want64)
        to64 = {k: {r[1]: r for r in leaf_errors(names, runs[k][0][0], want64, floor64)}
                for k in ("kernels", "plain", "kernel_fwd_plain_bwd")}
        plain64 = sorted(to64["plain"].values(), reverse=True)

        def from64(run, leaves):
            if leaves is None:
                return abs(runs[run][0][1][loss_key] - stats64[loss_key])
            rows = [to64[run][n] for n in leaves]
            return rows[0][0] if len(rows) == 1 else pooled_strengths(rows)

        judged = []
        for what, err, bound, run, ref, leaves in over:
            k64, ref64 = from64(run, leaves), from64(ref, leaves)
            ratio = k64 / ref64 if ref64 > 0 else (0.0 if k64 == 0 else math.inf)
            judged.append(dict(what=what, error=err, bound=bound, kernels_vs_f64=k64,
                               held_against_vs_f64=ref64, ratio=ratio))
        worst = max(judged, key=lambda j: j["ratio"], default=None)
        e["float64"] = dict(judged=len(judged), worst=worst,
                            plain_vs_f64_worst=plain64[0][0], plain_vs_f64_leaves_over_1e3=sum(
                                r[0] > 1e-3 for r in plain64),
                            loss64=stats64[loss_key])
        print(f"    float64 rule: {len(judged)} checks over their bound, worst kernels / held-"
              f"against distance to float64 {worst['ratio'] if worst else 0.0:.3f} "
              f"({worst['what'] if worst else '-'}); plain float32 vs float64: worst leaf "
              f"{plain64[0][0]:.3e} {_fmt(plain64)}, {e['float64']['plain_vs_f64_leaves_over_1e3']} "
              f"of {len(names)} leaves past 1e-3; {loss_key} float64 {stats64[loss_key]:.6f}",
              flush=True)
        failed = sorted((j for j in judged if j["ratio"] > F64_RATIO), key=lambda j: -j["ratio"])
        assert not failed, (f"{stage.upper()}_main kernels vs plain, float64 rule: {len(failed)} "
                            f"of {len(judged)} over, worst {failed[:5]}; {e}")
    del state64
    with torch.no_grad():
        for p in strengths:
            p.zero_()
    state.G.mapping.w_avg.copy_(w_avg)
    return errs, round_ms


def launch_events_ms(torch, fn, reps=5):
    """The kernel's own device ms in one call of `fn`, from CUDA events
    recorded on the launch's stream just before and after each kernel
    launch (`_launch` of ops/fused_conv.py and ops/conv3x3.py), summed over
    a call and averaged over `reps` calls after a warm one. (In the full
    script the profiler attributes no device time to most of these
    kernels: PR 23's runs left them null.)"""
    from morphganformer_tpu_torch.ops import conv3x3 as k4
    from morphganformer_tpu_torch.ops import fused_conv as fc

    real, events = fc._launch, []

    def timed(name, *args):
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        real(name, *args)
        pair[1].record()
        events.append(pair)
    fn()
    fc._launch = k4._launch = timed
    try:
        for _ in range(reps):
            fn()
    finally:
        fc._launch = k4._launch = real
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / reps


def check_train_kernel_bf16(torch, fc, gen, call):
    """One training role in bfloat16 at one call shape, batch 4
    (`train_case`; the `_bf16` entry points: K3-forward
    `downconv2_fwd_tc_kernel`, K1's dw `conv_dw_tc_kernel`, K2's use_dw role
    `upconv2_tc_kernel`, the FIR dw `fir_dw_tc_kernel`, all on the tensor
    cores):
    the kernel and the plain bfloat16 version, each
    against the float32 plain version on the same bfloat16-rounded
    activations, phase bf16's rule (the kernel's error at most BF16_RATIO
    times the plain one's, or within BF16_FLOOR of the output's largest
    entry). Times of the kernel (its wrapper; and the kernel's own device
    time from its launch's CUDA events), the plain version, cuDNN's bfloat16 call of
    the bare convolution and the same-function call in bfloat16; the bound
    at 2 bytes an element and the bf16 tensor-core peak."""
    role, block, layer = call[:3]
    key, run_k, run_p, run_ref, run_lib, run_same, flops, elements, _ = train_case(
        torch, fc, gen, call, torch.bfloat16)
    before = dict(fc.launch_counts)
    got = run_k()
    assert fc.launch_counts[key] == before[key] + 1, (role, fc.launch_counts)
    assert fc.launch_counts[TRAIN_KEYS[role]] == before[TRAIN_KEYS[role]], role
    plain, ref = run_p(), run_ref()
    torch.cuda.synchronize()
    assert got.dtype == plain.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all().item()
    ek, ep, kp = _bf16_errs((got,), (plain,), (ref,))
    print(f"  {role} bf16 {block} {layer}: vs float32 on the same inputs, kernel {ek:.3e}, "
          f"plain {ep:.3e} (of the largest entry); kernel vs plain {kp:.3e}", flush=True)
    assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), \
        f"{role} bf16 {block} {layer}: kernel err {ek} > max({BF16_RATIO} x {ep}, {BF16_FLOOR})"
    bound_ms, bound_by = bf16_bound(flops, sum(t if isinstance(t, int) else t.numel()
                                               for t in elements if t is not None))
    ms = cuda_ms(torch, run_k, reps=5, warmup=1)
    plain_ms = cuda_ms(torch, run_p, reps=1, warmup=0)     # warm: it ran for the check
    library_ms = cuda_ms(torch, run_lib, reps=5, warmup=1)
    same_ms = cuda_ms(torch, run_same, reps=5, warmup=1)
    kernel_ms = launch_events_ms(torch, run_k)
    print(f"  {role} bf16 {block} {layer}: ms {ms:.4f} (kernel's device ms {kernel_ms:.4f}) "
          f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f}{_same(same_ms)} "
          f"bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return dict(kernel=f"{role} bf16", block=block, role=layer, batch=TRAIN_BATCH,
                max_abs_err=kp, err_kernel=ek, err_plain=ep, ms=ms, kernel_device_ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms, same_function_ms=same_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_d_conv0_bf16(torch, fc, gen, res, c):
    """D's conv0 at one of its two 1024^2 call shapes, batch 4, in bfloat16
    through the tensor-core kernels with no styles and no demodulation:
    the forward (bias, lrelu) and the adjoint's dx alone (what D's backward
    asks for), and the second-order route's degenerate forward (gain =
    alpha = 1, no bias, a resid) and dx; each against the float32 plain
    version by phase bf16's rule. Returns the worst errors."""
    dev, bf = torch.device("cuda"), torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def f32(args):
        return tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == bf else a
                     for a in args)

    x = randn(TRAIN_BATCH, res, res, c).to(bf)
    w = randn(3, 3, c, c, scale=1 / math.sqrt(9 * c))
    g = randn(TRAIN_BATCH, res, res, c).to(bf)
    worst = (0.0, 0.0)
    for label, fwd in (("conv0", (x, w, None, None, randn(c, scale=0.1), None, math.sqrt(2),
                                  0.2, False)),
                       ("degenerate", (x, w, None, None, None,
                                       randn(TRAIN_BATCH, res, res, c).to(bf), 1.0, 1.0,
                                       False))):
        before = dict(fc.launch_counts)
        y = fc.fused_modconv3x3(*fwd)
        args = (g, x, w, None, y, None, fwd[4], fwd[5], fwd[6], fwd[7], False)
        dx = fc.modconv3x3_adjoint(*args, need_ds=False)[0]
        torch.cuda.synchronize()
        assert fc.launch_counts["modconv3x3_bf16"] == before["modconv3x3_bf16"] + 1
        assert fc.launch_counts["modconv3x3_adj_bf16"] == before["modconv3x3_adj_bf16"] + 1
        ek, ep, _ = _bf16_errs((y, dx), (fc.modconv3x3_plain(*fwd),
                                         fc.modconv3x3_adjoint_plain(*args, need_ds=False)[0]),
                               (fc.modconv3x3_plain(*f32(fwd)),
                                fc.modconv3x3_adjoint_plain(*f32(args), need_ds=False)[0]))
        print(f"  K1 bf16 D b{res} {label}, no styles (forward and dx): vs float32, kernel "
              f"{ek:.3e}, plain {ep:.3e}", flush=True)
        assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), (res, label, ek, ep)
        worst = (max(worst[0], ek), max(worst[1], ep))
    return worst


def check_grad_vjp_bf16(torch, so, gen, call):
    """`grad_case` in bfloat16 (the second-order route's launches on the
    `_bf16` entry points): kernels and plain versions, each against the
    plain version on the same values in float32, by phase bf16's rule on
    every output. Returns the worst errors and the kernels' ms."""
    from morphganformer_tpu_torch.ops import fused_conv as fc

    kind, block, layer, n = call[0], call[1], call[2], call[7]
    _, w, acts, fwd, vjp = grad_case(torch, so, gen, call, torch.bfloat16)
    y = fwd(w, acts)
    before = dict(fc.launch_counts)
    got = vjp(w, y, acts, False)
    launched = {k: v - before[k] for k, v in fc.launch_counts.items() if v != before[k]}
    assert launched and all(k.endswith("_bf16") for k in launched), launched
    plain = vjp(w, y, acts, True)
    x, g, resid, cots = acts
    wide = (x.float(), g.float(), None if resid is None else resid.float(),
            tuple(None if c is None else c.float() for c in cots))
    ref = vjp(w, y.float(), wide, True)
    torch.cuda.synchronize()
    assert all(a is None or torch.isfinite(a).all().item() for a in got)
    ek, ep, kp = _bf16_errs(got, plain, ref)
    ms = cuda_ms(torch, lambda: vjp(w, y, acts, False), reps=2, warmup=1)
    print(f"  grad VJP bf16 {kind} {block} {layer} batch {n}: vs float32, kernels {ek:.3e}, "
          f"plain {ep:.3e}; kernels vs plain {kp:.3e}; ms kernels {ms:.3f}; launches "
          f"{launched}", flush=True)
    assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), f"grad VJP bf16 {kind} {block} {layer}"
    return dict(kind=kind, block=block, layer=layer, err_kernel=ek, err_plain=ep, ms=ms)


SMALL_LEAF = 256       # leaves of fewer entries are held as one vector leaf (bf16 stages)


@contextlib.contextmanager
def plain_wrappers(fc):
    """Every kernel wrapper on its plain version, on the card too (each takes
    the plain version where `_on_cpu` says so): a stage's plain route, the
    second-order one included."""
    real = fc._on_cpu
    fc._on_cpu = lambda x: True
    try:
        yield
    finally:
        fc._on_cpu = real


def bf16_train_checks(torch, fc, gen, g_cfg, d_cfg, reals):
    """Training in bfloat16 at 1024^2, batch 4 (`train --dtype bfloat16`):
    a bfloat16 GANTrainer and a float32 one from the same seed (so the same
    weights), noise strengths set alike.
      1. Each stage's parameter gradients (G_main, G_reg, D_main, D_reg; one
         round, the same draws on every route): the bfloat16 route on the
         kernels and on the plain versions (`plain_wrappers`), each against
         the float32 plain route, by relative L2 error: each weight whose
         cotangent a dw kernel forms (the fused blocks' conv weights) at
         most BF16_RATIO times the plain bfloat16 route's, or within
         BF16_FLOOR; the other leaves as one vector, the leaves of fewer
         than SMALL_LEAF entries as one (as phase train holds the noise
         strengths) and the stage's whole gradient the same way. The two
         routes round at other places (the kernels the small weights, the
         plain versions the FIR-composed ones), so their errors are two
         draws of one size. On an H100 a leaf's largest entry error
         differed by up to 2x between them (medians 0.88-1.14), and so did
         the L2 error of leaves far from the kernels whose error is a few
         directions carried through the whole net (the mapping's and
         attention's, up to 1.55x at a median of 0.88).
      2. train_iteration at step 16 (all four stages due) in bfloat16 and
         in float32 (warm: part 1 ran every stage in both types): seconds,
         each stage's milliseconds, peak memory; the bfloat16 one's
         launches exactly phase reg's per-iteration launches on the `_bf16`
         entry points.
      3. One traced bfloat16 iteration (G_main and D_main): device busy
         time and idle share, the five training roles' bfloat16 launches,
         and no launch of a float32 least-work kernel.
    Returns (stats, launches of the timed bfloat16 iteration)."""
    import dataclasses

    from morphganformer_tpu_torch.bench_dw import HOST_TIMED, traced_run
    from morphganformer_tpu_torch.models.discriminator import packed_d_block_eligible
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    t_cfg = TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4)
    trainers = {dt: GANTrainer(dataclasses.replace(g_cfg, dtype=dt),
                               dataclasses.replace(d_cfg, dtype=dt), t_cfg)
                for dt in ("float32", "bfloat16")}
    states = {dt: t.init_state(seed=0) for dt, t in trainers.items()}
    for st in states.values():
        set_noise_strengths(torch, st.G, torch.Generator(device="cuda").manual_seed(5))
    w_avg = states["float32"].G.mapping.w_avg.clone()
    z = torch.randn((1, TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device="cuda")
    # The weights whose cotangent the dw kernels form: the fused blocks'.
    fused_g = [r for r in g_cfg.block_resolutions if r >= 256]
    fused_d = [r for r in d_cfg.block_resolutions if packed_d_block_eligible(d_cfg, r)]
    kernel_leaves = ({f"synthesis.b{r}.{layer}.weight" for r in fused_g
                      for layer in ("conv0", "conv1", "skip", "conv_last")}
                     | {f"b{r}.{layer}.weight" for r in fused_d
                        for layer in ("conv0", "conv1", "skip")})
    real = reals[None, :TRAIN_BATCH]

    def stage_grads(dt, stage, plain):
        trainer, state = trainers[dt], states[dt]
        state.G.mapping.w_avg.copy_(w_avg)
        rng = torch.Generator(device="cuda").manual_seed(11)
        with plain_wrappers(fc) if plain else contextlib.nullcontext():
            if stage == "g_main":
                return trainer.g_main_grads(state, z, gen=rng)[0]
            if stage == "d_main":
                return trainer.d_main_grads(state, real, z, gen=rng)[0]
            if stage == "g_reg":
                return trainer.g_reg_grads(state, z, gen=rng)[0]
            return trainer.d_reg_grads(state, real)[0]

    grads, failures = {}, []
    for stage in ("g_main", "g_reg", "d_main", "d_reg"):
        net = states["float32"].G if stage.startswith("g") else states["float32"].D
        names = [n for n, _ in net.named_parameters()]
        t0 = time.perf_counter()
        ref = stage_grads("float32", stage, True)
        kern = stage_grads("bfloat16", stage, False)
        plain = stage_grads("bfloat16", stage, True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        assert all(torch.isfinite(t).all().item() for t in kern), stage
        # Squared L2 norms: each leaf's error on either route and its own.
        sq = {n: ((k.double() - r.double()).square().sum().item(),
                  (p.double() - r.double()).square().sum().item(),
                  r.double().square().sum().item(), r.numel())
              for n, k, p, r in zip(names, kern, plain, ref)}
        small = [n for n in names if sq[n][3] < SMALL_LEAF]
        direct = [n for n in names if n in kernel_leaves]
        groups = {n: [n] for n in direct}
        groups.update({"the other leaves as one": [n for n in names
                                                   if n not in small and n not in direct],
                       "small leaves as one": small, "the stage": names})
        rows, bad = {}, []
        for g, members in groups.items():
            ek, ep, nr = (math.sqrt(sum(sq[n][i] for n in members)) for i in range(3))
            rel = (ek / max(nr, 1e-30), ep / max(nr, 1e-30))
            rows[g] = rel
            if rel[0] > max(BF16_RATIO * rel[1], BF16_FLOOR):
                bad.append((g, *rel))
        leaves = [n for n in names if n not in small]

        def ratio(n):
            ek, ep = (math.sqrt(sq[n][i]) for i in (0, 1))
            return ek / max(ep, 1e-300)
        ratios = sorted((ratio(n), n) for n in leaves)
        direct_worst = max(((rows[n][0] / max(rows[n][1], 1e-30), n) for n in direct),
                           default=(0.0, None))
        grads[stage] = dict(stage=rows["the stage"], small_leaves=rows["small leaves as one"],
                            others=rows["the other leaves as one"], n_small=len(small),
                            n_direct=len(direct), direct_largest_ratio=direct_worst,
                            median_ratio=ratios[len(ratios) // 2][0],
                            largest_ratio=ratios[-1], failures=bad, seconds=secs)
        print(f"  bf16 {stage} gradients against the float32 plain route, relative L2 errors "
              f"(kernels / plain bfloat16): the stage {rows['the stage'][0]:.3e} / "
              f"{rows['the stage'][1]:.3e}; {len(small)} small leaves as one "
              f"{rows['small leaves as one'][0]:.3e} / {rows['small leaves as one'][1]:.3e}; the "
              f"other leaves as one {rows['the other leaves as one'][0]:.3e} / "
              f"{rows['the other leaves as one'][1]:.3e}; {len(direct)} leaves from the dw "
              f"kernels, largest kernel/plain {direct_worst[0]:.3f} ({direct_worst[1]}); all "
              f"{len(leaves)} leaves, kernel/plain median {ratios[len(ratios) // 2][0]:.3f}, "
              f"largest {ratios[-1][0]:.3f} ({ratios[-1][1]}); {secs:.3f} s; failing {bad}",
              flush=True)
        if bad:
            failures.append((stage, bad))
        del ref, kern, plain
    assert not failures, f"bf16 stage gradients: {failures}"

    timings = {}
    bf16_launches = None
    for dt in ("bfloat16", "float32"):
        trainer, state = trainers[dt], states[dt]
        stage_ms, _ = timed_stages(torch, trainer, ("g_main", "g_reg", "d_main", "d_reg"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        stats = host(trainer.train_iteration(state, reals[:TRAIN_BATCH], 16))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(fc.launch_counts)
        assert all(math.isfinite(v) for v in stats.values()), (dt, stats)
        want = loop_launches(16)
        if dt == "bfloat16":
            want, bf16_launches = as_bf16(want), launches
        assert launches == want, (dt, launches, want)
        timings[dt] = dict(seconds=secs, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           **{f"{k}_ms": v[-1] for k, v in stage_ms.items()})
        print(f"  {dt} train_iteration at step 16 (all four stages), batch 4: {secs:.3f} s; "
              + ", ".join(f"{k} {v[-1]:.3f} ms" for k, v in stage_ms.items())
              + f"; peak {timings[dt]['peak_gib']:.3f} GiB; {json.dumps(stats)}; launches "
              f"{launches}", flush=True)
        for name in stage_ms:
            delattr(trainer, f"{name}_step")

    trainer, state = trainers["bfloat16"], states["bfloat16"]
    fc.reset_launch_counts()
    prof, averages, r = traced_run(
        lambda: trainer.train_iteration(state, reals[:TRAIN_BATCH], 17), HAND_WRITTEN,
        HOST_TIMED)
    traced_launches = dict(fc.launch_counts)
    f32_lw = {e.key: e.count for e in averages if e.device_type.name == "CUDA"
              and any(k in e.key for k in F32_LW_KERNELS)}
    busy, window = r["busy_ms"], r["window_ms"]
    print(averages.table(sort_by="self_cuda_time_total", row_limit=14), flush=True)
    print(f"  traced bfloat16 training iteration batch 4 (G_main, D_main): window "
          f"{window:.3f} ms, device busy {busy:.3f} ms, idle share {1 - busy / window:.4f}, "
          f"{r['launches']} device ops; hand-written kernels (device ms, launches): "
          + ", ".join(f"{k} {v[0]:.3f} ({v[1]})" for k, v in r["kernels"].items())
          + f"; float32 least-work kernels {f32_lw}; launches {traced_launches}", flush=True)
    assert traced_launches == as_bf16(per_iteration()), traced_launches
    assert all(traced_launches[k] > 0 for k in TRAIN_BF16_KEYS.values()), traced_launches
    assert not f32_lw, f"a float32 least-work kernel ran in a bfloat16 iteration: {f32_lw}"
    # K3's forward, K1's dw and the FIR dw (both its roles, K3's dw and the D
    # down-conv's, whose launches per_iteration counts above) on the tensor
    # cores: their kernels ran (and, above, no FMA kernel did).
    for role in ("K3-forward", "K1-dw", "K2-use_dw-dw", "K3-dw"):
        assert r["kernels"].get(TRAIN_BF16_KERNELS[role], (0.0, 0))[1] > 0, (role, r["kernels"])
    stats = dict(grads=grads, iteration=timings,
                 traced=dict(window_ms=window, busy_ms=busy, device_ops=r["launches"],
                             kernels=r["kernels"], host=r["host"]))
    del trainers, states
    return stats, bf16_launches


def train_phase(torch, fc):
    """Phase 8: the training roles' kernels, then train_iteration at 1024^2."""
    from morphganformer_tpu_torch.bench_dw import HOST_TIMED
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.ops import second_order as so
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = [check_train_kernel(torch, fc, gen, call) for call in train_calls()]
    noise_errs = check_per_sample_noise(torch, fc, gen)
    grad_rows = [check_grad_vjp(torch, so, gen, call) for call in grad_calls()]

    g_cfg, d_cfg = ffhq1024_config(), DiscriminatorConfig()
    trainer = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4))
    t0 = time.perf_counter()
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    print(f"  G (FFHQ-1024) and D (1024^2) from seed 0 on cuda: "
          f"{time.perf_counter() - t0:.3f} s; {sum(p.numel() for p in state.G.parameters())} "
          f"G and {sum(p.numel() for p in state.D.parameters())} D parameters", flush=True)
    res = d_cfg.img_resolution
    reals = torch.rand((2 * TRAIN_BATCH, res, res, 3), generator=gen, device="cuda") * 2 - 1

    # One G_main and one D_main round at the seed-0 weights, kernels
    # against plain (`main_round_checks`).
    z = torch.randn((1, TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device="cuda")
    errs, round_ms = main_round_checks(torch, fc, trainer, state, z, reals[None, :TRAIN_BATCH],
                                       gen)

    stage_ms, _ = timed_stages(torch, trainer, ("g_main", "d_main"))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = {k: 0 for k in fc.launch_counts}
    iter_ms = []
    for step in (1, 2, 3):
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        stats = host(trainer.train_iteration(state, reals[:TRAIN_BATCH], step))
        torch.cuda.synchronize()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(fc.launch_counts)
        print(f"  step {step}: {iter_ms[-1]:.3f} ms (G_main {stage_ms['g_main'][-1]:.3f}, "
              f"D_main {stage_ms['d_main'][-1]:.3f}); {json.dumps(stats)}; launches {launches}",
              flush=True)
        assert all(math.isfinite(v) for v in stats.values()), stats
        assert launches == per_iteration(), (launches, per_iteration())
        for k, v in launches.items():
            total[k] += v
    peak = torch.cuda.max_memory_allocated()
    assert state.cur_nimg == 3 * TRAIN_BATCH

    two = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=2 * TRAIN_BATCH, batch_gpu=4))
    assert two.n_accum == 2
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    stats2 = host(two.train_iteration(state, reals, 5))
    torch.cuda.synchronize()
    two_ms = (time.perf_counter() - t0) * 1e3
    print(f"  step 5, batch 8 in two rounds: {two_ms:.3f} ms; {json.dumps(stats2)}; launches "
          f"{dict(fc.launch_counts)}", flush=True)
    assert all(math.isfinite(v) for v in stats2.values()), stats2
    assert dict(fc.launch_counts) == per_iteration(2), dict(fc.launch_counts)
    assert state.cur_nimg == 5 * TRAIN_BATCH

    traced = traced_forward(torch,
                            lambda: trainer.train_iteration(state, reals[:TRAIN_BATCH], 6),
                            "training iteration batch 4", host_of=HOST_TIMED)
    print(f"  peak memory over steps 1-3: {peak / 2**30:.3f} GiB", flush=True)
    del state, two

    # Training in bfloat16: the roles at every call shape, D's conv0 and the
    # degenerate launches, the grad Functions' terms, then the iteration.
    t0 = time.perf_counter()
    bf16_rows = [check_train_kernel_bf16(torch, fc, gen, call) for call in train_calls()]
    d_conv0 = {f"b{res}": check_d_conv0_bf16(torch, fc, gen, res, c)
               for res, c in ((1024, 32), (512, 64))}
    grad_bf16 = [check_grad_vjp_bf16(torch, so, gen, call) for call in grad_calls()]
    bf16_stats, bf16_launches = bf16_train_checks(torch, fc, gen, g_cfg, d_cfg, reals)
    bf16_stats.update(d_conv0=d_conv0, grad_vjp=grad_bf16,
                      seconds=time.perf_counter() - t0)
    print(f"  the bfloat16 training checks: {bf16_stats['seconds']:.3f} s", flush=True)
    stats = dict(iteration_ms=iter_ms, g_main_ms=stage_ms["g_main"][:3], traced=traced,
                 d_main_ms=stage_ms["d_main"][:3], two_round_ms=two_ms, peak_gib=peak / 2**30,
                 g_grads=errs["g"], d_grads=errs["d"], round_ms=round_ms,
                 per_sample_noise=noise_errs, grad_vjp=grad_rows, bf16=bf16_stats)
    return rows, total, stats, bf16_rows, bf16_launches


def k4_calls():
    """K4's five call shapes at FFHQ-1024 widths in the `skip` and `orig`
    layouts: (net and block, layer, H, C, O)."""
    return [("G b512", "conv1", 512, 64, 64), ("G b1024", "conv1", 1024, 32, 32),
            ("G b1024", "conv_last", 1024, 32, 32), ("D b1024", "conv0", 1024, 32, 32),
            ("D b512", "conv0", 512, 64, 64)]


def k4_case(torch, k4, gen, call, n, role, dt):
    """K4's forward ("fwd") or dx role at one call shape and batch on random
    inputs of type `dt`: (key, name, run_k, run_p (the plain version),
    run_ref (the plain version on the same values in float32), run_lib (one
    cuDNN call of the same convolution: `F.conv2d`; `conv2d_input` for
    dx), FLOP, the elements read and written)."""
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input

    block, layer, h, c, o = call
    dev = torch.device(DEV)
    x = torch.randn((n, h, h, c), generator=gen, device=dev).to(dt)
    w = (torch.randn((3, 3, c, o), generator=gen, device=dev) / math.sqrt(9 * c)).to(dt)
    w_lib = w.permute(3, 2, 0, 1).contiguous()
    sfx = "" if dt == torch.float32 else "_bf16"
    if role == "fwd":
        key, name, t, wk = "conv3x3", "K4 fwd", x, w
        run_k = lambda: k4.conv3x3_forward(x, w)                             # noqa: E731
        run_lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), w_lib, padding=1)  # noqa: E731
        out_numel = n * h * h * o
    else:
        key, name = "conv3x3_adj", "K4 dx"
        t = torch.randn((n, h, h, o), generator=gen, device=dev).to(dt)
        wk = k4.conv3x3_adjoint_weights(w)
        run_k = lambda: k4.conv3x3_dx(t, w)                                  # noqa: E731
        run_lib = lambda: conv2d_input((n, c, h, h), w_lib, t.permute(0, 3, 1, 2),  # noqa
                                       padding=1)
        out_numel = n * h * h * c
    return (key + sfx, name + sfx.replace("_", " "), run_k,
            lambda: k4.conv3x3_same_plain(t, wk),
            lambda: k4.conv3x3_same_plain(t.float(), wk.float()), run_lib,
            2 * n * h * h * 9 * c * o, t.numel() + w.numel() + out_numel)


def check_k4(torch, k4, fc, gen, call, n, role):
    """K4's forward ("fwd") or dx role at one call shape and batch against
    the plain version on random inputs (`k4_case`): error, times, the
    bound, and one cuDNN call of the same convolution."""
    block, layer = call[:2]
    key, name, run_k, run_p, _, run_lib, flops, elements = k4_case(
        torch, k4, gen, call, n, role, torch.float32)
    before = fc.launch_counts[key]
    got = run_k()
    assert fc.launch_counts[key] == before + 1, (name, fc.launch_counts)
    want = run_p()
    torch.cuda.synchronize()
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    print(f"  {name} {block} {layer} batch {n}: out {tuple(got.shape)} max_abs_err {err:.3e} "
          f"(largest entry {scale:.3e})", flush=True)
    assert got.shape == want.shape and torch.isfinite(got).all().item()
    assert err <= 1e-5 * scale, f"{name} {block} {layer} batch {n}: {err} > 1e-5 of {scale}"
    nbytes = 4 * elements
    bound_ms, bound_by = bound(flops, nbytes)
    ms = cuda_ms(torch, run_k)
    plain_ms = cuda_ms(torch, run_p)
    library_ms = cuda_ms(torch, run_lib)
    print(f"  {name} {block} {layer} batch {n}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by})", flush=True)
    return dict(kernel=name, block=block, role=layer, batch=n, max_abs_err=err, ref_scale=scale,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, gflop=flops / 1e9, mbytes=nbytes / 1e6)


def check_k4_bf16(torch, k4, fc, gen, call, n, role):
    """K4's bfloat16 forward ("fwd", `mgt_conv3x3_fwd_bf16`) or dx
    (`mgt_conv3x3_dx_bf16`) at one call shape and batch (`k4_case`): the
    kernel and the plain bfloat16 version, each against the float32 plain
    version on the same bfloat16 inputs, phase bf16's rule; times of the
    kernel (its wrapper, and its own device time from its launch's CUDA
    events), the plain version and
    cuDNN's bfloat16 call of the same convolution, beside the bf16 bound."""
    block, layer = call[:2]
    key, name, run_k, run_p, run_ref, run_lib, flops, elements = k4_case(
        torch, k4, gen, call, n, role, torch.bfloat16)
    before = fc.launch_counts[key]
    got = run_k()
    assert fc.launch_counts[key] == before + 1, (name, fc.launch_counts)
    plain, ref = run_p(), run_ref()
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert torch.isfinite(got).all().item()
    ek, ep, kp = _bf16_errs((got,), (plain,), (ref,))
    print(f"  {name} {block} {layer} batch {n}: vs float32 on the same inputs, kernel "
          f"{ek:.3e}, plain {ep:.3e}; kernel vs plain {kp:.3e}", flush=True)
    assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), (name, block, layer, ek, ep)
    bound_ms, bound_by = bf16_bound(flops, elements)
    ms = cuda_ms(torch, run_k)
    plain_ms = cuda_ms(torch, run_p, reps=3, warmup=1)
    library_ms = cuda_ms(torch, run_lib)
    kernel_ms = launch_events_ms(torch, run_k)
    print(f"  {name} {block} {layer} batch {n}: ms {ms:.4f} (kernel's device ms {kernel_ms:.4f}) "
          f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
          f"({bound_by})", flush=True)
    return dict(kernel=name, block=block, role=layer, batch=n, max_abs_err=kp, err_kernel=ek,
                err_plain=ep, ms=ms, kernel_device_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def skip_bf16_iterations(torch, fc, g_cfg, d_cfg, reals):
    """train_iteration steps 1 and 2 (G_main, D_main) of the skip layouts at
    FFHQ-1024 widths in bfloat16, batch 4, from seed 0, with
    MGT_PALLAS_CONV=1: finite losses and exactly the float32 iteration's K4
    launches, on the `_bf16` keys. Returns (step 2's launches, stats)."""
    import dataclasses

    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    trainer = GANTrainer(dataclasses.replace(g_cfg, dtype="bfloat16"),
                         dataclasses.replace(d_cfg, dtype="bfloat16"),
                         TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4), device=DEV)
    state = trainer.init_state(seed=0)
    iter_ms = []
    with pallas_conv(True):
        for step in (1, 2):
            fc.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = host(trainer.train_iteration(state, reals, step))
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(fc.launch_counts)
            print(f"  skip bfloat16 step {step}: {iter_ms[-1]:.3f} ms; {json.dumps(stats)}; "
                  f"launches {launches}", flush=True)
            assert all(math.isfinite(v) for v in stats.values()), stats
            assert launches == as_bf16(layout_per_iteration()), launches
    return launches, dict(iteration_ms=iter_ms, stats=stats)


def layout_per_iteration(rounds=1):
    """Exact launches of one training iteration of the `skip` layouts at
    FFHQ-1024 widths with MGT_PALLAS_CONV=1: no block is fused, so only K4
    launches. G_main: G's forward (b512 conv1, b1024 conv1, conv_last) and
    its backward (their 3 dx; dw is torch's), D's forward (b1024 and b512
    conv0) and its backward to the image (2 dx). D_main: G's forward without
    a graph (3), then D forward and backward on fakes and on reals (2 and 2
    dx each: the conv0 inputs depend on the fromrgb weights)."""
    counts = dict.fromkeys(per_iteration(), 0)
    counts.update(conv3x3=rounds * (3 + 2 + 3 + 2 * 2), conv3x3_adj=rounds * (3 + 2 + 2 * 2))
    return counts


@contextlib.contextmanager
def pallas_conv(on):
    """MGT_PALLAS_CONV=1 (K4 on) or unset (K4 off, cuDNN) inside the block."""
    saved = os.environ.pop("MGT_PALLAS_CONV", None)
    if on:
        os.environ["MGT_PALLAS_CONV"] = "1"
    try:
        yield
    finally:
        os.environ.pop("MGT_PALLAS_CONV", None)
        if saved is not None:
            os.environ["MGT_PALLAS_CONV"] = saved


def timed_stages(torch, trainer, names, launches_of=None):
    """Wrap the trainer's `<name>_step` methods: each call appends its
    milliseconds (synchronised) to times[name] and, with `launches_of`, the
    launch counts it made to launches[name]."""
    times = {n: [] for n in names}
    launches = {n: [] for n in names}
    for name in names:
        inner = getattr(trainer, f"{name}_step")

        def timed(*a, _inner=inner, _name=name):
            torch.cuda.synchronize()
            before = dict(launches_of) if launches_of is not None else None
            t = time.perf_counter()
            out = _inner(*a)
            torch.cuda.synchronize()
            times[_name].append((time.perf_counter() - t) * 1e3)
            if before is not None:
                launches[_name].append({k: launches_of[k] - before[k] for k in before})
            return out
        setattr(trainer, f"{name}_step", timed)
    return times, launches


def set_noise_strengths(torch, G, gen):
    """Every noise strength (0 at init) to U(0.05, 0.15), so the per-sample
    noise reaches the gradients; returns the parameters."""
    strengths = [p for n, p in G.named_parameters() if n.endswith("noise_strength")]
    with torch.no_grad():
        for p in strengths:
            p.copy_(0.05 + 0.1 * torch.rand((), generator=gen, device=p.device))
    return strengths


def layouts_phase(torch, fc, k4):
    """Phase 10: K4 at its call shapes, then the `skip` layouts at 1024^2."""
    from morphganformer_tpu_torch import cli
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    gen = torch.Generator(device=DEV).manual_seed(2)
    rows = [check_k4(torch, k4, fc, gen, call, n, role)
            for n in (1, TRAIN_BATCH) for call in k4_calls() for role in ("fwd", "dx")]

    g_cfg, d_cfg = ffhq1024_config(architecture="skip"), DiscriminatorConfig(architecture="skip")
    trainer = GANTrainer(g_cfg, d_cfg, TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4),
                         device=DEV)
    state = trainer.init_state(seed=0)
    G, D = state.G, state.D
    print(f"  skip G (FFHQ-1024 widths) and skip D (1024^2) from seed 0: "
          f"{sum(p.numel() for p in G.parameters())} G and "
          f"{sum(p.numel() for p in D.parameters())} D parameters", flush=True)
    zeros = dict.fromkeys(fc.launch_counts, 0)

    z = torch.randn((1, g_cfg.k, g_cfg.z_dim), generator=torch.Generator().manual_seed(0))
    with pallas_conv(True):
        fc.reset_launch_counts()
        y_on = cli.synthesize(G, z)
        torch.cuda.synchronize()
        fwd_launches = dict(fc.launch_counts)
    with pallas_conv(False):
        y_off = cli.synthesize(G, z)
    diff = (y_on - y_off).abs().max().item()
    fwd_ms = {}
    for on in (True, False):
        with pallas_conv(on):
            fwd_ms["k4" if on else "cudnn"] = cuda_ms(torch, lambda: cli.synthesize(G, z),
                                                      reps=3, warmup=1)
    print(f"  forward batch 1, K4 on vs off: max abs diff {diff:.3e} (|img| max "
          f"{y_off.abs().max().item():.3f}); launches {fwd_launches}; ms K4 {fwd_ms['k4']:.3f}, "
          f"cuDNN {fwd_ms['cudnn']:.3f}", flush=True)
    res = g_cfg.img_resolution
    assert y_on.shape == (1, res, res, 3) and torch.isfinite(y_on).all().item()
    assert fwd_launches == {**zeros, "conv3x3": 3}, fwd_launches
    assert diff <= 1e-3, f"skip forward, K4 on vs off: {diff}"

    # One G_main and one D_main round, K4 on against K4 off, from the same
    # draws, with non-zero noise strengths; checked as phase train checks
    # the kernels against the plain path.
    res = d_cfg.img_resolution
    reals = torch.rand((TRAIN_BATCH, res, res, 3), generator=gen, device=DEV) * 2 - 1
    z4 = torch.randn((1, TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device=DEV)
    w_avg = G.mapping.w_avg.clone()
    strengths = set_noise_strengths(torch, G, gen)

    def one_round(stage, on):
        G.mapping.w_avg.copy_(w_avg)
        rng = torch.Generator(device=DEV).manual_seed(11)
        with pallas_conv(on):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stage == "g":
                grads, stats = trainer.g_main_grads(state, z4, gen=rng)
            else:
                grads, stats = trainer.d_main_grads(state, reals[None], z4, gen=rng)
            torch.cuda.synchronize()
        return (grads, host(stats)), (time.perf_counter() - t0) * 1e3

    grads = {}
    for stage, net in (("g", G), ("d", D)):
        before = fc.launch_counts["conv3x3"]
        (got, stats_k), ms_k = one_round(stage, True)
        assert fc.launch_counts["conv3x3"] > before
        (want, stats_p), ms_p = one_round(stage, False)
        names = [n for n, _ in net.named_parameters()]
        assert all(torch.isfinite(t).all().item() for t in got)
        floor = 1e-3 * max(t.abs().max().item() for t in want)
        full = leaf_errors(names, got, want, floor)
        others = [r for r in full if not r[4]]
        loss_key = next(k for k in stats_p if k.endswith("/loss"))
        grads[stage] = dict(other_leaves=others[0][0], noise_strengths_pooled=pooled_strengths(full),
                            noise_strength_worst=max((r[0] for r in full if r[4]), default=0.0),
                            loss_abs_err=abs(stats_k[loss_key] - stats_p[loss_key]),
                            ms_k4=ms_k, ms_cudnn=ms_p)
        print(f"  one {stage.upper()}_main round, K4 on vs off ({len(names)} leaves; floor "
              f"{floor:.3e}): other leaves worst {others[0][0]:.3e} {_fmt(others)}; noise "
              f"strengths as one {grads[stage]['noise_strengths_pooled']:.3e}, worst on its own "
              f"{grads[stage]['noise_strength_worst']:.3e}; {loss_key} {stats_k[loss_key]:.6f} "
              f"vs {stats_p[loss_key]:.6f}; ms K4 {ms_k:.3f}, cuDNN {ms_p:.3f}", flush=True)
        assert others[0][0] <= 1e-3, f"{stage.upper()}_main K4 on vs off: {grads[stage]}"
        assert grads[stage]["noise_strengths_pooled"] <= 1e-3, grads[stage]
        assert grads[stage]["loss_abs_err"] <= 1e-4 * max(1.0, abs(stats_p[loss_key]))
    with torch.no_grad():
        for p in strengths:
            p.zero_()
    G.mapping.w_avg.copy_(w_avg)

    stage_ms, _ = timed_stages(torch, trainer, ("g_main", "d_main"))
    total = dict(zeros)
    iter_ms = []
    with pallas_conv(True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for step in (1, 2, 3):
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            stats = host(trainer.train_iteration(state, reals, step))
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            launches = dict(fc.launch_counts)
            print(f"  skip step {step}: {iter_ms[-1]:.3f} ms (G_main "
                  f"{stage_ms['g_main'][-1]:.3f}, D_main {stage_ms['d_main'][-1]:.3f}); "
                  f"{json.dumps(stats)}; launches {launches}", flush=True)
            assert all(math.isfinite(v) for v in stats.values()), stats
            assert launches == layout_per_iteration(), (launches, layout_per_iteration())
            for k, v in launches.items():
                total[k] += v
        peak = torch.cuda.max_memory_allocated()
    print(f"  skip peak memory over steps 1-3: {peak / 2**30:.3f} GiB", flush=True)
    del trainer, state, G, D

    # K4 in bfloat16: its roles at the five call shapes, then the skip
    # layouts' bfloat16 iterations on it.
    rows += [check_k4_bf16(torch, k4, fc, gen, call, TRAIN_BATCH, role)
             for call in k4_calls() for role in ("fwd", "dx")]
    bf16_launches, bf16_stats = skip_bf16_iterations(torch, fc, g_cfg, d_cfg, reals)
    stats = dict(forward_diff=diff, forward_ms=fwd_ms, iteration_ms=iter_ms,
                 g_main_ms=stage_ms["g_main"], d_main_ms=stage_ms["d_main"],
                 peak_gib=peak / 2**30, grads=grads, bf16=bf16_stats)
    return rows, total, bf16_launches, stats


def reg_launches(stage, inner=False, g_nodes=(4, 3, 3), d_nodes=(2, 4)):
    """Exact launches of one G_reg or D_reg round on the scoped route on the
    resnet pair at FFHQ-1024 (`inner`: those of its inner create_graph
    gradient alone), derived from the fused nodes: G has 4 K1 nodes (conv1
    of b256, b512, b1024 and b1024's conv_last, all styled), 3 styled K2
    nodes (conv0) and 3 unstyled (skip); D's two fused blocks have 2 K1
    nodes (conv0, no styles) and 4 down-conv nodes (conv1, skip). Another
    pair gives its own (K1, styled K2, unstyled K2) as `g_nodes` and (K1,
    down-conv) as `d_nodes`.
      inner forward    one forward launch a node
      inner backward   one adjoint a node, dx (and ds) only: no dw
      outer, the grad Functions' backwards (path length feeds cdx and cds,
        R1 cdx alone): a styled node the adjoint for dxs, the dw launch for
        wg(c_dxs, dz) and a forward for conv(c_dxs, w); an unstyled one no
        adjoint (dxs is unused); a down-conv node the dw launch and a
        forward (cdw is None, so no adjoint and one forward)
      outer, the fused nodes' first-order backwards (their y's cotangent,
        c_y added): one adjoint and one dw launch a node"""
    counts = dict.fromkeys(per_iteration(), 0)
    if stage == "g_reg":
        k1, k2s, k2u = g_nodes
        counts.update(modconv3x3_adj=k1, upconv2_adj=k2s + k2u)
        if not inner:
            counts.update(modconv3x3=k1 + k1, upconv2=(k2s + k2u) * 2,
                          modconv3x3_adj=k1 * 3, upconv2_adj=(k2s + k2u) * 2 + k2s,
                          modconv3x3_dw=k1 * 2, upconv2_dw=(k2s + k2u) * 2)
    else:
        k1, down = d_nodes
        counts.update(modconv3x3_adj=k1, downconv2_adj=down)
        if not inner:
            counts.update(modconv3x3=k1 * 2, downconv2=down * 2, modconv3x3_adj=k1 * 2,
                          downconv2_adj=down * 2, modconv3x3_dw=k1 * 2, downconv2_dw=down * 2)
    return counts


def loop_launches(step, g_interval=4, d_interval=16):
    """Exact launches of one loop iteration at batch 4 on the resnet pair:
    phase train's per iteration, and each reg stage's round where it is
    due."""
    counts = per_iteration()
    for stage, every in (("g_reg", g_interval), ("d_reg", d_interval)):
        if step % every == 0:
            counts = {k: v + reg_launches(stage)[k] for k, v in counts.items()}
    return counts


@contextlib.contextmanager
def packed_env(value):
    """MGT_PACKED_SECOND_ORDER set to `value` (None: unset) inside the block."""
    saved = os.environ.pop("MGT_PACKED_SECOND_ORDER", None)
    if value is not None:
        os.environ["MGT_PACKED_SECOND_ORDER"] = value
    try:
        yield
    finally:
        os.environ.pop("MGT_PACKED_SECOND_ORDER", None)
        if saved is not None:
            os.environ["MGT_PACKED_SECOND_ORDER"] = saved


@contextlib.contextmanager
def inner_pass_launches(torch, fc, out):
    """Append to `out` the launches that each create_graph=True
    `torch.autograd.grad` call (a reg stage's inner gradient) makes."""
    real = torch.autograd.grad

    def grad(*a, **k):
        if not k.get("create_graph"):
            return real(*a, **k)
        before = dict(fc.launch_counts)
        try:
            return real(*a, **k)
        finally:
            out.append({key: fc.launch_counts[key] - before[key] for key in before})
    torch.autograd.grad = grad
    try:
        yield out
    finally:
        torch.autograd.grad = real


def reg_checks(torch, trainer, state, reals, gen):
    """Each reg stage's parameter gradients (one round of batch 4) in
    float32 on the default scoped route against the same stage in float64
    on the unpacked route (MGT_PACKED_SECOND_ORDER=0; the kernels take no
    float64) on float64 copies of the nets, beside two controls: the
    float32 unpacked route against float64, and float64 with every weight
    nudged by 1e-7 of itself (about float32's rounding) against float64.
    Bounds: the penalties within 1e-3 of each other, every leaf within 1e-2
    (R1) and 5e-2 (path length) of the stage's largest entry. Each leaf's
    error over its own largest entry (floored at 1e-3 of the stage's) and
    over the stage's are printed beside the controls'. A tighter bound does
    not hold for a float32 run (measured on an H100, PERF.md section 6): on
    the 1024^2 nets after two iterations the nudge alone moves path length's
    gradient by up to 2.7e-3 of the stage's largest entry and single leaves
    (noise strengths, torgb and attention leaves of the low-resolution
    blocks, whose few units each carry a large share across an lrelu kink)
    by up to 0.33 of themselves, and float32, which rounds every activation
    and sum and not only the weights, reached 1.3e-3 to 1.6e-2 of the
    stage's largest entry for path length and 2.1e-4 to 1.1e-3 for R1.
    Central differences of its float64 loss along two random directions
    against the autograd directional derivative: one over the parameters
    that no lrelu follows (every torgb of G; D's output layer), along which
    the loss is smooth, and one over all parameters, printed only (there
    the steps flip lrelu masks, and the penalties, which hold lrelu's
    derivative, jump). The float32 stage's time and peak memory on either
    route. Returns (results, failures): the caller fails after both pairs."""
    import copy
    import dataclasses

    from morphganformer_tpu_torch.training import loss as tloss

    cfg = trainer.cfg
    g_cfg = trainer.g_cfg
    z = torch.randn((1, TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device=DEV)
    real = reals[None]
    state64 = dataclasses.replace(state, G=copy.deepcopy(state.G).double(),
                                  D=copy.deepcopy(state.D).double(),
                                  pl_mean=state.pl_mean.double())
    seed = 13
    out, failures = {}, []
    for stage in ("g_reg", "d_reg"):
        def grads_of(st, dtype):
            if stage == "g_reg":
                rng = torch.Generator(device=DEV).manual_seed(seed)
                g, stats, _ = trainer.g_reg_grads(st, z.to(dtype), gen=rng)
                return g, host(stats)
            g, stats = trainer.d_reg_grads(st, real.to(dtype))
            return g, host(stats)

        def timed(st, dtype, route):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with packed_env(route):
                g, stats = grads_of(st, dtype)
            torch.cuda.synchronize()
            return g, stats, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()

        def loss_of(st):
            with packed_env("0"):
                if stage == "g_reg":
                    rng = torch.Generator(device=DEV).manual_seed(seed)
                    loss = tloss.g_pl_loss(st.G, z[0].double(), cfg.loss, rng, st.pl_mean)[0]
                    return loss.item() * float(cfg.g_reg_interval)
                loss = tloss.d_r1_loss(st.D, real[0].double(), cfg.loss)[0]
                return loss.item() * float(cfg.d_reg_interval)

        net, net64 = ((state.G, state64.G) if stage == "g_reg" else (state.D, state64.D))
        g32, s32, ms32, peak32 = timed(state, torch.float32, None)
        g32u, s32u, ms32u, peak32u = timed(state, torch.float32, "0")
        g64, s64, ms64, _ = timed(state64, torch.float64, "0")
        names = [n for n, _ in net.named_parameters()]
        assert all(torch.isfinite(t).all().item() for t in g32)
        floor = 1e-3 * max(t.abs().max().item() for t in g64)
        stage_max = max(t.abs().max().item() for t in g64)
        full = leaf_errors(names, g32, g64, floor)
        unpacked = leaf_errors(names, g32u, g64, floor)
        del g32u
        others = [r for r in full if not r[4]]
        pooled = pooled_strengths(full)
        of_stage = max(r[3] for r in full) / stage_max
        with nudged(torch, (net64,), torch.Generator(device=DEV).manual_seed(3), 1e-7):
            with packed_env("0"):
                g_ctrl, _ = grads_of(state64, torch.float64)
        ctrl = leaf_errors(names, g_ctrl, g64, floor)
        del g_ctrl

        params64 = list(net64.parameters())
        smooth = [("torgb" in n) if stage == "g_reg" else n.startswith("b4.out")
                  for n in names]
        fd = {}
        for label, chosen in (("smooth", smooth), ("all", [True] * len(names))):
            dgen = torch.Generator(device=DEV).manual_seed(17)
            v = [(torch.randn(p.shape, generator=dgen, device=p.device, dtype=p.dtype)
                  * (p.detach().square().mean().sqrt() + 1e-2)) if c else torch.zeros_like(p)
                 for p, c in zip(params64, chosen)]
            directional = sum((g * d).sum().item() for g, d in zip(g64, v))
            eps = 1e-4
            saved = [p.detach().clone() for p in params64]
            vals = []
            for sign in (1, -1):
                with torch.no_grad():
                    for p, p0, d in zip(params64, saved, v):
                        p.copy_(p0 + sign * eps * d)
                vals.append(loss_of(state64))
            with torch.no_grad():
                for p, p0 in zip(params64, saved):
                    p.copy_(p0)
            central = (vals[0] - vals[1]) / (2 * eps)
            fd[label] = dict(directional=directional, central=central,
                             rel_err=abs(central - directional) / max(abs(directional), 1e-30),
                             leaves=int(sum(chosen)), eps=eps)
        key = "Loss/pl_penalty" if stage == "g_reg" else "Loss/r1_penalty"
        out[stage] = dict(of_stage_max=of_stage, other_leaves=others[0][0],
                          noise_strengths_pooled=pooled, control_worst=ctrl[0][0],
                          control_of_stage_max=max(r[3] for r in ctrl) / stage_max,
                          unpacked32_of_stage_max=max(r[3] for r in unpacked) / stage_max,
                          unpacked32_worst=unpacked[0][0],
                          penalty32=s32[key], penalty32_unpacked=s32u[key], penalty64=s64[key],
                          ms32=ms32, ms32_unpacked=ms32u, ms64=ms64, peak32_gib=peak32 / 2**30,
                          peak32_unpacked_gib=peak32u / 2**30, fd=fd)
        print(f"  {stage} float32 scoped vs float64 unpacked ({len(names)} leaves; stage max "
              f"{stage_max:.3e}): worst {of_stage:.3e} of the stage max; each leaf over its own "
              f"largest entry (floor {floor:.3e}): other leaves worst {others[0][0]:.3e} "
              f"{_fmt(others)}; noise strengths as one {pooled:.3e}\n"
              f"    control float32 unpacked vs float64: worst "
              f"{out[stage]['unpacked32_of_stage_max']:.3e} of the stage max, {unpacked[0][0]:.3e} "
              f"{_fmt(unpacked)}; control float64 nudged by 1e-7: worst {ctrl[0][0]:.3e} "
              f"{_fmt(ctrl)}\n"
              f"    {key} scoped {s32[key]:.6f}, unpacked {s32u[key]:.6f}, float64 "
              f"{s64[key]:.9f}; ms float32 scoped {ms32:.3f}, unpacked {ms32u:.3f}, float64 "
              f"{ms64:.3f}; peak float32 scoped {peak32 / 2**30:.3f} GiB, unpacked "
              f"{peak32u / 2**30:.3f} GiB\n"
              f"    central difference (float64, eps {fd['smooth']['eps']}): "
              + "; ".join(f"{k} ({d['leaves']} leaves) {d['central']:.9e} vs autograd "
                          f"{d['directional']:.9e}, rel err {d['rel_err']:.3e}"
                          for k, d in fd.items()), flush=True)
        bound = 5e-2 if stage == "g_reg" else 1e-2
        if of_stage > bound or abs(s32[key] - s64[key]) > 1e-3 * abs(s64[key]):
            failures.append(f"{stage} float32 vs float64: {out[stage]}")
        if fd["smooth"]["rel_err"] > 1e-5:
            failures.append(f"{stage} central difference: {fd}")
    del state64
    return out, failures


def reg_phase(torch, fc):
    """Phase 11: the lazily regularised iteration at steps 0 and 16 on the
    resnet pair and on the skip pair, then `reg_checks`, with cuDNN in
    deterministic mode. Its default algorithms sum some backward passes in
    an order that varies from run to run, and two iterations of training
    carry those roundings into the state: on an H100 the skip pair's R1
    penalty differed by up to 40 % between runs. The float32 error that the
    checks measure depends on that state: the R1 penalty's was 1.7e-6 to
    1.2e-4 of itself in eight states and 2.1e-3 in one. With the state
    fixed, every run checks the same one."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _reg_pairs(torch, fc)
    finally:
        torch.backends.cudnn.deterministic = saved


def _reg_pairs(torch, fc):
    """`reg_phase` on the resnet pair, then the skip pair. The reg stages run
    on the default scoped route: on the resnet pair their exact launches
    (`reg_launches`), none of them a dw launch in an inner pass; on the
    skip pair none (no fused block, and K4 is off inside the scope)."""
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig

    gen = torch.Generator(device=DEV).manual_seed(4)
    zeros = dict.fromkeys(fc.launch_counts, 0)
    out, failures = {}, []
    reg_total = dict(zeros)
    for arch, main in (("resnet", per_iteration()), ("skip", layout_per_iteration())):
        d_cfg = DiscriminatorConfig(architecture=arch)
        trainer = GANTrainer(ffhq1024_config(architecture=arch), d_cfg,
                             TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4), device=DEV)
        res = d_cfg.img_resolution
        reals = torch.rand((TRAIN_BATCH, res, res, 3), generator=gen, device=DEV) * 2 - 1
        state = trainer.init_state(seed=0)
        names = ("g_main", "g_reg", "d_main", "d_reg")
        times, launches = timed_stages(torch, trainer, names, fc.launch_counts)
        want = {n: (reg_launches(n) if arch == "resnet" else zeros) for n in ("g_reg", "d_reg")}
        want_inner = [reg_launches(n, inner=True) if arch == "resnet" else zeros
                      for n in ("g_reg", "d_reg")]
        if arch == "resnet":
            print("  scoped reg-stage launches per round (resnet), derived: "
                  + "; ".join(f"{n} {{{', '.join(f'{k}: {v}' for k, v in want[n].items() if v)}}}"
                              f" (inner pass {{{', '.join(f'{k}: {v}' for k, v in i.items() if v)}}})"
                              for n, i in zip(("g_reg", "d_reg"), want_inner)), flush=True)
        steps = {}
        with pallas_conv(arch == "skip"):
            for step in (0, 16):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fc.reset_launch_counts()
                inner = []
                t0 = time.perf_counter()
                with inner_pass_launches(torch, fc, inner):
                    stats = host(trainer.train_iteration(state, reals, step))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated()
                total = dict(fc.launch_counts)
                steps[step] = dict(iteration_ms=ms, peak_gib=peak / 2**30,
                                   stage_ms={n: times[n][-1] for n in names},
                                   pl_mean=state.pl_mean.item(), stats=stats)
                print(f"  {arch} step {step}: {ms:.3f} ms ("
                      + ", ".join(f"{n} {times[n][-1]:.3f}" for n in names)
                      + f"); peak {peak / 2**30:.3f} GiB; pl_mean {state.pl_mean.item():.6f}; "
                      f"{json.dumps(stats)}; launches {total}; reg stages "
                      f"{[launches[n][-1] for n in ('g_reg', 'd_reg')]}; inner passes {inner}",
                      flush=True)
                assert all(math.isfinite(v) for v in stats.values()), stats
                assert {"Loss/pl_penalty", "Loss/G/reg", "Loss/r1_penalty",
                        "Loss/D/reg"} <= set(stats), stats
                for n in ("g_reg", "d_reg"):
                    assert launches[n][-1] == want[n], (n, launches[n][-1], want[n])
                    if arch == "resnet":
                        for k, v in launches[n][-1].items():
                            reg_total[k] += v
                assert inner == want_inner, (inner, want_inner)
                assert not any(v for i in inner for k, v in i.items() if k.endswith("_dw"))
                assert total == {k: main[k] + want["g_reg"][k] + want["d_reg"][k]
                                 for k in main}, (total, main)
                assert state.pl_mean.item() != 0.0
            if arch == "resnet":
                # Where the scoped reg stages spend their time.
                traced_forward(torch, lambda: trainer.g_reg_grads(state, reals.new_empty(
                    (1, TRAIN_BATCH, trainer.g_cfg.k, trainer.g_cfg.z_dim)).normal_()),
                    "G_reg (resnet, scoped)", shapes=True)
                traced_forward(torch, lambda: trainer.d_reg_grads(state, reals[None]),
                               "D_reg (resnet, scoped)", shapes=True)
            checks, failed = reg_checks(torch, trainer, state, reals, gen)
            out[arch] = dict(steps=steps, checks=checks)
            failures += [f"{arch}: {f}" for f in failed]
        del trainer, state
        torch.cuda.empty_cache()
    assert not failures, failures
    out["reg_launches"] = reg_total
    return out


def tree_bits(tree):
    """{path: (dtype, shape, bytes)} of a flax-form tree (numpy leaves)."""
    import numpy as np

    from morphganformer_tpu_torch.checkpoint.convert import flatten

    out = {}
    for path, leaf in flatten(tree):
        a = np.asarray(leaf)
        out["/".join(path)] = (a.dtype.str, a.shape, a.tobytes())
    return out


def assert_same_tree(got, want, what):
    g, w = tree_bits(got), tree_bits(want)
    assert sorted(g) == sorted(w), f"{what}: leaves differ"
    bad = [k for k in w if g[k] != w[k]]
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. {bad[:3]}"
    return len(w)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def checkpoint_phase(torch, fc, cli, G, tmp):
    """Phase 7: the generator and a 1024^2 D through checkpoint/io.py."""
    from morphganformer_tpu_torch.checkpoint import to_flax
    from morphganformer_tpu_torch.checkpoint.io import (load_discriminator,
                                                        save_discriminator, save_generator)
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig
    from morphganformer_tpu_torch.models.discriminator import init_discriminator

    ckpt = os.path.join(tmp, "ckpt")
    D = init_discriminator(DiscriminatorConfig(), seed=4, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_generator(ckpt, G.cfg, G)
    save_discriminator(ckpt, D.cfg, D)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(ckpt)
    t0 = time.perf_counter()
    cfg2, G2 = cli.get_model(ckpt, device=DEV)
    d_cfg2, D2 = load_discriminator(ckpt, device=DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert cfg2 == G.cfg and d_cfg2 == D.cfg
    n = assert_same_tree(to_flax(G2), to_flax(G), "G")
    n += assert_same_tree(to_flax(D2), to_flax(D), "D")
    fc.reset_launch_counts()
    cli.run_generate(G2, os.path.join(tmp, "gen_loaded"), images_num=2, truncation_psi=0.7,
                     batch_size=2, seed=0)
    launches = dict(fc.launch_counts)
    for name in sorted(os.listdir(os.path.join(tmp, "gen"))):
        with open(os.path.join(tmp, "gen", name), "rb") as a, \
                open(os.path.join(tmp, "gen_loaded", name), "rb") as b:
            assert a.read() == b.read(), f"{name}: the loaded generator's PNG differs"
    assert launches == _per_step(0, 1), launches
    print(f"  arch.json + Gs.msgpack + D.msgpack: {nbytes} bytes; save {save_s:.3f} s, load "
          f"(cli.get_model + load_discriminator, to cuda) {load_s:.3f} s; {n} leaves "
          f"bit-equal; run_generate from the loaded G: the same 2 PNGs byte for byte; "
          f"launches {launches}", flush=True)
    return dict(bytes=nbytes, save_s=save_s, load_s=load_s, leaves=n)


CONVERT_FORMS = ("plain", "zipfile", "tf")
LANDMARK_HELDOUT_PX = 6.0      # tests/test_landmarks_trained.py's regression bound


def convert_phase(torch, fc, cli, G, tmp, card):
    """Phase convert: the reference-checkpoint converter and the landmark
    net's trainer, each run as a user runs it (`python -m`, no JAX).

    Three pickles in the reference's wire format (tests/
    torch_reference_pickles.py), each holding phase generate's init:1024 G
    as G and as Gs and phase checkpoint's 1024^2 D (seed 4): the
    persistence dict through `pickle` and through `torch.save` (zipfile),
    and the TF-legacy (G, D, Gs) tuple. Each is converted in a subprocess,
    loaded through cli.get_model(<dir>) and load_discriminator: the configs
    G's and D's (the TF form's G with normalize_global False, which the TF
    form cannot carry and the converter sets, as JAX's does), every leaf
    bit-equal, run_generate's two PNGs byte for byte those of the G the
    pickle came from (phase generate's; for the TF form, that G's weights
    under the TF config, through a native checkpoint), exactly one forward's
    launches. Beside them, in a process of its own started first,
    train_landmarks with JAX's defaults on the card (its host-bound dataset
    build overlaps the conversions; its steps share the card with the three
    two-image generations): its held-out error and the bundled model's on
    16 faces of RandomState(991) under LANDMARK_HELDOUT_PX at 256 scale."""
    import numpy as np

    from morphganformer_tpu_torch.losses.landmarks import (BUNDLED_NPZ, load_landmark_npz,
                                                           make_landmark_fn)
    from morphganformer_tpu_torch.losses.synthetic_faces import sample_batch

    work = os.path.join(tmp, "convert")
    os.makedirs(work)
    lm_out, lm_log = os.path.join(work, "landmarks_trained.npz"), os.path.join(work, "lm.log")
    t_lm = time.perf_counter()
    with open(lm_log, "w") as log:
        trainer = subprocess.Popen([sys.executable, "-m",
                                    "morphganformer_tpu_torch.tools.train_landmarks", "2000",
                                    lm_out], stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
    try:
        stats = convert_forms(torch, fc, cli, G, tmp, work, card)
        rc = trainer.wait(timeout=900)
    finally:
        if trainer.poll() is None:
            trainer.kill()
            trainer.wait()
    train_wall = time.perf_counter() - t_lm
    with open(lm_log) as f:
        out_lines = f.read().splitlines()
    assert rc == 0, f"train_landmarks: {out_lines[-30:]}"
    dataset_s = float(next(line for line in out_lines if line.startswith("dataset:")).split()[1])
    rate_line = next(line for line in out_lines if line.startswith("trained "))
    assert rate_line.endswith("on " + DEV), rate_line
    steps_per_s = float(rate_line.split(": ")[1].split()[0])
    last_step = [line for line in out_lines if line.startswith("step ")][-1]
    val_px = float(last_step.split("val_err ")[1].split("px")[0])
    imgs, lms = sample_batch(np.random.RandomState(991), 16, 128)
    heldout = {}
    for which, path in (("trained", lm_out), ("bundled", BUNDLED_NPZ)):
        fn = make_landmark_fn(load_landmark_npz(path, DEV), temperature=0.05)
        with torch.no_grad():
            pred = fn(torch.from_numpy(imgs).to(DEV)).cpu().numpy()
        heldout[which] = float(np.linalg.norm(pred - lms, axis=-1).mean() * 256)
    stats["landmarks"] = dict(dataset_s=dataset_s, steps_per_s=steps_per_s,
                              val_err_px=val_px, heldout_err_px=heldout["trained"],
                              bundled_heldout_err_px=heldout["bundled"], wall_s=train_wall)
    print(f"  train_landmarks 2000 steps (python -m, on cuda, beside the conversions): dataset "
          f"of 2048 + 128 faces built on the host in {dataset_s:.3f} s; {steps_per_s:.3f} "
          f"steps/s; validation error {val_px:.3f} px at 256 scale; held-out (16 faces, "
          f"RandomState(991)) {heldout['trained']:.3f} px, the bundled model "
          f"{heldout['bundled']:.3f} px (bound {LANDMARK_HELDOUT_PX}); {train_wall:.3f} s from "
          f"its start to its end; {card}", flush=True)
    assert heldout["trained"] < LANDMARK_HELDOUT_PX, heldout
    assert heldout["bundled"] < LANDMARK_HELDOUT_PX, heldout
    return stats


def convert_forms(torch, fc, cli, G, tmp, work, card):
    """The three pickles of phase convert, each converted, loaded and held
    to the nets it came from; {form: figures}."""
    from morphganformer_tpu_torch.checkpoint import to_flax
    from morphganformer_tpu_torch.checkpoint.io import (load_discriminator, load_generator,
                                                        save_generator)
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig
    from morphganformer_tpu_torch.models.discriminator import init_discriminator

    from tests import torch_reference_pickles as refpk

    D = init_discriminator(DiscriminatorConfig(), seed=4, device=DEV)
    g_tree, d_tree, d_cfg = to_flax(G), to_flax(D), D.cfg
    del D
    stats = {"card": card}

    def same_pngs(a, b):
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and len(names) == 2, (names, os.listdir(b))
        for name in names:
            with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), f"{name}: the converted generator's PNG differs"

    for form in CONVERT_FORMS:
        pkl = os.path.join(work, f"snapshot_{form}.pkl")
        out = os.path.join(work, form)
        t0 = time.perf_counter()
        if form == "tf":
            refpk.write_tf_pickle(pkl, refpk.tf_nets(G.cfg, g_tree, d_cfg, d_tree))
            want_cfg = refpk.tf_config(G.cfg)
            ref_dir = os.path.join(work, "gen_tf_config")
            save_generator(os.path.join(work, "tf_config"), want_cfg, g_tree)
            _, G_ref = cli.get_model(os.path.join(work, "tf_config"), device=DEV)
            cli.run_generate(G_ref, ref_dir, images_num=2, truncation_psi=0.7, batch_size=2,
                             seed=0)
            del G_ref
        else:
            refpk.write_persistence_pickle(pkl, refpk.persistence_nets(G.cfg, g_tree, d_cfg,
                                                                       d_tree),
                                           zipfile=form == "zipfile")
            want_cfg, ref_dir = G.cfg, os.path.join(tmp, "gen")
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(pkl)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m",
                              "morphganformer_tpu_torch.tools.convert_checkpoint", pkl, out],
                             capture_output=True, text=True, timeout=600, cwd=REPO)
        convert_s = time.perf_counter() - t0
        assert run.returncode == 0, f"convert_checkpoint {form}: {run.stderr[-3000:]}"
        lines = run.stdout.splitlines()
        assert lines[-1] == "done" and not any("WARNING" in line for line in lines), lines
        os.remove(pkl)
        t0 = time.perf_counter()
        cfg2, G2 = cli.get_model(out, device=DEV)
        d_cfg2, D2 = load_discriminator(out, device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        g_cfg_role, G_role = load_generator(out, role="G", device=DEV)
        assert cfg2 == g_cfg_role == want_cfg, (cfg2, want_cfg)
        assert d_cfg2 == d_cfg, d_cfg2
        n = assert_same_tree(to_flax(G2), g_tree, f"{form} Gs")
        n += assert_same_tree(to_flax(G_role), g_tree, f"{form} G")
        n += assert_same_tree(to_flax(D2), d_tree, f"{form} D")
        del G_role, D2
        fc.reset_launch_counts()
        cli.run_generate(G2, os.path.join(work, f"gen_{form}"), images_num=2,
                         truncation_psi=0.7, batch_size=2, seed=0)
        launches = dict(fc.launch_counts)
        assert launches == _per_step(0, 1), launches
        same_pngs(ref_dir, os.path.join(work, f"gen_{form}"))
        del G2
        torch.cuda.empty_cache()
        stats[form] = dict(pickle_bytes=nbytes, write_s=write_s, convert_s=convert_s,
                           load_s=load_s, leaves=n, out_bytes=dir_bytes(out))
        source = "its G under the TF config" if form == "tf" else "phase generate"
        print(f"  {form}: pickle {nbytes} bytes (written in {write_s:.3f} s); "
              f"convert_checkpoint (python -m, a subprocess) {convert_s:.3f} s; "
              f"load (cli.get_model + load_discriminator, to cuda) {load_s:.3f} s; arch.json + "
              f"G, Gs, D msgpack {stats[form]['out_bytes']} bytes; {n} leaves bit-equal; "
              f"run_generate: the 2 PNGs of {source} byte for byte; launches {launches}; "
              f"{card}", flush=True)
    return stats


def write_png_filtered(path, img, filter_type):
    """An RGB PNG with every row filtered by `filter_type` (1 Sub, 4 Paeth),
    as libpng's encoders often pick for photographs."""
    import numpy as np

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), x[:, :-c]])
    if filter_type == 1:
        pred = left
    else:
        upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), filter_type, np.uint8), ((x - pred) % 256).astype(np.uint8)])

    def chunk(tag, data):
        return (len(data).to_bytes(4, "big") + tag + data
                + (zlib.crc32(tag + data) & 0xFFFFFFFF).to_bytes(4, "big"))

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, 2, 0, 0, 0])
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


LOOP_IMAGES = 16


def loop_phase(torch, fc, cli, G, train_stats):
    """Phase 9: the data feed and the looping trainer at FFHQ-1024."""
    import numpy as np

    from morphganformer_tpu_torch.checkpoint.async_io import AsyncSnapshotter
    from morphganformer_tpu_torch.checkpoint.io import save_discriminator, save_generator
    from morphganformer_tpu_torch.checkpoint.msgpack_codec import msgpack_restore
    from morphganformer_tpu_torch.data import native_loader
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    from morphganformer_tpu_torch.training import loop as tloop
    from morphganformer_tpu_torch.utils.image import read_png, to_uint8, write_png

    g_cfg, d_cfg = ffhq1024_config(), DiscriminatorConfig()
    res = g_cfg.img_resolution
    with tempfile.TemporaryDirectory(prefix="mgt_loop_") as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(os.path.join(data, str(res)))
        t0 = time.perf_counter()
        z = torch.randn((LOOP_IMAGES, G.cfg.k, G.cfg.z_dim),
                        generator=torch.Generator().manual_seed(100))
        imgs = np.concatenate([cli.synthesize(G, z[i:i + 4]).cpu().numpy()
                               for i in range(0, LOOP_IMAGES, 4)])
        for i, img in enumerate(imgs):
            write_png_filtered(os.path.join(data, str(res), f"{i:05d}.png"), to_uint8(img),
                               4 if i % 2 == 0 else 1)
        print(f"  {LOOP_IMAGES} PNGs of {res}^2 (Paeth rows: even, Sub rows: odd) written in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

        decode_ms = {}
        assert native_loader.native_available(), native_loader.build_error()
        for name, path in (("paeth", "00000.png"), ("sub", "00001.png")):
            path = os.path.join(data, str(res), path)
            want = to_uint8(imgs[0 if name == "paeth" else 1])
            for how, fn in (("native", lambda p: native_loader.decode_png(p, res, res)),
                            ("read_png", read_png)):
                t0 = time.perf_counter()
                got = fn(path)
                decode_ms[f"{how}_{name}"] = (time.perf_counter() - t0) * 1e3
                assert np.array_equal(got, want), (how, name)
        print(f"  decode of one {res}^2 PNG (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in decode_ms.items()), flush=True)

        t_cfg = TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4)
        run_dir = os.path.join(tmp, "run")
        real_iteration = GANTrainer.train_iteration
        record = {"calls": [], "first_state": None}

        def recording(self, state, real_img, step, z=None):
            if record["first_state"] is None:
                record["first_state"] = tloop.train_state_tree(state)
            torch.cuda.synchronize()
            before = dict(fc.launch_counts)
            t_in = time.perf_counter()
            out = real_iteration(self, state, real_img, step, z)
            torch.cuda.synchronize()
            t_out = time.perf_counter()
            record["calls"].append(dict(step=step, t_in=t_in, t_out=t_out, launches={
                k: fc.launch_counts[k] - before[k] for k in before}))
            return out

        def run(max_ticks, resume, backend, images=True):
            """`images`: image snapshots every tick (the resumed runs leave
            them out: the first run checks them)."""
            record["calls"], record["first_state"] = [], None
            l_cfg = tloop.LoopConfig(run_dir=run_dir, total_kimg=1,
                                     kimg_per_tick=2 * TRAIN_BATCH / 1000, snapshot_ticks=1,
                                     img_snapshot_ticks=int(images), vis=("grid", "interp"),
                                     tensorboard=True, snapshot_backend=backend, seed=0)
            out = io.StringIO()
            GANTrainer.train_iteration = recording
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    state = tloop.training_loop(g_cfg, d_cfg, t_cfg, l_cfg, data, resume=resume,
                                                max_ticks=max_ticks, device=DEV)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                GANTrainer.train_iteration = real_iteration
            text = out.getvalue()
            for line in text.splitlines():
                if line.startswith(("feed:", "Resuming", "tick ", "snapshot ")):
                    print(f"    {line}", flush=True)
            calls = record["calls"]
            for i, c in enumerate(calls):
                c["inside_s"] = c["t_out"] - c["t_in"]
                c["gap_s"] = c["t_in"] - calls[i - 1]["t_out"] if i else None
                assert c["launches"] == loop_launches(c["step"]), (c["step"], c["launches"])
                print(f"    step {c['step']}: {c['inside_s']:.3f} s in train_iteration"
                      + (f", {c['gap_s']:.3f} s since the previous one returned"
                         if i else "") + f"; launches {c['launches']}", flush=True)
            print(f"    {backend}: {len(calls)} iterations, {wall:.3f} s in training_loop",
                  flush=True)
            return state, text, calls, wall

        def saved_tree():
            path = os.path.join(tloop.latest_snapshot(run_dir), "train_state.msgpack")
            with open(path, "rb") as f:
                return msgpack_restore(f.read())

        state1, text1, calls1, wall1 = run(2, None, "msgpack")
        assert "feed: native" in text1, text1[:2000]
        assert text1.count("snapshot ") == 2 and state1.cur_nimg == 4 * TRAIN_BATCH
        lines = open(os.path.join(run_dir, "stats.jsonl")).read().splitlines()
        assert len(lines) == 2 and all(math.isfinite(json.loads(x)["Loss/D/loss"]["mean"])
                                       for x in lines)
        for name in ("fakes000000.png", "vis000000/interpolation.png", "module_summary.txt",
                     "training_options.json"):
            assert os.path.exists(os.path.join(run_dir, name)), name
        assert len([f for f in os.listdir(run_dir) if f.startswith("events.out.tfevents")]) == 1
        snap = tloop.latest_snapshot(run_dir)
        assert sorted(os.listdir(snap)) == ["D.msgpack", "G.msgpack", "Gs.msgpack", "arch.json",
                                            "train_state.msgpack"]
        saved1 = saved_tree()
        n_leaves = assert_same_tree(saved1, tloop.train_state_tree(state1), "saved vs in memory")

        state2, text2, calls2, wall2 = run(1, "auto", "msgpack", images=False)
        assert f"at cur_nimg {4 * TRAIN_BATCH}" in text2 and state2.cur_nimg == 6 * TRAIN_BATCH
        assert_same_tree(record["first_state"], saved1, "resumed (msgpack) vs saved")
        saved2 = saved_tree()
        del state1, state2
        state3, text3, calls3, wall3 = run(1, "auto", "async", images=False)
        assert f"at cur_nimg {6 * TRAIN_BATCH}" in text3 and state3.cur_nimg == 8 * TRAIN_BATCH
        assert_same_tree(record["first_state"], saved2, "resumed (async) vs saved")
        assert_same_tree(saved_tree(), tloop.train_state_tree(state3), "async saved vs memory")
        print(f"  resumed twice from a state bit-equal to the saved one ({n_leaves} leaves)",
              flush=True)

        _, G_snap = cli.get_model(tloop.latest_snapshot(run_dir), device=DEV)
        zs = torch.randn((2, g_cfg.k, g_cfg.z_dim), generator=torch.Generator().manual_seed(5))
        a, b = cli.synthesize(G_snap, zs), cli.synthesize(state3.G_ema, zs)
        img_diff = (a - b).abs().max().item()
        assert img_diff <= 1e-6, img_diff
        assert np.array_equal(to_uint8(a[0].cpu().numpy()), to_uint8(b[0].cpu().numpy()))

        # Snapshot cost on the final state: bytes, the synchronous write, the
        # asynchronous one (until save returns, then until the write ends),
        # and a load into a fresh state.
        snap_dir = os.path.join(tmp, "timed_snapshot")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_generator(snap_dir, g_cfg, state3.G, role="G")
        save_generator(snap_dir, g_cfg, state3.G_ema, role="Gs")
        save_discriminator(snap_dir, d_cfg, state3.D)
        nets_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tloop.save_train_state(os.path.join(snap_dir, "train_state.msgpack"), state3)
        sync_s = time.perf_counter() - t0
        nbytes = dir_bytes(snap_dir)
        writer = AsyncSnapshotter()
        t0 = time.perf_counter()
        writer.save(snap_dir, tloop.train_state_tree(state3))
        async_return_s = time.perf_counter() - t0
        writer.wait()
        async_s = time.perf_counter() - t0
        writer.close()
        fresh = GANTrainer(g_cfg, d_cfg, t_cfg, device=DEV).init_state(seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tloop.load_train_state(os.path.join(snap_dir, "train_state.msgpack"), fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert fresh.cur_nimg == state3.cur_nimg
        state_bytes = os.path.getsize(os.path.join(snap_dir, "train_state.msgpack"))
        print(f"  snapshot: {nbytes} bytes ({state_bytes} in train_state.msgpack); "
              f"G + Gs + D {nets_s:.3f} s; "
              f"train state synchronous {sync_s:.3f} s, async {async_return_s:.3f} s until "
              f"save returns and {async_s:.3f} s until written; load of the train state "
              f"{load_s:.3f} s; cli.get_model(snapshot) vs G_ema max abs diff {img_diff:.3e}",
              flush=True)

        # `train --dtype bfloat16` through the entry point and training_loop
        # on the same PNGs: one tick of two iterations (G_reg and D_reg due
        # at step 0), every fused block on the bfloat16 entry points.
        del fresh, state3
        fc.reset_launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["train", "--data-dir", data, "--result-dir", os.path.join(tmp, "bf16runs"),
                      "--expname", "bf16", "--resolution", str(res), "--batch", str(TRAIN_BATCH),
                      "--batch-gpu", str(TRAIN_BATCH), "--kimg-per-tick",
                      str(2 * TRAIN_BATCH / 1000), "--max-ticks", "1", "--img-snapshot-ticks",
                      "0", "--dtype", "bfloat16", "--device", DEV])
        torch.cuda.synchronize()
        bf16_train_s = time.perf_counter() - t0
        bf16_launches = dict(fc.launch_counts)
        snap = tloop.latest_snapshot(os.path.join(tmp, "bf16runs", "bf16-000"))
        with open(os.path.join(snap, "arch.json")) as f:
            arch = json.load(f)
        lines = [x for x in out.getvalue().splitlines() if x.startswith(("feed:", "tick "))]
        print(f"  train --dtype bfloat16 (cli.main, one tick of 2 iterations at batch "
              f"{TRAIN_BATCH}): {bf16_train_s:.3f} s; {lines}; launches {bf16_launches}",
              flush=True)
        assert arch["G"]["dtype"] == arch["Gs"]["dtype"] == arch["D"]["dtype"] == "bfloat16"
        assert all(bf16_launches[f"{k}_bf16"] > 0 for k in (*TRAIN_KEYS.values(), *BF16_KEYS)), \
            bf16_launches
        assert not any(v for k, v in bf16_launches.items() if not k.endswith("_bf16")), \
            bf16_launches

    calls = calls1 + calls2 + calls3
    # Odd steps: no reg stage inside, and no tick (after each odd step) in
    # the gap before them.
    steady = [c for c in calls if c["gap_s"] is not None and c["step"] % 2 == 1]
    inside = [c["inside_s"] for c in steady]
    gaps = [c["gap_s"] for c in steady]
    print(f"  loop iterations without reg stages or a tick before them: {len(steady)}; "
          f"seconds inside "
          f"train_iteration {_fmt_list(inside)}; since the previous one returned "
          f"{_fmt_list(gaps)}; phase train's untraced train_iteration "
          f"{_fmt_list([ms / 1e3 for ms in train_stats['iteration_ms']])} s", flush=True)
    return dict(decode_ms=decode_ms, iterations=[
        {k: c[k] for k in ("step", "inside_s", "gap_s")} for c in calls],
        loop_wall_s=[wall1, wall2, wall3], snapshot_bytes=nbytes, nets_save_s=nets_s,
        train_state_sync_s=sync_s, train_state_async_return_s=async_return_s,
        train_state_async_s=async_s, train_state_load_s=load_s, g_snapshot_diff=img_diff,
        train_bf16_s=bf16_train_s, train_bf16_launches=bf16_launches)


# ------------------------------------------------------------ this slice's paths

METRICS_BATCH = 16        # calc_metrics' default batch
METRICS_ITEMS = 32        # fid2k_full over two batches of 16 on each side
PPL_SAMPLES = 4           # ppl2_wend at batch 2: two syntheses of 4 images
NR_STEPS = 10             # project --noise_regularize against the same call without it
CSV_PAIRS = 4             # morph --pairs-csv: 4 pairs at --pairs-per-batch 4; the first at 1
CSV_STEPS = 10


@contextlib.contextmanager
def compute_dtype(G, dtype):
    """G's synthesis in `dtype` within the block, float32 after."""
    from morphganformer_tpu_torch.models import set_compute_dtype

    set_compute_dtype(G, dtype)
    try:
        yield G
    finally:
        set_compute_dtype(G, "float32")


@contextlib.contextmanager
def nonzero_noise(torch, G, seed):
    """Within the block every noise strength (0 at init) is U(0.05, 0.15),
    so the noise maps' cotangent through the kernels is not a zero; G's
    strengths and noise buffers come back as they were."""
    strengths = {n: p.detach().clone() for n, p in G.named_parameters()
                 if n.endswith("noise_strength")}
    buffers = {n: b.detach().clone() for n, b in G.named_buffers() if n.endswith("noise_const")}
    set_noise_strengths(torch, G, torch.Generator(device="cuda").manual_seed(seed))
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in G.named_parameters():
                if n in strengths:
                    p.copy_(strengths[n])
            for n, b in G.named_buffers():
                if n in buffers:
                    b.copy_(buffers[n])


def _group_rates(stamps):
    """Steady steps/s of each projection of a run (the progress steps restart
    at each group), averaged."""
    groups, cur = [], []
    for s in stamps:
        if cur and s[0] <= cur[-1][0]:
            groups.append(cur)
            cur = []
        cur.append(s)
    groups.append(cur)
    return sum(_steady_rate(g) for g in groups) / len(groups)


def noise_reg_check(torch, fc, cli, G, target_png, tmp):
    """project --noise_regularize 1e5 on the bfloat16 synthesis (project's
    default) with non-zero noise strengths, against the same call without
    it: NR_STEPS steps each, launches per step unchanged (4/6/4/6 on the
    tensor-core kernels), ms per step, the <latent>.noises.npz; merge
    --latents w.mat w.mat --noises w.noises.npz writes the projection's best
    PNG byte for byte; at one noised latent the latent and noise-map
    gradients on the bfloat16 kernels and on the bfloat16 plain route,
    each against float32's on the kernels (phase bf16's rule); one traced
    step with and without."""
    import numpy as np

    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.models import set_compute_dtype
    from morphganformer_tpu_torch.projection import (ProjectionConfig, latent_stats,
                                                     loss_and_grad, loss_and_grads_with_noise,
                                                     split_noise_buffers)
    from morphganformer_tpu_torch.utils.image import load_target, read_png

    out = {}
    with nonzero_noise(torch, G, 22), compute_dtype(G, "bfloat16"):
        for nr in (0.0, 1e5):
            stamps = []
            d = os.path.join(tmp, f"proj_nr_{nr:g}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fc.reset_launch_counts()
            res = cli.run_project(G, target_png, d, steps=NR_STEPS, n_mean_latent=10000,
                                  chunk=2, seed=0, progress=_timed_progress(stamps),
                                  noise_regularize=nr)
            launches = dict(fc.launch_counts)
            rate, peak = _steady_rate(stamps), torch.cuda.max_memory_allocated() / 2**30
            history = res.loss_history.numpy()
            print(f"  run_project bfloat16 --noise_regularize {nr:g}: {NR_STEPS} steps, steady "
                  f"{rate:.3f} steps/s ({1e3 / rate:.3f} ms/step), peak {peak:.3f} GiB; loss "
                  f"{history[0]:.5f} -> best {res.best_loss:.5f}; launches {launches}",
                  flush=True)
            assert launches == _per_step(NR_STEPS, 1, bf16=True), launches
            assert np.isfinite(history).all() and torch.isfinite(res.best_img).all().item()
            out[f"nr_{nr:g}"] = dict(steps_per_s=rate, ms_per_step=1e3 / rate, peak_gib=peak)
        assert set(res.noises) == set(split_noise_buffers(G)), sorted(res.noises)
        files = sorted(os.listdir(d))
        assert files[1:] == ["w.mat", "w.noises.npz"] and files[0].startswith("sample_"), files

        w = os.path.join(d, "w.mat")
        fc.reset_launch_counts()
        cli.run_merge(G, [w, w], os.path.join(tmp, "merge_nr"),
                      noises=os.path.join(d, "w.noises.npz"))
        assert dict(fc.launch_counts) == _per_step(0, 1, bf16=True), fc.launch_counts
        assert np.array_equal(read_png(os.path.join(tmp, "merge_nr", "w_w.png")),
                              read_png(os.path.join(d, files[0]))), "merge --noises differs"

        pcfg = ProjectionConfig(steps=NR_STEPS, noise_regularize=1e5)
        mean, std = latent_stats(G.cfg, torch.Generator().manual_seed(0), 10000)
        latent_n = (mean[None] + torch.randn((1, G.cfg.k, G.cfg.z_dim),
                                             generator=torch.Generator().manual_seed(1))
                    * std * pcfg.noise).cuda()
        target = torch.from_numpy(load_target(target_png, G.cfg.img_resolution)).cuda()
        loss_fn = build_loss_stack({"mse": 1.0})
        noises = {k: v.clone() for k, v in res.noises.items()}
        grads = {}
        for key, dtype, plain in (("float32", "float32", False), ("kernels", "bfloat16", False),
                                  ("plain", "bfloat16", True)):
            set_compute_dtype(G, dtype)
            _, _, _, gl, gn = loss_and_grads_with_noise(G, latent_n, noises, target, loss_fn,
                                                        pcfg, plain)
            grads[key] = [gl, *gn.values()]
        set_compute_dtype(G, "bfloat16")
        ek, ep, kp = _bf16_errs(grads["kernels"], grads["plain"], grads["float32"])
        smallest = min(g.abs().max().item() for g in grads["float32"][1:])
        print(f"  noise_regularize gradients (the latent's and {len(noises)} noise maps') in "
              f"bfloat16 against float32's, of each one's largest entry: kernels {ek:.3e}, "
              f"plain {ep:.3e}, kernels vs plain {kp:.3e}; smallest noise-map gradient "
              f"{smallest:.3e}", flush=True)
        assert smallest > 0, "a noise map's cotangent is zero"
        assert ek <= max(BF16_RATIO * ep, BF16_FLOOR), (ek, ep)
        out["grad_vs_f32"] = dict(kernels=ek, plain=ep, kernels_vs_plain=kp)

        fc.reset_launch_counts()
        loss_and_grads_with_noise(G, latent_n, noises, target, loss_fn, pcfg)
        assert dict(fc.launch_counts) == _per_step(1, 0, bf16=True), fc.launch_counts
        for label, fn in (("noise_regularize", lambda: loss_and_grads_with_noise(
                              G, latent_n, noises, target, loss_fn, pcfg)),
                          ("plain latent", lambda: loss_and_grad(G, latent_n, target, loss_fn,
                                                                 pcfg))):
            t = traced_forward(torch, fn, f"bfloat16 projection step, {label}")
            out[f"traced_{label.replace(' ', '_')}"] = {
                k: t[k] for k in ("window_ms", "busy_ms", "device_ops")}
    return out


def morph_csv_check(torch, fc, cli, G, tmp):
    """morph --pairs-csv on the bfloat16 synthesis (morph's default): the
    four bfloat16 tensor-core roles at batch 2 * CSV_PAIRS (`check_bf16`);
    a CSV of CSV_PAIRS pairs of G(z) faces and one row under
    --min-similarity; CSV_STEPS-step projections with --pairs-per-batch
    CSV_PAIRS (one batch-8 projection) and, on the first pair alone, 1 (the
    rate of one batch-2 projection): exact launches, every file of every
    pair, the morph latents the pairs' averages, pair-steps/s and peak
    memory."""
    import numpy as np

    from morphganformer_tpu_torch.morph import load_latent_mat
    from morphganformer_tpu_torch.utils.image import to_uint8, write_png

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = [check_bf16(torch, fc, gen, call, adjoint, batch=2 * CSV_PAIRS)
            for adjoint in (False, True) for call in kernel_calls()]
    faces = os.path.join(tmp, "csv_faces")
    os.makedirs(faces)
    z = torch.randn((2 * CSV_PAIRS, G.cfg.k, G.cfg.z_dim),
                    generator=torch.Generator().manual_seed(30))
    names = [f"face{i}" for i in range(2 * CSV_PAIRS)]
    for name, img in zip(names, cli.synthesize(G, z).cpu().numpy()):
        write_png(os.path.join(faces, f"{name}.png"), to_uint8(img))
    csv_path = os.path.join(tmp, "pairs.csv")
    with open(csv_path, "w") as f:
        f.write("img_a,img_b,similarity\n")
        for i in range(CSV_PAIRS):
            f.write(f"{names[2 * i]}.png,{names[2 * i + 1]}.png,0.9\n")
        f.write(f"{names[0]}.png,{names[3]}.png,0.1\n")          # under --min-similarity
    out = {}
    with compute_dtype(G, "bfloat16"):
        pairs = cli.read_pairs_csv(csv_path, faces, 0.5)
        assert len(pairs) == CSV_PAIRS, pairs
        for per, todo in ((CSV_PAIRS, pairs), (1, pairs[:1])):
            d = os.path.join(tmp, f"csv_{per}")
            stamps = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fc.reset_launch_counts()
            t0 = time.perf_counter()
            groups = cli.run_morph_pairs(G, todo, d, steps=CSV_STEPS, chunk=2, seed=0,
                                         progress=_timed_progress(stamps), pairs_per_batch=per)
            wall = time.perf_counter() - t0
            launches = dict(fc.launch_counts)
            peak = torch.cuda.max_memory_allocated() / 2**30
            rate = _group_rates(stamps) * per
            n = len(groups)
            print(f"  morph --pairs-csv, --pairs-per-batch {per}: {n} batch-{2 * per} "
                  f"projection(s) of {CSV_STEPS} steps in {wall:.3f} s; steady {rate:.3f} "
                  f"pair-steps/s; peak {peak:.3f} GiB; launches {launches}", flush=True)
            assert n == len(todo) // per
            assert launches == _per_step(n * CSV_STEPS, 2 * n, bf16=True), launches
            assert len(os.listdir(d)) == 6 * len(todo), sorted(os.listdir(d))
            for a, b in list(zip(names[::2], names[1::2]))[:len(todo)]:
                wa, wb, wm = (load_latent_mat(os.path.join(d, f"{s}.mat"))
                              for s in (a, b, f"{a}_{b}_morph"))
                assert np.allclose(wm, 0.5 * wa + 0.5 * wb, rtol=0, atol=1e-6)
            for res, imgs, _ in groups:
                assert np.isfinite(res.loss_history.numpy()).all() and np.isfinite(imgs).all()
            out[f"pairs_per_batch_{per}"] = dict(pair_steps_per_s=rate, peak_gib=peak,
                                                 wall_s=wall, launches=launches)
    return rows, out


@contextlib.contextmanager
def timed_calls(seconds, *targets):
    """Within the block each (module, name) of `targets` is wrapped so that
    its calls add their wall seconds to seconds[name]."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return call

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield seconds
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ppl_feature_fn(torch):
    """PPL's perceptual embedding for the smoke run: the LPIPS-VGG tower on
    random weights (seed 0), each slice unit-normalised over channels,
    flattened and joined."""
    from morphganformer_tpu_torch.losses import lpips

    params = lpips.random_lpips_params("vgg", device="cuda")

    def embed(img):
        x = (img / 127.5 - 1.0).permute(0, 3, 1, 2)
        return torch.cat([lpips.normalize_tensor(f).flatten(1)
                          for f in lpips.vgg16_features(params["tower"], x)], dim=1)

    return embed


def metrics_phase(torch, fc, cli, G, tmp):
    """The float32 K1 and K2 forwards at the 10 call shapes at batch 16
    (calc_metrics' default); fid2k_full through run_calc_metrics (the
    calc_metrics entry point) on METRICS_ITEMS G(z) images written as PNGs,
    with a random-weight InceptionV3 written as an .npz, then with the raw
    detector: exact launches per batch-16 forward, the metric-fid2k_full.jsonl
    lines, each run's seconds split between the dataset's features, the
    generator's and frechet_distance (scipy's sqrtm on the host); one
    batch's images on the kernels against the plain route; imgs/s of
    features_for_generator and its split between G and the detector;
    ppl2_wend on PPL_SAMPLES pairs (batch 2), kernels and plain."""
    import numpy as np

    from morphganformer_tpu_torch.metrics import core, inception, registry
    from morphganformer_tpu_torch.metrics.extract import (_to_detector_range,
                                                          features_for_generator)
    from morphganformer_tpu_torch.metrics.registry import compute_metric
    from morphganformer_tpu_torch.utils.image import to_uint8, write_png

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = [check_kernel(torch, fc, gen, call, batch=METRICS_BATCH) for call in kernel_calls()]
    cfg = G.cfg
    out = {}
    data = os.path.join(tmp, "metrics_data")
    res_dir = os.path.join(data, str(cfg.img_resolution))
    os.makedirs(res_dir)
    gz = torch.Generator().manual_seed(40)
    t0 = time.perf_counter()
    for lo in range(0, METRICS_ITEMS, METRICS_BATCH):
        z = torch.randn((METRICS_BATCH, cfg.k, cfg.z_dim), generator=gz)
        for i, img in enumerate(cli.synthesize(G, z).cpu().numpy()):
            write_png(os.path.join(res_dir, f"{lo + i:04d}.png"), to_uint8(img))
    print(f"  {METRICS_ITEMS} dataset PNGs written in {time.perf_counter() - t0:.3f} s",
          flush=True)
    npz = os.path.join(tmp, "inception_random.npz")
    inception.save_inception_npz(inception.random_inception_params(0), npz)
    # The detector's one-time cost (load, first cuDNN calls at each shape),
    # apart from the metric's run.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inception.make_detector(inception.load_inception_npz(npz))(
        torch.zeros((METRICS_BATCH, cfg.img_resolution, cfg.img_resolution, 3), device=DEV))
    torch.cuda.synchronize()
    out["detector_first_call_s"] = time.perf_counter() - t0
    print(f"  InceptionV3 from the .npz, its first call at batch {METRICS_BATCH}: "
          f"{out['detector_first_call_s']:.3f} s", flush=True)
    run_dir = os.path.join(tmp, "metrics_run")
    os.makedirs(run_dir)
    for det, items in ((npz, METRICS_ITEMS), ("raw", METRICS_BATCH)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_calls({}, (registry, "features_for_dataset"),
                         (registry, "features_for_generator"),
                         (core, "frechet_distance")) as split:
            (result,) = cli.run_calc_metrics(G, data, ["fid2k_full"], max_items=items,
                                             batch=METRICS_BATCH, run_dir=run_dir,
                                             detector=det)
        torch.cuda.synchronize()
        secs, launches = time.perf_counter() - t0, dict(fc.launch_counts)
        tag = "inception" if det == npz else "raw"
        value = result["results"]["fid2k_full"]
        print(f"  calc_metrics fid2k_full, {tag} detector, {items} items at batch "
              f"{METRICS_BATCH}: {value:.6g} in {secs:.3f} s (dataset features "
              f"{split['features_for_dataset']:.3f} s, generator features "
              f"{split['features_for_generator']:.3f} s, frechet_distance "
              f"{split['frechet_distance']:.3f} s), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}",
              flush=True)
        assert launches == _per_step(0, items // METRICS_BATCH), launches
        assert np.isfinite(value), value
        out[f"fid2k_full_{tag}"] = dict(value=value, seconds=secs, items=items,
                                        launches=launches, split_s=split)
    lines = [json.loads(s) for s in open(os.path.join(run_dir, "metric-fid2k_full.jsonl"))]
    assert len(lines) == 2 and {"results", "metric", "total_time", "snapshot_pkl",
                                "timestamp"} <= set(lines[0])

    z = torch.randn((METRICS_BATCH, cfg.k, cfg.z_dim),
                    generator=torch.Generator().manual_seed(0)).cuda()
    yk = cli.synthesize(G, z, truncation_psi=1.0)
    yp = cli.synthesize(G, z, truncation_psi=1.0, plain=True)
    torch.cuda.synchronize()
    diff = (yk - yp).abs().max().item()
    print(f"  batch {METRICS_BATCH} forward at psi 1, kernels vs plain: max abs diff "
          f"{diff:.3e}", flush=True)
    assert diff <= 1e-3, diff
    det = inception.make_detector(inception.random_inception_params(0))
    x = _to_detector_range(yk)
    g_ms = cuda_ms(torch, lambda: cli.synthesize(G, z, truncation_psi=1.0), reps=3, warmup=1)
    d_ms = cuda_ms(torch, lambda: det(x), reps=3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = features_for_generator(det, G, max_items=2 * METRICS_BATCH, batch=METRICS_BATCH,
                                   capture_mean_cov=True)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    rate = stats.num_items / feat_s
    print(f"  features_for_generator: {stats.num_items} images in {feat_s:.3f} s, {rate:.3f} "
          f"imgs/s; a batch of {METRICS_BATCH}: G {g_ms:.3f} ms, InceptionV3 {d_ms:.3f} ms",
          flush=True)
    out["features"] = dict(imgs_per_s=rate, g_ms=g_ms, detector_ms=d_ms, kernels_vs_plain=diff)

    embed = ppl_feature_fn(torch)
    vals = {}
    for plain in (False, True):
        fc.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = compute_metric("ppl2_wend", G=G, feature_fn=embed, max_items=PPL_SAMPLES, batch=2,
                           plain=plain)
        torch.cuda.synchronize()
        vals["plain" if plain else "kernels"] = (r["results"]["ppl2_wend"],
                                                 time.perf_counter() - t0)
        if not plain:
            assert dict(fc.launch_counts) == _per_step(0, PPL_SAMPLES // 2), fc.launch_counts
    print(f"  ppl2_wend over {PPL_SAMPLES} samples: kernels {vals['kernels'][0]:.6g} "
          f"({PPL_SAMPLES / vals['kernels'][1]:.3f} samples/s), plain {vals['plain'][0]:.6g}",
          flush=True)
    for v, _ in vals.values():
        assert np.isfinite(v) and v > 0, vals
    out["ppl2_wend"] = dict(kernels=vals["kernels"][0], plain=vals["plain"][0],
                            samples_per_s=PPL_SAMPLES / vals["kernels"][1])
    return rows, out


VIS_BATCH = 4
VIS_FPS = 4


def gif_blocks(data):
    """A GIF89a walked block by block: ((width, height), frames, each
    frame's delay in hundredths of a second, the NETSCAPE loop count)."""
    assert data[:6] == b"GIF89a", data[:6]
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0)
    frames, delays, loop = 0, [], None
    while data[pos] != 0x3B:
        if data[pos] == 0x21:                       # extension: label, sub-blocks
            label, pos = data[pos + 1], pos + 2
            blocks = []
            while data[pos]:
                blocks.append(data[pos + 1:pos + 1 + data[pos]])
                pos += 1 + data[pos]
            pos += 1
            if label == 0xF9:
                delays.append(struct.unpack("<H", blocks[0][1:3])[0])
            elif label == 0xFF and blocks[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", blocks[1][1:3])[0]
        elif data[pos] == 0x2C:                     # image: descriptor, table, LZW data
            fw, fh, packed = struct.unpack("<HHB", data[pos + 5:pos + 10])
            assert (fw, fh) == (w, h), (fw, fh)
            pos += 10 + (3 << ((packed & 7) + 1) if packed & 0x80 else 0) + 1
            while data[pos]:
                pos += 1 + data[pos]
            pos += 1
            frames += 1
        else:
            raise ValueError(f"GIF: unexpected block 0x{data[pos]:02x} at {pos}")
    return (w, h), frames, delays, loop


def vis_phase(torch, fc, cli, G, tmp, card):
    """Phase vis: the attention maps (return_att) of FFHQ-1024 at batch 4,
    attention_blends, and make_video of its four blends."""
    import numpy as np

    from morphganformer_tpu_torch.training import visualize as vz

    cfg = G.cfg
    z = torch.randn((VIS_BATCH, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(21))
    zc = z.cuda()
    with torch.no_grad():
        fc.reset_launch_counts()
        img = G(z=zc, truncation_psi=0.7)
        plain_launches = dict(fc.launch_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        img_att, att = G(z=zc, truncation_psi=0.7, return_att=True)
        torch.cuda.synchronize()
        att_s = time.perf_counter() - t0
        att_launches = dict(fc.launch_counts)
        att_peak = torch.cuda.max_memory_allocated()
        L = sum(1 + (r > 4) for r in cfg.block_resolutions if cfg.use_attention(r))
        want_shape = (VIS_BATCH, cfg.k - 1, L, cfg.attention.num_heads, 1024, 1024)
        sum_err = (att.sum(dim=1) - 1).abs().max().item()
        print(f"  return_att at batch {VIS_BATCH}: maps {tuple(att.shape)} "
              f"({att.numel() * 4 / 2**30:.3f} GiB), {att_s:.3f} s, peak memory "
              f"{att_peak / 2**30:.3f} GiB ({card}); launches {att_launches}; each layer's maps "
              f"sum to 1 within {sum_err:.3e}", flush=True)
        assert tuple(att.shape) == want_shape == (4, 16, 11, 1, 1024, 1024), att.shape
        assert torch.equal(img, img_att), "return_att changed the image"
        assert plain_launches == att_launches == _per_step(0, 1), (plain_launches, att_launches)
        assert sum_err <= 1e-5, sum_err
        img_p, att_p = G(z=zc, truncation_psi=0.7, return_att=True, plain=True)
        img_diff = (img_att - img_p).abs().max().item()
        att_diff = (att - att_p).abs().max().item()
        del att, att_p
        print(f"  kernels vs plain with return_att: image {img_diff:.3e}, maps {att_diff:.3e}",
              flush=True)
        assert img_diff <= 1e-3 and att_diff <= 1e-3, (img_diff, att_diff)

    vis_dir = os.path.join(tmp, "vis")
    os.makedirs(vis_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    blends = vz.attention_blends(G, cfg, num=VIS_BATCH, out_dir=vis_dir, z=z.numpy())
    blend_s = time.perf_counter() - t0
    blend_launches = dict(fc.launch_counts)
    blend_peak = torch.cuda.max_memory_allocated()
    print(f"  attention_blends: {VIS_BATCH} images in {blend_s:.3f} s (PNGs included), peak "
          f"memory {blend_peak / 2**30:.3f} GiB ({card}); launches {blend_launches}", flush=True)
    assert blends.shape == (VIS_BATCH, 1024, 1024, 3) and np.isfinite(blends).all()
    assert blend_launches == _per_step(0, 1), blend_launches
    assert sorted(os.listdir(vis_dir)) == sorted(
        [f"attention_{i}.png" for i in range(VIS_BATCH)]
        + [f"sample_{i}.png" for i in range(VIS_BATCH)])

    frames = os.path.join(tmp, "frames.txt")
    with open(frames, "w") as f:
        f.write("".join(os.path.join(vis_dir, f"attention_{i}.png\n") for i in range(VIS_BATCH)))
    gif = os.path.join(tmp, "attention.gif")
    t0 = time.perf_counter()
    cli.main(["make_video", "--list", frames, "--out", gif, "--fps", str(VIS_FPS)])
    gif_s = time.perf_counter() - t0
    with open(gif, "rb") as f:
        data = f.read()
    size, n_frames, delays, loop = gif_blocks(data)
    print(f"  make_video: {n_frames} frames of {size[0]}x{size[1]}, {len(data)} bytes in "
          f"{gif_s:.3f} s on the host ({card}); delays {delays} cs, loop {loop}", flush=True)
    assert size == (1024, 1024) and n_frames == VIS_BATCH and loop == 0
    assert delays == [int(1000 / VIS_FPS) // 10] * VIS_BATCH, delays
    return dict(att_s=att_s, att_peak_gib=att_peak / 2**30, blends_s=blend_s,
                blends_peak_gib=blend_peak / 2**30, att_sum_err=sum_err, img_vs_plain=img_diff,
                att_vs_plain=att_diff, gif_s=gif_s, gif_bytes=len(data), card=card)


def warp_phase(torch, cli, morph_png, png_a, png_b, tmp, card):
    """Phase warp: warp_morphs on phase morph's morph and its two targets,
    with predicted landmarks and again from CSVs; the card's float64 warp
    against the CPU path."""
    import numpy as np

    from morphganformer_tpu_torch.losses.landmarks import save_landmarks_csv
    from morphganformer_tpu_torch.morph.warp import (
        load_landmarks_csv,
        warp_morph_to_average_landmarks,
    )
    from morphganformer_tpu_torch.utils.image import read_png, read_png_rgb

    name = os.path.splitext(os.path.basename(morph_png))[0]
    out_p, out_b = os.path.join(tmp, "warped_predict"), os.path.join(tmp, "warped_list")
    t0 = time.perf_counter()
    cli.main(["warp_morphs", "--morph", morph_png, "--img-a", png_a, "--img-b", png_b,
              "--predict-landmarks", "--out", out_p])
    predict_s = time.perf_counter() - t0

    predict = cli.landmark_predictor(device="cuda")
    csvs = []
    for path in (png_a, png_b, morph_png):
        csvs.append(os.path.join(tmp, os.path.basename(path) + ".csv"))
        save_landmarks_csv(csvs[-1], predict(read_png_rgb(path).astype(np.float32)))
    batch = os.path.join(tmp, "warp_list.txt")
    with open(batch, "w") as f:
        f.write(f"{morph_png},{csvs[0]},{csvs[1]},{csvs[2]}\n")
    t0 = time.perf_counter()
    cli.main(["warp_morphs", "--batch-list", batch, "--out", out_b])
    list_s = time.perf_counter() - t0
    by_predict = read_png(os.path.join(out_p, f"{name}_warped.png")).astype(int)
    by_list = read_png(os.path.join(out_b, f"{name}_warped.png")).astype(int)
    csv_diff = np.abs(by_predict - by_list)

    lm_a, lm_b, lm_m = (load_landmarks_csv(c) for c in csvs)
    img = read_png_rgb(morph_png).astype(np.float32)
    gpu = torch.from_numpy(img).cuda()
    warped = warp_morph_to_average_landmarks(gpu, lm_m, lm_a, lm_b)
    t0 = time.perf_counter()
    on_cpu = warp_morph_to_average_landmarks(torch.from_numpy(img), lm_m, lm_a, lm_b)
    cpu_s = time.perf_counter() - t0
    warp_ms = cuda_ms(torch, lambda: warp_morph_to_average_landmarks(gpu, lm_m, lm_a, lm_b),
                      reps=3, warmup=1)
    err = (warped.cpu() - on_cpu).abs().max().item()
    exact = on_cpu.numpy()
    keep = np.abs(exact - np.rint(exact)) >= 1e-6
    truncated = np.clip(exact, 0, 255).astype(np.uint8)
    mismatch = int((by_list != truncated)[keep].sum())
    moved = float(np.abs(exact - img).mean())
    print(f"  warp_morphs --predict-landmarks {predict_s:.3f} s, --batch-list {list_s:.3f} s "
          f"(set-up, PNGs included); CSV (3 decimals) vs predicted landmarks: max "
          f"{csv_diff.max()}, {(csv_diff > 0).mean():.4f} of the values; the warp moved the "
          f"morph by {moved:.3f} levels on average", flush=True)
    print(f"  float64 warp at 1024^2: card {warp_ms:.3f} ms (CUDA events, the triangulation "
          f"on the host included), CPU path {cpu_s:.3f} s ({card}); card vs CPU max abs "
          f"{err:.3e}; the CSV route's PNG vs the CPU warp truncated: {mismatch} values apart "
          f"among the {keep.mean():.4f} of them away from integers", flush=True)
    assert warped.dtype == torch.float64 and tuple(warped.shape) == (1024, 1024, 3)
    assert err <= 1e-6, err
    assert mismatch == 0 and keep.mean() > 0.1, (mismatch, keep.mean())
    assert csv_diff.max() <= 1 and moved > 0
    return dict(predict_s=predict_s, batch_list_s=list_s, card_ms=warp_ms, cpu_s=cpu_s,
                card_vs_cpu=err, csv_vs_predict_max=int(csv_diff.max()), card=card)


DATASET_SIZES = ((1100, 1300), (1300, 1100), (1200, 1250), (1030, 1500), (1500, 1030),
                 (1111, 1234))    # (h, w) of the crops


def dataset_phase(torch, cli, G, card):
    """Phase dataset: dataset_tool's four subcommands on six non-square
    PNGs cut from G's images, and one batch of the result through the
    native feed."""
    import numpy as np

    from morphganformer_tpu_torch.data import native_loader
    from morphganformer_tpu_torch.data.dataset import dataset_files
    from morphganformer_tpu_torch.utils.image import read_png, to_uint8, write_png

    n = len(DATASET_SIZES)
    with tempfile.TemporaryDirectory(prefix="mgt_ds_") as tmp:
        src, out = os.path.join(tmp, "photos"), os.path.join(tmp, "ds")
        os.makedirs(src)
        z = torch.randn((n, G.cfg.k, G.cfg.z_dim), generator=torch.Generator().manual_seed(200))
        faces = np.concatenate([cli.synthesize(G, z[i:i + 2]).cpu().numpy()
                                for i in range(0, n, 2)])
        for i, (face, (h, w)) in enumerate(zip(faces, DATASET_SIZES)):
            big = np.pad(to_uint8(face), ((250, 250), (250, 250), (0, 0)), mode="reflect")
            top, left = (1524 - h) // 2 + i, (1524 - w) // 2 - i
            write_png(os.path.join(src, f"photo_{i}.png"), big[top:top + h, left:left + w])

        def tool(*argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    cli.main(["dataset_tool", *argv])
                    code = 0
                except SystemExit as e:
                    code = e.code
            return code, buf.getvalue()

        t0 = time.perf_counter()
        code, text = tool("create_from_images", out, src, "--resolution", "1024", "--lods", "2")
        create_s = time.perf_counter() - t0
        assert code == 0 and f"wrote {n} images at levels [1024, 512]" in text, text
        for r in (1024, 512):
            files = dataset_files(out, r)
            assert [os.path.basename(f) for f in files] == [f"{i:08d}.png" for i in range(n)]
            assert all(read_png(f).shape == (r, r, 3) for f in files)
        assert tool("display", out, "--resolution", "1024")[0] == 0
        assert read_png(os.path.join(out, "preview_1024.png")).shape[2] == 3

        code, text = tool("compare", out, out, "--resolution", "1024")
        assert code == 0 and text.strip().endswith("identical"), text
        copy = os.path.join(tmp, "copy")
        shutil.copytree(out, copy)
        changed = os.path.join(copy, "1024", "00000002.png")
        img = read_png(changed)
        img[300, 400, 0] ^= 1
        write_png(changed, img)
        code, text = tool("compare", out, copy, "--resolution", "1024")
        assert code == 1 and "item 2 differs (max abs diff 1)" in text, (code, text)
        assert text.strip().endswith("1 differences"), text

        extracted = os.path.join(tmp, "extracted")
        assert tool("extract", out, extracted, "--resolution", "512")[0] == 0
        items = [read_png(f) for f in dataset_files(out, 512)]
        got = [read_png(os.path.join(extracted, f"img{i:08d}.png")) for i in range(n)]
        assert sorted(os.listdir(extracted)) == [f"img{i:08d}.png" for i in range(n)]
        assert all(np.array_equal(a, b) for a, b in zip(got, items))

        assert native_loader.native_available(), native_loader.build_error()
        decoded = [read_png(f) for f in dataset_files(out, 1024)]
        # One worker: it takes a batch's four indices in order from one shuffled
        # pass over the six items, so they are distinct. With several workers
        # the indices interleave and a batch may cross into the next pass.
        batches = native_loader.native_infinite_batches(out, 1024, 4, seed=0, num_threads=1)
        t0 = time.perf_counter()
        x, labels = next(batches)
        feed_s = time.perf_counter() - t0
        batches.close()
        assert x.shape == (4, 1024, 1024, 3) and x.dtype == np.float32 and labels.shape == (4, 0)
        as_uint8 = np.rint((x + 1) * 127.5).astype(np.uint8)
        found = [next((i for i, d in enumerate(decoded) if np.array_equal(b, d)), None)
                 for b in as_uint8]
        print(f"  dataset_tool create_from_images: {n} PNGs of "
              + ", ".join(f"{w}x{h}" for h, w in DATASET_SIZES)
              + f" at levels 1024 and 512 in {create_s:.3f} s on the host ({card}); display, "
              f"compare (0 and 1 differences), extract ok; the native feed's first batch "
              f"({feed_s:.3f} s) holds items {found}", flush=True)
        assert None not in found and len(set(found)) == 4, found
    return dict(create_s=create_s, feed_s=feed_s, card=card)


DIST_PROJECT_STEPS = 5


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN in deterministic mode inside the block."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def dist_phase(torch, fc, cli, card):
    """Phase 15: data parallelism through torch.distributed on this card: a
    world-1 NCCL group met through initialize_distributed at a free
    localhost port; two 1024^2 iterations at batch 4 on phase train's
    resnet pair (step 0 with G_reg and D_reg due, then step 1), from one
    state and on one set of z and reals, by the plain trainer and by the
    trainer over make_data_mesh() (each stage's gradients all-reduced):
    every leaf of G, D, G_ema and both Adams bit-equal, and each iteration
    exactly phase train's launches (`loop_launches`). cuDNN runs in
    deterministic mode there (phase reg's reason), else two runs of one
    iteration differ in their last bits. Then, in cuDNN's default mode, the
    all-reduces of one main-stage iteration (G's and D's gradients, one
    buffer each) alone in CUDA events, against four main-only iterations
    each way, in turns: in a group of one rank an all-reduce is a local
    copy, so this times the trainer's path, not data parallelism's cost
    (dist_probe.py measures that on several cards). Last, deterministic again, a 2-row projection of
    DIST_PROJECT_STEPS steps through mesh=[cuda:0] and mesh=None: latents
    and losses equal, the same launches."""
    import torch.distributed as dist

    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.parallel import free_port, initialize_distributed
    from morphganformer_tpu_torch.parallel.mesh import all_mean_, make_data_mesh
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, project
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    from morphganformer_tpu_torch.training.loop import apply_train_state, train_state_tree

    t0 = time.perf_counter()
    rank = initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda",
                                  timeout_s=120)
    try:
        assert rank == 0 and dist.get_backend() == "nccl" and dist.get_world_size() == 1
        mesh = make_data_mesh()
        assert mesh.world == 1 and mesh.devices == (torch.device("cuda", 0),), mesh
        rendezvous_s = time.perf_counter() - t0
        print(f"  NCCL group of 1 at localhost: {rendezvous_s:.3f} s; mesh {mesh}", flush=True)
        g_cfg, d_cfg = ffhq1024_config(), DiscriminatorConfig()
        cfg = TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4)
        trainers = {"plain": GANTrainer(g_cfg, d_cfg, cfg),
                    "mesh": GANTrainer(g_cfg, d_cfg, cfg, mesh=mesh)}
        state = trainers["plain"].init_state(seed=0)
        start = train_state_tree(state)
        gen = torch.Generator(device="cuda").manual_seed(21)
        res = d_cfg.img_resolution
        reals = torch.rand((2, TRAIN_BATCH, res, res, 3), generator=gen, device="cuda") * 2 - 1
        zs = torch.randn((2, TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device="cuda")
        trees, iter_ms = {}, {}
        with cudnn_deterministic(torch):
            for name, trainer in trainers.items():
                apply_train_state(state, start)
                state.gen = torch.Generator(device="cuda").manual_seed(0)
                iter_ms[name] = []
                for step in (0, 1):
                    fc.reset_launch_counts()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    stats = host(trainer.train_iteration(state, reals[step], step, z=zs[step]))
                    torch.cuda.synchronize()
                    iter_ms[name].append((time.perf_counter() - t) * 1e3)
                    launches = dict(fc.launch_counts)
                    assert all(math.isfinite(v) for v in stats.values()), (name, stats)
                    assert launches == loop_launches(step), (name, step, launches)
                trees[name] = train_state_tree(state)
                print(f"  {name} (deterministic cuDNN): steps 0 (reg) and 1: "
                      f"{_fmt_list(iter_ms[name])} ms; launches as phase train's", flush=True)
        n_leaves = assert_same_tree(trees["mesh"], trees["plain"], "mesh vs plain")
        print(f"  mesh vs plain after two iterations: {n_leaves} leaves bit-equal", flush=True)
        del trees, start

        flats = {net: torch.randn(sum(p.numel() for p in getattr(state, net).parameters()),
                                  generator=gen, device="cuda") for net in ("G", "D")}
        n_params = {net: f.numel() for net, f in flats.items()}

        def all_reduces():
            all_mean_(flats["G"], mesh)
            all_mean_(flats["D"], mesh)
        ar_ms = cuda_ms(torch, all_reduces, reps=10, warmup=2)
        del flats
        main_ms = {"plain": [], "mesh": []}
        for step in (1, 2, 3, 5):
            for name in (("plain", "mesh") if step % 2 else ("mesh", "plain")):
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainers[name].train_iteration(state, reals[step % 2], step, z=zs[step % 2])
                torch.cuda.synchronize()
                main_ms[name].append((time.perf_counter() - t) * 1e3)
        share = ar_ms / min(main_ms["mesh"])
        print(f"  all-reduces of one main-stage iteration (G {n_params['G']} + D "
              f"{n_params['D']} float32 gradients) in a 1-rank group, a local copy: "
              f"{ar_ms:.3f} ms (CUDA events); main-only iterations, in turns: mesh "
              f"{_fmt_list(main_ms['mesh'])} ms, plain {_fmt_list(main_ms['plain'])} ms; the "
              f"copies {100 * share:.2f} % of the fastest mesh iteration; {card}", flush=True)

        G = state.G_ema
        z = torch.randn((2, g_cfg.k, g_cfg.z_dim), generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            target = G(z=z.cuda(), truncation_psi=0.7)
        mean, std = latent_stats(g_cfg, torch.Generator().manual_seed(1), 1000)
        pcfg = ProjectionConfig(steps=DIST_PROJECT_STEPS, chunk=DIST_PROJECT_STEPS)
        runs, proj_ms = {}, {}
        with cudnn_deterministic(torch):
            for name, m in (("mesh", [torch.device("cuda", 0)]), ("plain", None)):
                fc.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = project(G, target, build_loss_stack({"mse": 1.0}), pcfg, mean, std,
                            generator=torch.Generator().manual_seed(2), mesh=m)
                torch.cuda.synchronize()
                proj_ms[name] = (time.perf_counter() - t) * 1e3
                runs[name] = (r, dict(fc.launch_counts))
        (a, la), (b, lb) = runs["mesh"], runs["plain"]
        assert la == lb == _per_step(DIST_PROJECT_STEPS, 1), (la, lb)
        assert torch.equal(a.latent, b.latent) and torch.equal(a.loss_history, b.loss_history)
        assert torch.isfinite(a.loss_history).all()
        print(f"  projection of 2 rows, {DIST_PROJECT_STEPS} steps: mesh=[cuda:0] "
              f"{proj_ms['mesh']:.3f} ms, mesh=None {proj_ms['plain']:.3f} ms; latents and "
              f"losses equal; launches {la}", flush=True)
    finally:
        dist.destroy_process_group()
    return dict(rendezvous_s=rendezvous_s, iteration_ms=iter_ms, all_reduce_ms=ar_ms,
                main_iteration_ms=main_ms, all_reduce_share=share, params=n_params,
                leaves_equal=n_leaves, projection_ms=proj_ms, card=card)


TP_KEYS = {"K1": "modconv3x3", "K1-adjoint": "modconv3x3_adj", "K2": "upconv2",
           "K3-adjoint": "upconv2_adj", **TRAIN_KEYS}


def tp_calls():
    """Every fused call shape of FFHQ-1024 and a 1024^2 D in a training
    iteration at batch 4 whose output channels a model axis slices: (role,
    block, layer, base resolution, Cin, Cout, kh), as `train_calls`. G's
    forward and adjoint at `kernel_calls`' 10 shapes, D's conv0 (K1 with no
    styles) forward and adjoint, and the training roles."""
    calls = []
    for kernel, block, layer, h, cin, cout in kernel_calls():
        roles = ("K1", "K1-adjoint") if kernel == "K1" else ("K2", "K3-adjoint")
        calls += [(r, f"G {block}", layer, h, cin, cout, 1 if layer == "skip" else 3)
                  for r in roles]
    for res, c in ((1024, 32), (512, 64)):
        calls += [(r, f"D b{res}", "conv0", res, c, c, 3) for r in ("K1", "K1-adjoint")]
    return calls + train_calls()


def tp_case(torch, fc, gen, call, dt):
    """One role at one call shape, batch 4, on random activations of type
    `dt` (weights, styles, noise and bias float32): (key, run, combine).
    run(sl, plain=False, wide=False) gives the role's outputs for the output
    channels `sl` (slice(None): the full width) on their slice of the
    weight, bias, resid, y and cotangent and the whole of x, styles and
    noise, launched or on the plain version, on the activations widened to
    float32 with `wide`. `combine` says for each output how the slices make
    the full width: "cat" (per output channel) or "sum" (a partial sum
    over the output channels: dx, ds)."""
    from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

    role, block, layer, h, cin, cout, kh = call
    dev, n = torch.device("cuda"), TRAIN_BATCH
    f = setup_filter([1, 3, 3, 1]).cuda()

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def act(t):
        return None if t is None else t.to(dt)

    def cut(t, sl):
        return None if t is None else t[..., sl].contiguous()

    def widen(args, wide):
        return tuple(a.float() if wide and isinstance(a, torch.Tensor) and a.dtype == dt
                     else a for a in args)

    w = randn(kh, kh, cin, cout, scale=1 / math.sqrt(kh * kh * cin))
    on_g = block.startswith("G")
    s = (torch.rand((n, cin), generator=gen, device=dev) + 0.5) if on_g else None
    key = TP_KEYS[role] + ("" if dt == torch.float32 else "_bf16")
    if role in ("K1", "K1-adjoint"):
        last = layer == "conv_last"
        x = act(randn(n, h, h, cin))
        noise = randn(n, h, h, scale=0.1) if on_g and not last else None
        bias = None if last else randn(cout, scale=0.1)
        resid = act(randn(n, h, h, cout)) if layer == "conv1" else None
        gain, alpha = (1.0, 1.0) if last else ((1.0, 0.2) if on_g else (math.sqrt(2), 0.2))
        if role == "K1":
            def run(sl, plain=False, wide=False):
                args = widen((x, cut(w, sl), s, noise, cut(bias, sl), cut(resid, sl)), wide)
                fn = fc.modconv3x3_plain if plain else fc.fused_modconv3x3
                return (fn(*args, gain, alpha, on_g),)
            return key, run, ("cat",)
        y = act(fc.modconv3x3_plain(x, w, s, noise, bias, resid, gain, alpha, on_g))
        g = act(randn(n, h, h, cout))

        def run(sl, plain=False, wide=False):
            args = widen((cut(g, sl), x, cut(w, sl), s, cut(y, sl), noise, cut(bias, sl),
                          cut(resid, sl)), wide)
            fn = fc.modconv3x3_adjoint_plain if plain else fc.modconv3x3_adjoint
            return fn(*args, gain, alpha, on_g)
        return key, run, ("sum", "sum", "cat", "cat")
    if role in ("K2", "K3-adjoint"):
        skip = layer == "skip"
        x = act(randn(n, h, h, cin))
        styles = None if skip else s
        noise = None if skip else randn(n, 2 * h, 2 * h, scale=0.1)
        bias = None if skip else randn(cout, scale=0.1)
        gain, alpha = (math.sqrt(0.5), 1.0) if skip else (math.sqrt(2), 0.2)
        if role == "K2":
            def run(sl, plain=False, wide=False):
                args = widen((x, cut(w, sl), styles, f, noise, cut(bias, sl)), wide)
                fn = fc.upconv2_plain if plain else fc.fused_upconv2
                return (fn(*args, gain, alpha, not skip, False),)
            return key, run, ("cat",)
        y = act(fc.upconv2_plain(x, w, styles, f, noise, bias, gain, alpha, not skip, False))
        g = act(randn(n, 2 * h, 2 * h, cout))

        def run(sl, plain=False, wide=False):
            args = widen((cut(g, sl), x, cut(w, sl), styles, f, cut(y, sl), noise,
                          cut(bias, sl)), wide)
            fn = fc.upconv2_adjoint_plain if plain else fc.upconv2_adjoint
            return fn(*args, gain, alpha, not skip, False)
        return key, run, ("sum", "sum", "cat", "cat")
    if role in ("K3-forward", "K2-use_dw", "K2-use_dw-dw"):
        conv1 = layer == "conv1"
        x = act(randn(n, 2 * h, 2 * h, cin))
        gz = act(randn(n, h, h, cout))
        if role == "K3-forward":
            b = randn(cout, scale=0.1) if conv1 else None
            r = act(randn(n, h, h, cout)) if conv1 else None
            gain, alpha = (1.0, 0.2) if conv1 else (math.sqrt(0.5), 1.0)

            def run(sl, plain=False, wide=False):
                args = widen((x, cut(w, sl), f, cut(b, sl), cut(r, sl)), wide)
                fn = fc.downconv2_plain if plain else fc.fused_downconv2
                return (fn(*args, gain, alpha),)
            return key, run, ("cat",)
        if role == "K2-use_dw":
            def run(sl, plain=False, wide=False):
                args = widen((cut(gz, sl), cut(w, sl), f), wide)
                return ((fc.downconv2_adjoint_plain if plain else fc.downconv2_adjoint)(*args),)
            return key, run, ("sum",)

        def run(sl, plain=False, wide=False):
            args = widen((x, cut(gz, sl), cut(w, sl), f), wide)
            return ((fc.downconv2_dw_plain if plain else fc.downconv2_dw)(*args),)
        return key, run, ("cat",)
    x = act(randn(n, h, h, cin))
    if role == "K1-dw":
        gd = act(randn(n, h, h, cout))

        def run(sl, plain=False, wide=False):
            args = widen((x, cut(gd, sl), s), wide)
            if plain:
                return (fc.conv_dw_plain(*args, 1, 1, 3, (0, 0))[0],)
            return (fc.conv_dw(*args),)
        return key, run, ("cat",)
    gd = act(randn(n, 2 * h, 2 * h, cout))

    def run(sl, plain=False, wide=False):
        args = widen((x, cut(gd, sl), s, cut(w, sl), f), wide)
        return ((fc.upconv2_dw_plain if plain else fc.upconv2_dw)(*args),)
    return key, run, ("cat",)


def _tp_f32_err(role, got, want):
    """A float32 output's error by the rule its role is held to in phases
    kernels and train, as a fraction of its bound: max abs 1e-4 for K1 and
    K2's forward, 1e-3 for K3-forward; otherwise 1e-4 of the reference's
    largest entry (the adjoints' dx, ds and dd; K2's use_dw; the dw roles)."""
    err = (got.float() - want.float()).abs().max().item()
    if role in ("K1", "K2"):
        return err / 1e-4
    if role == "K3-forward":
        return err / 1e-3
    return err / max(1e-4 * want.abs().max().item(), 1e-30)


def _join(torch, parts, combine):
    """The full width from the slices' outputs, by `combine`: concatenated
    along the last axis, or summed in float32."""
    out = []
    for i, how in enumerate(combine):
        ts = [p[i] for p in parts]
        if ts[0] is None:
            out.append(None)
        elif how == "cat":
            out.append(torch.cat(ts, dim=-1))
        else:
            out.append(sum(t.float() for t in ts))
    return tuple(out)


def check_tp_slices(torch, fc, gen, call, dt, halves=2):
    """One role at one call shape (`tp_case`) launched at each of `halves`
    slices of its output channels and at the full width: each slice held
    to its plain version by the rule of its role (float32: `_tp_f32_err`;
    bfloat16: phase bf16's, the kernel's error from the float32 plain
    version at most BF16_RATIO times the plain bfloat16 version's, or
    BF16_FLOOR of the largest entry); the slices' outputs, concatenated
    (per output channel) or summed (dx, ds: partial sums), held to the
    full-width launch by the same rule (bfloat16: their distance from it,
    against the full width's float32 reference, within the full width's
    bound). Returns (key, the worst error over its bound)."""
    role, block, layer, h, cin, cout, kh = call
    key, run, combine = tp_case(torch, fc, gen, call, dt)
    c = cout // halves
    slices = [slice(i * c, (i + 1) * c) for i in range(halves)]
    full = run(slice(None))
    parts = [run(sl) for sl in slices]
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.float()).all().item() for p in parts for t in p if t is not None)
    worst = 0.0
    if dt == torch.float32:
        for sl, got in zip(slices, parts):
            want = run(sl, plain=True)
            worst = max([worst] + [_tp_f32_err(role, g, w) for g, w in zip(got, want)
                                   if w is not None])
        joined = _join(torch, parts, combine)
        worst = max([worst] + [_tp_f32_err(role if how == "cat" else "sum", j, fl)
                               for j, fl, how in zip(joined, full, combine) if fl is not None])
    else:
        for sl, got in zip(slices, parts):
            ek, ep, _ = _bf16_errs(got, run(sl, plain=True), run(sl, plain=True, wide=True))
            worst = max(worst, ek / max(BF16_RATIO * ep, BF16_FLOOR))
        ref = run(slice(None), plain=True, wide=True)
        _, ep, _ = _bf16_errs(full, run(slice(None), plain=True), ref)
        joined = _join(torch, parts, combine)
        for j, fl, r in zip(joined, full, ref):
            if r is None:
                continue
            gap = (j.float() - fl.float()).abs().max().item() / max(r.abs().max().item(), 1e-30)
            worst = max(worst, gap / max(BF16_RATIO * ep, BF16_FLOOR))
    print(f"  tp {role} {'bf16 ' if dt != torch.float32 else ''}{block} {layer}: {halves} "
          f"slices of {c} of {cout} output channels, worst error over its bound {worst:.3e}",
          flush=True)
    assert worst <= 1.0, f"tp {role} {dt} {block} {layer}: {worst}"
    return key, worst


def tp_phase(torch, fc, card):
    """Phase tp: tensor parallelism on this card. A world-1 NCCL group
    through `make_mesh(model_parallel=1)` (the data mesh): one 1024^2
    iteration at step 0 (all four stages) at batch 4 on phase train's
    resnet pair by the plain trainer and by the trainer over that mesh,
    from one state on one set of z and reals, every leaf bit-equal (cuDNN
    deterministic). Then every fused call shape of FFHQ-1024 and a 1024^2
    D in an iteration at batch 4 (`tp_calls`: K1 forward and adjoint, K2
    forward, K3 adjoint, K3-forward, K2's use_dw, the three dw roles) at
    both halves of its output channels, as a 2-way model axis runs them, in
    float32 and bfloat16 (`check_tp_slices`), with exactly three launches
    of its role a case (the full width and two halves). Returns (stats,
    the launches by key)."""
    import torch.distributed as dist

    from morphganformer_tpu_torch.models.config import DiscriminatorConfig, ffhq1024_config
    from morphganformer_tpu_torch.parallel import free_port, initialize_distributed
    from morphganformer_tpu_torch.parallel.tp import make_mesh
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    from morphganformer_tpu_torch.training.loop import apply_train_state, train_state_tree

    t0 = time.perf_counter()
    initialize_distributed(f"localhost:{free_port()}", 1, 0, device="cuda", timeout_s=120)
    try:
        mesh = make_mesh(model_parallel=1)
        assert type(mesh).__name__ == "DataMesh" and mesh.world == 1, mesh
        g_cfg, d_cfg = ffhq1024_config(), DiscriminatorConfig()
        cfg = TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4)
        trainers = {"plain": GANTrainer(g_cfg, d_cfg, cfg),
                    "mesh": GANTrainer(g_cfg, d_cfg, cfg, mesh=mesh)}
        state = trainers["plain"].init_state(seed=0)
        start = train_state_tree(state)
        gen = torch.Generator(device="cuda").manual_seed(31)
        res = d_cfg.img_resolution
        real = torch.rand((TRAIN_BATCH, res, res, 3), generator=gen, device="cuda") * 2 - 1
        z = torch.randn((TRAIN_BATCH, g_cfg.k, g_cfg.z_dim), generator=gen, device="cuda")
        trees, iter_ms = {}, {}
        with cudnn_deterministic(torch):
            for name, trainer in trainers.items():
                apply_train_state(state, start)
                state.gen = torch.Generator(device="cuda").manual_seed(0)
                fc.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                stats = host(trainer.train_iteration(state, real, 0, z=z))
                torch.cuda.synchronize()
                iter_ms[name] = (time.perf_counter() - t) * 1e3
                assert all(math.isfinite(v) for v in stats.values()), (name, stats)
                assert dict(fc.launch_counts) == loop_launches(0), (name, fc.launch_counts)
                trees[name] = train_state_tree(state)
        n_leaves = assert_same_tree(trees["mesh"], trees["plain"], "make_mesh(1) vs plain")
        del trees, start, state, trainers
    finally:
        dist.destroy_process_group()
    trainer_s = time.perf_counter() - t0
    print(f"  make_mesh(model_parallel=1) trainer vs plain, step 0 (all four stages): "
          f"{n_leaves} leaves bit-equal; {iter_ms['mesh']:.3f} / {iter_ms['plain']:.3f} ms; "
          f"{trainer_s:.3f} s", flush=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(32)
    fc.reset_launch_counts()
    worst, want = {}, {k: 0 for k in fc.launch_counts}
    for dt in (torch.float32, torch.bfloat16):
        for call in tp_calls():
            key, w = check_tp_slices(torch, fc, gen, call, dt)
            worst[key] = max(worst.get(key, 0.0), w)
            want[key] += 3
    launches = dict(fc.launch_counts)
    assert launches == want, (launches, want)
    slices_s = time.perf_counter() - t0
    print(f"  tp slices: {len(tp_calls())} call shapes x 2 types, each at 2 halves and the full "
          f"width: worst error over its bound by role {json.dumps(worst)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; {slices_s:.3f} s; {card}", flush=True)
    return dict(leaves_equal=n_leaves, iteration_ms=iter_ms, trainer_s=trainer_s,
                slices_s=slices_s, worst=worst, card=card), launches


def extract_phase(torch, fc, cli, tmp, card):
    """Phase 10b: extract_features through the entry point with a random
    iresnet18 backbone on the card: --bona on phase morph's CSV faces (the
    G(z) PNGs of morph_csv_check) against --morph on its morph PNGs: JAX's
    JSON, accuracies in [0, 1], the counts; then --images on the faces to an
    npz of 512-d rows in file order, extract_dir's within 1e-5 of their
    largest entry; no fused-kernel launch (the iresnet is plain
    convolutions). Seconds of each."""
    import numpy as np

    from morphganformer_tpu_torch.losses.face_embedding import random_iresnet_params
    from morphganformer_tpu_torch.metrics import fingerprint

    faces = os.path.join(tmp, "csv_faces")
    morphs = os.path.join(tmp, "extract_morphs")
    os.makedirs(morphs)
    src = os.path.join(tmp, f"csv_{CSV_PAIRS}")
    for f in sorted(os.listdir(src)):
        if f.endswith("_morph.png"):
            shutil.copy(os.path.join(src, f), morphs)
    n_bona, n_morph = len(os.listdir(faces)), len(os.listdir(morphs))
    assert (n_bona, n_morph) == (2 * CSV_PAIRS, CSV_PAIRS), (n_bona, n_morph)
    fc.reset_launch_counts()
    out = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["extract_features", "--random-backbone", "--bona", faces, "--morph", morphs])
    svm_s = time.perf_counter() - t
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"  extract_features --bona ({n_bona}) --morph ({n_morph}): {svm_s:.3f} s; "
          f"{json.dumps(result)}", flush=True)
    assert set(result) == {"train_acc", "test_acc", "num_bona", "num_morph"}, result
    assert (result["num_bona"], result["num_morph"]) == (n_bona, n_morph), result
    assert 0.0 <= result["train_acc"] <= 1.0 and 0.0 <= result["test_acc"] <= 1.0, result
    npz = os.path.join(tmp, "features.npz")
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["extract_features", "--random-backbone", "--images", faces, "--out", npz])
    images_s = time.perf_counter() - t
    data = np.load(npz)
    files, feats = fingerprint.extract_dir(random_iresnet_params("iresnet18"), faces)
    assert list(data["files"]) == files == sorted(files)
    assert data["features"].shape == (n_bona, 512) and np.isfinite(data["features"]).all()
    err = float(np.abs(data["features"] - feats).max())
    assert err <= 1e-5 * float(np.abs(feats).max()), err
    assert all(v == 0 for v in fc.launch_counts.values()), dict(fc.launch_counts)
    print(f"  extract_features --images ({n_bona}) --out: {images_s:.3f} s; rows "
          f"{data['features'].shape} in file order; {card}", flush=True)
    return dict(svm=result, svm_s=svm_s, images_s=images_s, card=card)


# Phase options: the GANformer options at FFHQ-1024 widths (k, the mapping
# and the attention as each set says; the rest of ffhq1024_config).
OPTION_SETS = (
    ("gated", dict(k=17, mapping=dict(ltnt_gate=True),
                   attention=dict(ltnt_gate=True, img_gate=True, kmeans_iters=2,
                                  pos_type="trainable"))),
    # JAX's carry needs F = 2 (k - 1) at 4^2: k 9.
    ("iterative-conditional", dict(k=9, c_dim=8, mapping=dict(resnet=False),
                                   attention=dict(iterative=True, kmeans_iters=2,
                                                  pos_type="linear"))),
    ("stylegan2", dict(k=1, transformer=False)),
    ("shared", dict(k=2, mapping=dict(shared=True), attention=dict(pos_type="trainable2d"))),
)
OPTIONS_PROJECT_STEPS = 5


def option_config(kw):
    from morphganformer_tpu_torch.models.config import (AttentionConfig, MappingConfig,
                                                        ffhq1024_config)
    kw = dict(kw)
    return ffhq1024_config(mapping=MappingConfig(**kw.pop("mapping", {})),
                           attention=AttentionConfig(**kw.pop("attention", {})), **kw)


def option_launches(cfg, steps, forwards, bf16=False):
    """`_per_step` for a generator whose fused blocks `packed_structural_ok`
    picks: per block one K1 (conv1) and two K2 (conv0, skip), and one K1
    for the last block's conv_last."""
    from morphganformer_tpu_torch.models.synthesis import packed_structural_ok

    n = sum(packed_structural_ok(cfg, r, "const") for r in cfg.block_resolutions)
    k1 = n + packed_structural_ok(cfg, cfg.img_resolution, "const")
    return _per_step(steps, forwards, bf16, k1, 2 * n)


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _one_hot(torch, gen, rows, n):
    return torch.nn.functional.one_hot(torch.randint(0, n, (rows,), generator=gen),
                                       n).float().cuda()


def option_train(torch, fc, cfg, total):
    """The iterative-conditional pair (a 1024^2 D with the same c_dim) from
    seed 0: one G_main and one D_main round's gradients with labels,
    kernels against plain, by phase train's `main_round_checks` with the
    float64 rule; the path-length penalty at the same weights in float32
    (the default route) and in float64 (plain, unpacked), on the same z,
    labels and noise; then train_iteration at step 0 with labels (G_main,
    G_reg, D_main, D_reg): finite stats and phase reg's exact launches
    (`loop_launches`)."""
    import copy

    from morphganformer_tpu_torch.models.config import DiscriminatorConfig
    from morphganformer_tpu_torch.training import GANTrainer, TrainConfig
    from morphganformer_tpu_torch.training import loss as tloss

    d_cfg = DiscriminatorConfig(c_dim=cfg.c_dim, img_resolution=cfg.img_resolution)
    trainer = GANTrainer(cfg, d_cfg, TrainConfig(batch_size=TRAIN_BATCH, batch_gpu=4))
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(21)
    res = cfg.img_resolution
    reals = torch.rand((TRAIN_BATCH, res, res, 3), generator=gen, device="cuda") * 2 - 1
    c = _one_hot(torch, torch.Generator().manual_seed(22), TRAIN_BATCH, cfg.c_dim)
    z = torch.randn((1, TRAIN_BATCH, cfg.k, cfg.z_dim), generator=gen, device="cuda")
    fc.reset_launch_counts()
    errs, round_ms = main_round_checks(torch, fc, trainer, state, z, reals[None], gen, c[None],
                                       f64_rule=True)
    _add(total, fc.launch_counts)

    rows, _ = tloss.pl_rows(TRAIN_BATCH, trainer.cfg.loss.pl_batch_shrink, None)
    noise = torch.randn((rows, res, res, 3), generator=gen, device="cuda") / res
    G64 = copy.deepcopy(state.G).double()
    pl = {}
    for name, net, dt, route in (("float32", state.G, torch.float32, None),
                                 ("float64", G64, torch.float64, "0")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with packed_env(route):
            _, aux = tloss.g_pl_loss(net, z[0].to(dt), trainer.cfg.loss,
                                     torch.Generator(device="cuda").manual_seed(13),
                                     state.pl_mean.to(dt), c=c.to(dt), pl_noise=noise.to(dt))
        torch.cuda.synchronize()
        pl[name] = dict(penalty=float(aux["Loss/pl_penalty"]), pl_mean=float(aux["pl_mean"]),
                        ms=(time.perf_counter() - t0) * 1e3)
    del G64
    print(f"    path-length penalty at the seed-0 weights, the same z, labels and noise: float32 "
          f"{pl['float32']['penalty']:.6f} ({pl['float32']['ms']:.3f} ms), float64 (plain, "
          f"unpacked) {pl['float64']['penalty']:.9f} ({pl['float64']['ms']:.3f} ms)", flush=True)
    assert all(math.isfinite(v["penalty"]) and v["penalty"] > 0 for v in pl.values()), pl

    torch.cuda.synchronize()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    stats = host(trainer.train_iteration(state, reals, 0, c=c))
    torch.cuda.synchronize()
    it_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(fc.launch_counts)
    _add(total, launches)
    print(f"    train_iteration step 0 with labels (all four stages): {it_ms:.3f} ms; "
          f"{json.dumps(stats)}; launches {nonzero(launches)}", flush=True)
    assert {"Loss/G/reg", "Loss/D/reg"} <= set(stats), stats
    assert all(math.isfinite(v) for v in stats.values()), stats
    assert launches == loop_launches(0), (launches, loop_launches(0))
    return dict(main_grads=errs, round_ms=round_ms, path_length=pl, iteration_ms=it_ms,
                stats=stats)


def options_phase(torch, fc, cli, tmp):
    """Phase options: four sets of GANformer options at FFHQ-1024 widths
    (`OPTION_SETS`), each G from seed 0. Per set, generation at batch 2
    with const noise (exact K1 and K2 launches, kernels against plain
    within phase generate's 1e-3, ms); a 5-step projection at batch 1 onto
    G's own image (run_project; the conditional set, whose mapping needs
    labels, in W+ from its labelled ws through `project`), exact launches
    with the adjoints, the latent gradient kernels against plain within
    phase project's 1e-3; the gated set also in bfloat16 (the forward
    against float32, the kernels' mean and max error at most BF16_RATIO
    times the plain version's, exact bf16 launches); the
    iterative-conditional set a training iteration with labels
    (`option_train`). Returns (stats, launches over the phase)."""
    import numpy as np

    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.models import init_generator, set_compute_dtype
    from morphganformer_tpu_torch.projection import (ProjectionConfig, latent_stats,
                                                     loss_and_grad, project)
    from morphganformer_tpu_torch.utils.image import to_uint8, write_png

    out, total = {}, {}
    for name, kw in OPTION_SETS:
        t_set = time.perf_counter()
        cfg = option_config(kw)
        G = init_generator(cfg, seed=0, device="cuda")
        z = torch.randn((2, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(0)).cuda()
        c = _one_hot(torch, torch.Generator().manual_seed(1), 2, cfg.c_dim) if cfg.c_dim else None

        def forward(plain=False, zz=z, cc=c):
            with torch.no_grad():
                return G(zz, cc, truncation_psi=0.7, plain=plain)

        fc.reset_launch_counts()
        y_k = forward()
        torch.cuda.synchronize()
        launches = dict(fc.launch_counts)
        _add(total, launches)
        y_p = forward(plain=True)
        diff = (y_k - y_p).abs().max().item()
        res = cfg.img_resolution
        assert y_k.shape == (2, res, res, 3) and torch.isfinite(y_k).all().item()
        assert launches == option_launches(cfg, 0, 1), (name, launches)
        assert launches["modconv3x3"] > 0 and launches["upconv2"] > 0
        assert diff <= 1e-3, f"{name}: kernel vs plain forward differ by {diff}"
        ms = cuda_ms(torch, forward, reps=3, warmup=1)
        print(f"  {name}: k {cfg.k}, {sum(p.numel() for p in G.parameters())} parameters; "
              f"forward batch 2 launches {nonzero(launches)}; kernels vs plain max abs {diff:.3e}; "
              f"{ms:.3f} ms on the kernels", flush=True)
        row = dict(k=cfg.k, forward_err=diff, forward_ms=ms)

        png = os.path.join(tmp, f"{name}.png")
        write_png(png, to_uint8(y_k[0].cpu().numpy()))
        loss_fn = build_loss_stack({"mse": 1.0})
        target = cli._targets(G, [png])
        mean, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
        pcfg = ProjectionConfig(steps=OPTIONS_PROJECT_STEPS, chunk=OPTIONS_PROJECT_STEPS,
                                w_plus=cfg.c_dim > 0)
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        if cfg.c_dim:
            ws0 = G.run_mapping(z[:1], c[:1], truncation_psi=0.7).detach()
            res = project(G, target, loss_fn, pcfg, mean, std,
                          generator=torch.Generator().manual_seed(0), init_latent=ws0)
            latent_n = ws0 + std * pcfg.noise * torch.randn(
                ws0.shape, generator=torch.Generator().manual_seed(1)).cuda()
        else:
            res = cli.run_project(G, png, os.path.join(tmp, f"proj_{name}"),
                                  steps=OPTIONS_PROJECT_STEPS, n_mean_latent=10000,
                                  chunk=OPTIONS_PROJECT_STEPS, seed=0)
            latent_n = (mean[None] + std * pcfg.noise * torch.randn(
                (1, cfg.k, cfg.z_dim), generator=torch.Generator().manual_seed(1))).cuda()
        torch.cuda.synchronize()
        proj_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(fc.launch_counts)
        _add(total, launches)
        history = res.loss_history.numpy()
        assert np.isfinite(history).all() and history.shape == (OPTIONS_PROJECT_STEPS,)
        assert launches == option_launches(cfg, OPTIONS_PROJECT_STEPS, 1), (name, launches)
        grads = {}
        for plain in (False, True):
            fc.reset_launch_counts()
            grads[plain] = loss_and_grad(G, latent_n, target, loss_fn, pcfg, plain)[2]
            _add(total, fc.launch_counts)
        grad_err = _rel_err(grads[False], grads[True])
        print(f"    projection{' in W+' if cfg.c_dim else ''}: {OPTIONS_PROJECT_STEPS} steps in "
              f"{proj_ms:.3f} ms (set-up and the best image's forward included), loss "
              f"{history[0]:.5f} -> best {res.best_loss:.5f}; launches {nonzero(launches)}; latent "
              f"gradient kernels vs plain rel err {grad_err:.3e}", flush=True)
        assert torch.isfinite(grads[False]).all().item()
        assert grad_err <= 1e-3, f"{name}: latent gradient kernels vs plain: {grad_err}"
        row.update(project_ms=proj_ms, grad_rel_err=grad_err)

        if name == "gated":
            set_compute_dtype(G, "bfloat16")
            fc.reset_launch_counts()
            yb_k = forward()
            launches = dict(fc.launch_counts)
            _add(total, launches)
            yb_p = forward(plain=True)
            set_compute_dtype(G, "float32")
            gaps = {k: ((y - y_k).abs().mean().item(), (y - y_k).abs().max().item())
                    for k, y in (("kernels", yb_k), ("plain", yb_p))}
            print(f"    bfloat16 forward vs float32 (mean, max abs): kernels {gaps['kernels']}, "
                  f"plain {gaps['plain']}; launches {nonzero(launches)}", flush=True)
            assert launches == option_launches(cfg, 0, 1, bf16=True), launches
            for i, what in enumerate(("mean", "max")):
                assert gaps["kernels"][i] <= BF16_RATIO * gaps["plain"][i], (what, gaps)
            row["bf16_vs_f32"] = gaps
        del G
        if cfg.c_dim:
            row["train"] = option_train(torch, fc, cfg, total)
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_set
        print(f"    {name}: {row['seconds']:.3f} s", flush=True)
        out[name] = row
    return out, total


FORMATS_DIR = os.path.join(REPO, "tests", "data", "formats")
FORMATS_STEPS = 20        # the face JPEG's bfloat16 projection at FFHQ-1024 widths


def array_digest(arr):
    """The fixture script's digest of an array (a bool array as 0 and 1)."""
    import hashlib

    import numpy as np

    arr = np.ascontiguousarray(arr != 0 if arr.dtype == bool else arr)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}


def check_format_fixtures(folder=FORMATS_DIR):
    """Decode every committed fixture with the port's decoders (no Pillow):
    its mode and the SHA-256 of its array and of its RGB conversion equal
    Pillow's, recorded in formats.json. Returns {name: decode seconds}."""
    from morphganformer_tpu_torch.utils import image

    with open(os.path.join(folder, "formats.json")) as f:
        table = json.load(f)
    names = sorted(n for n in os.listdir(folder) if n != "formats.json")
    assert names == sorted(table), (names, sorted(table))
    seconds = {}
    for name in names:
        t0 = time.perf_counter()
        got = image.open_image(os.path.join(folder, name))
        seconds[name] = time.perf_counter() - t0
        assert got.mode == table[name]["mode"], (name, got.mode)
        assert array_digest(got.array) == table[name]["image"], name
        assert array_digest(image.to_rgb(got)) == table[name]["rgb"], name
    return seconds


def _best_of(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, min(times), sum(times) / reps


def formats_phase(torch, fc, cli, G, tmp, card):
    """Photo formats without Pillow: every committed fixture decoded and
    held to Pillow's recorded SHA-256; the decode time of the face JPEG
    (800 x 640, quality 90) and of a 1024^2 JPEG (4:2:0, quality 90, made
    here by the fixture script's encoder); load_target of the face JPEG
    equal to load_target of its pixels written as a PNG; then the JPEG
    projected at FFHQ-1024 widths in bfloat16 for FORMATS_STEPS steps
    through run_project (exact tensor-core launches per step, the loss
    descending), and at one noised latent the gradient on the kernels
    against the plain path: float32 within 1e-3 of its largest entry (phase
    project's rule), bfloat16 against float32 by phase bf16's rule."""
    import numpy as np

    from morphganformer_tpu_torch.losses import build_loss_stack
    from morphganformer_tpu_torch.projection import ProjectionConfig, latent_stats, loss_and_grad
    from morphganformer_tpu_torch.utils.image import load_target, read_image, read_image_rgb
    from morphganformer_tpu_torch.utils.image import write_png

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import make_format_fixtures as mff

    out = {"card": card, "pillow_importable": _importable("PIL")}
    seconds = check_format_fixtures()
    assert "PIL" not in sys.modules, "a decoder imported Pillow"
    out["fixtures"] = len(seconds)
    out["fixture_decode_s"] = sum(seconds.values())
    print(f"  {len(seconds)} fixtures decoded without Pillow (importable here: "
          f"{out['pillow_importable']}), each equal to Pillow's SHA-256, in "
          f"{out['fixture_decode_s']:.3f} s", flush=True)
    face = os.path.join(FORMATS_DIR, "face.jpg")
    img, best, mean = _best_of(lambda: read_image(face))
    assert img.shape == (800, 640, 3)
    out["face_jpeg_decode_s"] = dict(best=best, mean=mean, bytes=os.path.getsize(face))
    t0 = time.perf_counter()
    big = mff.encode_jpeg(mff.photo(5, 1024, 1024), quality=90)
    encode_s = time.perf_counter() - t0
    big_path = os.path.join(tmp, "photo_1024.jpg")
    with open(big_path, "wb") as f:
        f.write(big)
    big_img, best_b, mean_b = _best_of(lambda: read_image(big_path))
    psnr = 10 * math.log10(255 ** 2 / float(np.mean((big_img.astype(np.float64)
                                                     - mff.photo(5, 1024, 1024)) ** 2)))
    assert big_img.shape == (1024, 1024, 3) and psnr > 25, psnr
    out["jpeg_1024_decode_s"] = dict(best=best_b, mean=mean_b, bytes=len(big), psnr_db=psnr,
                                     encode_s=encode_s)
    print(f"  decode on the host: face.jpg (800 x 640, {os.path.getsize(face)} bytes) best "
          f"{best:.4f} s, mean {mean:.4f} s of 3; a 1024^2 4:2:0 JPEG ({len(big)} bytes, "
          f"{psnr:.2f} dB against its source) best {best_b:.4f} s, mean {mean_b:.4f} s; "
          f"{card}", flush=True)

    png = os.path.join(tmp, "face_from_jpeg.png")
    write_png(png, read_image_rgb(face))
    target_np = load_target(face, 1024)
    assert np.array_equal(target_np, load_target(png, 1024)), "load_target JPEG != PNG"
    assert target_np.shape == (1, 1024, 1024, 3)

    with compute_dtype(G, "bfloat16"):
        stamps = []
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        res = cli.run_project(G, face, os.path.join(tmp, "proj_jpeg"), steps=FORMATS_STEPS,
                              n_mean_latent=10000, chunk=5, seed=0,
                              progress=_timed_progress(stamps))
        proj_s = time.perf_counter() - t0
        launches = dict(fc.launch_counts)
    history = res.loss_history.numpy()
    rate = _steady_rate(stamps)
    print(f"  run_project bfloat16 on face.jpg: {FORMATS_STEPS} steps in {proj_s:.3f} s; steady "
          f"{rate:.3f} steps/s; loss {history[0]:.5f} -> best {res.best_loss:.5f}; launches "
          f"{launches}", flush=True)
    assert launches == _per_step(FORMATS_STEPS, 1, bf16=True), launches
    assert np.isfinite(history).all() and res.best_loss < history[0]
    assert torch.isfinite(res.best_img).all().item()
    assert len(os.listdir(os.path.join(tmp, "proj_jpeg"))) == 2

    cfg = G.cfg
    pcfg = ProjectionConfig(steps=FORMATS_STEPS)
    mean_l, std = latent_stats(cfg, torch.Generator().manual_seed(0), 10000)
    latent_n = (mean_l[None] + torch.randn((1, cfg.k, cfg.z_dim),
                                           generator=torch.Generator().manual_seed(1))
                * std * pcfg.noise).cuda()
    target = torch.from_numpy(target_np).cuda()
    loss_fn = build_loss_stack({"mse": 1.0})
    grads = {}
    for dt in ("float32", "bfloat16"):
        with compute_dtype(G, dt):
            for plain in (False, True):
                grads[dt, plain] = loss_and_grad(G, latent_n, target, loss_fn, pcfg, plain)[2]
    f32_err = _rel_err(grads["float32", False], grads["float32", True])
    ref = grads["float32", True]
    gk, gp = (_rel_err(grads["bfloat16", p], ref) for p in (False, True))
    print(f"  latent gradient on face.jpg's target: float32 kernels vs plain {f32_err:.3e} (of "
          f"|grad| max {ref.abs().max().item():.4e}); bfloat16 against float32: kernels {gk:.3e}, "
          f"plain {gp:.3e}", flush=True)
    assert f32_err <= 1e-3, f32_err
    assert gk <= max(BF16_RATIO * gp, BF16_FLOOR), (gk, gp)
    out["project"] = dict(steps=FORMATS_STEPS, steps_per_s=rate, wall_s=proj_s,
                          first_loss=float(history[0]), best_loss=res.best_loss,
                          launches={k: v for k, v in launches.items() if v},
                          grad_f32_kernels_vs_plain=f32_err, grad_bf16_kernels_vs_f32=gk,
                          grad_bf16_plain_vs_f32=gp)
    return out, launches


def _importable(name):
    import importlib.util

    return importlib.util.find_spec(name) is not None


APL_MEMORY, APL_STEPS, APL_WRITE, APL_QUERIES, APL_K = 128, 16, 16, 8, 8


def apl_episode(torch, device, enc, dec, images, labels, queries):
    """One APL episode on `device`: every step embeds a batch, writes it
    with its labels and reads the queries' APL_K nearest entries; then the
    decoder's logits for the last step's queries. Returns (labels [steps,
    Q, K], distances [steps, Q, K], logits [Q, classes])."""
    from morphganformer_tpu_torch import apl

    state = apl.init_memory(APL_MEMORY, 64, dec.logits.bias.shape[0], device=device)
    got_l, got_d = [], []
    with torch.no_grad():
        for s in range(APL_STEPS):
            state = apl.add_entries(state, enc(images[s].to(device)), labels[s].to(device))
            q = enc(queries[s].to(device))
            be, bl, bd = apl.nearest_entries(state, q, APL_K)
            got_l.append(bl)
            got_d.append(bd)
        logits = dec(be, bl, q, bd)
    return torch.stack(got_l).cpu(), torch.stack(got_d).cpu(), logits.cpu(), state


def apl_phase(torch, card):
    """APL on the card: the Encoder (32^2 gray images to 64 features, eval
    mode) and an RSAFFDecoder (2 layers, 4 heads) from seeded weights; one
    episode of APL_STEPS steps, each writing APL_WRITE entries to an
    APL_MEMORY-slot memory (it wraps around) and reading APL_K neighbours
    of APL_QUERIES queries, then the decoder's logits: the card against the
    same episode on the CPU, the distances and logits within 1e-5 of their
    largest entry, the labels equal wherever the distances are not tied
    within 1e-5."""
    import copy

    import numpy as np

    from morphganformer_tpu_torch import apl

    gen = torch.Generator().manual_seed(0)
    classes = 10
    enc = apl.Encoder((32, 32, 1), gen, device="cpu").eval()
    dec = apl.RSAFFDecoder(classes, 64, 16, APL_K, 16, 16, 4, 2, gen, device="cpu")
    images = torch.randn((APL_STEPS, APL_WRITE, 32, 32, 1), generator=gen)
    labels = torch.randint(0, classes, (APL_STEPS, APL_WRITE), generator=gen, dtype=torch.int32)
    queries = torch.randn((APL_STEPS, APL_QUERIES, 32, 32, 1), generator=gen)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)              # torch's CPU pool is far slower on these small ops
    try:
        t0 = time.perf_counter()
        cpu = apl_episode(torch, "cpu", enc, dec, images, labels, queries)
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    enc_c, dec_c = copy.deepcopy(enc).to("cuda"), copy.deepcopy(dec).to("cuda")
    apl_episode(torch, "cuda", enc_c, dec_c, images, labels, queries)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_out = apl_episode(torch, "cuda", enc_c, dec_c, images, labels, queries)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert card_out[3].embeds.device.type == "cuda"
    assert int(apl.num_entries(card_out[3])) == APL_MEMORY
    d_err = _rel_err(card_out[1], cpu[1])
    l_err = _rel_err(card_out[2], cpu[2])
    dist = cpu[1].numpy()
    gaps = np.diff(dist, axis=-1)
    tied = np.zeros(dist.shape, bool)
    tied[..., 1:] |= gaps <= 1e-5 * np.abs(dist).max()
    tied[..., :-1] |= gaps <= 1e-5 * np.abs(dist).max()
    same = (card_out[0].numpy() == cpu[0].numpy()) | tied
    print(f"  APL episode ({APL_STEPS} steps, {APL_WRITE} writes and {APL_QUERIES} queries x "
          f"{APL_K} neighbours a step, {APL_MEMORY} slots): card {card_s * 1e3:.3f} ms, CPU "
          f"{cpu_s * 1e3:.3f} ms; distances {d_err:.3e}, logits {l_err:.3e} of their largest "
          f"entry; {int(tied.sum())} neighbour slots tied within 1e-5; {card}", flush=True)
    assert d_err <= 1e-5 and l_err <= 1e-5, (d_err, l_err)
    assert same.all(), "kNN labels differ where the distances are not tied"
    assert torch.isfinite(card_out[2]).all().item()
    return dict(card_ms=card_s * 1e3, cpu_ms=cpu_s * 1e3, dist_rel_err=d_err,
                logits_rel_err=l_err, tied_slots=int(tied.sum()), card=card)


DEMO_ARGS = ("--images", "32", "--res", "64", "--ticks", "1", "--metrics")
DEMO_ITERATIONS = 125     # one tick of 2 kimg at batch 16
DEMO_G_NODES = (2, 1, 1)  # b64's K1 (conv1, conv_last), styled K2 (conv0), unstyled K2 (skip)


def demo_forward():
    """Launches of one forward of the demo's G (a 64^2 GANformer with
    attention in b4-b32, `--end-res 6`): only b64 runs on the fused kernels
    (`packed_structural_ok` leaves out the blocks with attention)."""
    k1, k2s, k2u = DEMO_G_NODES
    return {**dict.fromkeys(per_iteration(), 0), "modconv3x3": k1, "upconv2": k2s + k2u}


def demo_launches(step):
    """Exact launches of one demo iteration (batch 16 in one round), derived
    from the fused nodes of `demo_forward`. G_main: G's forward, then its
    backward with dw (an adjoint and a dw launch a node); D_main: G's
    forward without a graph. D (64^2) has no block of 512^2 or above, so it
    runs unfused, and D_reg launches nothing. G_reg, every 4 steps: phase
    reg's rule (`reg_launches`) over G's nodes."""
    fwd = demo_forward()
    k1, k2s, k2u = DEMO_G_NODES
    counts = {k: 2 * v for k, v in fwd.items()}
    counts.update(modconv3x3_adj=k1, upconv2_adj=k2s + k2u, modconv3x3_dw=k1,
                  upconv2_dw=k2s + k2u)
    if step % 4 == 0:
        reg = reg_launches("g_reg", g_nodes=DEMO_G_NODES)
        counts = {k: v + reg[k] for k, v in counts.items()}
    return counts


def demo_phase(torch, fc, tmp, card):
    """The synthetic-faces training demo at a reduced size, through its
    entry point (`cli train` in this process): 32 faces at 64^2 (JAX's
    default 512), one tick of 2 kimg (JAX's 3 ticks), no metric (JAX's
    fid2k_full). Checks: each iteration's launches exact (`demo_launches`),
    125 of them; the run's other launches exactly five forwards of G (the
    module summary's and the 16-image grid's four of batch 4); a snapshot,
    the fakes grid PNG and finite losses in stats.jsonl. Then, on the
    trained G and D at the demo's shapes, one G_main and one D_main round's
    gradients on the kernels against plain, by phase train's rule
    (`main_round_checks`), on 16 of the demo's faces."""
    import numpy as np

    from morphganformer_tpu_torch.tools import train_demo_synfaces as demo
    from morphganformer_tpu_torch.training import GANTrainer
    from morphganformer_tpu_torch.utils.image import read_image

    out = os.path.join(tmp, "demo")
    print("  cuts: --images 32 (JAX 512), --ticks 1 (JAX 3), --metrics none (JAX fid2k_full); "
          "--res 64 and 2 kimg a tick as JAX", flush=True)
    real_iteration = GANTrainer.train_iteration
    calls, held = [], {}

    def recording(self, state, real_img, step, z=None):
        before = dict(fc.launch_counts)
        result = real_iteration(self, state, real_img, step, z)
        calls.append((step, {k: fc.launch_counts[k] - before[k] for k in before}))
        held.update(trainer=self, state=state)
        return result

    fc.reset_launch_counts()
    GANTrainer.train_iteration = recording
    try:
        t0 = time.perf_counter()
        rc = demo.main(["--out", out, *DEMO_ARGS, "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        GANTrainer.train_iteration = real_iteration
    launches = {k: v for k, v in fc.launch_counts.items() if v}
    run = os.path.join(out, "results", "exp-000")
    snaps = [d for d in os.listdir(run) if d.startswith("network-snapshot-")]
    grids = [f for f in os.listdir(run) if f.startswith("fakes") and f.endswith(".png")]
    with open(os.path.join(run, "stats.jsonl")) as f:
        stats = [json.loads(line) for line in f]
    losses = {k: v["mean"] for st in stats for k, v in st.items() if k.startswith("Loss/")}
    print(f"  demo: rc {rc}, {wall:.3f} s (the dataset included); snapshots {snaps}; grids "
          f"{grids}; losses {losses}; launches {launches}; {card}", flush=True)
    assert rc == 0 and len(snaps) == 1 and grids
    assert read_image(os.path.join(run, grids[0])).ndim == 3
    assert {"Loss/G/loss", "Loss/D/loss"} <= set(losses)
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert stats[-1]["kimg"] >= 2.0, stats[-1]["kimg"]

    assert [step for step, _ in calls] == list(range(DEMO_ITERATIONS)), [s for s, _ in calls]
    wrong = [(step, got) for step, got in calls if got != demo_launches(step)]
    assert not wrong, f"demo launches per iteration: {wrong[:3]}"
    want = {k: sum(demo_launches(step)[k] for step, _ in calls) + 5 * v
            for k, v in demo_forward().items()}
    assert dict(fc.launch_counts) == want, (dict(fc.launch_counts), want)
    print(f"  {len(calls)} iterations, each at its exact launches (G_reg at every 4th: "
          f"{demo_launches(0)}; else {demo_launches(1)}), and five forwards of G outside "
          "them", flush=True)

    trainer, state = held["trainer"], held["state"]
    faces = sorted(os.listdir(os.path.join(out, "dataset", "64")))[:16]
    real = np.stack([read_image(os.path.join(out, "dataset", "64", f)) for f in faces])
    real = torch.from_numpy(real).cuda().float().div(127.5).sub(1)[None]
    gen = torch.Generator(device="cuda").manual_seed(31)
    z = torch.randn((1, len(faces), trainer.g_cfg.k, trainer.g_cfg.z_dim), generator=gen,
                    device="cuda")
    errs, round_ms = main_round_checks(torch, fc, trainer, state, z, real, gen)
    return dict(wall_s=wall, kimg=stats[-1]["kimg"], losses=losses, launches=launches,
                iterations=len(calls), g_grads=errs["g"], d_grads=errs["d"],
                round_ms=round_ms, card=card)


def _fmt_list(xs):
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from morphganformer_tpu_torch import cli
    from morphganformer_tpu_torch.ops import _build
    from morphganformer_tpu_torch.ops import conv3x3 as k4
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
            if any(k in line for k in ("Compiling entry", "registers", "spill", "error")):
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
            cfg, G = cli.get_model("init:1024", device="cuda")
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

        with Phase("vis") as ph:
            vis_stats = vis_phase(torch, fc, cli, G, tmp, smi[0])
        phases["vis"] = ph.seconds

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
            nr_stats = noise_reg_check(torch, fc, cli, G, target_png, tmp)
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
            (res_m, imgs_pm, ws_pm), = cli.run_morph_pairs(
                G, [(png_a, png_b)], os.path.join(tmp, "pm"), steps=MORPH_STEPS, chunk=5,
                seed=0, progress=_timed_progress(stamps))
            img_pm, w_pm = imgs_pm[0], ws_pm[0]
            pair_s = time.perf_counter() - t0
            pair_launches = dict(fc.launch_counts)
            pair_peak = torch.cuda.max_memory_allocated()
            pair_rate = _steady_rate(stamps)
            print(f"  run_morph_pairs, one pair: {MORPH_STEPS} steps at batch 2 in {pair_s:.3f} "
                  f"s; steady "
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
            csv_rows, csv_stats = morph_csv_check(torch, fc, cli, G, tmp)
        phases["morph"] = ph.seconds

        with Phase("warp") as ph:
            warp_stats = warp_phase(torch, cli, os.path.join(tmp, "pm", "alice_bob_morph.png"),
                                    png_a, png_b, tmp, smi[0])
        phases["warp"] = ph.seconds
        morph_stats = dict(pair_steps_per_s=pair_rate, peak_gib=pair_peak / 2**30,
                           wall_s=pair_s, demorph_image_s=demorph_img_s)

        with Phase("bf16") as ph:
            bf16_rows, bf16_launches, bf16_stats = bf16_phase(torch, fc, cli, G, target_png,
                                                              png_a, png_b, tmp)
            bf16_stats["f32_project_steps_per_s"] = proj_stats["steps_per_s"]
            bf16_stats["f32_project_peak_gib"] = proj_stats["peak_gib"]
            print(f"  projection steps/s float32 {proj_stats['steps_per_s']:.3f}, bfloat16 "
                  f"{bf16_stats['project']['steps_per_s']:.3f}; peak GiB float32 "
                  f"{proj_stats['peak_gib']:.3f}, bfloat16 {bf16_stats['project']['peak_gib']:.3f}",
                  flush=True)
        phases["bf16"] = ph.seconds

        with Phase("losses") as ph:
            loss_stats = losses_phase(torch, fc, cli, G, tmp)
        phases["losses"] = ph.seconds

        with Phase("checkpoint") as ph:
            ckpt_stats = checkpoint_phase(torch, fc, cli, G, tmp)
        phases["checkpoint"] = ph.seconds

        with Phase("convert") as ph:
            convert_stats = convert_phase(torch, fc, cli, G, tmp, smi[0])
        phases["convert"] = ph.seconds

        with Phase("metrics") as ph:
            metrics_rows, metrics_stats = metrics_phase(torch, fc, cli, G, tmp)
        phases["metrics"] = ph.seconds

        with Phase("extract") as ph:
            extract_stats = extract_phase(torch, fc, cli, tmp, smi[0])
        phases["extract"] = ph.seconds

        with Phase("formats") as ph:
            formats_stats, formats_launches = formats_phase(torch, fc, cli, G, tmp, smi[0])
        phases["formats"] = ph.seconds

    with Phase("train") as ph:
        train_rows, train_launches, train_stats, train_bf16_rows, train_bf16_launches = \
            train_phase(torch, fc)
    phases["train"] = ph.seconds

    with Phase("dataset") as ph:
        dataset_stats = dataset_phase(torch, cli, G, smi[0])
    phases["dataset"] = ph.seconds

    with Phase("loop") as ph:
        loop_stats = loop_phase(torch, fc, cli, G, train_stats)
    phases["loop"] = ph.seconds

    with Phase("layouts") as ph:
        k4_rows, k4_launches, k4_bf16_launches, layout_stats = layouts_phase(torch, fc, k4)
    phases["layouts"] = ph.seconds

    with Phase("reg") as ph:
        reg_stats = reg_phase(torch, fc)
    phases["reg"] = ph.seconds

    with Phase("dist") as ph:
        dist_stats = dist_phase(torch, fc, cli, smi[0])
    phases["dist"] = ph.seconds

    with Phase("tp") as ph:
        tp_stats, tp_launches = tp_phase(torch, fc, smi[0])
    phases["tp"] = ph.seconds

    with Phase("options") as ph, tempfile.TemporaryDirectory(prefix="mgt_options_") as tmp:
        options_stats, options_launches = options_phase(torch, fc, cli, tmp)
    phases["options"] = ph.seconds

    with Phase("apl") as ph:
        apl_stats = apl_phase(torch, smi[0])
    phases["apl"] = ph.seconds

    with Phase("demo") as ph, tempfile.TemporaryDirectory(prefix="mgt_demo_") as tmp:
        demo_stats = demo_phase(torch, fc, tmp, smi[0])
    phases["demo"] = ph.seconds

    print("kernel_calls " + json.dumps(rows + train_rows + k4_rows), flush=True)
    print("kernel_calls_train_bf16 " + json.dumps(train_bf16_rows), flush=True)
    print("projection " + json.dumps(proj_stats), flush=True)
    print("noise_regularize " + json.dumps(nr_stats), flush=True)
    print("morph " + json.dumps(morph_stats), flush=True)
    print("morph_csv " + json.dumps(csv_stats), flush=True)
    print("metrics " + json.dumps(metrics_stats), flush=True)
    print("kernel_calls_batched " + json.dumps(metrics_rows + csv_rows), flush=True)
    print("bf16 " + json.dumps(bf16_stats), flush=True)
    print("losses " + json.dumps(loss_stats), flush=True)
    print("checkpoint " + json.dumps(ckpt_stats), flush=True)
    print("convert " + json.dumps(convert_stats), flush=True)
    print("train " + json.dumps(train_stats), flush=True)
    print("loop " + json.dumps(loop_stats), flush=True)
    print("dist " + json.dumps(dist_stats), flush=True)
    print("tp " + json.dumps(tp_stats), flush=True)
    print("extract " + json.dumps(extract_stats), flush=True)
    print("layouts " + json.dumps(layout_stats), flush=True)
    print("reg " + json.dumps(reg_stats), flush=True)
    print("vis " + json.dumps(vis_stats), flush=True)
    print("warp " + json.dumps(warp_stats), flush=True)
    print("dataset " + json.dumps(dataset_stats), flush=True)
    print("options " + json.dumps(options_stats), flush=True)
    print("formats " + json.dumps(formats_stats), flush=True)
    print("apl " + json.dumps(apl_stats), flush=True)
    print("demo " + json.dumps(demo_stats), flush=True)
    kernels = []
    for kernel, name, replaces, key in (
            ("K1", "fused_modconv3x3 (mgt_modconv3x3_fwd; least work: conv3x3_lw_kernel, a "
             "lane per output channel, the style folded into the weights)", K1_REPLACES,
             "modconv3x3"),
            ("K2", "fused_upconv2 (mgt_upconv2_fwd; least work: a stride-2 transposed conv, "
             "then the FIR in shared memory)", K2_REPLACES, "upconv2"),
            ("K1-adjoint", "mgt_modconv3x3_bwd (adjoint launch, pallas_conv.py:858-908; least "
             "work: conv3x3_lw_kernel, gd formed in the kernel, flip(w)^T read by index)",
             K1_REPLACES, "modconv3x3_adj"),
            ("K3-adjoint", "mgt_upconv2_bwd (adjoint of K2, pallas_conv.py:1786-1851; least "
             "work: the FIR in shared memory, then a stride-2 conv)",
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
            "tp_launches": tp_launches[key],
            "options_launches": options_launches.get(key, 0),
            "reg_launches": reg_stats["reg_launches"][key],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for kernel, name, replaces, key in (
            ("K1 bf16", "fused_modconv3x3 on bfloat16 x (mgt_modconv3x3_fwd_bf16: "
             "conv3x3_fwd_tc_kernel, an implicit GEMM of x * s against w on bf16 mma.sync "
             "with float32 accumulators, x * s rounded in shared memory by the thread that "
             "copied it, a tap a shifted row address into the staged tile, the weight "
             "fragments by ldmatrix.trans, the epilogue on the accumulators and y stored "
             "through stmatrix; persistent blocks)", K1_REPLACES, "modconv3x3"),
            ("K2 bf16", "fused_upconv2 on bfloat16 x (mgt_upconv2_fwd_bf16: upconv2_tc_kernel, "
             "each Z class an implicit GEMM on bf16 mma.sync with float32 accumulators, bf16 "
             "tiles staged by cp.async, x * s rounded in shared memory; the FIR and the "
             "epilogue in float32)", K2_REPLACES, "upconv2"),
            ("K1-adjoint bf16", "mgt_modconv3x3_bwd_bf16 (conv3x3_adj_tc_kernel: gd formed "
             "and rounded in bfloat16 from g, y, resid and d in the kernel, then an implicit "
             "GEMM against flip(w)^T on bf16 mma.sync with float32 accumulators, a tap a "
             "shifted row address into the staged gd tile, the dd taps as mma products; "
             "persistent blocks)", K1_REPLACES, "modconv3x3_adj"),
            ("K3-adjoint bf16", "mgt_upconv2_bwd_bf16 (downconv2_tc_kernel: gd formed and "
             "rounded in bfloat16 from g, y and d in the kernel, the FIR in float32, B split "
             "into bfloat16 hi and lo parity planes, each tap an implicit GEMM on bf16 "
             "mma.sync with float32 accumulators)", K3_REPLACES, "upconv2_adj")):
        mine = [r for r in bf16_rows if r["kernel"] == kernel]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{kernel} {name} (the call shapes of one 1024^2 forward, batch 1: "
                    + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + f"; launches over the {PROJECT_STEPS}-step bfloat16 projection; "
                      "max_abs_err: kernel vs plain bfloat16, of the float32 reference's "
                      "largest entry)",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": bf16_launches[BF16_KEYS[key]],
            "tp_launches": tp_launches[BF16_KEYS[key]],
            "options_launches": options_launches.get(BF16_KEYS[key], 0),
            "formats_launches": formats_launches[BF16_KEYS[key]],
            "reg_launches": 0,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "err_vs_f32": max(r["err_kernel"] for r in mine),
            "plain_err_vs_f32": max(r["err_plain"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "kernel_device_ms": sum(r["kernel_device_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for kernel, rows_b, run, path in (
            ("K1", metrics_rows, metrics_stats["fid2k_full_inception"], "calc_metrics"),
            ("K2", metrics_rows, metrics_stats["fid2k_full_inception"], "calc_metrics"),
            ("K1 bf16", csv_rows, csv_stats[f"pairs_per_batch_{CSV_PAIRS}"], "morph CSV"),
            ("K2 bf16", csv_rows, csv_stats[f"pairs_per_batch_{CSV_PAIRS}"], "morph CSV"),
            ("K1-adjoint bf16", csv_rows, csv_stats[f"pairs_per_batch_{CSV_PAIRS}"], "morph CSV"),
            ("K3-adjoint bf16", csv_rows, csv_stats[f"pairs_per_batch_{CSV_PAIRS}"],
             "morph CSV")):
        mine = [r for r in rows_b if r["kernel"] == kernel]
        key = {"K1": "modconv3x3", "K2": "upconv2", "K1 bf16": "modconv3x3_bf16",
               "K2 bf16": "upconv2_bf16", "K1-adjoint bf16": "modconv3x3_adj_bf16",
               "K3-adjoint bf16": "upconv2_adj_bf16"}[kernel]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{kernel} at batch {mine[0]['batch']} ({path}: the call shapes of one "
                    "1024^2 forward, " + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + f"; launches over the {path} run"
                    + ("" if path == "calc_metrics" else
                       f", --pairs-per-batch {CSV_PAIRS}, {CSV_STEPS} steps")
                    + (")" if "bf16" not in kernel else
                       "; max_abs_err: kernel vs plain bfloat16, of the float32 reference's "
                       "largest entry)"),
            "route": "cuda", "source": SOURCE,
            "replaces": K3_REPLACES if kernel.startswith("K3") else (
                K2_REPLACES if kernel.startswith("K2") else K1_REPLACES),
            "launches": run["launches"][key],
            "tp_launches": tp_launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for role, name, replaces, what in (
            ("K3-forward", "mgt_downconv2_fwd (D-tower forward, pallas_conv.py:2054-2072; "
             "least work, as K3-adjoint)",
             K3_REPLACES, "the D down-conv"),
            ("K2-use_dw", "mgt_upconv2_fwd in the use_dw role (dx of the D down-conv, "
             "pallas_conv.py:2121-2157; least work, as K2)", K2_REPLACES,
             "the D down-conv's dx"),
            ("K2-use_dw-dw", "mgt_fir_dw (the D down-conv's block cotangent, "
             "pallas_conv.py:1225-1246, :2161-2173; least work: fir_dw_kernel, the FIR once "
             "in shared memory, then the small weight's stride-2 taps, no fold)", K2_DW_REPLACES,
             "the D down-conv's dw"),
            ("K1-dw", "mgt_conv_dw (K1's dw taps, pallas_conv.py:256-285, :894-905; least "
             "work: conv_dw_lw_kernel, all nine taps in a block, x's columns sliding along "
             "each row)", K1_DW_REPLACES, "G conv1/conv_last and D conv0 dw"),
            ("K3-dw", "mgt_fir_dw (K3's dw taps in the adjoint role, pallas_conv.py:1387-1416; "
             "least work: fir_dw_kernel, as K2-use_dw-dw)", K3_DW_REPLACES, "G conv0/skip dw")):
        mine = [r for r in train_rows if r["kernel"] == role]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{role} {name}: {what} (the call shapes of one 1024^2 training iteration, "
                    f"batch {TRAIN_BATCH}: " + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + "; launches over train_iteration steps 1-3)",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": train_launches[TRAIN_KEYS[role]],
            "tp_launches": tp_launches[TRAIN_KEYS[role]],
            "options_launches": options_launches.get(TRAIN_KEYS[role], 0),
            "reg_launches": reg_stats["reg_launches"][TRAIN_KEYS[role]],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for role, name, replaces in (
            ("K3-forward", "mgt_downconv2_fwd_bf16 (D-tower forward in bfloat16 training, "
             "pallas_conv.py:2054-2072: downconv2_fwd_tc_kernel, downconv2_tc_kernel's "
             "pipeline with x staged as it lands, the FIR in float32 into bfloat16 hi and lo "
             "parity planes, each tap an implicit GEMM on bf16 mma.sync with float32 "
             "accumulators, the epilogue on the accumulators, y rounded once)", K3_REPLACES),
            ("K2-use_dw", "mgt_upconv2_fwd_bf16 in the use_dw role (dx of the D down-conv in "
             "bfloat16, pallas_conv.py:2121-2157: upconv2_tc_kernel with no styles, no d, no "
             "bias, gain = alpha = 1)", K2_REPLACES),
            ("K2-use_dw-dw", "mgt_fir_dw_bf16 (the D down-conv's dw in bfloat16, "
             "pallas_conv.py:1225-1246: fir_dw_tc_kernel, the FIR in float32 on the staged "
             "bfloat16 x into bfloat16 hi and lo parity planes, per tap a GEMM over the "
             "pixels on bf16 mma.sync with float32 accumulators, hi and lo each against gz, "
             "both operands by ldmatrix.trans, float32 partials)", K2_DW_REPLACES),
            ("K1-dw", "mgt_conv_dw_bf16 (K1's dw taps in bfloat16, pallas_conv.py:256-285: "
             "conv_dw_tc_kernel, x * s rounded to bfloat16 in shared memory, per tap a GEMM "
             "over the pixels on bf16 mma.sync with float32 accumulators, both operands by "
             "ldmatrix.trans from the pixel-major tiles, float32 partials)", K1_DW_REPLACES),
            ("K3-dw", "mgt_fir_dw_bf16 (K3's dw taps in bfloat16, pallas_conv.py:1387-1416: "
             "fir_dw_tc_kernel on bfloat16 gd and x, x * s rounded to bfloat16 in shared "
             "memory, as K2-use_dw-dw)", K3_DW_REPLACES)):
        mine = [r for r in train_bf16_rows if r["kernel"] == f"{role} bf16"]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{role} bf16 {name} (the call shapes of one 1024^2 training iteration, "
                    f"batch {TRAIN_BATCH}: " + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + "; launches over one bfloat16 train_iteration with G_reg and D_reg due; "
                      "max_abs_err: kernel vs plain bfloat16, of the float32 reference's "
                      "largest entry)",
            "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": train_bf16_launches[TRAIN_BF16_KEYS[role]],
            "tp_launches": tp_launches[TRAIN_BF16_KEYS[role]],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "err_vs_f32": max(r["err_kernel"] for r in mine),
            "plain_err_vs_f32": max(r["err_plain"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "kernel_device_ms": sum(r["kernel_device_ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for role, name in (("K4 fwd", "mgt_conv3x3_fwd (pallas_conv.py:74-111, :322-353; K1's "
                                  "least-work kernel conv3x3_lw_kernel)"),
                       ("K4 dx", "mgt_conv3x3_dx (the custom VJP, pallas_conv.py:356-370; "
                                 "K1's least-work adjoint, conv3x3_lw_kernel)")):
        mine = [r for r in k4_rows if r["kernel"] == role and r["batch"] == TRAIN_BATCH]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        kernels.append({
            "name": f"{role} {name}: the SAME 3x3 convs of the skip/orig layouts with "
                    f"MGT_PALLAS_CONV=1 (the call shapes of one 1024^2 training iteration, batch "
                    f"{TRAIN_BATCH}: " + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + "; launches over the skip layouts' train_iteration steps 1-3)",
            "route": "cuda", "source": SOURCE, "replaces": K4_REPLACES,
            "launches": k4_launches["conv3x3" if role == "K4 fwd" else "conv3x3_adj"],
            "tp_launches": tp_launches["conv3x3" if role == "K4 fwd" else "conv3x3_adj"],
            "reg_launches": reg_stats["reg_launches"]["conv3x3" if role == "K4 fwd"
                                                      else "conv3x3_adj"],
            "max_abs_err": max(r["max_abs_err"] for r in k4_rows if r["kernel"] == role),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": b_ms,
            "bound_by": "operations" if 2 * ops_ms >= b_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "same_function_ms": _same_sum(mine),
        })
    for role, name in (("K4 fwd bf16", "mgt_conv3x3_fwd_bf16 (pallas_conv.py:74-111, "
                                       ":322-353 in a bfloat16 program: conv3x3_fwd_tc_kernel "
                                       "with no styles, demodulation or epilogue)"),
                       ("K4 dx bf16", "mgt_conv3x3_dx_bf16 (the custom VJP, pallas_conv.py"
                                      ":356-370, in bfloat16: conv3x3_adj_tc_kernel with no "
                                      "mask, scale or taps)")):
        mine = [r for r in k4_rows if r["kernel"] == role]
        b_ms = sum(r["bound_ms"] for r in mine)
        ops_ms = sum(r["bound_ms"] for r in mine if r["bound_by"] == "operations")
        key = "conv3x3_bf16" if role == "K4 fwd bf16" else "conv3x3_adj_bf16"
        kernels.append({
            "name": f"{role} {name}: the SAME 3x3 convs of the skip/orig layouts in bfloat16 "
                    f"with MGT_PALLAS_CONV=1 (the call shapes of one 1024^2 training iteration, "
                    f"batch {TRAIN_BATCH}: " + ", ".join(f"{r['block']} {r['role']}" for r in mine)
                    + "; launches over one bfloat16 skip-layout train_iteration; max_abs_err: "
                      "kernel vs plain bfloat16, of the float32 reference's largest entry)",
            "route": "cuda", "source": SOURCE, "replaces": K4_REPLACES,
            "launches": k4_bf16_launches[key],
            "tp_launches": tp_launches[key],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "err_vs_f32": max(r["err_kernel"] for r in mine),
            "plain_err_vs_f32": max(r["err_plain"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "kernel_device_ms": sum(r["kernel_device_ms"] for r in mine),
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
