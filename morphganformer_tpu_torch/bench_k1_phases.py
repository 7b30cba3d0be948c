"""Where the time of K1's bfloat16 adjoint kernel (`conv3x3_adj_tc_kernel`)
or, with --fwd, of its bfloat16 forward kernel (`conv3x3_fwd_tc_kernel`)
goes, on a card where no profiler reads inside a kernel: source variants of
csrc/fused_conv.cu, each with one phase of the kernel removed or one design
choice reversed, built side by side with the same nvcc flags into
morphganformer_tpu_torch/_build/, and their bare launches
(`mgt_modconv3x3_bwd_bf16`, or `mgt_modconv3x3_fwd_bf16`) timed with CUDA
events at the four K1 call shapes of a 1024^2 projection step at batch 1,
on the inputs of bench_k1.py --bf16 (or --bf16-fwd).

    python -m morphganformer_tpu_torch.bench_k1_phases [--fwd]

Variants of the adjoint:
  kernel          the source as it is
  one_per_tile    one block per tile (the grid is the tile count): the
                  persistent blocks' alternative, the same dx (the
                  partials summed in another order)
  no_mma          the mma.sync gone (their operands kept live): the tensor
                  cores' share
  no_staging      no tile of g, y or resid copied (the weights still are):
                  the copies' share
  no_gd           gd not formed (the mma reads g as it landed, the dd taps
                  y)
  no_dd           the dd taps gone (their partials summed from whatever
                  the buffers hold)

Variants of the forward (--fwd):
  kernel          the source as it is
  one_per_tile    one block per tile, as above (the same y)
  no_mma          the mma.sync gone (their operands kept live)
  no_staging      no x tile copied (the weights still are)
  no_xs           x * s not formed (the mma reads x as it landed)
  no_epilogue     no epilogue: the accumulators neither finished nor
                  stored (y is left as it was)

The variants but the first two compute wrong outputs by construction;
one_per_tile's output is compared with the kernel's here (the kernels
themselves are checked by bench_k1.py --bf16 / --bf16-fwd and the CUDA
tests). A variant's time less the kernel's is its phase's share; the
phases overlap, so the shares do not add up to the whole. The variants run
in turns, the order reversed in the second round; each time is the mean of
the two. Prints one JSON line per shape, then the card and the sums.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from morphganformer_tpu_torch.bench_k1 import (K1_CALLS, bare_adjoint, bare_forward,
                                               bf16_adjoint_args, bf16_forward_args)
from morphganformer_tpu_torch.bench_k2_phases import build_variants
from morphganformer_tpu_torch.bench_k3 import cuda_ms

FN = "mgt_modconv3x3_bwd_bf16"
_GRID = "constexpr int kAtGrid = 264; "
_MMA = """            ldsm_x4(b, wa + 2 * at_swz(row, 8 * hb));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * np], af[i + ta], b[0], b[1]);
              mma_bf16(acc[i][2 * np + 1], af[i + ta], b[2], b[3]);"""
_STAGE = """        cp_async_bf16(gb + e, gn + off, WIDE, ok);
        if (yn) cp_async_bf16(yb + e, yn + off, WIDE, ok);
        if (rn) cp_async_bf16(rb + e, rn + off, WIDE, ok);"""
_GD = """        if (m + 1 < NIT || i < P * NV) {
          const unsigned e = at_swz(i / NV, cv);
          unsigned gu[CV / 2], yu[CV / 2], ru[CV / 2];
"""
_DD = "    const bool dd_here = a.dd1 && k % groups == grp;"
VARIANTS = {
    "kernel": [],
    "one_per_tile": [(_GRID, "constexpr int kAtGrid = 1 << 30; ")],
    "no_mma": [(_MMA, _MMA.split("              mma_bf16")[0]
                + '              asm volatile("" ::"r"(b[0]), "r"(b[2]), "r"(af[i + ta][0]));')],
    "no_staging": [(_STAGE, '        asm volatile("" ::"r"(e), "r"(off));')],
    "no_gd": [(_GD, _GD.replace("m + 1 < NIT || i < P * NV", "false"))],
    "no_dd": [(_DD, "    const bool dd_here = false;")],
}
FWD_FN = "mgt_modconv3x3_fwd_bf16"
_FWD_MMA = """            ldsm_x4_trans(b, wa + 2 * ((3 * ta + tb) * CK * WS + 16 * np));
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * np], af[i + ta], b[0], b[1]);
              mma_bf16(acc[i][2 * np + 1], af[i + ta], b[2], b[3]);"""
_FWD_STAGE = ("        cp_async_bf16(xb + 2 * at_swz(p, cv), xn + (ok ? (gy * W + gx) * C + c : 0), "
              "WIDE, ok);")
_FWD_XS = """    // (1) x * s in place, in bfloat16 pairs, on this thread's own copies.
    if (sn) {"""
_FWD_EPI = """    if (k + 1 < nchunks) continue;

    // (3) The tile's epilogue, a row at a time."""
FWD_VARIANTS = {
    "kernel": [],
    "one_per_tile": [(_GRID, "constexpr int kAtGrid = 1 << 30; ")],
    "no_mma": [(_FWD_MMA, _FWD_MMA.split("              mma_bf16")[0]
                + '              asm volatile("" ::"r"(b[0]), "r"(b[2]), "r"(af[i + ta][0]));')],
    "no_staging": [(_FWD_STAGE, '        asm volatile("" ::"r"(p), "r"((int)ok));')],
    "no_xs": [(_FWD_XS, _FWD_XS.replace("if (sn)", "if (false)"))],
    "no_epilogue": [(_FWD_EPI, _FWD_EPI.replace("k + 1 < nchunks", "true"))],
}


def main(fwd):
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if fwd:
        libs = build_variants(FWD_VARIANTS, FWD_FN, "k1_fwd_phase")
    else:
        libs = build_variants(VARIANTS, FN, "k1_phase")
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for res, c, last in K1_CALLS:
        if fwd:
            args = bf16_forward_args(gen, res, c, last)
            launches = {name: bare_forward(lib, args) for name, lib in libs.items()}
        else:
            args = bf16_adjoint_args(gen, res, c, last)
            launches = {name: bare_adjoint(lib, lib.mgt_bwd_tiles_bf16, args, torch.bfloat16)
                        for name, lib in libs.items()}
        row = dict(block=f"G b{res}", layer="conv_last" if last else "conv1")
        t = {}
        for names in (list(libs), list(libs)[::-1]):
            for name in names:
                t.setdefault(name, []).append(cuda_ms(launches[name][0], reps=20))
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()})
        # one_per_tile keeps the function: its y or dx against the kernel's
        # (the adjoint's partials are per tile, summed in another order).
        torch.cuda.synchronize()
        out = (lambda v: v[1]) if fwd else (lambda v: v[1][0])  # noqa: E731
        row["same_output"] = bool(torch.equal(out(launches["one_per_tile"]),
                                              out(launches["kernel"])))
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(smi, flush=True)
    print(json.dumps({"sums": {f"{k}_ms": sum(r[f"{k}_ms"] for r in rows) for k in libs}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] == ["--fwd"]))
