"""Where the time of the FIR dw's bfloat16 kernel (`fir_dw_tc_kernel`) goes,
on a card where no profiler reads inside a kernel: source variants of
csrc/fused_conv.cu, each with one phase of the kernel removed, built side
by side with the same nvcc flags into morphganformer_tpu_torch/_build/, and
their bare launches (`mgt_fir_dw_bf16`) timed with CUDA events at the ten
FIR dw shapes of a 1024^2 training iteration at batch 4 (bench_dw.py's
SHAPES), on random bfloat16 operands.

    python -m morphganformer_tpu_torch.bench_fir_dw_phases

Variants:
  kernel       the source as it is
  no_mma       the mma.sync gone (their operands kept live): the tensor
               cores' share
  no_lo        the lo plane's ldmatrix and mma.sync gone (B rounded once to
               bfloat16, the variant that adds a rounding JAX does not have)
  no_staging   no tile copied (the kernel runs on whatever shared memory
               holds): the copies' share
  no_fir_fma   the FIR's FMAs gone (its raw loads kept live, the hi/lo
               stores of zeros kept)
  no_fir       the FIR phase gone whole (no raw loads, no plane stores)

The variants compute wrong outputs by construction, and none is checked
here (the kernel is, by bench_dw.py --bf16 and the CUDA tests). A variant's
time less the kernel's is its phase's share; where phases overlap, the
shares add up to less than the whole. The variants run in turns, the order
reversed in the second round; each time is the mean of the two. The
anchors are source lines of `fir_dw_tc_kernel`: a variant whose anchor is
gone raises before any nvcc starts. Prints one JSON line per shape, then
the card and the sums.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

from morphganformer_tpu_torch.bench_dw import SHAPES, fir_dw_launch
from morphganformer_tpu_torch.bench_k2_phases import build_variants
from morphganformer_tpu_torch.bench_k3 import cuda_ms
from morphganformer_tpu_torch.ops import fused_conv as fc
from morphganformer_tpu_torch.ops.upfirdn2d import setup_filter

FN = "mgt_fir_dw_bf16"
_MMA = """              mma_bf16(c[0], ah, bq[m & 1][0], bq[m & 1][1]);
              mma_bf16(c[0], al, bq[m & 1][0], bq[m & 1][1]);
              mma_bf16(c[1], ah, bq[m & 1][2], bq[m & 1][3]);
              mma_bf16(c[1], al, bq[m & 1][2], bq[m & 1][3]);"""
_LO_LDSM = "        ldsm_x4_trans(lo, plb + (q ^ 64));\n"
_STAGE = "    const int gy0 = 2 * kFwTH * ty - a.pad, gx0 = 2 * kFwTW * tx - a.pad;\n"
_FMA3 = """                v[(r - iy) & 3].x = fmaf(f[4 * iy + ix], x.x, v[(r - iy) & 3].x);
                v[(r - iy) & 3].y = fmaf(f[4 * iy + ix], x.y, v[(r - iy) & 3].y);"""
_FMA1 = """              v[(p >> 1) & 1].x = fmaf(f[4 * iy + ix], x.x, v[(p >> 1) & 1].x);
              v[(p >> 1) & 1].y = fmaf(f[4 * iy + ix], x.y, v[(p >> 1) & 1].y);"""
_FMA_COL = """              v.x = fmaf(f[4 * iy + ix], x.x, v.x);
              v.y = fmaf(f[4 * iy + ix], x.y, v.y);"""
_KEEP = '{}asm volatile("" ::"f"(x.x), "f"(x.y));'
_FIR = """    // (2) The FIR in float32, B split into hi and lo. Thread: channels 2 cp,
    // 2 cp + 1 of the block's 32.
    {"""
VARIANTS = {
    "kernel": [],
    "no_mma": [(_MMA, '              asm volatile("" ::"r"(ah[0]), "r"(al[0]), '
                      '"r"(bq[m & 1][0]), "r"(bq[m & 1][2]));')],
    "no_lo": [(_LO_LDSM, "        lo[0] = lo[1] = lo[2] = lo[3] = 0u;\n"),
              (_MMA, "\n".join(line for line in _MMA.splitlines() if ", al," not in line))],
    "no_staging": [(_STAGE, "    cp_async_commit();\n    return;\n" + _STAGE)],
    "no_fir_fma": [(_FMA3, _KEEP.format(" " * 16)), (_FMA1, _KEEP.format(" " * 14)),
                   (_FMA_COL, _KEEP.format(" " * 14))],
    "no_fir": [(_FIR, _FIR[:-1] + "if (false) {")],
}
BATCH = 4


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants(VARIANTS, FN, "fir_dw_phase")
    gen = torch.Generator(device="cuda").manual_seed(25)
    f = setup_filter([1, 3, 3, 1]).to("cuda")
    rows = []
    for role, block, layer, h, cin, cout, kh in SHAPES:
        randn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")       # noqa: E731
        w = randn(kh, kh, cin, cout) / math.sqrt(kh * kh * cin)
        if role == "K3-dw":
            src, base = randn(BATCH, 2 * h, 2 * h, cout), randn(BATCH, h, h, cin)
            s = torch.rand((BATCH, cin), generator=gen, device="cuda") + 0.5
            _, fk, pad = fc.upconv2_dw_leastwork(w, f, False)
        else:
            src, base = randn(BATCH, 2 * h, 2 * h, cin), randn(BATCH, h, h, cout)
            s = None
            _, fk, pad = fc.downconv2_dw_leastwork(w, f, True)
        src, base = src.bfloat16(), base.bfloat16()
        launches = {name: fir_dw_launch(lib, src, base, s, fk, pad, kh)[0]
                    for name, lib in libs.items()}
        row = dict(role=role, block=block, layer=layer, batch=BATCH)
        t = {}
        for names in (list(libs), list(libs)[::-1]):
            for name in names:
                t.setdefault(name, []).append(cuda_ms(launches[name], reps=20))
        row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()})
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(smi, flush=True)
    sums = {role: {f"{k}_ms": sum(r[f"{k}_ms"] for r in rows if r["role"] == role) for k in libs}
            for role in ("K2-use_dw-dw", "K3-dw")}
    print(json.dumps({"sums": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
