"""Where the time of K3's bfloat16 adjoint kernel (`downconv2_tc_kernel`) goes,
on a card where no profiler reads inside a kernel: source variants of
csrc/fused_conv.cu, each with one phase of the kernel removed, built side
by side with the same nvcc flags into morphganformer_tpu_torch/_build/, and
their bare launches (`mgt_upconv2_bwd_bf16`) timed with CUDA events at the
six K3-adjoint shapes of a 1024^2 projection step at batch 1, on the inputs
of bench_k3.py --bf16.

    python -m morphganformer_tpu_torch.bench_k3_phases

Variants:
  kernel      the source as it is
  no_mma      the mma.sync gone (their operands kept live): the tensor
              cores' share
  no_lo       the lo plane's ldmatrix and mma.sync gone (B rounded once to
              bfloat16, the variant that adds a rounding JAX does not have)
  no_staging  no chunk copied (the kernel runs on whatever shared memory
              holds): the copies' share
  no_fir      the FIR's FMAs gone (its loads and the hi/lo stores kept)
  no_gd       gd not formed (the FIR reads y, or g, as it landed)
  no_dd       the dd taps gone (their partials left unwritten)

The variants compute wrong outputs by construction, and none is checked
here (the kernel is, by bench_k3.py --bf16 and the CUDA tests). A variant's
time less the kernel's is its phase's share; the phases overlap, so the
shares do not add up to the whole. The variants run in turns, the order
reversed in the second round; each time is the mean of the two. Prints
one JSON line per shape, then the card and the sums.
"""

from __future__ import annotations

import json
import sys

import torch

from morphganformer_tpu_torch.bench_k2_phases import build_variants
from morphganformer_tpu_torch.bench_k3 import bare_bf16, bf16_adjoint_args, cuda_ms

FN = "mgt_upconv2_bwd_bf16"
_MMA = """          mma_bf16(acc[2 * np], ah, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np], al, bfr[0], bfr[1]);
          mma_bf16(acc[2 * np + 1], ah, bfr[2], bfr[3]);
          mma_bf16(acc[2 * np + 1], al, bfr[2], bfr[3]);"""
_LO_LDSM = "        ldsm_x4(al, lb + off);\n"
_RAW = """    const unsigned base = smem_u32(dst);
    const bf16* tk = t + img * O + k * CK;"""
_W = """    const unsigned base = smem_u32(ws + (k % T::NWB) * T::WT);
    const bf16* wk = a.w + (size_t)k * CK * C + o0;"""
_FIR = """          v.x = fmaf(f[4 * iy + ix], w[ix].x, v.x);
          v.y = fmaf(f[4 * iy + ix], w[ix].y, v.y);"""
_GD = """#pragma unroll
      for (int b = 0; b < NIT; b += NB2) {"""
_DD = "    const bool dd_here = KH == 3 && a.dd1 && k % groups == grp;"
_SKIP = "    cp_async_commit();\n    return;\n"
VARIANTS = {
    "kernel": [],
    "no_mma": [(_MMA, '          asm volatile("" ::"r"(bfr[0]), "r"(bfr[2]), "r"(ah[0]), '
                      '"r"(al[0]));')],
    "no_lo": [(_LO_LDSM, "        al[0] = al[1] = al[2] = al[3] = 0u;\n"),
              (_MMA, "\n".join(line for line in _MMA.splitlines() if ", al," not in line))],
    "no_staging": [(_RAW, _SKIP + _RAW), (_W, _SKIP + _W)],
    "no_fir": [(_FIR, "          v.x += w[ix].x * 0.f;")],
    "no_gd": [(_GD, "      if (false)\n" + _GD.split("\n")[1])],
    "no_dd": [(_DD, "    const bool dd_here = false;")],
}


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants(VARIANTS, FN, "k3_phase")
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        for skip in (False, True):
            args = bf16_adjoint_args(gen, res, cin, cout, skip)
            launches = {name: bare_bf16(lib, args) for name, lib in libs.items()}
            row = dict(block=f"G b{res}", layer="skip" if skip else "conv0")
            t = {}
            for names in (list(libs), list(libs)[::-1]):
                for name in names:
                    t.setdefault(name, []).append(cuda_ms(launches[name][0], reps=20))
            row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()})
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(smi, flush=True)
    print(json.dumps({"sums": {f"{k}_ms": sum(r[f"{k}_ms"] for r in rows) for k in libs}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
