"""Where the time of K2's bfloat16 forward kernel (`upconv2_tc_kernel`) goes,
on a card where no profiler reads inside a kernel: source variants of
csrc/fused_conv.cu, each with one phase of the kernel removed or replaced,
built side by side with the same nvcc flags into
morphganformer_tpu_torch/_build/, and their bare launches
(`mgt_upconv2_fwd_bf16`) timed with CUDA events at the six K2 shapes of a
1024^2 forward at batch 1, on the inputs of bench_k2.py --bf16.

    python -m morphganformer_tpu_torch.bench_k2_phases

Variants:
  kernel              the source as it is
  no_mma              the mma.sync gone (their operands kept live): the
                      tensor cores' share
  no_staging          no chunk copied (the math runs on whatever shared
                      memory holds): the copies' share
  no_fir              the FIR's FMAs gone (its loads and the epilogue kept)
  scale_in_registers  x * s formed on each A fragment after ldmatrix (the
                      style loaded for each k16 step) in place of shared
                      memory: the design's alternative, the same output

The variants but the last compute wrong outputs by construction, and none is
checked here (the kernel is, by bench_k2.py --bf16 and the CUDA tests). A
variant's time less the kernel's is its phase's share; the phases overlap,
so the shares do not add up to the whole. The variants run in turns, the
order reversed in the second round; each time is the mean of the two.
Prints one JSON line per shape, then the card and the sums.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from morphganformer_tpu_torch.bench_k2 import bf16_case
from morphganformer_tpu_torch.bench_k3 import _call, cuda_ms
from morphganformer_tpu_torch.ops import _build

FN = "mgt_upconv2_fwd_bf16"
_MMA = """          mma_bf16(acc[i][cls][0], af[i + dr][dc], bfr[0], bfr[1]);
          mma_bf16(acc[i][cls][1], af[i + dr][dc], bfr[2], bfr[3]);"""
_STAGE = """    const int c0 = k * CK, buf = k % T::S;
    const unsigned xb"""
_FIR = """            *reinterpret_cast<const float4*>(zc + ((ly + 3) * T::ZC + ix) * T::ZP);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int iy = 0; iy < 4; ++iy)
#pragma unroll
        for (int ix = 0; ix < 4; ++ix) fma4(f[iy * 4 + ix], win[(ly + iy) & 3][ix], v);"""
_SCALE = """    if (sn) {
      // This thread's copies of chunk k have landed: x * s, rounded once."""
_LDSM = "          ldsm_x4(af[rr][dc], xa + 2 * ((rr * kTcXC + dc) * XS + 16 * kk));"
VARIANTS = {
    "kernel": [],
    "no_mma": [(_MMA, '          asm volatile("" ::"r"(bfr[0]), "r"(bfr[2]), '
                      '"r"(af[i + dr][dc][0]));')],
    "no_staging": [(_STAGE, "    cp_async_commit();\n    return;\n" + _STAGE)],
    "no_fir": [(_FIR, _FIR.replace("fma4(f[iy * 4 + ix], win[(ly + iy) & 3][ix], v);",
                                   "v.x += win[(ly + iy) & 3][ix].x * 0.f;"))],
    "scale_in_registers": [
        (_SCALE, _SCALE.replace("if (sn)", "if (false)")),
        (_LDSM, """        {
          ldsm_x4(af[rr][dc], xa + 2 * ((rr * kTcXC + dc) * XS + 16 * kk));
          if (sn) {
            const int c = c0 + 16 * kk + 2 * (lane & 3);
            const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
            const __nv_bfloat162 lo = c < Cin ? __halves2bfloat162(sn[c], sn[c + 1]) : z;
            const __nv_bfloat162 hi =
                c + 8 < Cin ? __halves2bfloat162(sn[c + 8], sn[c + 9]) : z;
            af[rr][dc][0] = hmul2_u32(af[rr][dc][0], lo);
            af[rr][dc][1] = hmul2_u32(af[rr][dc][1], lo);
            af[rr][dc][2] = hmul2_u32(af[rr][dc][2], hi);
            af[rr][dc][3] = hmul2_u32(af[rr][dc][3], hi);
          }
        }""")],
}


def variant_source(patches):
    src = _build.SOURCE.read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer holds the anchor {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(variants=VARIANTS, fn=FN, prefix="k2_phase"):
    """{name: loaded library} of the source `variants`, all compiled at once,
    with the signature of entry point `fn` set."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(patches) for name, patches in variants.items()}
    procs = {}
    for name, text in sources.items():
        src = _build.BUILD_DIR / f"{prefix}_{name}.cu"
        src.write_text(text)
        out = _build.BUILD_DIR / f"libmgt_{prefix}_{name}.so"
        procs[name] = (subprocess.Popen(_build.build_command(out, _build.nvcc_path(), src),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    logs = {name: proc.communicate(timeout=_build.BUILD_TIMEOUT_S)[0]
            for name, (proc, _) in procs.items()}      # every build ends before any raise
    libs = {}
    for name, (proc, out) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{logs[name]}")
        lib = ctypes.CDLL(str(out))
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = []
    for res, cin, cout in ((256, 256, 128), (512, 128, 64), (1024, 64, 32)):
        for skip in (False, True):
            row, _, launch, _, _, _ = bf16_case(gen, res, cin, cout, skip)
            ptrs, tail, _keep = launch[torch.bfloat16]
            y = torch.empty((1, res, res, cout), device="cuda", dtype=torch.bfloat16)
            t = {}
            for names in (list(libs), list(libs)[::-1]):
                for name in names:
                    t.setdefault(name, []).append(cuda_ms(
                        lambda: _call(libs[name], FN, *ptrs, y.data_ptr(), *tail), reps=20))
            row.update({f"{k}_ms": sum(v) / len(v) for k, v in t.items()})
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(smi, flush=True)
    print(json.dumps({"sums": {f"{k}_ms": sum(r[f"{k}_ms"] for r in rows) for k in libs}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
