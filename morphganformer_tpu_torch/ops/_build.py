"""Build and load the port's CUDA kernels: one `nvcc` call, loaded with ctypes.

The shared library is built at first use into `morphganformer_tpu_torch/_build/`
(listed in .gitignore). Its name carries a hash of the source and the flags,
so a changed source is rebuilt and a stale library is never loaded. The
build writes to a temporary name and renames it into place, so an interrupted
build leaves nothing that a later one would wait on or load.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_conv.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, s, d, noise, bias, resid, y, N, H, W, C, O, gain, alpha, noise_ns, device, stream
    "mgt_modconv3x3_fwd": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # x, w, y, N, H, W, C, O, device, stream
    "mgt_conv3x3_fwd": [_P] * 3 + [_I] * 5 + [_I, _P],
    # g, w, dx, N, H, W, C, O, device, stream
    "mgt_conv3x3_dx": [_P] * 3 + [_I] * 5 + [_I, _P],
    # x, wk, fir, s, d, noise, bias, y, N, H, W, Cin, Cout, kh, pad, gain, alpha, noise_ns,
    # device, stream
    "mgt_upconv2_fwd": [_P] * 8 + [_I] * 7 + [_F, _F, _I, _I, _P],
    # x, wk, fir, bias, resid, y, N, H, W, Cin, Cout, kh, pad, gain, alpha, device, stream
    "mgt_downconv2_fwd": [_P] * 6 + [_I] * 7 + [_F, _F, _I, _P],
    # H, W of the output -> the number of spatial blocks of a K3 launch
    "mgt_downconv2_tiles": [_I, _I],
    # H, W, C of dx -> the number of spatial blocks of a K1 adjoint launch
    "mgt_bwd_tiles": [_I, _I, _I],
    # H, W, C of dx -> the number of tiles of a bfloat16 K1 adjoint launch
    "mgt_bwd_tiles_bf16": [_I, _I, _I],
    # g, w, s, d, x, y, resid, noise, dx, dot, dd1, dd2, N, H, W, O, C, gain, alpha,
    # noise_ns, device, stream
    "mgt_modconv3x3_bwd": [_P] * 12 + [_I] * 5 + [_F, _F, _I, _I, _P],
    # gd, wk, fir, s, x, y, noise, dx, dot, dd1, dd2, N, H, W, O, C, kh, pad, gain, alpha,
    # noise_ns, device, stream
    "mgt_upconv2_bwd": [_P] * 11 + [_I] * 7 + [_F, _F, _I, _I, _P],
    # x, gd, s, part, N, H, W, C, O, ot, slices, tiles_per_slice, device, stream
    "mgt_conv_dw": [_P] * 4 + [_I] * 8 + [_I, _P],
    # N, H, W, ot -> the number of tiles of a mgt_conv_dw launch (and of a
    # mgt_conv_dw_bf16 one)
    "mgt_conv_dw_tiles": [_I] * 4,
    "mgt_conv_dw_tiles_bf16": [_I] * 4,
    # src, base, s, fir, part, N, H, W, CB, CK, kh, pad, slices, tiles_per_slice, device,
    # stream
    "mgt_fir_dw": [_P] * 5 + [_I] * 9 + [_I, _P],
    # N, H, W of the base grid -> the number of tiles of a mgt_fir_dw launch
    "mgt_fir_dw_tiles": [_I, _I, _I],
}
# The bfloat16 entry points of K1 (forward, adjoint), K2, K3's forward, K4
# and the dw kernels take the float32 ones' arguments (pointers to bfloat16
# where the kernel reads or writes the compute type); K3's adjoint takes the
# output cotangent g for gd and d after s.
_SIGNATURES.update({f"{name}_bf16": _SIGNATURES[name] for name in (
    "mgt_modconv3x3_fwd", "mgt_modconv3x3_bwd", "mgt_upconv2_fwd", "mgt_downconv2_fwd",
    "mgt_conv3x3_fwd", "mgt_conv3x3_dx", "mgt_conv_dw", "mgt_fir_dw")})
# g, wk, fir, s, d, x, y, noise, dx, dot, dd1, dd2, N, H, W, O, C, kh, pad, gain, alpha,
# noise_ns, device, stream
_SIGNATURES["mgt_upconv2_bwd_bf16"] = [_P] * 12 + [_I] * 7 + [_F, _F, _I, _I, _P]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels need the CUDA toolkit")


def build_command(out_path, nvcc="nvcc", source=SOURCE):
    return [str(nvcc), *NVCC_FLAGS, "-o", str(out_path), str(source)]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmgt_fused_conv_{digest}.so"


@functools.lru_cache(maxsize=None)
def build():
    """Compile the library if it is not there yet. Returns (path, seconds,
    compiler log); seconds and log are 0 and "" when it was already built."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp, nvcc_path()), capture_output=True,
                          text=True, timeout=BUILD_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
