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
    # x, w, s, d, noise, bias, resid, y, N, H, W, C, O, gain, alpha, device, stream
    "mgt_modconv3x3_fwd": [_P] * 8 + [_I] * 5 + [_F, _F, _I, _P],
    # x, wp, s, d, noise, bias, y, N, H, W, Cin, Cout, nt, hb0, hb1, gain, alpha, device, stream
    "mgt_upconv2_fwd": [_P] * 7 + [_I] * 8 + [_F, _F, _I, _P],
}


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
