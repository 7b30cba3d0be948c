"""The port stands alone: no JAX, flax, Pillow, msgpack or JAX package on
its import path, and its kernels build with plain nvcc for sm_90a."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "PIL", "msgpack", "morphganformer_tpu")
PORT_FILES = sorted((ROOT / "morphganformer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_forbidden(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_build_is_one_plain_nvcc_call_for_sm_90a():
    from morphganformer_tpu_torch.ops import _build

    cmd = _build.build_command("out.so", nvcc="nvcc")
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[-1] == str(_build.SOURCE)
    src = _build.SOURCE.read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src
    assert "cpp_extension" not in (ROOT / "morphganformer_tpu_torch" / "ops" / "_build.py").read_text()
    # A changed source gets another library name, so a stale build is never loaded.
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("libmgt_fused_conv_")


def test_entry_points_refuse_a_missing_card():
    import torch

    from morphganformer_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card():
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
