"""The port's synthetic-faces training demo
(morphganformer_tpu_torch/tools/train_demo_synfaces.py) against the JAX
package's tools/train_demo_synfaces.py: the dataset decodes pixel for pixel
to what JAX's build_dataset writes for the same seed (the PNG bytes differ:
JAX's are Pillow's), the train command carries JAX's flags, each accepted
by the port's `cli train`, and one tick at 16^2 on the CPU writes a
snapshot and an image grid with finite losses."""

import argparse
import importlib.util
import json
import math
import os
import tempfile

import numpy as np
from PIL import Image

from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.tools import train_demo_synfaces as demo
from morphganformer_tpu_torch.utils.image import read_image

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

_JAX_TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                         "train_demo_synfaces.py")


def jax_demo():
    spec = importlib.util.spec_from_file_location("jax_train_demo_synfaces", _JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_dataset_matches_jax_pixel_for_pixel(tmp_path):
    demo.build_dataset(str(tmp_path / "port"), 5, 32)
    jax_demo().build_dataset(str(tmp_path / "jax"), 5, 32)
    names = sorted(os.listdir(tmp_path / "jax" / "32"))
    assert names == sorted(os.listdir(tmp_path / "port" / "32")) == [f"{i:05d}.png"
                                                                      for i in range(5)]
    for n in names:
        got = read_image(str(tmp_path / "port" / "32" / n))
        want = np.asarray(Image.open(tmp_path / "jax" / "32" / n))
        assert got.shape == want.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "32" / n)), want)


def test_train_command_carries_the_jax_flags(tmp_path, monkeypatch):
    """JAX's command (cli/train.py and its flags) against the port's
    (`cli train`, the same flags, then --device), at JAX's defaults and at
    a cut run; every flag parses in the port's train parser."""
    jdemo = jax_demo()
    calls = []
    monkeypatch.setattr(jdemo, "build_dataset", lambda *a, **k: None)
    monkeypatch.setattr(jdemo.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    for argv in ([], ["--res", "128", "--ticks", "5", "--images", "8"]):
        out = ["--out", str(tmp_path / "run")]
        try:
            jdemo.main(out + argv)
        except SystemExit as e:
            assert e.code == 0
        jflags = calls[-1][2:]
        assert calls[-1][1].endswith(os.path.join("cli", "train.py"))
        mine = demo.train_argv(demo.parse_args(out + argv))
        assert mine[0] == "train" and mine[-2:] == ["--device", "cuda"]
        assert mine[1:-2] == jflags
        parser = argparse.ArgumentParser()
        cli.train_parser(parser.add_subparsers(dest="command"))
        parsed = parser.parse_args(mine)
        assert parsed.resolution == (int(argv[1]) if argv else 64)
        assert parsed.metrics == ["fid2k_full"] and parsed.device == "cuda"


def test_default_out_is_under_the_temp_dir(tmp_path, monkeypatch):
    """With no --out the run goes under tempfile's directory ($TMPDIR), not
    a fixed path that two checkouts would share."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert demo.parse_args([]).out == str(tmp_path / "synface_run")


def test_one_tick_at_16_on_the_cpu(tmp_path, one_torch_thread):
    """32 faces at 16^2, one tick of 32 images, no metric: a snapshot, the
    image grid, and finite losses in stats.jsonl."""
    out = str(tmp_path / "run")
    assert demo.main(["--out", out, "--images", "32", "--res", "16", "--ticks", "1",
                      "--kimg-per-tick", "0.032", "--metrics", "--device", "cpu"]) == 0
    run = os.path.join(out, "results", "exp-000")
    snaps = [d for d in os.listdir(run) if d.startswith("network-snapshot-")]
    assert len(snaps) == 1
    assert {"G.msgpack", "D.msgpack", "Gs.msgpack", "train_state.msgpack",
            "arch.json"} <= set(os.listdir(os.path.join(run, snaps[0])))
    grids = [f for f in os.listdir(run) if f.startswith("fakes") and f.endswith(".png")]
    assert grids and read_image(os.path.join(run, grids[0])).ndim == 3
    with open(os.path.join(run, "stats.jsonl")) as f:
        stats = [json.loads(line) for line in f]
    losses = {k: v["mean"] for s in stats for k, v in s.items() if k.startswith("Loss/")}
    assert {"Loss/G/loss", "Loss/D/loss"} <= set(losses)
    assert all(math.isfinite(v) for v in losses.values()), losses
