"""extract_features in the port (metrics/fingerprint.py and the CLI
subcommand) against the JAX package's cli/extract_features.py and the
scikit-learn calls it makes: the stratified split index for index, the
linear SVM's optimum, the embeddings of a folder, and the CLI end to end
on the CPU with a random backbone."""

import ast
import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from morphganformer_tpu_torch import cli as tcli
from morphganformer_tpu_torch.losses import face_embedding
from morphganformer_tpu_torch.metrics import fingerprint
from morphganformer_tpu_torch.utils.image import write_png

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_stratified_split_is_sklearns(seed):
    """sklearn's train_test_split(test_size=0.3, random_state=seed,
    stratify=y), index for index, over a grid of class sizes."""
    model_selection = pytest.importorskip("sklearn.model_selection")
    checked = 0
    for n_bona in (2, 3, 5, 7, 10, 13, 40):
        for n_morph in (2, 4, 6, 9, 11, 25):
            y = np.concatenate([np.zeros(n_bona), np.ones(n_morph)])
            idx = np.arange(len(y))
            try:
                want = model_selection.train_test_split(idx, test_size=0.3, random_state=seed,
                                                        stratify=y)
            except ValueError:
                with pytest.raises(ValueError):
                    fingerprint.stratified_split(y, 0.3, seed)
                continue
            got = fingerprint.stratified_split(y, 0.3, seed)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            checked += 1
    assert checked >= 40


def _margin_data(n=60, d=512, seed=0):
    """Embedding-like rows (d > n) of two classes with a margin."""
    rng = np.random.RandomState(seed)
    y = (np.arange(n) < n // 2).astype(np.float64)
    direction = np.sign(rng.randn(d))
    x = rng.randn(n, d) * 0.3 + direction * y[:, None]
    return x, y


def test_linear_svm_is_linearsvcs():
    """The port's SVM against LinearSVC(max_iter=5000), JAX's call: the
    coefficients and the intercept within 1e-3 of their largest entry,
    the same accuracies; and against LinearSVC run to tol 1e-12 (its exact
    optimum) within 1e-6 on 20-d data, where the default tol stops far
    from it."""
    svm = pytest.importorskip("sklearn.svm")
    x, y = _margin_data()
    clf = svm.LinearSVC(max_iter=5000).fit(x, y)
    coef, intercept = fingerprint.linear_svm(x, y)
    scale = np.abs(clf.coef_[0]).max()
    assert np.abs(coef - clf.coef_[0]).max() <= 1e-3 * scale
    assert abs(intercept - clf.intercept_[0]) <= 1e-3 * max(abs(clf.intercept_[0]), scale)
    xt, yt = _margin_data(seed=1)
    for xs, ys in ((x, y), (xt, yt)):
        assert fingerprint.svm_accuracy(coef, intercept, xs, ys) == clf.score(xs, ys)

    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(40, 20) + 1.5, rng.randn(50, 20) - 1.5])
    y = np.concatenate([np.zeros(40), np.ones(50)])
    exact = svm.LinearSVC(tol=1e-12, max_iter=100000, dual=False).fit(x, y)
    coef, intercept = fingerprint.linear_svm(x, y)
    scale = np.abs(exact.coef_[0]).max()
    assert np.abs(coef - exact.coef_[0]).max() <= 1e-6 * scale
    assert abs(intercept - exact.intercept_[0]) <= 1e-6 * scale


def test_svm_fingerprinting_matches_jax():
    """JAX's svm_fingerprinting (sklearn) and the port's on the same
    features: the same counts and accuracies."""
    pytest.importorskip("sklearn")
    import cli.extract_features as jef

    rng = np.random.RandomState(5)
    bona = rng.randn(14, 512) * 0.5 + 0.2
    morph = rng.randn(11, 512) * 0.5 - 0.2
    assert fingerprint.svm_fingerprinting(bona, morph) == jef.svm_fingerprinting(bona, morph)


def _faces(root, n, seed, size=112):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        write_png(os.path.join(root, f"face{i:02d}.png"),
                  (rng.rand(size, size, 3) * 255).astype(np.uint8))
    return root


def test_extract_dir_matches_jax(tmp_path):
    """JAX's extract_dir and the port's on 3 seeded 112^2 PNGs with the same
    random iresnet18 weights: the files in the same order, the embeddings
    within 1e-4 of their largest entry."""
    from morphganformer_tpu.losses.face_embedding import random_iresnet_params

    import cli.extract_features as jef

    root = _faces(str(tmp_path / "faces"), 3, seed=1)
    files_j, feats_j = jef.extract_dir(random_iresnet_params("iresnet18"), root)
    params = face_embedding.random_iresnet_params("iresnet18", device="cpu")
    files, feats = fingerprint.extract_dir(params, root, device="cpu")
    assert files == files_j and feats.shape == (3, 512)
    feats_j = np.asarray(feats_j)
    assert np.abs(feats - feats_j).max() <= 1e-4 * np.abs(feats_j).max()


def test_extract_features_cli(tmp_path):
    """The subcommand on the CPU with a random backbone: --bona/--morph
    prints JAX's JSON (accuracies in [0, 1], the counts), --images writes
    the npz of files and 512-d features in file order, equal to
    extract_dir's; a file it does not read (an empty .jpg) is refused by name."""
    bona = _faces(str(tmp_path / "bona"), 5, seed=2)
    morph = _faces(str(tmp_path / "morph"), 4, seed=3)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tcli.main(["extract_features", "--random-backbone", "--bona", bona, "--morph", morph,
                   "--device", "cpu"])
    out = json.loads(log.getvalue().strip().splitlines()[-1])
    assert set(out) == {"train_acc", "test_acc", "num_bona", "num_morph"}
    assert (out["num_bona"], out["num_morph"]) == (5, 4)
    assert 0.0 <= out["train_acc"] <= 1.0 and 0.0 <= out["test_acc"] <= 1.0

    npz = str(tmp_path / "features.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["extract_features", "--random-backbone", "--images", bona, "--out", npz,
                   "--device", "cpu"])
    data = np.load(npz)
    assert [os.path.basename(f) for f in data["files"]] == [f"face{i:02d}.png"
                                                            for i in range(5)]
    params = face_embedding.random_iresnet_params("iresnet18", device="cpu")
    with torch.no_grad():
        _, want = fingerprint.extract_dir(params, bona, device="cpu")
    assert data["features"].shape == (5, 512)
    np.testing.assert_array_equal(data["features"], want)

    open(os.path.join(bona, "late.jpg"), "wb").close()
    with pytest.raises(ValueError, match="late.jpg: an empty file"):
        tcli.main(["extract_features", "--random-backbone", "--images", bona, "--out", npz,
                   "--device", "cpu"])


def test_port_does_not_import_sklearn():
    """The card's machine has no scikit-learn: no module of the port, nor
    chip_smoke.py, imports it."""
    files = sorted((ROOT / "morphganformer_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "sklearn" for n in names), path
