"""The port's metrics (morphganformer_tpu_torch/metrics/) against the JAX
package's, and the metrics in the training loop and the entry points.

Features are numpy draws from fixed seeds, fed to both packages. FID, KID
and IS run the same float64 numpy in both: equal to 1e-6 relative (in
practice to the bit). P&R's distances run in float32 (torch here, jnp
there): the distances to 1e-6 relative, and precision and recall exactly on
well-separated features. The detector's input grid is bit-equal. The
random InceptionV3 weights are bit-equal; its features and probabilities
of a 2-image batch agree to 1e-5 relative (about 2e-7 measured). PPL: JAX's
own draws are handed to the port; at epsilon 1e-1 the distances agree to
1e-4 relative, at the default 1e-4, where the difference quotient
multiplies float32 rounding by 1e8, to 5e-2; the band reduction is exact.
"""

import contextlib
import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cli.calc_metrics as jcalc
from morphganformer_tpu.metrics import core as jcore
from morphganformer_tpu.metrics import detector as jdet
from morphganformer_tpu.metrics import extract as jext
from morphganformer_tpu.metrics import feature_stats as jfs
from morphganformer_tpu.metrics import inception as jinc
from morphganformer_tpu.metrics import ppl as jppl
from morphganformer_tpu.metrics import registry as jreg
from morphganformer_tpu.models import config as jcfg
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.checkpoint.io import save_generator
from morphganformer_tpu_torch.metrics import core, detector, extract, inception, ppl, registry
from morphganformer_tpu_torch.metrics import feature_stats as fs
from morphganformer_tpu_torch.utils.image import to_uint8, write_png

from .test_torch_generator import _cfg
from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401
from .test_torch_noise_reg import small  # noqa: F401  (a fixture)
from .test_torch_training_loop import RES, data_root, run_loop  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def feats(seed, n=64, f=16, shift=0.0):
    return (np.random.RandomState(seed).randn(n, f) + shift).astype(np.float32)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------ feature stats

def _fill(mod, x, batch=10, **kw):
    st = mod.FeatureStats(capture_all=True, capture_mean_cov=True, **kw)
    for i in range(0, len(x), batch):
        st.append(x[i:i + batch])
    return st


@pytest.mark.parametrize("max_items", [None, 37])
def test_feature_stats_match_jax(max_items):
    x = feats(0)
    got, want = _fill(fs, x, max_items=max_items), _fill(jfs, x, max_items=max_items)
    assert got.num_items == want.num_items == (max_items or 64) and got.is_full() == want.is_full()
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.get_all(), want.get_all())
    assert pickle.dumps(got.__dict__) == pickle.dumps(want.__dict__)


@pytest.mark.parametrize("writer,reader", [(jfs, fs), (fs, jfs)], ids=["jax-to-port",
                                                                      "port-to-jax"])
def test_stats_cache_crosses_packages(tmp_path, writer, reader):
    path = str(tmp_path / "cache" / "stats.pkl")
    _fill(writer, feats(1)).save(path)
    back, ref = reader.FeatureStats.load(path), _fill(reader, feats(1))
    for a, b in zip(back.get_mean_cov(), ref.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.get_all(), ref.get_all())
    assert back.num_items == 64 and type(back) is reader.FeatureStats


def test_stats_cache_key_matches_jax():
    for args in (("data/ffhq", "inception", 50000), ("a/b/c", "raw", None)):
        assert fs.stats_cache_key(*args) == jfs.stats_cache_key(*args)


# ------------------------------------------------------------ the metrics

def test_fid_matches_jax():
    real, gen = _fill(fs, feats(2)), _fill(fs, feats(3, shift=0.5))
    jreal, jgen = _fill(jfs, feats(2)), _fill(jfs, feats(3, shift=0.5))
    got, want = core.compute_fid_from_stats(real, gen), jcore.compute_fid_from_stats(jreal, jgen)
    assert got == pytest.approx(want, rel=1e-6) and got > 0


def test_kid_matches_jax():
    got = core.compute_kid_from_features(feats(4, 80), feats(5, 70, shift=0.3), num_subsets=7,
                                         max_subset_size=50)
    want = jcore.compute_kid_from_features(feats(4, 80), feats(5, 70, shift=0.3), num_subsets=7,
                                           max_subset_size=50)
    assert got == pytest.approx(want, rel=1e-6)


def test_is_matches_jax():
    logits = feats(6, 50, 10) * 2
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for got, want in zip(core.compute_is_from_probs(probs, 5),
                         jcore.compute_is_from_probs(probs, 5)):
        assert got == pytest.approx(want, rel=1e-6)


def test_cdist_matches_jax():
    rows, cols = feats(7, 30), feats(8, 45)
    got = core._cdist_batched(rows, cols, batch=16, device="cpu")
    want = np.asarray(jcore._cdist_batched(rows, cols, batch=16))
    assert got.shape == (30, 45) and rel(got, want) <= 1e-6


def test_precision_recall_match_jax_exactly_on_separated_features():
    """Two clusters per side, one shared, the others far apart against their
    spread: both packages count the same probes, and none of the far
    clusters'."""
    rng = np.random.RandomState(9)
    centres = np.array([[0.0] * 8, [50.0] * 8, [-50.0] * 8], np.float32)
    real = np.concatenate([centres[0] + rng.randn(20, 8), centres[1] + rng.randn(20, 8)])
    gen = np.concatenate([centres[0] + rng.randn(15, 8), centres[2] + rng.randn(25, 8)])
    real, gen = real.astype(np.float32), gen.astype(np.float32)
    got = core.compute_pr_from_features(real, gen, row_batch_size=16, col_batch_size=8,
                                        device="cpu")
    want = jcore.compute_pr_from_features(real, gen, row_batch_size=16, col_batch_size=8)
    assert got == want
    assert 0 < got[0] <= 15 / 40 and 0 < got[1] <= 20 / 40


def test_slerp_and_lerp_match_jax():
    a, b = feats(10, 4, 8), feats(11, 4, 8)
    t = np.float32(0.3)
    np.testing.assert_allclose(core.slerp(a, b, t), jcore.slerp(a, b, t), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(core.lerp(a, b, t), jcore.lerp(a, b, t))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(ppl._slerp(ta, tb, torch.tensor(0.3)).numpy(),
                               np.asarray(jppl._slerp(jnp.asarray(a), jnp.asarray(b), t)),
                               rtol=1e-5, atol=1e-6)


def test_registry_names_match_jax():
    assert registry.list_valid_metrics() == jreg.list_valid_metrics()


# ------------------------------------------------------------ the detector

def test_to_detector_range_is_bit_equal():
    rng = np.random.RandomState(12)
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    x[0, 0, 1] = [-1.0039216, 0.99607843, -0.0039215684]     # on the grid's edges
    want = jext._to_detector_range(x)
    np.testing.assert_array_equal(extract._to_detector_range(x), want)
    np.testing.assert_array_equal(extract._to_detector_range(torch.from_numpy(x)).numpy(), want)
    u8 = rng.uniform(-20, 300, (1, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(extract._to_detector_range(u8), jext._to_detector_range(u8))
    np.testing.assert_array_equal(extract._to_detector_range(torch.from_numpy(u8)).numpy(),
                                  jext._to_detector_range(u8))


def test_raw_pixel_detector_matches_jax():
    x = np.random.RandomState(13).uniform(0, 255, (3, 16, 16, 3)).astype(np.float32)
    want = jdet.raw_pixel_detector()(x)
    np.testing.assert_array_equal(detector.raw_pixel_detector()(x), want)
    np.testing.assert_array_equal(detector.raw_pixel_detector()(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.fixture(scope="module")
def inception_pair():
    """(JAX params, the port's params, the port's features and probs
    detectors on the CPU), built once."""
    pj, pt = jinc.random_inception_params(0), inception.random_inception_params(0)
    return pj, pt, {k: inception.make_detector(pt, k, device="cpu")
                    for k in ("features", "probs")}


def test_random_inception_params_are_bit_equal(inception_pair):
    pj, pt, _ = inception_pair
    leaves = jax.tree_util.tree_leaves_with_path(pj)
    assert len(leaves) == 284
    for path, v in leaves:
        node = pt
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v), err_msg=jax.tree_util.keystr(path))


def test_inception_matches_jax(inception_pair):
    """Features [2, 2048] and probs [2, 1000] of two 24^2 images (resized to
    299 inside) against JAX's jitted detector: 1e-5 relative."""
    pj, _, dets = inception_pair
    x = np.random.RandomState(14).uniform(0, 255, (2, 24, 24, 3)).astype(np.float32)
    both = jax.jit(lambda p, x: (jinc.inception_features(p, x), jinc.inception_probs(p, x)))
    for kind, want in zip(("features", "probs"), both(pj, jnp.asarray(x))):
        got, want = dets[kind](x).numpy(), np.asarray(want)
        assert got.shape == want.shape == (2, 2048 if kind == "features" else 1000)
        assert rel(got, want) <= 1e-5, kind


def test_inception_npz_loader_matches_jax(inception_pair, tmp_path, monkeypatch):
    pj, pt, _ = inception_pair
    path = str(tmp_path / "inception.npz")
    inception.save_inception_npz(pt, path)
    got, want = inception.load_inception_npz(path), jinc.load_inception_npz(path)
    pairs = jax.tree_util.tree_leaves_with_path(want)
    assert len(pairs) == 284
    for keypath, v in pairs:
        node = got
        for k in keypath:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v))
    # resolve_detector finds it as JAX's does: the path, $MGT_INCEPTION_NPZ, the cache.
    monkeypatch.setenv("MGT_INCEPTION_NPZ", path)
    assert detector.default_inception_path() == jdet.default_inception_path() == path
    monkeypatch.delenv("MGT_INCEPTION_NPZ")
    monkeypatch.setenv("MGT_CACHE_DIR", str(tmp_path))
    assert detector.default_inception_path() == jdet.default_inception_path() == path
    monkeypatch.setenv("MGT_CACHE_DIR", str(tmp_path / "none"))
    assert detector.default_inception_path() is jdet.default_inception_path() is None
    with contextlib.redirect_stdout(io.StringIO()) as out:
        raw = detector.resolve_detector("auto", device="cpu")
    assert "raw-pixel fallback" in out.getvalue()
    x = np.ones((1, 4, 4, 3), np.float32)
    np.testing.assert_array_equal(raw(x), jdet.raw_pixel_detector()(x))


# ------------------------------------------------------------ extraction

IMGS = np.random.RandomState(15).uniform(-1, 1, (6, 8, 8, 3)).astype(np.float32)


def _callable_g(pkg_is_jax):
    """G(rng or gen, batch) -> the next `batch` images of IMGS, cycling."""
    state = {"i": 0}

    def g(_rng, batch):
        idx = [(state["i"] + j) % len(IMGS) for j in range(batch)]
        state["i"] += batch
        return jnp.asarray(IMGS[idx]) if pkg_is_jax else torch.from_numpy(IMGS[idx])

    return g


def test_features_for_generator_with_a_callable_g_matches_jax():
    kw = dict(max_items=10, batch=4, capture_all=True, capture_mean_cov=True)
    got = extract.features_for_generator(detector.raw_pixel_detector(), _callable_g(False), **kw)
    want = jext.features_for_generator(jdet.raw_pixel_detector(), _callable_g(True), **kw)
    assert got.num_items == want.num_items == 10
    np.testing.assert_array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    probs = extract.probs_for_generator(lambda x: torch.softmax(x.reshape(len(x), -1)[:, :5], 1),
                                        _callable_g(False), max_items=6, batch=4)
    assert probs.shape == (6, 5)


def test_features_for_generator_draws_z_from_the_seed(small):
    _, _, G = small
    got = extract.features_for_generator(detector.raw_pixel_detector(), G, max_items=5,
                                         batch=2, capture_all=True, seed=3).get_all()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        imgs = torch.cat([G(z=torch.randn((2, G.cfg.k, G.cfg.z_dim), generator=gen),
                            truncation_psi=1.0) for _ in range(3)])
    want = detector.raw_pixel_detector()(extract._to_detector_range(imgs))[:5].numpy()
    np.testing.assert_array_equal(got, want)


def test_features_for_dataset_uses_its_cache(tmp_path):
    batches = [np.random.RandomState(i).uniform(0, 255, (4, 8, 8, 3)).astype(np.float32)
               for i in range(3)]
    path = str(tmp_path / "c.pkl")
    got = extract.features_for_dataset(detector.raw_pixel_detector(), iter(batches), max_items=9,
                                       capture_mean_cov=True, cache_path=path)
    want = jext.features_for_dataset(jdet.raw_pixel_detector(), iter(batches), max_items=9,
                                     capture_mean_cov=True)
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    again = extract.features_for_dataset(None, None, cache_path=path)     # read, not computed
    assert again.num_items == 9


@pytest.mark.parametrize("metric", ["fid2k_full", "kid50k_full", "pr50k3_full", "is50k"])
def test_compute_metric_matches_jax(metric):
    """The registry on identical images: the dataset's and the callable G's,
    the raw detector (a softmax of it for IS)."""
    real = [np.random.RandomState(20 + i).uniform(0, 255, (4, 8, 8, 3)).astype(np.float32)
            for i in range(3)]
    kw = dict(max_items=12, batch=4)
    if metric == "is50k":
        det_t = lambda x: torch.softmax(torch.as_tensor(x).reshape(len(x), -1)[:, :7] / 50, 1)
        det_j = lambda x: jax.nn.softmax(jnp.asarray(x).reshape(len(x), -1)[:, :7] / 50, 1)
    else:
        det_t, det_j = detector.raw_pixel_detector(), jdet.raw_pixel_detector()
    got = registry.compute_metric(metric, detector=det_t, dataset=iter(real),
                                  G=_callable_g(False), device="cpu", **kw)
    want = jreg.compute_metric(metric, detector=det_j, dataset=iter(real), G=_callable_g(True),
                               **kw)
    assert got["metric"] == want["metric"] == metric
    assert got["results"].keys() == want["results"].keys()
    for k, v in want["results"].items():
        assert got["results"][k] == pytest.approx(v, rel=1e-6, abs=1e-12), k


def test_report_metric_writes_jax_line(tmp_path):
    result = registry.compute_metric("fid2k_full", detector=detector.raw_pixel_detector(),
                                     dataset=iter([IMGS * 100 + 128]), G=_callable_g(False),
                                     max_items=6, batch=3, device="cpu")
    jresult = dict(result, total_time=0.0)
    with contextlib.redirect_stdout(io.StringIO()):
        registry.report_metric(result, run_dir=str(tmp_path), snapshot_pkl="snap")
        jreg.report_metric(jresult, run_dir=str(tmp_path / "none"))
    line = json.loads(open(tmp_path / "metric-fid2k_full.jsonl").read())
    assert set(line) == {"results", "metric", "total_time", "total_time_str", "num_gpus",
                         "snapshot_pkl", "timestamp"}
    assert line["snapshot_pkl"] == "snap" and np.isfinite(line["results"]["fid2k_full"])


# ------------------------------------------------------------ PPL

def _feature_fns():
    """A fixed random projection of the flattened image, in both packages."""
    proj = np.random.RandomState(16).randn(8 * 8 * 3, 12).astype(np.float32) / 14

    def ft(img):
        return img.reshape(len(img), -1) @ torch.from_numpy(proj)

    def fj(img):
        return img.reshape(img.shape[0], -1) @ jnp.asarray(proj)

    return ft, fj


@pytest.mark.parametrize("space,sampling,epsilon,tol", [
    ("w", "end", 1e-1, 1e-4), ("z", "full", 1e-1, 1e-4), ("w", "full", 1e-4, 5e-2)])
def test_ppl_distances_from_jax_draws(small, space, sampling, epsilon, tol, monkeypatch):
    model, variables, G = small
    monkeypatch.setenv("MGT_PACKED_SYNTH", "0")
    ft, fj = _feature_fns()
    rng, batch = jax.random.PRNGKey(7), 3
    sampler = jppl.make_ppl_sampler(model, variables, _cfg(jcfg, "small"), fj, epsilon, space,
                                    sampling, crop=True)
    want = np.asarray(sampler(rng, batch))
    r_t, r_z = jax.random.split(rng)           # the draws inside JAX's sampler
    t = np.asarray(jax.random.uniform(r_t, (batch,))) * (1.0 if sampling == "full" else 0.0)
    z = np.asarray(jax.random.normal(r_z, (2 * batch, G.cfg.k, G.cfg.z_dim)))
    got = ppl.ppl_distances(G, torch.from_numpy(t), torch.from_numpy(z), ft, epsilon, space,
                            crop=True).numpy()
    assert got.shape == want.shape == (batch,) and (want > 0).all()
    assert rel(got, want) <= tol, (rel(got, want), got, want)


def test_ppl_band_reduction_matches_jax(monkeypatch):
    """compute_ppl's [1 %, 99 %] band over given distances, exactly."""
    dist = np.random.RandomState(17).lognormal(size=203).astype(np.float32)
    chunks = [dist[i:i + 8] for i in range(0, 208, 8)]

    def replay(jax_side):
        it = iter(chunks)
        if jax_side:
            return lambda *a, **k: (lambda rng, batch: jnp.asarray(next(it)))
        return lambda *a, **k: (lambda gen, batch: torch.from_numpy(next(it)))

    monkeypatch.setattr(jppl, "make_ppl_sampler", replay(True))
    want = jppl.compute_ppl(None, None, None, None, num_samples=203, batch=8)
    monkeypatch.setattr(ppl, "make_ppl_sampler", replay(False))
    got = ppl.compute_ppl(None, None, num_samples=203, batch=8)
    assert got == want == ppl.ppl_from_distances(dist)


def test_ppl_without_a_feature_net_raises(small):
    _, _, G = small
    with pytest.raises(ValueError, match="feature net"):
        registry.compute_metric("ppl2_wend", G=G, max_items=2)


def test_compute_ppl_runs_on_the_generator(small):
    _, _, G = small
    ft, _ = _feature_fns()
    got = registry.compute_metric("ppl_zfull", G=G, feature_fn=ft, max_items=5, batch=2)
    assert got["results"]["ppl_zfull"] > 0 and np.isfinite(got["results"]["ppl_zfull"])


# ------------------------------------------------------------ the loop and the entry points

def test_loop_reports_metrics_at_snapshots(data_root, tmp_path):
    """One tick with eval_metrics: the snapshot tick's line and the final
    snapshot's, on G_ema with the raw detector."""
    run_dir = str(tmp_path / "run")
    run_loop(run_dir, data_root, 1, eval_metrics=("fid2k_full", "kid50k_full"),
             eval_images_num=8, eval_batch=4, detector="raw")
    for metric in ("fid2k_full", "kid50k_full"):
        lines = [json.loads(s) for s in open(os.path.join(run_dir, f"metric-{metric}.jsonl"))]
        assert len(lines) == 2 and all(e["metric"] == metric for e in lines)
        assert all(np.isfinite(e["results"][metric]) for e in lines)
        assert all(e["snapshot_pkl"].endswith("network-snapshot-000000") for e in lines)


TRAIN_FLAGS = ["train", "--resolution", str(RES), "--components-num", "2", "--latent-size", "16",
               "--channel-base", "256", "--channel-max", "32", "--end-res", "3",
               "--batch", "4", "--device", "cpu", "--ganformer-default"]


def test_train_entry_point_evaluates(data_root, tmp_path, monkeypatch):
    """train --metrics at the snapshot ticks (eval_images_num cut to 8), then
    train --eval on the newest snapshot (2000 images, as JAX's)."""
    from morphganformer_tpu_torch.training import loop as tloop

    real = tloop.LoopConfig
    monkeypatch.setattr(tloop, "LoopConfig",
                        lambda **kw: real(**kw, eval_images_num=8, eval_batch=4))
    flags = TRAIN_FLAGS + ["--data-dir", data_root, "--result-dir", str(tmp_path),
                           "--expname", "e", "--kimg-per-tick", "0.004", "--max-ticks", "1",
                           "--img-snapshot-ticks", "0", "--snapshot-ticks", "1",
                           "--detector", "raw"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(flags + ["--metrics", "fid2k_full"])
    lines = open(tmp_path / "e-000" / "metric-fid2k_full.jsonl").read().splitlines()
    assert len(lines) == 2 and np.isfinite(json.loads(lines[0])["results"]["fid2k_full"])
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(flags + ["--eval", "--metrics", "kid50k_full"])
    line, = open(tmp_path / "e-000" / "metric-kid50k_full.jsonl").read().splitlines()
    assert json.loads(line)["snapshot_pkl"].endswith("network-snapshot-000000")
    with pytest.raises(FileNotFoundError, match="no snapshot"):
        cli.main(flags + ["--eval", "--expname", "none"])


def test_calc_metrics_entry_point(small, tmp_path, monkeypatch):
    """calc_metrics on a checkpoint directory and a PNG folder writes JAX's
    metric line; the same numbers as run_calc_metrics on the loaded G, which
    it loads in float32 (JAX's calc_metrics has no --dtype, nor has the
    port's)."""
    _, _, G = small
    save_generator(str(tmp_path / "ckpt"), G.cfg, G)
    loaded = []
    get_model = cli.get_model
    monkeypatch.setattr(cli, "get_model", lambda *a, **k: loaded.append(k) or get_model(*a, **k))
    res = G.cfg.img_resolution
    os.makedirs(tmp_path / "data" / str(res))
    for i, img in enumerate(np.random.RandomState(18).uniform(0, 255, (10, res, res, 3))):
        write_png(str(tmp_path / "data" / str(res) / f"{i:03d}.png"), img.astype(np.uint8))
    os.makedirs(tmp_path / "run")
    args = ["calc_metrics", "--model", str(tmp_path / "ckpt"), "--data", str(tmp_path / "data"),
            "--metrics", "fid2k_full", "pr50k3_full", "--max-items", "8", "--batch", "4",
            "--detector", "raw", "--run-dir", str(tmp_path / "run"), "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(args)
        want = cli.run_calc_metrics(G, str(tmp_path / "data"), ["fid2k_full", "pr50k3_full"],
                                    8, 4, None, "raw", "cpu")
    for name, w in zip(("fid2k_full", "pr50k3_full"), want):
        line = json.loads(open(tmp_path / "run" / f"metric-{name}.jsonl").read())
        assert line["results"] == w["results"] and line["metric"] == name
    assert loaded == [{"device": "cpu"}]
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.main(args + ["--dtype", "bfloat16"])


def test_calc_metrics_morph_qa_matches_jax(tmp_path):
    rng = np.random.RandomState(19)
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
    for i in range(3):
        base = rng.uniform(-1, 1, (24, 20, 3))
        write_png(str(tmp_path / "a" / f"{i}.png"), to_uint8(base))
        write_png(str(tmp_path / "b" / f"{i}.png"),
                  to_uint8(np.clip(base + 0.1 * rng.randn(24, 20, 3), -1, 1)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["calc_metrics", "--morph-qa", "--dir-a", str(tmp_path / "a"), "--dir-b",
                  str(tmp_path / "b"), "--device", "cpu"])
    got = json.loads(out.getvalue())
    want = jcalc.morph_qa(str(tmp_path / "a"), str(tmp_path / "b"))
    assert got["num_pairs"] == want["num_pairs"] == 3
    for k in ("psnr_mean", "ssim_mean"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    with pytest.raises(ValueError, match="mismatch"):
        cli.morph_qa(str(tmp_path / "a"), str(tmp_path), device="cpu")
