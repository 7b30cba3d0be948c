"""The warped-morph tail of the port against the JAX package: grid_sample
(values and gradients to the second order), the piecewise-affine warp and
the average-landmark warp in float64, the landmark CSV writer, the
warp_morphs entry point (CSV, batch-list and predicted landmarks) and
make_video's GIF."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from morphganformer_tpu.losses import landmarks as jlm
from morphganformer_tpu.morph import warp as jwarp
from morphganformer_tpu.ops.grid_sample import grid_sample as j_grid_sample
from morphganformer_tpu_torch import cli
from morphganformer_tpu_torch.losses import landmarks as tlm
from morphganformer_tpu_torch.morph import warp as twarp
from morphganformer_tpu_torch.ops.grid_sample import grid_sample
from morphganformer_tpu_torch.utils import video
from morphganformer_tpu_torch.utils.image import read_png, write_png

import cli.make_video as jmake_video
import cli.warp_morphs as jwarp_morphs

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 64


# ------------------------------------------------------------ grid_sample

def sample_inputs(seed, n=2, h=7, w=9, ho=5, wo=6, c=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (n, ho, wo, 2)).astype(np.float32)   # some outside
    r = rng.randn(n, ho, wo, c).astype(np.float32)
    vx = rng.randn(*x.shape).astype(np.float32)
    vg = rng.randn(*grid.shape).astype(np.float32)
    return x, grid, r, vx, vg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_sample_matches_jax(seed):
    x, grid, _, _, _ = sample_inputs(seed)
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = grid_sample(torch.from_numpy(x), torch.from_numpy(grid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_sample_gradients_match_jax_to_the_second_order(seed):
    """First-order gradients (x and grid) against jax.grad, second-order
    against a JAX Hessian-vector product (forward over reverse), both
    packages in float64 so that float32 rounding does not hide a term."""
    x, grid, r, vx, vg = (a.astype(np.float64) for a in sample_inputs(seed))

    def j_loss(xx, gg):
        return jnp.sum(j_grid_sample(xx, gg) * r)

    with jax.enable_x64(True):
        want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid)))
        jgx, jgg = jax.grad(j_loss, argnums=(0, 1))(x, grid)
        _, (hx, hg) = jax.jvp(jax.grad(j_loss, argnums=(0, 1)), (x, grid), (vx, vg))
        assert want.dtype == np.float64

    xt = torch.tensor(x, requires_grad=True)
    gt = torch.tensor(grid, requires_grad=True)
    out = grid_sample(xt, gt)
    gx, gg = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (xt, gt), create_graph=True)
    thx, thg = torch.autograd.grad((gx, gg), (xt, gt),
                                   grad_outputs=(torch.from_numpy(vx), torch.from_numpy(vg)))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=1e-6)
    for got, ref in ((gx, jgx), (gg, jgg), (thx, hx), (thg, hg)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert np.abs(thg.numpy()).max() > 0.1          # the grid's second order is not zero


def test_grid_sample_reads_zeros_outside_and_pixels_at_the_corners():
    x = torch.arange(12.0).reshape(1, 3, 4, 1)
    grid = torch.tensor([[[[-1.0, -1.0], [1.0, 1.0], [1.0, -1.0], [3.0, 0.0]]]])
    np.testing.assert_array_equal(grid_sample(x, grid).reshape(-1).numpy(), [0, 11, 3, 0])


# ------------------------------------------------------------ the warp

def landmark_sets(seed, sliver=False, size=SIZE):
    rng = np.random.RandomState(seed)
    base = rng.rand(68, 2) * size * 0.6 + size * 0.2
    if sliver:
        # Points a hair inside the image's border, between two anchors:
        # hull triangles of tiny area.
        base[:4] = [[1e-4, size * 0.2], [1e-3, size * 0.5], [size * 0.45, size - 1 - 1e-4],
                    [size - 1 - 1e-3, size * 0.55]]
    m = base + rng.randn(68, 2) * 1.5
    a = base + rng.randn(68, 2) * 2.0
    b = base + rng.randn(68, 2) * 2.0
    if sliver:
        a[:4] = b[:4] = base[:4]            # the average keeps the slivers
    return m, a, b


def min_triangle_area(m, a, b, size=SIZE):
    from scipy.spatial import Delaunay

    anchors = jwarp.border_anchor_points(size)
    dst = np.concatenate([(a + b) / 2, anchors])
    t = dst[Delaunay(dst).simplices]
    u, v = t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    return np.abs(u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]).min() / 2


@pytest.mark.parametrize("seed,sliver", [(0, False), (1, False), (2, True), (3, True)])
def test_warp_to_average_landmarks_matches_jax(seed, sliver):
    m, a, b = landmark_sets(seed, sliver)
    if sliver:
        assert min_triangle_area(m, a, b) < 1e-2
    img = np.random.RandomState(seed + 10).rand(SIZE, SIZE, 3) * 255
    want = jwarp.warp_morph_to_average_landmarks(img, m, a, b)
    got = twarp.warp_morph_to_average_landmarks(torch.from_numpy(img), m, a, b)
    assert got.dtype == torch.float64 and tuple(got.shape) == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fill", [None, 17.0])
def test_piecewise_affine_warp_matches_jax(fill):
    """Points that leave part of the image outside every triangle."""
    rng = np.random.RandomState(4)
    img = rng.rand(40, 48, 2) * 255
    dst = rng.rand(30, 2) * [30, 24] + [8, 10]
    src = dst + rng.randn(30, 2)
    want = jwarp.piecewise_affine_warp(img, src, dst, fill=fill)
    got = twarp.piecewise_affine_warp(torch.from_numpy(img), src, dst, fill=fill).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(got[0, 0], img[0, 0] if fill is None else [fill, fill])


def test_anchor_points_and_the_csv_reader(tmp_path):
    np.testing.assert_array_equal(twarp.border_anchor_points(100),
                                  jwarp.border_anchor_points(100))
    path = tmp_path / "bad.csv"
    np.savetxt(path, np.ones((4, 3)), delimiter=",")
    with pytest.raises(ValueError, match="x,y"):
        twarp.load_landmarks_csv(str(path))


# ------------------------------------------------------------ warp_morphs

@pytest.fixture(scope="module")
def warp_inputs(tmp_path_factory):
    """A morph PNG and two bona fide PNGs, three landmark sets written by
    both packages' CSV writers."""
    root = tmp_path_factory.mktemp("warp")
    rng = np.random.RandomState(7)
    y, x = np.mgrid[0:SIZE, 0:SIZE]
    pngs = {}
    for name in ("pair_morph", "alice", "bob"):
        smooth = np.stack([np.sin(x / 5.0 + rng.rand()), np.cos(y / 7.0 + rng.rand()),
                           np.sin((x + y) / 9.0)], -1)
        img = np.clip(127.5 + 120 * smooth + rng.randn(SIZE, SIZE, 3) * 4, 0, 255)
        pngs[name] = str(root / f"{name}.png")
        write_png(pngs[name], img.astype(np.uint8))
    m, a, b = landmark_sets(8)
    csv = {}
    for side, mod in (("port", tlm), ("jax", jlm)):
        for key, pts in (("m", m), ("a", a), ("b", b)):
            csv[side, key] = str(root / f"{key}_{side}.csv")
            mod.save_landmarks_csv(csv[side, key], pts)
    return root, pngs, csv


def test_landmark_csv_files_are_byte_equal(warp_inputs):
    _, _, csv = warp_inputs
    for key in ("m", "a", "b"):
        with open(csv["port", key], "rb") as f, open(csv["jax", key], "rb") as g:
            assert f.read() == g.read()
    # A tensor is written as its array is.
    path = csv["port", "m"] + ".t"
    tlm.save_landmarks_csv(path, torch.from_numpy(twarp.load_landmarks_csv(csv["port", "m"])))
    with open(path, "rb") as f, open(csv["port", "m"], "rb") as g:
        assert f.read() == g.read()


def run_both(root, tag, flags_port, flags_jax):
    """Both entry points on the same flags; the port's outputs in JAX's order."""
    out_p, out_j = root / f"{tag}_port", root / f"{tag}_jax"
    cli.main(["warp_morphs"] + flags_port + ["--out", str(out_p), "--device", "cpu"])
    want = jwarp_morphs.run(jwarp_morphs.build_parser().parse_args(
        flags_jax + ["--out", str(out_j)]))
    names = [os.path.basename(w) for w in want]
    assert sorted(os.listdir(out_p)) == sorted(names)
    return [str(out_p / n) for n in names], want


def near_integer(values):
    return np.abs(values - np.rint(values)) < 1e-6


def test_warp_morphs_csv_and_batch_list_match_jax(warp_inputs):
    root, pngs, csv = warp_inputs
    flags = ["--morph", pngs["pair_morph"]]
    got, want = run_both(root, "csv",
                         flags + ["--landmarks-morph", csv["port", "m"], "--landmarks-a",
                                  csv["port", "a"], "--landmarks-b", csv["port", "b"]],
                         flags + ["--landmarks-morph", csv["jax", "m"], "--landmarks-a",
                                  csv["jax", "a"], "--landmarks-b", csv["jax", "b"]])
    assert [os.path.basename(p) for p in got] == ["pair_morph_warped.png"]
    # The morph twice in the list: the second output is de-duplicated.
    lists = {}
    for side in ("port", "jax"):
        lists[side] = str(root / f"list_{side}.txt")
        line = f"{pngs['pair_morph']},{csv[side, 'a']},{csv[side, 'b']},{csv[side, 'm']}\n"
        with open(lists[side], "w") as f:
            f.write(f"# morph,a,b,morph\n{line}\n{line}")
    got_b, want_b = run_both(root, "list", ["--batch-list", lists["port"]],
                             ["--batch-list", lists["jax"]])
    assert [os.path.basename(p) for p in got_b] == ["pair_morph_warped.png",
                                                     "pair_morph_001_warped.png"]

    img = np.asarray(Image.open(pngs["pair_morph"]).convert("RGB"), dtype=np.float32)
    lm = [jwarp.load_landmarks_csv(csv["jax", k]) for k in ("m", "a", "b")]
    exact = jwarp.warp_morph_to_average_landmarks(img, *lm)
    keep = ~near_integer(exact)
    assert keep.mean() > 0.9
    for g, w in zip(got + got_b, want + want_b):
        mine, theirs = read_png(g), np.asarray(Image.open(w))
        assert mine.shape == theirs.shape == (SIZE, SIZE, 3)
        np.testing.assert_array_equal(mine[keep], theirs[keep])
    # Two fields, or three without a predictor for the morph: refused, as in JAX.
    for body, match in (("a.png,b.csv\n", "bad batch line"),
                        (f"{pngs['pair_morph']},{csv['port', 'a']},{csv['port', 'b']}\n",
                         "--predict-landmarks")):
        bad = str(root / "bad.txt")
        with open(bad, "w") as f:
            f.write(body)
        with pytest.raises(SystemExit, match=match):
            cli.main(["warp_morphs", "--batch-list", bad, "--device", "cpu"])


@pytest.mark.parametrize("mode", ["images", "batch-list"])
def test_warp_morphs_with_predicted_landmarks_matches_jax(warp_inputs, mode):
    """--predict-landmarks: the port's landmark net against JAX's, and the
    port's output against JAX's warp on the port's landmarks (bit for bit
    away from integers); JAX's own output is at most one level away."""
    root, pngs, csv = warp_inputs
    if mode == "images":
        flags = {side: ["--morph", pngs["pair_morph"], "--img-a", pngs["alice"], "--img-b",
                        pngs["bob"]] for side in ("port", "jax")}
    else:       # three fields: the morph's landmarks predicted, a and b read
        flags = {}
        for side in ("port", "jax"):
            lst = str(root / f"list3_{side}.txt")
            with open(lst, "w") as f:
                f.write(f"{pngs['pair_morph']},{csv[side, 'a']},{csv[side, 'b']}\n")
            flags[side] = ["--batch-list", lst]
    got, want = run_both(root, f"predict_{mode}", flags["port"] + ["--predict-landmarks"],
                         flags["jax"] + ["--predict-landmarks"])

    def load(name):
        return np.asarray(Image.open(pngs[name]).convert("RGB"), dtype=np.float32)

    fn = jlm.make_landmark_fn(jlm.load_landmark_npz(jlm.bundled_landmark_path()),
                              temperature=0.05)
    predict = cli.landmark_predictor(device="cpu")
    lms = {}
    for name in ("pair_morph", "alice", "bob"):
        img = load(name)
        lm_j = np.asarray(fn(jnp.asarray(img[None] / 127.5 - 1.0)))[0] * np.asarray([SIZE, SIZE])
        lms[name] = predict(img)
        np.testing.assert_allclose(lms[name], lm_j, rtol=0, atol=2e-3)
    if mode == "images":
        lm_a, lm_b = lms["alice"], lms["bob"]
    else:
        lm_a, lm_b = (jwarp.load_landmarks_csv(csv["jax", k]) for k in ("a", "b"))
    exact = jwarp.warp_morph_to_average_landmarks(load("pair_morph"), lms["pair_morph"],
                                                  lm_a, lm_b)
    keep = ~near_integer(exact)
    mine = read_png(got[0])
    np.testing.assert_array_equal(mine[keep], np.clip(exact, 0, 255).astype(np.uint8)[keep])
    assert np.abs(mine.astype(int) - np.asarray(Image.open(want[0])).astype(int)).max() <= 1


# ------------------------------------------------------------ make_video

def gif_frames(path):
    im = Image.open(path)
    frames, durations = [], []
    for k in range(im.n_frames):
        im.seek(k)
        durations.append(im.info["duration"])
        frames.append(np.asarray(im.convert("RGB")).astype(int))
    return im, frames, durations


@pytest.mark.parametrize("fps", [24, 8])
def test_make_video_gif_matches_jax(tmp_path, fps):
    y, x = np.mgrid[0:48, 0:40]
    rng = np.random.RandomState(fps)
    frames = []
    for i in range(3):
        img = np.stack([(x * 5 + i * 30) % 256, (y * 4 + i * 11) % 256,
                        (x * y // 8 + rng.randint(0, 40, x.shape)) % 256], -1)
        frames.append(str(tmp_path / f"f{i:03d}.png"))
        write_png(frames[-1], img.astype(np.uint8))
    out = str(tmp_path / "port.gif")
    cli.main(["make_video", "--images", str(tmp_path), "--out", out, "--fps", str(fps)])
    jmake_video.write_video(jmake_video.collect_frames(images=str(tmp_path)),
                            str(tmp_path / "jax.gif"), fps)
    im, got, dur = gif_frames(out)
    jim, want, jdur = gif_frames(str(tmp_path / "jax.gif"))
    assert im.n_frames == jim.n_frames == 3 and im.size == jim.size == (40, 48)
    assert dur == jdur == [int(1000 / fps) // 10 * 10] * 3
    assert im.info["loop"] == jim.info["loop"] == 0
    for k, src in enumerate(frames):
        ref = read_png(src).astype(int)
        err, jerr = np.abs(got[k] - ref).mean(), np.abs(want[k] - ref).mean()
        assert err <= 1.5 * jerr, (k, err, jerr)


def test_make_video_list_and_mp4_fallback(tmp_path, capsys):
    rng = np.random.RandomState(1)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"g{i}.png"))
        write_png(paths[-1], rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    lst = tmp_path / "frames.txt"
    lst.write_text("\n".join(paths[::-1]) + "\n\n")
    assert video.collect_frames(list_file=str(lst)) == paths[::-1]
    cli.main(["make_video", "--list", str(lst), "--out", str(tmp_path / "clip.mp4")])
    out = capsys.readouterr().out
    assert f"mp4 backend unavailable (" in out and f"writing {tmp_path / 'clip.gif'}" in out
    im, frames, _ = gif_frames(str(tmp_path / "clip.gif"))
    assert im.n_frames == 2
    # Fewer than 256 colours: every pixel exact.
    np.testing.assert_array_equal(frames[0], read_png(paths[1]))


def test_lzw_fills_and_clears_its_table(tmp_path):
    """A frame of many colours: the code table fills and restarts."""
    img = np.random.RandomState(3).randint(0, 256, (96, 128, 3)).astype(np.uint8)
    path = str(tmp_path / "noise.gif")
    video.write_gif(path, [img, img[::-1]], 40)
    _, frames, _ = gif_frames(path)
    palette, idx = video.median_cut(img)
    np.testing.assert_array_equal(frames[0], palette[idx].astype(int))
    assert len(video.lzw_encode(idx.reshape(-1))) > 96 * 128   # 12-bit codes, clears


def test_non_png_frames_raise_by_name(tmp_path):
    """A frame the port does not read (a CMYK JPEG) raises by name."""
    path = tmp_path / "f.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("CMYK").save(path)
    with pytest.raises(ValueError, match="f.jpg"):
        cli.main(["make_video", "--images", str(tmp_path), "--out", str(tmp_path / "x.gif")])
