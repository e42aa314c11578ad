"""The port's data layer against the JAX package's, on the CPU: the ten
dataparsers and their split policies, the PNG codec, the datasets loaders,
the synthetic scene and its writers, the corruption harness, the method
registry and the dotted flags. Trees come from both packages' writers.
Bars (tests/torch_parity.py): the parsers, the numpy writers' poses and
points, the corruption noise and the flags exactly; the rendered scene
``SYNTHETIC_TOL``; the blur ``BLUR_ATOL``."""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import BLUR_ATOL, MIN_DEPTH_ACC, SYNTHETIC_TOL
from uncertainty_nerf_gs_torch.configs import flags as tflags
from uncertainty_nerf_gs_torch.configs import methods as tmethods
from uncertainty_nerf_gs_torch.data import corruption as tcr
from uncertainty_nerf_gs_torch.data import dataparsers as tdp
from uncertainty_nerf_gs_torch.data import datasets as tds
from uncertainty_nerf_gs_torch.data import png
from uncertainty_nerf_gs_torch.data import synthetic as tsyn
from uncertainty_nerf_gs_tpu.configs import flags as jflags
from uncertainty_nerf_gs_tpu.configs import methods as jmethods
from uncertainty_nerf_gs_tpu.data import corruption as jcr
from uncertainty_nerf_gs_tpu.data import dataparsers as jdp
from uncertainty_nerf_gs_tpu.data import datasets as jds
from uncertainty_nerf_gs_tpu.data import synthetic as jsyn

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's small CPU steps spend their time in thread hand-offs when
    the test workers share the cores; one intra-op thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- trees ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def blender_trees(tmp_path_factory):
    """The same Blender tree written by each package."""
    root = tmp_path_factory.mktemp("blender")
    jsyn.write_blender_dataset(root / "jax", num_train=8, num_test=3, height=32, width=32)
    tsyn.write_blender_dataset(root / "port", num_train=8, num_test=3, height=32, width=32, device="cpu")
    return {"jax": root / "jax", "port": root / "port"}


@pytest.fixture(scope="module")
def capture_trees(tmp_path_factory):
    """The same nerfstudio capture written by each package."""
    root = tmp_path_factory.mktemp("capture")
    jsyn.write_nerfstudio_dataset(root / "jax", num_frames=10, height=16, width=16)
    tsyn.write_nerfstudio_dataset(root / "port", num_frames=10, height=16, width=16, device="cpu")
    return {"jax": root / "jax", "port": root / "port"}


def _assert_outputs_equal(j, t):
    """A JAX and a port DataparserOutputs hold the same cameras, files, box,
    transform and metadata, exactly."""
    jc, tc = j.cameras, t.cameras
    for f in ("camera_to_worlds", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    assert (tc.width, tc.height, tc.camera_type) == (jc.width, jc.height, jc.camera_type)
    if jc.distortion_params is None:
        assert tc.distortion_params is None
    else:
        np.testing.assert_array_equal(tc.distortion_params.numpy(), np.asarray(jc.distortion_params))
    assert [str(p) for p in t.image_filenames] == [str(p) for p in j.image_filenames]
    assert [str(p) for p in t.depth_filenames or []] == [str(p) for p in j.depth_filenames or []]
    np.testing.assert_array_equal(t.scene_box, j.scene_box)
    assert t.dataparser_scale == j.dataparser_scale
    np.testing.assert_array_equal(t.dataparser_transform, j.dataparser_transform)
    assert (t.alpha_color is None) == (j.alpha_color is None)
    if j.alpha_color is not None:
        np.testing.assert_array_equal(t.alpha_color, j.alpha_color)
    assert set(t.metadata) == set(j.metadata)
    for k, v in j.metadata.items():
        np.testing.assert_array_equal(np.asarray(t.metadata[k]), np.asarray(v), err_msg=k)


def _capture_variant(src: Path, dst: Path, names, extra: dict | None = None) -> Path:
    """A capture tree whose frames are ``src``'s, repeated and renamed
    (``names``, one per frame; every file points at a copy of a real
    image), with ``extra`` merged into transforms.json."""
    meta = json.loads((src / "transforms.json").read_text())
    frames = meta["frames"]
    (dst / "images").mkdir(parents=True)
    out = []
    for i, name in enumerate(names):
        fr = dict(frames[i % len(frames)])
        fr["file_path"] = f"images/{name}"
        shutil.copy(src / frames[i % len(frames)]["file_path"], dst / "images" / name)
        out.append(fr)
    meta["frames"] = out
    meta.update(extra or {})
    shutil.copy(src / "sparse_pc.ply", dst / "sparse_pc.ply")
    (dst / "transforms.json").write_text(json.dumps(meta))
    return dst


def _variants(trees, tmp_path):
    """name -> (tree, parser kwargs) for the five capture-style parsers."""
    cap = trees["port"]
    frames = [f"frame_{i:05d}.png" for i in range(40)]
    robust = [f"{'train' if i % 3 else 'eval'}_{i:03d}.png" for i in range(12)]
    gotho = _capture_variant(cap, tmp_path / "onthego", [f"img_{i:03d}.png" for i in range(10)])
    (gotho / "split.json").write_text(json.dumps({"clutter": [f"img_{i:03d}.png" for i in range(0, 10, 2)],
                                                  "extra": [f"img_{i:03d}.png" for i in range(1, 10, 2)]}))
    return {
        "sparse-nerfstudio": (_capture_variant(cap, tmp_path / "sparse", frames), dict(scene="scene_079")),
        "sparse-mipnerf360": (_capture_variant(cap, tmp_path / "mip", frames[:20]),
                              dict(proportion_train_images=0.5)),
        "ood-mipnerf360": (_capture_variant(cap, tmp_path / "ood", frames[:20]), dict(scene="garden")),
        "robustnerf": (_capture_variant(cap, tmp_path / "robust", robust), dict(scene="crab")),
        "nerfonthego": (gotho, {}),
    }


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_parse_nerfstudio_matches_jax(capture_trees, writer, split):
    tree = capture_trees[writer]
    _assert_outputs_equal(jdp.parse_nerfstudio(tree, split), tdp.parse_nerfstudio(tree, split))


@pytest.mark.parametrize("name", ["sparse-nerfstudio", "sparse-mipnerf360", "ood-mipnerf360", "robustnerf",
                                  "nerfonthego"])
def test_capture_parsers_match_jax(capture_trees, tmp_path, name):
    tree, kw = _variants(capture_trees, tmp_path)[name]
    for split in ("train", "test"):
        j = jdp.DATAPARSERS[name](tree, split, **kw)
        _assert_outputs_equal(j, tdp.DATAPARSERS[name](tree, split, **kw))
        assert len(j.image_filenames) > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,kw", [
    ("blender-data", {}), ("hh-blender", {}), ("blender-downscale", {}),
    ("blender-downscale", dict(downscale_factor=2)), ("sparse-blender", dict(num_images=5)),
], ids=["blender-data", "hh-blender", "blender-downscale", "blender-downscale-2", "sparse-blender"])
def test_blender_parsers_match_jax(blender_trees, tmp_path, writer, name, kw):
    for split in ("train", "test"):
        # each package writes blender-downscale's copies into its own tree
        trees = {}
        for pkg in ("jax", "port"):
            trees[pkg] = tmp_path / f"{pkg}_{split}"
            shutil.copytree(blender_trees[writer], trees[pkg])
            if name == "sparse-blender":  # it assumes 100-frame sets: the frames repeated
                meta = json.loads((trees[pkg] / "transforms_train.json").read_text())
                meta["frames"] = [meta["frames"][i % 8] for i in range(100)]
                (trees[pkg] / "transforms_train.json").write_text(json.dumps(meta))
        j = jdp.DATAPARSERS[name](trees["jax"], split, **kw)
        t = tdp.DATAPARSERS[name](trees["port"], split, **kw)
        assert len(j.image_filenames) > 0
        _assert_outputs_equal(
            dataclasses.replace(j, image_filenames=[Path(str(p).replace("jax_", "port_")) for p in j.image_filenames],
                                depth_filenames=None if j.depth_filenames is None else [
                                    Path(str(p).replace("jax_", "port_")) for p in j.depth_filenames]), t)
        for a, b in zip(j.image_filenames, t.image_filenames):
            np.testing.assert_array_equal(tds.read_image(b), np.asarray(Image.open(a)))


def test_split_policies_match_jax():
    """Every split policy on its own inputs, exactly."""
    rng = np.random.default_rng(0)
    poses = rng.normal(size=(30, 3, 4))
    for n, frac in ((10, 0.9), (37, 0.5), (1, 0.9)):
        for a, b in zip(tdp.get_train_eval_split_fraction(n, frac), jdp.get_train_eval_split_fraction(n, frac)):
            np.testing.assert_array_equal(a, b)
    names = [f"{'train' if i % 2 else 'eval'}_{i}" for i in range(9)]
    for a, b in zip(tdp.get_train_eval_split_filename(names), jdp.get_train_eval_split_filename(names)):
        np.testing.assert_array_equal(a, b)
    for scene in tdp.SPARSE_NERFSTUDIO_SCENES:
        for a, b in zip(tdp.split_sparse_nerfstudio(scene), jdp.split_sparse_nerfstudio(scene)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tdp.split_sparse_mipnerf360(100, 0.3), jdp.split_sparse_mipnerf360(100, 0.3)):
        np.testing.assert_array_equal(a, b)
    for scene in ("garden", "room"):
        for a, b in zip(tdp.split_ood_mipnerf360(poses, scene), jdp.split_ood_mipnerf360(poses, scene)):
            np.testing.assert_array_equal(a, b)
    yoda = [f"clean_{i}" for i in range(6)] + [f"clutter_{i}" for i in range(6)] + ["extra_0", "extra_1"]
    for ratio in (0.0, 0.5, 1.0):
        for a, b in zip(tdp.split_robustnerf(yoda, "yoda", ratio), jdp.split_robustnerf(yoda, "yoda", ratio)):
            np.testing.assert_array_equal(a, b)
    other = [f"IMG_{1 + i % 2}{i:03d}" for i in range(25)]
    for scene in ("and-bot", "t_balloon_statue"):
        for a, b in zip(tdp.split_robustnerf(other, scene), jdp.split_robustnerf(other, scene)):
            np.testing.assert_array_equal(a, b)
    for seed in tdp.SPARSE_BLENDER_PERMS:
        np.testing.assert_array_equal(tdp.split_sparse_blender(seed, 7), jdp.split_sparse_blender(seed, 7))
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(tdp.split_hh_blender(poses, split), jdp.split_hh_blender(poses, split))
    np.testing.assert_array_equal(tdp._torch_randperm(17, 2023), jdp._torch_randperm(17, 2023))
    h = np.concatenate([poses, np.tile([[[0.0, 0, 0, 1]]], (30, 1, 1))], axis=1)
    for method, center in (("up", "poses"), ("up", "focus"), ("none", "none")):
        for a, b in zip(tdp.auto_orient_and_center_poses(h, method, center),
                        jdp.auto_orient_and_center_poses(h, method, center)):
            np.testing.assert_array_equal(a, b)


def test_auto_downscale_rule_matches_jax(tmp_path):
    """``_get_fname``'s auto rule reads the size from the PNG header."""
    (tmp_path / "images").mkdir()
    (tmp_path / "images_2").mkdir()
    for w, h in ((2000, 1400), (3118, 2078), (1600, 1200), (6500, 4000)):
        name = Path(f"images/p{w}.png")
        png.write_png(tmp_path / name, np.zeros((h, w), np.uint8))
        png.write_png(tmp_path / "images_2" / name.name, np.zeros((h // 2, w // 2), np.uint8))
        assert tdp._get_fname(name, tmp_path, None) == jdp._get_fname(name, tmp_path, None)


# -- PNG codec -------------------------------------------------------------------

MODES = {"L": (9, 13), "LA": (9, 13, 2), "RGB": (9, 13, 3), "RGBA": (9, 13, 4)}


@pytest.mark.parametrize("mode", [*MODES, "I;16"])
def test_png_reads_pil_files(tmp_path, mode):
    rng = np.random.default_rng(1)
    if mode == "I;16":
        arr = rng.integers(0, 65536, (9, 13)).astype(np.uint16)
        Image.fromarray(arr).save(tmp_path / "a.png")
    else:
        # smooth content, so that PIL's adaptive filters pick several types
        ramp = np.add.outer(np.arange(9), np.arange(13)) * 9 % 256
        arr = (ramp.reshape(9, 13, *([1] * (len(MODES[mode]) - 2)))
               + rng.integers(0, 3, MODES[mode])).astype(np.uint8)
        Image.fromarray(arr, mode).save(tmp_path / "a.png")
    want = np.asarray(Image.open(tmp_path / "a.png"))
    got = png.read_png(tmp_path / "a.png")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert png.png_size(tmp_path / "a.png") == (13, 9)


@pytest.mark.parametrize("mode", [*MODES, "I;16"])
def test_pil_reads_port_files(tmp_path, mode):
    rng = np.random.default_rng(2)
    if mode == "I;16":
        arr = rng.integers(0, 65536, (9, 13)).astype(np.uint16)
    else:
        arr = rng.integers(0, 256, MODES[mode]).astype(np.uint8)
    png.write_png(tmp_path / "a.png", arr)
    back = np.asarray(Image.open(tmp_path / "a.png"))
    assert np.array_equal(back, arr) and np.array_equal(png.read_png(tmp_path / "a.png"), arr)


def _filter_rows(raw: np.ndarray, bpp: int, kinds) -> bytes:
    """PNG-filter each row of ``raw`` (H, stride) with its kind in turn."""
    out, prev = [], np.zeros(raw.shape[1], np.int64)
    for y, row in enumerate(raw.astype(np.int64)):
        kind = kinds[y % len(kinds)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([kind]) + ((row - pred) & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decodes_every_filter(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth decode to the image, as
    PIL decodes them."""
    import struct
    import zlib

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (10, 7, channels)).astype(np.uint8)
    data = _filter_rows(img.reshape(10, -1), channels, [0, 1, 2, 3, 4])
    header = struct.pack(">IIBBBBB", 7, 10, 8, {1: 0, 2: 4, 3: 2, 4: 6}[channels], 0, 0, 0)
    path = tmp_path / "f.png"
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", header) + png._chunk(b"IDAT", zlib.compress(data))
                     + png._chunk(b"IEND", b""))
    want = img[..., 0] if channels == 1 else img
    assert np.array_equal(png.read_png(path), want)
    assert np.array_equal(np.asarray(Image.open(path)), want)
    del struct


def test_png_refuses_palette_and_datasets_name_missing_pil(tmp_path, monkeypatch):
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "a.jpg")
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"\.jpg images needs PIL"):
        tds.read_image(tmp_path / "a.jpg")


def test_load_images_match_jax(blender_trees, tmp_path):
    """``load_image`` composites RGBA over the alpha colour and repeats
    gray as JAX's does; ``load_images``/``load_depths``/``load_masks`` on a
    parsed split equal JAX's."""
    rng = np.random.default_rng(4)
    Image.fromarray(rng.integers(0, 256, (5, 6, 4)).astype(np.uint8), "RGBA").save(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 256, (5, 6)).astype(np.uint8)).save(tmp_path / "g.png")
    for name in ("a.png", "g.png"):
        for alpha in (None, np.zeros(3, np.float32)):
            np.testing.assert_array_equal(tds.load_image(tmp_path / name, alpha),
                                          jds.load_image(tmp_path / name, alpha))
    tree = blender_trees["port"]
    t = tdp.parse_blender(tree, "test", with_depth=True)
    j = jdp.parse_blender(tree, "test", with_depth=True)
    np.testing.assert_array_equal(tds.load_images(t), jds.load_images(j))
    np.testing.assert_array_equal(tds.load_depths(t), jds.load_depths(j))
    t.mask_filenames = j.mask_filenames = list(t.depth_filenames)
    np.testing.assert_array_equal(tds.load_masks(t), jds.load_masks(j))


# -- synthetic scene and writers ---------------------------------------------------


def test_render_ground_truth_matches_jax():
    """rgb and accumulation everywhere; the expected depth where the
    accumulation reaches ``MIN_DEPTH_ACC`` (it divides by it: below, a
    1e-7 difference in a weight moves it by more than the bar)."""
    jcams, jimgs, jdepths = jsyn.make_dataset(3, 12, 16)
    tcams, timgs, tdepths = tsyn.make_dataset(3, 12, 16, device="cpu")
    np.testing.assert_array_equal(tcams.camera_to_worlds.numpy(), np.asarray(jcams.camera_to_worlds))
    np.testing.assert_allclose(timgs, jimgs, **SYNTHETIC_TOL)
    for white in (True, False):
        for i in range(3):
            j = jsyn.render_ground_truth(jcams, i, num_samples=64 if i else 256, white_background=white)
            t = tsyn.render_ground_truth(tcams, i, num_samples=64 if i else 256, white_background=white,
                                         device="cpu")
            np.testing.assert_allclose(t[0], j[0], **SYNTHETIC_TOL)
            np.testing.assert_allclose(t[2], j[2], **SYNTHETIC_TOL)
            seen = j[2] >= MIN_DEPTH_ACC
            assert seen.sum() > 0.3 * seen.size
            np.testing.assert_allclose(t[1][seen], j[1][seen], **SYNTHETIC_TOL)
            if i == 0 and white:
                np.testing.assert_allclose(tdepths[i][seen], jdepths[i][seen], **SYNTHETIC_TOL)
    p = np.random.default_rng(5).uniform(-1, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tsyn.scene_density(torch.from_numpy(p)).numpy(),
                               np.asarray(jsyn.scene_density(p)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tsyn.scene_rgb(torch.from_numpy(p)).numpy(), np.asarray(jsyn.scene_rgb(p)),
                               **SYNTHETIC_TOL)


def test_writers_match_jax(blender_trees, capture_trees):
    """The same json, poses and points; images within one 8-bit step."""
    for trees, jsons in ((blender_trees, ["transforms_train.json", "transforms_test.json", "transforms_val.json"]),
                         (capture_trees, ["transforms.json"])):
        for name in jsons:
            assert json.loads((trees["port"] / name).read_text()) == json.loads((trees["jax"] / name).read_text())
        images = sorted(p.relative_to(trees["jax"]) for p in trees["jax"].rglob("*.png"))
        assert images == sorted(p.relative_to(trees["port"]) for p in trees["port"].rglob("*.png"))
        for rel in images:
            a = np.asarray(Image.open(trees["jax"] / rel)).astype(int)
            b = png.read_png(trees["port"] / rel).astype(int)
            if "depth" in rel.name:  # where the accumulation reaches MIN_DEPTH_ACC
                cams = tsyn.hemisphere_cameras(11, 32, 32)
                acc = tsyn.render_ground_truth(cams, 8 + int(rel.name.split("_")[1]), device="cpu")[2]
                a, b = a[acc >= MIN_DEPTH_ACC], b[acc >= MIN_DEPTH_ACC]
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, rel
    for name in ("sparse_pc.ply", "points_world.npy"):
        assert (capture_trees["port"] / name).read_bytes() == (capture_trees["jax"] / name).read_bytes()


# -- corruption ---------------------------------------------------------------------


def test_corruption_matches_jax(blender_trees, tmp_path):
    img = np.random.default_rng(6).integers(0, 256, (11, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tcr.add_gaussian_noise(img, 0.0, 0.1, np.random.default_rng(7)),
                                  jcr.add_gaussian_noise(img, 0.0, 0.1, np.random.default_rng(7)))
    for k in (3, 5, 7):
        np.testing.assert_allclose(tcr.add_gaussian_blur(img, k), jcr.add_gaussian_blur(img, k), rtol=0,
                                   atol=BLUR_ATOL)
    src = blender_trees["jax"] / "test"
    for op in ("noise", "blur"):
        done_t = tcr.process_images(src, tmp_path / f"t_{op}", op, std_dev=0.2, seed=0)
        done_j = jcr.process_images(src, tmp_path / f"j_{op}", op, std_dev=0.2, seed=0)
        assert done_t == done_j
        for name in done_t["train"] + done_t["eval"]:
            np.testing.assert_array_equal(png.read_png(tmp_path / f"t_{op}" / name),
                                          np.asarray(Image.open(tmp_path / f"j_{op}" / name)))
    tcr.main(["--input-folder", str(src), "--output-folder", str(tmp_path / "cli"), "--seed", "0"])
    assert sorted(p.name for p in (tmp_path / "cli").iterdir()) == sorted(p.name for p in src.iterdir()
                                                                           if p.suffix == ".png")


# -- configs ------------------------------------------------------------------------


def test_methods_match_jax():
    assert list(tmethods.METHODS) == list(jmethods.METHODS)
    for name, j in jmethods.METHODS.items():
        t = tmethods.get_method(name)
        for f in dataclasses.fields(j):
            if f.name == "model_config":
                assert dataclasses.asdict(t.model_config) == dataclasses.asdict(j.model_config), name
            else:
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    with pytest.raises(KeyError, match="unknown method"):
        tmethods.get_method("nope")


FLAG_CASES = [
    ["--model.beta-min", "0.02"],
    ["--pipeline.model.num-nerf-samples=32", "--model.use_appearance_embedding", "false"],
    ["--model.aabb", "[[-1, -1, -1], [1, 1, 1]]", "--model.camera-optimizer.mode", "off"],
    ["--model.proposal-net-args", '[{"num_levels": 3}]', "--model.background-color", "random"],
    ["--model.camera_optimizer.mode", "SO3xR3", "--model.density-dropout-layers", "[-1]"],
    ["--model.grid-layout", "cell", "--model.mixed-precision", "on"],
    ["--model.beta-min"],
    ["--model.nope", "1"],
    ["--bogus", "1"],
    ["--model.num-levels", "1.5"],
    ["--model.mixed-precision", "maybe"],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=[" ".join(a)[:40] for a in FLAG_CASES])
@pytest.mark.parametrize("method", ["active-nerfacto", "active-splatfacto"])
def test_parse_dotted_flags_matches_jax(argv, method):
    def run(flags, methods):
        try:
            return flags.parse_dotted_flags(argv, methods.get_method(method).model_config)
        except SystemExit as e:
            return ("SystemExit", str(e))

    assert run(tflags, tmethods) == run(jflags, jmethods)


# -- utils ----------------------------------------------------------------------------


def test_writer_and_images_match_jax(tmp_path):
    """``ScalarWriter`` writes the JAX writer's events.jsonl records (the
    wall clock aside) and history; ``Throughput``, ``to_u8`` and
    ``colorize`` give the JAX helpers' results; ``profile_trace`` writes a
    Chrome trace of the block."""
    from uncertainty_nerf_gs_torch.utils import images as timages
    from uncertainty_nerf_gs_torch.utils import writer as twriter
    from uncertainty_nerf_gs_tpu.utils import images as jimages
    from uncertainty_nerf_gs_tpu.utils import writer as jwriter

    records = {}
    for name, mod in (("jax", jwriter), ("port", twriter)):
        w = mod.ScalarWriter(tmp_path / name / "events.jsonl")
        w.write(1, {"loss": 0.5, "psnr": np.float32(20.25)})
        w.write(11, {"loss": 0.25})
        assert w.latest("loss") == 0.25 and w.latest("nope") is None
        w.close()
        records[name] = [{k: v for k, v in json.loads(line).items() if k != "wall"}
                         for line in (tmp_path / name / "events.jsonl").read_text().splitlines()]
        t = mod.Throughput()
        t.start()
        assert set(t.stop(100, 10, 10)) == {"num_rays_per_sec", "fps"}
    assert records["port"] == records["jax"]
    x = np.random.default_rng(8).normal(size=(6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(timages.to_u8(x), jimages.to_u8(x))
    for lo, hi in ((None, None), (0.0, 1.0)):
        np.testing.assert_array_equal(timages.colorize(x, lo, hi), jimages.colorize(x, lo, hi))
    with twriter.profile_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with twriter.profile_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()
