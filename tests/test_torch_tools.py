"""The port's render, pose-gradient and viewer CLIs and its image output, on
the CPU, against the JAX package on the same weights: the jet and viridis
tables against matplotlib, the eval's image writers against the JAX
package's (PIL and matplotlib) bit for bit, the PNG codec's bytes and the
GIF codec read back by PIL, the render CLI's path functions bit for bit and
its frames, the pose Jacobian, and the viewer's ``render_pose`` for each
mode against the JAX package's functions on a run the JAX package trained
(converted with ``interop.trainer_state_from_jax``, in test code only).

Inputs are drawn with numpy from a seed; the tolerances are
tests/torch_parity.py's, named at each test.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_cli import TINY_OVERRIDES
from torch_parity import GRID_GRAD_TOL, MAX_FLIPPED_RAY_SHARE, OUTPUT_TOLS
from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.cameras.cameras import Cameras as TCameras
from uncertainty_nerf_gs_torch.data import gif, png
from uncertainty_nerf_gs_torch.engine import checkpointing as tck
from uncertainty_nerf_gs_torch.eval import evaluator as teval
from uncertainty_nerf_gs_torch.scripts import pose_gradient as tpg
from uncertainty_nerf_gs_torch.scripts import render as trender
from uncertainty_nerf_gs_torch.scripts import viewer as tviewer
from uncertainty_nerf_gs_torch.utils import colormaps, images
from uncertainty_nerf_gs_tpu.cameras.cameras import Cameras as JCameras
from uncertainty_nerf_gs_tpu.data.synthetic import write_blender_dataset
from uncertainty_nerf_gs_tpu.engine import checkpointing as jck
from uncertainty_nerf_gs_tpu.eval import evaluator as jeval
from uncertainty_nerf_gs_tpu.scripts import pose_gradient as jpg
from uncertainty_nerf_gs_tpu.scripts import render as jrender
from uncertainty_nerf_gs_tpu.scripts import train as jtrain
from uncertainty_nerf_gs_tpu.scripts import viewer as jviewer
from uncertainty_nerf_gs_tpu.utils import images as jimages


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """One intra-op thread for this module's small CPU renders (the test
    workers share the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- colour tables and image writers -------------------------------------------


@pytest.mark.parametrize("name", ["jet", "viridis"])
def test_colormaps_match_matplotlib(rng, name):
    """The port's 256-entry tables, indexed as matplotlib indexes its own,
    give matplotlib's u8 colours bit for bit: float32 and float64 inputs,
    0, 1, each table step's edges and NaN (matplotlib's "bad" colour)."""
    import matplotlib

    cmap = matplotlib.colormaps[name]
    for dtype in (np.float32, np.float64):
        x = rng.uniform(0, 1, 5000).astype(dtype)
        x[:4] = [0.0, 1.0, np.nan, 0.5]
        x[4:260] = np.arange(256, dtype=dtype) / 256
        want = (cmap(x)[..., :3] * 255).astype(np.uint8)
        assert np.array_equal(colormaps.lookup(x, name), want)


def test_colorize_matches_jax(rng):
    """``utils/images.py::colorize`` (jet through the port's table) equals
    the JAX package's (matplotlib) bit for bit, with its own window and a
    pinned one, on a map and a channelled map."""
    for x in (rng.gamma(2.0, size=(20, 30)).astype(np.float32), rng.uniform(size=(20, 30, 3)).astype(np.float32)):
        assert np.array_equal(images.colorize(x), jimages.colorize(x))
        assert np.array_equal(images.colorize(x, 0.2, 0.8), jimages.colorize(x, 0.2, 0.8))
        assert np.array_equal(images.to_u8(x), jimages.to_u8(x))


def test_eval_image_writers_match_jax(rng, tmp_path):
    """``save_imgs_rgb`` and ``save_imgs_depth`` write, through the port's
    PNG codec and colour tables, the files the JAX package writes through
    PIL and matplotlib: the same names, decoded (by PIL) to the same
    bytes."""
    h, w = 14, 18
    rgb_gt, rgb_pred = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    std, err = rng.uniform(0, 0.3, (2, h, w)).astype(np.float32)
    d_gt, d_pred, d_std = rng.uniform(0.5, 3.0, (3, h, w)).astype(np.float32)
    for mod, out in ((teval, tmp_path / "port"), (jeval, tmp_path / "jax")):
        mod.save_imgs_rgb(out, 0, rgb_gt, rgb_pred, std, err, 0.0, 0.25)
        mod.save_imgs_depth(out, 0, d_gt, d_pred, d_std, np.abs(d_gt - d_pred))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names and len(names) == 10
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        assert np.array_equal(got, np.asarray(Image.open(tmp_path / "jax" / name))), name
        assert np.array_equal(png.read_png(tmp_path / "port" / name), got)


def test_png_bytes_read_back(rng):
    """``png_bytes`` (the viewer's) decodes, by PIL and by ``read_png`` from
    the bytes, to the image: RGB, gray and 16-bit gray."""
    import io

    for img in (rng.integers(0, 256, (9, 13, 3)).astype(np.uint8), rng.integers(0, 256, (9, 13)).astype(np.uint8),
                rng.integers(0, 65536, (9, 13)).astype(np.uint16)):
        data = png.png_bytes(img)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        assert np.array_equal(png.read_png(data), img)


def _pil_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return np.stack(frames), im.info.get("duration"), im.info.get("loop")


def test_gif_writer_read_by_pil(rng, tmp_path):
    """``write_gif``'s files decode by PIL to ``read_gif``'s frames; jet
    frames on the jet table's palette exactly, RGB frames on the uniform
    palette within ``UNIFORM_BOUND`` (25) a channel; the delay and the loop
    as written. A colour outside a given palette is refused."""
    rgb = [rng.integers(0, 256, (17, 23, 3)).astype(np.uint8) for _ in range(3)]
    jet = [colormaps.lookup(rng.uniform(size=(17, 23)), "jet") for _ in range(3)]
    for frames, palette, name in ((rgb, None, "rgb"), (jet, colormaps.TABLES["jet"], "jet")):
        path = tmp_path / f"{name}.gif"
        gif.write_gif(path, frames, 100, palette=palette)
        pil, duration, loop = _pil_frames(path)
        got, delays = gif.read_gif(path)
        assert np.array_equal(pil, got) and duration == 100 and loop == 0 and delays == [100] * 3
        err = np.abs(got.astype(int) - np.stack(frames).astype(int)).max()
        assert err == 0 if palette is not None else 0 < err <= gif.UNIFORM_BOUND
    with pytest.raises(ValueError, match="palette"):
        gif.write_gif(tmp_path / "x.gif", rgb, 100, palette=colormaps.TABLES["jet"])


# -- the render CLI's path functions --------------------------------------------


def _camera_pair(rng, n=5):
    c2w = np.concatenate([np.stack([trender._look_at(o, np.zeros(3)) for o in
                                    rng.normal(size=(n, 3)) * 2 + [0, 0, 1]])], 0)
    f = np.full((n,), 20.0, np.float32)
    j = JCameras(camera_to_worlds=jnp.asarray(c2w), fx=jnp.asarray(f), fy=jnp.asarray(f), cx=jnp.asarray(f / 2),
                 cy=jnp.asarray(f / 2), width=20, height=20)
    t = TCameras(camera_to_worlds=torch.from_numpy(c2w), fx=torch.from_numpy(f), fy=torch.from_numpy(f),
                 cx=torch.from_numpy(f / 2), cy=torch.from_numpy(f / 2), width=20, height=20)
    return j, t


def test_render_paths_match_jax(rng):
    """``_look_at`` (also looking along up), ``orbit_path`` and
    ``interpolate_path`` equal the JAX package's bit for bit."""
    for origin in (rng.normal(size=3), np.array([0.0, 0.0, 2.0])):
        assert np.array_equal(trender._look_at(origin, np.zeros(3)), jrender._look_at(origin, np.zeros(3)))
    jcams, tcams = _camera_pair(rng)
    for name in ("orbit_path", "interpolate_path"):
        for frames in (1, 7):
            want = getattr(jrender, name)(jcams, frames)
            got = getattr(trender, name)(tcams, frames)
            assert got.dtype == want.dtype and np.array_equal(got, want), (name, frames)


# -- the CLIs on a run the JAX package trained -----------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX run's dir, the converted port run's dir) of active-nerfacto
    trained 3 steps by the JAX package's CLI on a 24x24 Blender tree."""
    root = tmp_path_factory.mktemp("tools")
    scene = root / "scene"
    write_blender_dataset(scene, num_train=4, num_test=2, height=24, width=24)
    jdir = jtrain.main(["active-nerfacto", "--data", str(scene), "--dataparser", "blender-data", "--output-dir",
                        str(root / "jax"), "--max-num-iterations", "3", "--steps-per-save", "3", "--log-every", "0",
                        "--overrides", json.dumps(TINY_OVERRIDES)])
    trainer, _, _ = jtrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, TINY_OVERRIDES)
    state = jck.load_checkpoint(jck.latest_checkpoint(jdir), target=trainer.state_dict())
    tdir = root / "port"
    tdir.mkdir()
    shutil.copy(jdir / "config.json", tdir / "config.json")
    tck.save_checkpoint(tdir, int(np.asarray(state["step"])), interop.trainer_state_from_jax(state))
    return jdir, tdir


def _jet_index(frame):
    """Each pixel's index in the jet table (the first of equal colours)."""
    return gif._palette_indices(frame, colormaps.TABLES["jet"])


def test_render_cli_frames_match_jax(run, tmp_path):
    """``scripts.render.main`` against the JAX package's on the same weights,
    orbit, rgb, depth and rgb_std: the same files and trajectory; the rgb
    frames within 2 u8 levels and the jet frames within one table step on
    all but MAX_FLIPPED_RAY_SHARE of the pixels (a sample moved across a
    cell face changes a ray's output); the port's GIFs hold its PNG frames
    (``read_gif``: jet exactly, rgb within UNIFORM_BOUND)."""
    jdir, tdir = run
    argv = ["--traj", "orbit", "--num-frames", "2", "--outputs", "rgb", "depth", "rgb_std"]
    jout = jrender.main(["--load-config", str(jdir), "--output-dir", str(tmp_path / "jax"), *argv])
    tout = trender.main(["--load-config", str(tdir), "--output-dir", str(tmp_path / "port"), *argv, "--device", "cpu"])
    names = sorted(p.name for p in jout.iterdir())
    assert sorted(p.name for p in tout.iterdir()) == names
    assert json.loads((tout / "trajectory.json").read_text()) == json.loads((jout / "trajectory.json").read_text())
    for name in names:
        if not name.endswith(".png"):
            continue
        want = np.asarray(Image.open(jout / name))
        got = png.read_png(tout / name)
        assert got.shape == want.shape, name
        if name.startswith("rgb_0"):
            off = (np.abs(got.astype(int) - want.astype(int)) > 2).any(-1)
        else:
            off = np.abs(_jet_index(got) - _jet_index(want)) > 1
        assert off.mean() <= MAX_FLIPPED_RAY_SHARE, (name, off.mean())
    for key in ("rgb", "depth", "rgb_std"):
        frames, _ = gif.read_gif(tout / f"{key}.gif")
        pngs = np.stack([png.read_png(tout / f"{key}_{i:04d}.png") for i in range(2)])
        err = np.abs(frames.astype(int) - pngs.astype(int)).max()
        assert err <= (gif.UNIFORM_BOUND if key == "rgb" else 0), (key, err)


def test_pose_jacobian_matches_jax(run):
    """``pose_jacobian_render`` (three backward passes of per-ray tangent
    copies) against the JAX package's one ``jax.jacrev`` of each chunk, on
    the same weights, eval camera 0, a 0.01 translation: the (H, W, 3, 6)
    Jacobian within GRID_GRAD_TOL of its largest entry on all but
    MAX_FLIPPED_RAY_SHARE of the pixels, the perturbed render within
    OUTPUT_TOLS' rgb bar there, and the sensitivity map from the same
    formula."""
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _eval_cameras_and_images as t_cams
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import _load_run as t_load
    from uncertainty_nerf_gs_tpu.scripts.eval_uncertainty import _eval_cameras_and_images as j_cams
    from uncertainty_nerf_gs_tpu.scripts.eval_uncertainty import _load_run as j_load

    jdir, tdir = run
    jtr, _, jcfg, _ = j_load(jdir)
    params = {k: v for k, v in jtr.state.params.items() if k != "camera_opt"}
    tangent = tpg.get_perturbed_6dof_pose(0.01, 0.0, 0)
    want = jpg.pose_jacobian_render(lambda rb: jtr.model.apply({"params": params}, rb, train=False),
                                    j_cams(jcfg)[0].cameras, 0, jnp.asarray(tangent), 192)
    ttr, _, tcfg, _ = t_load(tdir, "cpu")
    with tpg.frozen(ttr.model):
        got = tpg.pose_jacobian_render(lambda rb: ttr.model(rb, train=False, with_grad=True), t_cams(tcfg)[0].cameras,
                                       0, torch.as_tensor(tangent), 192)
    assert got["jacobian"].shape == want["jacobian"].shape == (24, 24, 3, 6)
    scale = np.abs(want["jacobian"]).max()
    assert scale > 0
    off = (np.abs(got["jacobian"] - want["jacobian"]) > GRID_GRAD_TOL["atol"] * scale
           + GRID_GRAD_TOL["rtol"] * np.abs(want["jacobian"])).any(axis=(2, 3))
    assert off.mean() <= MAX_FLIPPED_RAY_SHARE, off.mean()
    rgb_off = ~np.isclose(got["rgb"], want["rgb"], **OUTPUT_TOLS["rgb"]).all(-1)
    assert rgb_off.mean() <= MAX_FLIPPED_RAY_SHARE
    assert np.allclose(got["sensitivity"][~off], np.linalg.norm(got["jacobian"].mean(axis=2), axis=-1)[~off])


def test_viewer_render_pose_matches_jax(run):
    """``ViewerState`` against the JAX package's on the same run: the same
    view size, intrinsics, orbit and modes; ``render_pose`` at an orbit
    pose within OUTPUT_TOLS on all but MAX_FLIPPED_RAY_SHARE of the pixels
    for each mode; ``render_png`` decodes to its image."""
    jdir, tdir = run
    jstate = jviewer.ViewerState(jdir, downscale=2)
    tstate = tviewer.ViewerState(tdir, downscale=2, device="cpu")
    ji, ti = jstate.info(), tstate.info()
    assert {k: ti[k] for k in ("method", "num_members", "step", "width", "height", "modes")} == {
        k: ji[k] for k in ("method", "num_members", "step", "width", "height", "modes")}
    assert np.allclose(ti["center"], ji["center"], atol=1e-5) and np.isclose(ti["radius"], ji["radius"], rtol=1e-6)
    c2w = trender._look_at(np.asarray(ji["center"]) + [1.5, 1.0, 1.2], np.asarray(ji["center"]))
    want, got = jstate.render_pose(c2w), tstate.render_pose(c2w)
    for mode in ti["modes"]:
        tol = OUTPUT_TOLS.get(mode, OUTPUT_TOLS["rgb"])
        off = ~np.isclose(got[mode], want[mode], **tol)
        off = off.reshape(off.shape[0], off.shape[1], -1).any(-1)
        assert off.mean() <= MAX_FLIPPED_RAY_SHARE, (mode, off.mean())
        data = tstate.render_png(c2w, mode)
        img = png.read_png(data)
        arr = tstate.render_pose(c2w)[mode]
        assert np.array_equal(img, images.to_u8(arr) if mode == "rgb" else images.colorize(arr, *tstate._windows[mode]))
