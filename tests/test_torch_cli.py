"""The slice as a whole, on the CPU: runs trained by the JAX package's
``scripts.train.main`` on a tiny Blender tree are converted to port
checkpoints (``interop.trainer_state_from_jax`` and
``splat_trainer_state_from_jax``, here in test code only) and evaluated by
both packages' ``eval_uncertainty.main``: active-nerfacto, active-splatfacto,
a two-member ensemble (float32 tables, two hybrid runs trained with the
face-consistency loss at the default bf16 tables, and two corner runs,
which render per member), nerfacto-mcdropout and nerfacto-laplace. The metrics JSONs hold the same keys, the same
``approximations`` and values within ``CLI_METRIC_TOLS``
(tests/torch_parity.py). The port's ``train.main`` writes the same files and
keys as the JAX package's; the sparse-view parsers switch the nerfacto
family to the hybrid layout and the face-consistency loss as the JAX
package's do; hybrid and mlp-proposal parameters and trainer state convert
bit for bit both ways. tests/test_cli.py's pose-gradient maps and
tests/test_viewer.py's five cases run on the port's converted runs, and the
eval CLI's ``--save-rendered-images`` and ``--plot-ause`` in an interpreter
where PIL and matplotlib cannot be imported, as on the card's machine.

Each JAX run is a single save chunk: the JAX trainer restarts its key at
``seed + 1`` on every ``train`` call, the port's generator carries on, so
only a run's first chunk is comparable (ROADMAP section 3)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_cli import TINY_OVERRIDES, TINY_SPLAT_OVERRIDES
from torch_parity import CLI_METRIC_TOLS
from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.engine import checkpointing as tck
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as teval
from uncertainty_nerf_gs_torch.scripts import train as ttrain
from uncertainty_nerf_gs_tpu.data.synthetic import write_blender_dataset
from uncertainty_nerf_gs_tpu.engine import checkpointing as jck
from uncertainty_nerf_gs_tpu.scripts import eval_uncertainty as jeval
from uncertainty_nerf_gs_tpu.scripts import train as jtrain


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's small CPU steps spend their time in thread hand-offs when
    the test workers share the cores; one intra-op thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the sparse-view path's model: the hybrid layout (a dense level in the main
# field and in the proposal) and the face-consistency loss
HYBRID_OVERRIDES = dict(TINY_OVERRIDES, grid_layout="hybrid", face_consistency_mult=1.0, proposal_net_args=(
    dict(num_levels=2, max_res=32, log2_hashmap_size=10, hidden_dim=8),))
# the corner layout (tcnn's), two levels in the main field to keep the JAX
# package's corner lookup quick to compile on the CPU
CORNER_OVERRIDES = dict(TINY_OVERRIDES, grid_layout="corner", num_levels=2)
RUNS = {  # name -> (method, overrides, seed, steps)
    "active-nerfacto": ("active-nerfacto", TINY_OVERRIDES, 0, 3),
    "active-nerfacto-seed1": ("active-nerfacto", TINY_OVERRIDES, 1, 3),
    "hybrid": ("active-nerfacto", HYBRID_OVERRIDES, 0, 3),
    "hybrid-seed1": ("active-nerfacto", HYBRID_OVERRIDES, 1, 3),
    "corner": ("active-nerfacto", CORNER_OVERRIDES, 0, 3),
    "corner-seed1": ("active-nerfacto", CORNER_OVERRIDES, 1, 3),
    "nerfacto-mcdropout": ("nerfacto-mcdropout", TINY_OVERRIDES, 0, 3),
    "nerfacto-laplace": ("nerfacto-laplace", TINY_OVERRIDES, 0, 3),
    "active-splatfacto": ("active-splatfacto", TINY_SPLAT_OVERRIDES, 0, 3),
}
# eval case -> (runs, extra flags for both packages)
CASES = {
    "active-nerfacto": (["active-nerfacto"], []),
    "active-splatfacto": (["active-splatfacto"], ["--raster-capacity", "auto"]),
    "ensemble": (["active-nerfacto", "active-nerfacto-seed1"], ["--table-dtype", "f32"]),
    "ensemble-hybrid-bf16": (["hybrid", "hybrid-seed1"], []),  # the default tables, bf16
    "ensemble-corner": (["corner", "corner-seed1"], []),  # per member in either mode, as the JAX CLI routes it
    "nerfacto-mcdropout": (["nerfacto-mcdropout"], ["--mc-samples", "10"]),
    "nerfacto-laplace": (["nerfacto-laplace"], ["--laplace-iters", "3", "--laplace-samples", "100"]),
}


def _train_args(name, scene, out_dir):
    method, overrides, seed, steps = RUNS[name]
    return [method, "--data", str(scene), "--dataparser", "blender-data", "--output-dir", str(out_dir),
            "--max-num-iterations", str(steps), "--steps-per-save", str(steps), "--seed", str(seed),
            "--log-every", "0", "--overrides", json.dumps(overrides)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    write_blender_dataset(root, num_train=4, num_test=2, height=24, width=24)
    return root


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """name -> (the JAX run's dir, the converted port run's dir)."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for name in RUNS:
        jdir = jtrain.main(_train_args(name, scene, root / "jax" / name))
        run_cfg = json.loads((jdir / "config.json").read_text())
        trainer, spec, _ = jtrain.build_trainer(run_cfg["method"], run_cfg["data"], run_cfg["dataparser"],
                                                run_cfg["seed"], run_cfg["parser_kwargs"], run_cfg["overrides"])
        path = jck.latest_checkpoint(jdir)
        state = jck.load_checkpoint(path, target=trainer.state_dict())
        convert = (interop.splat_trainer_state_from_jax if spec.family == "splatfacto"
                   else interop.trainer_state_from_jax)
        tdir = root / "port" / name
        tdir.mkdir(parents=True)
        shutil.copy(jdir / "config.json", tdir / "config.json")
        tck.save_checkpoint(tdir, int(np.asarray(state["step"])), convert(state))
        out[name] = (jdir, tdir)
    return out


def _eval(module, dirs, extra, out_path, device=()):
    argv = [a for d in dirs for a in ("--load-config", str(d))] + ["--output-path", str(out_path), *extra]
    module.main(argv + list(device))
    return json.loads(Path(out_path).read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_eval_cli_matches_jax(runs, tmp_path, case):
    names, extra = CASES[case]
    jdirs = [runs[n][0] for n in names]
    tdirs = [runs[n][1] for n in names]
    want = _eval(jeval, jdirs, extra, tmp_path / "jax.json")
    if case == "nerfacto-laplace":  # the JAX package's GGN cache, read by the port
        shutil.copy(jck.ggn_cache_path(jdirs[0], 3), tck.ggn_cache_path(tdirs[0], 3))
    got = _eval(teval, tdirs, extra, tmp_path / "port.json", ("--device", "cpu"))
    assert set(got) == set(want)
    assert got["method_name"] == want["method_name"] and got["approximations"] == want["approximations"]
    assert set(got["results"]) == set(want["results"])
    tols = CLI_METRIC_TOLS[case]
    for k, v in want["results"].items():
        if k in ("num_rays_per_sec", "fps", "compile_and_first_render_sec"):
            continue  # host-clock times of two programs
        bar = tols.get(k, tols["default"])
        assert abs(got["results"][k] - v) <= bar["atol"] + bar["rtol"] * abs(v), (k, got["results"][k], v)


def test_train_cli_writes_the_jax_files(scene, runs, tmp_path):
    """The port's ``train.main --device cpu`` writes the JAX run's file set,
    the same ``config.json``, the same ``events.jsonl`` keys and loss
    names, and a checkpoint ``eval_uncertainty.main`` reads."""
    for name in ("active-nerfacto", "active-splatfacto"):
        jdir = runs[name][0]
        tdir = ttrain.main(_train_args(name, scene, tmp_path / name) + ["--device", "cpu"])
        assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
        cfg = json.loads((tdir / "config.json").read_text())
        assert cfg == {**json.loads((jdir / "config.json").read_text()), "data": cfg["data"]}
        assert json.loads((tdir / "config.yml").read_text()) == cfg

        def events(d):
            lines = [json.loads(line) for line in (d / "events.jsonl").read_text().splitlines()]
            return {tuple(sorted(r)) for r in lines}, sorted({r["name"] for r in lines}), sorted(
                {r["step"] for r in lines})

        assert events(tdir) == events(jdir)
        out = teval.main(["--load-config", str(tdir), "--output-path", str(tmp_path / f"{name}.json"),
                          "--device", "cpu"])
        assert np.isfinite(out["results"]["psnr"])


def test_eval_cli_refusals(runs, tmp_path):
    """What the port's eval CLI once refused now runs: ``--table-fold 2``
    (the JAX CLI refuses it for its TPU compiler's memory; a fold is a view
    here) gives the unfolded run's metrics bit for bit, and so does
    ``--table-split``; ``--table-dtype bf16`` is the default, and the JSON
    records it; a fold below 1 is refused."""
    dirs = [runs["active-nerfacto"][1], runs["active-nerfacto-seed1"][1]]
    base = _eval(teval, dirs, [], tmp_path / "base.json", ("--device", "cpu"))
    assert base["approximations"]["table_dtype"] == "bf16"
    for flags in (["--table-fold", "2"], ["--table-split"]):
        got = _eval(teval, dirs, flags, tmp_path / "m.json", ("--device", "cpu"))
        timing = ("num_rays_per_sec", "fps", "compile_and_first_render_sec")
        assert {k: v for k, v in got["results"].items() if k not in timing} == {
            k: v for k, v in base["results"].items() if k not in timing}, flags
    with pytest.raises(SystemExit):
        _eval(teval, dirs, ["--table-fold", "0"], tmp_path / "m.json", ("--device", "cpu"))


def test_sparse_parser_defaults_hybrid_facereg(scene, tmp_path):
    """tests/test_cli.py:471 on the port: a sparse-view parser switches the
    nerfacto family to the hybrid layout with ``face_consistency_mult`` 1.0,
    and an explicit ``grid_layout`` override stops the switch; the trainer
    then trains a step with the face-consistency loss."""
    meta = json.loads((scene / "transforms_train.json").read_text())
    root = tmp_path / "b100"
    (root / "train").mkdir(parents=True)
    first = Path(meta["frames"][0]["file_path"]).name + ".png"
    shutil.copy(scene / "train" / first, root / "train" / first)
    frames = [dict(meta["frames"][0]) for _ in range(100)]  # sparse-blender's permutations index 100
    (root / "transforms_train.json").write_text(json.dumps({"camera_angle_x": meta["camera_angle_x"],
                                                            "frames": frames}))
    kw = {"seed_name": "seed1", "num_images": 5}
    tr, _, _ = ttrain.build_trainer("nerfacto", root, "sparse-blender", parser_kwargs=kw,
                                    config_overrides=dict(TINY_OVERRIDES), device="cpu")
    assert tr.config.grid_layout == "hybrid" and tr.config.face_consistency_mult == 1.0
    assert np.isfinite(tr.train_step(16)["face_consistency_loss"])
    tr2, _, _ = ttrain.build_trainer("nerfacto", root, "sparse-blender", parser_kwargs=kw,
                                     config_overrides=dict(TINY_OVERRIDES, grid_layout="cell"), device="cpu")
    assert tr2.config.grid_layout == "cell" and tr2.config.face_consistency_mult == 0.0


@pytest.mark.parametrize("proposal", ["hash", "mlp"])
def test_hybrid_state_round_trips_jax(scene, proposal):
    """A JAX-built hybrid trainer (its main field's corner grids and hashed
    cells; an mlp or a hash proposal) with every leaf of its state dict
    drawn at random: ``trainer_state_from_jax``, the port's ``restore`` and
    ``state_dict``, and ``trainer_state_to_jax`` bring it back bit for bit,
    and ``params_to_jax`` of the port's parameters equals the flax tree."""
    import jax

    overrides = dict(HYBRID_OVERRIDES, proposal_field_type=proposal)
    jtr, _, _ = jtrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, overrides)
    ttr, _, _ = ttrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, overrides, device="cpu")
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(jtr.state_dict())
    leaves = [rng.normal(size=np.shape(x)).astype(np.float32) if np.asarray(x).dtype == np.float32
              else np.asarray(x) + 5 for x in leaves]
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    params = state["params"]
    assert any(k.startswith("corners_") for k in params["field"]["encoding"])
    assert ("encoding" in params["proposal_0"]) == (proposal == "hash")
    ttr.restore(interop.trainer_state_from_jax(state))
    back = interop.trainer_state_to_jax(ttr.state_dict(), like=state)
    got, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == treedef
    for a, b in zip(leaves, got):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    model_params = {k: v for k, v in ttr.params().items() if k != "camera_opt"}
    tree = interop.params_to_jax(model_params)
    want = {k: v for k, v in params.items() if k != "camera_opt"}
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a, b)


# -- the pose-gradient and viewer CLIs (tests/test_cli.py, tests/test_viewer.py) --


def test_pose_gradient_maps(runs, tmp_path):
    """tests/test_cli.py:233 on the port: 6-DoF pose-sensitivity maps of a
    run, (24, 24, 3, 6), finite and not all zero, the PNGs written through
    the port's codec, the intrinsics."""
    from uncertainty_nerf_gs_torch.data.png import read_png
    from uncertainty_nerf_gs_torch.scripts import pose_gradient

    pg_dir = tmp_path / "pg"
    pose_gradient.main(["--load-config", str(runs["active-nerfacto"][1]), "--output-dir", str(pg_dir),
                        "--camera-idx", "0", "--magnitude-trans", "0.01", "--direction", "0", "--chunk", "192",
                        "--device", "cpu"])
    jac = np.load(pg_dir / "jacobian_0.npy")
    assert jac.shape == (24, 24, 3, 6) and np.isfinite(jac).all() and np.abs(jac).sum() > 0
    assert np.load(pg_dir / "sensitivity_0.npy").shape == (24, 24)
    assert read_png(pg_dir / "sensitivity_0.png").shape == (24, 24)
    assert read_png(pg_dir / "render_0.png").shape == (24, 24, 3)
    assert set(json.loads((pg_dir / "intrinsics.json").read_text())) == {"fx", "fy", "cx", "cy"}


def _orbit_pose(center, radius, az=0.5, el=0.3):
    o = np.array(center) + radius * np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el), np.sin(el)])
    f = np.array(center) - o
    f /= np.linalg.norm(f)
    r = np.array([f[1], -f[0], 0.0])
    r /= max(np.linalg.norm(r), 1e-8)
    u = np.cross(r, f)
    return np.stack([r, u, -f, o], axis=1).astype(np.float32)


def test_viewer_state_renders_modes(runs):
    """tests/test_viewer.py:37 on the port."""
    from uncertainty_nerf_gs_torch.scripts.viewer import ViewerState

    state = ViewerState(runs["active-nerfacto"][1], downscale=2, device="cpu")
    info = state.info()
    assert "rgb" in info["modes"] and "depth" in info["modes"] and "rgb_std" in info["modes"]
    c2w = _orbit_pose(info["center"], info["radius"])
    outs = state.render_pose(c2w)
    assert outs["rgb"].shape == (info["height"], info["width"], 3)
    for k in info["modes"]:
        assert np.isfinite(outs[k]).all(), k
    assert state.render_png(c2w, "rgb")[:4] == b"\x89PNG"
    with pytest.raises(KeyError):
        state.render_png(c2w, "nope")


def test_viewer_http_roundtrip(runs):
    """tests/test_viewer.py:57 on the port: the page, /info, a depth frame
    as PNG, and a request without a pose answered 400."""
    import threading
    import urllib.error
    import urllib.request

    from uncertainty_nerf_gs_torch.scripts.viewer import ViewerState, serve

    state = ViewerState(runs["active-nerfacto"][1], downscale=2, device="cpu")
    server = serve(state, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert b"ut-viewer" in urllib.request.urlopen(base + "/", timeout=60).read()
        info = json.loads(urllib.request.urlopen(base + "/info", timeout=60).read())
        assert info["modes"][0] == "rgb"
        req = urllib.request.Request(base + "/render", headers={"content-type": "application/json"}, data=json.dumps(
            {"c2w": _orbit_pose(info["center"], info["radius"]).tolist(), "mode": "depth"}).encode())
        assert urllib.request.urlopen(req, timeout=120).read()[:4] == b"\x89PNG"
        bad = urllib.request.Request(base + "/render", data=json.dumps({"mode": "rgb"}).encode(),
                                     headers={"content-type": "application/json"})
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=60)
    finally:
        server.shutdown()
        server.server_close()


def test_viewer_state_ensemble(runs):
    """tests/test_viewer.py:92 on the port: two runs are a fused ensemble with
    the epistemic and aleatoric modes."""
    from uncertainty_nerf_gs_torch.scripts.viewer import ViewerState

    state = ViewerState([runs["active-nerfacto"][1], runs["active-nerfacto-seed1"][1]], downscale=2, device="cpu")
    info = state.info()
    assert info["num_members"] == 2 and "rgb_var_epi" in info["modes"]
    c2w = _orbit_pose(info["center"], info["radius"])
    outs = state.render_pose(c2w)
    assert outs["rgb"].shape == (info["height"], info["width"], 3) and np.isfinite(outs["rgb_var_epi"]).all()
    assert state.render_png(c2w, "rgb_var_epi")[:4] == b"\x89PNG"


def test_viewer_state_splat(runs):
    """tests/test_viewer.py:115 on the port: active-splatfacto's std map."""
    from uncertainty_nerf_gs_torch.scripts.viewer import ViewerState

    state = ViewerState(runs["active-splatfacto"][1], downscale=2, device="cpu")
    info = state.info()
    assert "uncertainty" in info["modes"]
    outs = state.render_pose(_orbit_pose(info["center"], info["radius"]))
    assert outs["rgb"].shape == (info["height"], info["width"], 3) and np.isfinite(outs["uncertainty"]).all()


def test_live_viewer_tracks_training(scene):
    """tests/test_viewer.py:130 on the port: the live viewer serves the
    current parameters (the reported step advances and the frame changes),
    and its lock is the trainer's launch lock."""
    import threading
    import urllib.request

    from uncertainty_nerf_gs_torch.scripts.viewer import LiveViewerState, serve

    trainer, spec, _ = ttrain.build_trainer("active-nerfacto", scene, "blender-data", 0, None, TINY_OVERRIDES,
                                            camera_opt="off", device="cpu")
    state = LiveViewerState(trainer, spec, downscale=2)
    assert trainer.launch_lock is state.lock
    info = state.info()
    assert info["step"] == 0
    c2w = _orbit_pose(info["center"], info["radius"])
    before = state.render_pose(c2w)["rgb"]
    server = serve(state, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        trainer.train(4, num_rays_per_batch=64, log_every=0)
        live = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/info",
                                                 timeout=60).read())
        assert live["step"] == 4
        after = state.render_pose(c2w)["rgb"]
        assert np.isfinite(after).all() and not np.allclose(before, after)
    finally:
        server.shutdown()
        server.server_close()


def test_train_cli_with_viewer_trains_as_without(scene, tmp_path):
    """``scripts.train.main --viewer-port`` serves the live viewer during the
    run (0 is off, as in the JAX package) and trains bit for bit as the same
    run without it, here two steps a launch."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["active-nerfacto", "--data", str(scene), "--dataparser", "blender-data", "--max-num-iterations", "4",
            "--steps-per-save", "2", "--steps-per-launch", "2", "--log-every", "0", "--overrides",
            json.dumps(TINY_OVERRIDES), "--device", "cpu"]
    plain = ttrain.main(args + ["--output-dir", str(tmp_path / "plain")])
    live = ttrain.main(args + ["--output-dir", str(tmp_path / "live"), "--viewer-port", str(port)])
    a, b = (tck.load_checkpoint(tck.latest_checkpoint(d)) for d in (plain, live))
    assert torch.equal(a["generator"], b["generator"]) and a["step"] == b["step"] == 4
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k


_NO_PIL_OR_MATPLOTLIB = """
import json, sys
sys.modules['PIL'] = None
sys.modules['matplotlib'] = None
from uncertainty_nerf_gs_torch.scripts import eval_uncertainty as ev
renders = []
build = ev.build_render_fn
def counting(*a, **k):
    fn = build(*a, **k)
    def render(i):
        renders.append(i)
        return fn(i)
    return render
ev.build_render_fn = counting
argv = json.loads(sys.argv[1])
try:
    ev.main(argv)
    print(json.dumps({"ok": True, "renders": len(renders)}))
except ImportError as e:
    print(json.dumps({"ok": False, "renders": len(renders), "error": str(e)}))
"""


def test_eval_images_and_plots_without_pil_or_matplotlib(runs, tmp_path):
    """The card's machine has neither PIL nor matplotlib: in an interpreter
    where both cannot be imported, ``--save-rendered-images`` writes its
    PNGs (the port's codec and jet table), and ``--plot-ause`` raises before
    the first render, naming matplotlib."""
    import subprocess
    import sys

    from uncertainty_nerf_gs_torch.data.png import read_png

    repo = Path(__file__).resolve().parents[1]

    def run(*flags):
        argv = ["--load-config", str(runs["active-nerfacto"][1]), "--output-path", str(tmp_path / "m.json"),
                "--render-output-path", str(tmp_path / "imgs"), "--device", "cpu", *flags]
        proc = subprocess.run([sys.executable, "-c", _NO_PIL_OR_MATPLOTLIB, json.dumps(argv)], cwd=repo,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    saved = run("--save-rendered-images")
    assert saved["ok"] and saved["renders"] > 0
    pngs = sorted((tmp_path / "imgs").glob("*.png"))
    assert {p.name for p in pngs} >= {"0_rgb_pred.png", "0_rgb_std.png", "1_rgb_unc_rank.png"}
    assert all(read_png(p).shape == (24, 24, 3) for p in pngs)
    plotted = run("--plot-ause")
    assert not plotted["ok"] and plotted["renders"] == 0 and "matplotlib" in plotted["error"]

