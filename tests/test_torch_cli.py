"""The slice as a whole, on the CPU: runs trained by the JAX package's
``scripts.train.main`` on a tiny Blender tree are converted to port
checkpoints (``interop.trainer_state_from_jax`` and
``splat_trainer_state_from_jax``, here in test code only) and evaluated by
both packages' ``eval_uncertainty.main``: active-nerfacto, active-splatfacto,
a two-member ensemble, nerfacto-mcdropout and nerfacto-laplace. The metrics
JSONs hold the same keys, the same ``approximations`` and values within
``CLI_METRIC_TOLS`` (tests/torch_parity.py). The port's ``train.main``
writes the same files and keys as the JAX package's.

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


RUNS = {  # name -> (method, overrides, seed, steps)
    "active-nerfacto": ("active-nerfacto", TINY_OVERRIDES, 0, 3),
    "active-nerfacto-seed1": ("active-nerfacto", TINY_OVERRIDES, 1, 3),
    "nerfacto-mcdropout": ("nerfacto-mcdropout", TINY_OVERRIDES, 0, 3),
    "nerfacto-laplace": ("nerfacto-laplace", TINY_OVERRIDES, 0, 3),
    "active-splatfacto": ("active-splatfacto", TINY_SPLAT_OVERRIDES, 0, 3),
}
# eval case -> (runs, extra flags for both packages)
CASES = {
    "active-nerfacto": (["active-nerfacto"], []),
    "active-splatfacto": (["active-splatfacto"], ["--raster-capacity", "auto"]),
    "ensemble": (["active-nerfacto", "active-nerfacto-seed1"], ["--table-dtype", "f32"]),
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
    """``--table-fold 2/4`` is refused as the JAX package refuses it; bf16
    and int8 packed tables are not ported (ROADMAP queue 1, item 7)."""
    dirs = [runs["active-nerfacto"][1], runs["active-nerfacto-seed1"][1]]
    with pytest.raises(SystemExit):
        _eval(teval, dirs, ["--table-fold", "2"], tmp_path / "m.json", ("--device", "cpu"))
    with pytest.raises(NotImplementedError, match="item 7"):
        _eval(teval, dirs, ["--table-dtype", "bf16"], tmp_path / "m.json", ("--device", "cpu"))
