"""Checkpoints, resume, the GGN cache, the K-step launch and gradient
checkpointing of the port's nerfacto trainer, on the CPU.

Oracles: the JAX package's ``engine/checkpointing.py`` (file names, the GGN
cache's layout, read across packages in both directions) and its trainer
tests (``tests/test_trainer_multistep.py``: K steps a launch equal K single
steps, the writer and callback cadence, remat equal to the plain
backward). Everything here holds bit for bit: a checkpoint round trip, a
resumed run against the straight run, ``steps_per_launch`` K against K
single steps, and gradient checkpointing against the plain backward."""

import json

import numpy as np
import pytest
import torch

from test_cli import TINY_OVERRIDES
from torch_parity import small_config_kwargs
from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras, write_blender_dataset
from uncertainty_nerf_gs_torch.engine import checkpointing as tck
from uncertainty_nerf_gs_torch.engine import optimizers as topt
from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer
from uncertainty_nerf_gs_torch.models.laplace import LaplacePosterior as TPosterior
from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig
from uncertainty_nerf_gs_torch.ops import backend
from uncertainty_nerf_gs_torch.scripts import train as ttrain
from uncertainty_nerf_gs_tpu.engine import checkpointing as jck
from uncertainty_nerf_gs_tpu.models.laplace import LaplacePosterior as JPosterior

H, W, N = 10, 12, 3
DROPOUT = dict(dropout_rate=0.2, density_dropout_layers=(-1,), rgb_dropout_layers=(-1,))


def _trainer(**kw):
    cfg = NerfactoConfig(**small_config_kwargs(num_images=N, num_proposal_samples=(32, 16), num_nerf_samples=8,
                                               **kw.pop("config", {})))
    images = np.random.default_rng(0).uniform(size=(N, H, W, 3)).astype(np.float32)
    return NerfactoTrainer(cfg, hemisphere_cameras(N, H, W, seed=1), images, seed=3, use_camera_optimizer=True,
                           device="cpu", **kw)


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), path
    else:
        assert a == b, path


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's small CPU steps spend their time in thread hand-offs when
    the test workers share the cores; one intra-op thread for this module,
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- checkpoint files ---------------------------------------------------------------


def test_checkpoint_round_trips_trainer_state(tmp_path):
    """A trainer's whole state (parameters, Adam's moments and counts, the
    step and the generator) through a file bit for bit; the latest file by
    step number; ensembles member by member."""
    tr = _trainer()
    tr.train(2, 16)
    state = tr.state_dict()
    for step in (2, 10, 7):
        tck.save_checkpoint(tmp_path / "a", step, state)
    assert tck.latest_checkpoint(tmp_path / "a").name == "step-000000010.ckpt"
    loaded, step = tck.load_latest(tmp_path / "a")
    assert step == 10
    _assert_tree_equal(state, loaded)
    restored = _trainer()
    restored.restore(loaded)
    _assert_tree_equal(state, restored.state_dict())
    assert restored.train_step(16) == tr.train_step(16)
    tck.save_checkpoint(tmp_path / "b", 3, restored.state_dict())
    members = tck.load_ensemble_checkpoints([tmp_path / "a", tmp_path / "b"])
    assert [m["step"] for m in members] == [2, 3]
    assert tck.latest_checkpoint(tmp_path / "none") is None and tck.load_latest(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        tck.load_ensemble_checkpoints([tmp_path / "a", tmp_path / "none"])


def test_orbax_checkpoint_refused_with_converter_named(tmp_path):
    """The JAX package's orbax directory under the same name: the port
    says how to convert it and reads nothing."""
    path = jck.save_checkpoint(tmp_path, 5, {"params": {"w": np.arange(3.0)}, "step": np.int32(5)})
    assert tck.latest_checkpoint(tmp_path) == path
    with pytest.raises(ValueError, match="interop.trainer_state_from_jax"):
        tck.load_latest(tmp_path)


def test_resumed_cli_run_equals_straight_run(tmp_path):
    """``train.main`` on the CPU: 4 steps saved every 2, against 2 steps and
    a resume with ``--load-dir`` to 4; both at 2 steps a launch. The last
    checkpoints are equal bit for bit (parameters, moments, counts, step
    and generator)."""
    data = write_blender_dataset(tmp_path / "scene", num_train=3, num_test=1, height=12, width=12, device="cpu")
    common = ["active-nerfacto", "--data", str(data), "--steps-per-save", "2", "--log-every", "0",
              "--overrides", json.dumps(TINY_OVERRIDES), "--steps-per-launch", "2", "--device", "cpu"]
    straight = ttrain.main(common + ["--output-dir", str(tmp_path / "straight"), "--max-num-iterations", "4"])
    ttrain.main(common + ["--output-dir", str(tmp_path / "resumed"), "--max-num-iterations", "2"])
    resumed = ttrain.main(common + ["--output-dir", str(tmp_path / "resumed"), "--max-num-iterations", "4",
                                    "--load-dir", str(tmp_path / "resumed")])
    a, b = tck.load_latest(straight), tck.load_latest(resumed)
    assert a[1] == b[1] == 4 and a[0]["step"] == 4
    _assert_tree_equal(a[0], b[0])


# -- GGN cache ----------------------------------------------------------------------


def _jax_posterior(rng):
    def head(n_in, n_out):
        return {"kernel": rng.uniform(size=(n_in, n_out)).astype(np.float32),
                "bias": rng.uniform(size=(n_out,)).astype(np.float32)}

    return JPosterior(density_head=head(15, 1), rgb_head=head(16, 3))


def test_ggn_cache_reads_across_packages(tmp_path):
    """A cache the JAX package writes loads in the port as
    ``interop.laplace_posterior_from_jax`` of it, and a cache the port
    writes loads in the JAX package as ``laplace_posterior_to_jax`` of
    the port's, bit for bit, under the JAX file name."""
    rng = np.random.default_rng(0)
    jpost = _jax_posterior(rng)
    assert tck.load_ggn_cache(tmp_path / "j", 50) is None
    jck.save_ggn_cache(tmp_path / "j", 50, jpost)
    got = tck.load_ggn_cache(tmp_path / "j", 50)
    want = interop.laplace_posterior_from_jax(jpost)
    _assert_tree_equal(got._asdict(), want._asdict())

    tpost = interop.laplace_posterior_from_jax(_jax_posterior(rng))
    path = tck.save_ggn_cache(tmp_path / "t", 50, tpost)
    assert path == jck.ggn_cache_path(tmp_path / "t", 50)
    back = jck.load_ggn_cache(tmp_path / "t", 50, jpost)
    want = interop.laplace_posterior_to_jax(tpost)
    for head in ("density_head", "rgb_head"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(np.asarray(getattr(back, head)[leaf]), want[head][leaf])
    assert isinstance(got, TPosterior)


# -- the K-step launch ---------------------------------------------------------------


@pytest.mark.parametrize("config", [{}, DROPOUT], ids=["active-nerfacto", "mcdropout"])
def test_steps_per_launch_matches_single_steps(config):
    """7 steps at 3 a launch against 7 single steps: the losses, the whole
    state and the step bit for bit (the JAX package's
    test_multistep_matches_per_step_loop)."""
    t1, t3 = _trainer(config=config), _trainer(config=config)
    seen1, seen3 = [], []
    l1 = t1.train(7, 32, steps_per_launch=1, callback=lambda i, l: seen1.append(l))
    l3 = t3.train(7, 32, steps_per_launch=3, callback=lambda i, l: seen3.append(l))
    assert l1 == l3 and seen1 == seen3 and t1.step == t3.step == 7
    _assert_tree_equal(t1.state_dict(), t3.state_dict())


@pytest.mark.parametrize("steps,k", [(5, 5), (12, 5), (12, 1), (3, 50)])
def test_steps_per_launch_writer_and_callback_cadence(steps, k):
    """The JAX trainer's cadence at any K: the writer at step 1, every 10th
    and the last (its step numbers the trainer's), the callback after every
    step with the step's index (tests/test_trainer_multistep.py:67)."""
    records, seen = [], []

    class Writer:
        def write(self, step, scalars):
            records.append((step, dict(scalars)))

    tr = _trainer()
    tr.train(steps, 16, steps_per_launch=k, writer=Writer(), callback=lambda i, l: seen.append(i))
    assert seen == list(range(steps))
    assert [s for s, _ in records] == sorted({1, steps} | set(range(11, steps + 1, 10)))
    assert all(np.isfinite(list(r.values())).all() and "total_loss" in r for _, r in records)


def test_count_replays_adds_a_capture_per_replay():
    before = dict(backend.launch_counts)
    backend.count_replays({"pdf_resample": 2, "cell_lookup_fwd": 3}, 49)
    assert backend.launch_counts["pdf_resample"] == before["pdf_resample"] + 98
    assert backend.launch_counts["cell_lookup_fwd"] == before["cell_lookup_fwd"] + 147
    backend.launch_counts.update(before)


def test_device_schedule_matches_host_schedule():
    """The groups' lr computed on the device (float32) against the host's
    float64 schedule: warmup, decay, the final-lr bound, a rising rate and
    a constant one."""
    configs = [topt.OptimizerGroupConfig(lr=1e-2, lr_final=1e-4, max_steps=100, warmup_steps=20),
               topt.OptimizerGroupConfig(lr=1e-3, lr_final=1e-4, max_steps=50),
               topt.OptimizerGroupConfig(lr=1e-3, lr_final=1e-2, max_steps=50),
               topt.OptimizerGroupConfig(lr=5e-3, lr_final=5e-3, max_steps=0)]
    for cfg in configs:
        host = topt.exp_decay_schedule(cfg)
        for t in (0, 1, 19, 20, 21, 70, 119, 120, 500):
            got = float(topt.device_schedule(cfg, torch.tensor(t)))
            np.testing.assert_allclose(got, host(t), rtol=1e-6, atol=0)


# -- gradient checkpointing ------------------------------------------------------------


@pytest.mark.parametrize("config", [{}, DROPOUT], ids=["active-nerfacto", "mcdropout"])
def test_gradient_checkpointing_matches_plain_backward(config):
    """One step's gradients and two steps' weights with the forward
    recomputed in the backward, bit for bit against the plain backward (the
    JAX package's test_gradient_checkpointing_matches_plain_backward holds
    1e-6); with dropout the recompute replays the first run's masks."""
    plain, remat = _trainer(config=config), _trainer(config=config, gradient_checkpointing=True)
    for tr in (plain, remat):
        batch = tr.sample_batch(32)
        tr.optimizer.zero_grad(set_to_none=True)
        total, _ = tr._loss_fn(batch, tr.step)
        total.backward()
    for name, p in plain.params().items():
        assert torch.equal(p.grad, remat.params()[name].grad), name
    assert plain.train(2, 32) == remat.train(2, 32)
    _assert_tree_equal(plain.state_dict(), remat.state_dict())
