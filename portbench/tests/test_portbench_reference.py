"""The plain reference against the port's CPU path at tiny widths, on the
same seeded weights and draws."""


import torch

from portbench import harness, scene, weights
from portbench.drivers import nerfacto_train
from portbench.reference import ensemble as ref_ensemble
from portbench.reference import k1
from portbench.reference import nerfacto as ref
from portbench.tests import tiny

SEED = 2**31 + 77


def _trainer(cell):
    from uncertainty_nerf_gs_torch.engine.optimizers import OptimizerGroupConfig
    from uncertainty_nerf_gs_torch.engine.trainer import NerfactoTrainer

    cfg, tr = cell["config"], cell["traffic"]
    sc = nerfacto_train.training_views(tr, SEED, torch.device("cpu"))
    groups = {k: OptimizerGroupConfig(**v) for k, v in cfg["optimizer"].items()}
    trainer = NerfactoTrainer(harness.program_config(cfg["model"]), harness.program_cameras(sc),
                              images=sc["images"].numpy(), use_camera_optimizer=True, optimizer_groups=groups,
                              device="cpu")
    shapes = {k: tuple(v.shape) for k, v in trainer.params().items()}
    params = {k: v[0] for k, v in weights.draw(shapes, 1, cfg["table_scale"], 7, torch.device("cpu")).items()}
    trainer.restore({"params": params, "generator": torch.Generator().manual_seed(3).get_state()})
    return trainer, params, sc


def test_resampler_copy_equals_the_programs_plain_version():
    from uncertainty_nerf_gs_torch.ops.pdf_resample import resample_edges_reference

    g = torch.Generator().manual_seed(1)
    w = torch.rand(64, 256, generator=g) ** 4
    w[3] = 0.0
    e = torch.sort(torch.rand(64, 257, generator=g), dim=1).values
    u = torch.sort(torch.rand(64, 97, generator=g), dim=1).values
    assert torch.equal(k1.resample_edges(w, e, u), resample_edges_reference(w, e, u))


def test_training_step_loss_and_gradients():
    cell = tiny.cell("nerfacto-train")
    trainer, params, sc = _trainer(cell)
    cfg = cell["config"]
    state = trainer._generator.get_state()
    losses = []
    trainer.train(1, 32, steps_per_launch=4, callback=lambda i, row: losses.append(row["total_loss"]))
    grads = {k: v / 0.1 for k, v in trainer.state_dict()["opt_state"]["exp_avg"].items()}
    got = ref.train_steps(params, cfg["model"], cfg["optimizer"], sc, state, 1, 32)
    assert abs(got["losses"][0] - losses[0]) <= 1e-6 * abs(losses[0])
    for k, g in got["first_grad"].items():
        assert torch.allclose(g, grads[k], rtol=1e-4, atol=1e-6 * float(g.abs().max()) + 1e-12), k


def test_eval_forward_equals_the_programs():
    cell = tiny.cell("nerfacto-eval")
    trainer, params, sc = _trainer(tiny.cell("nerfacto-train"))
    cam, px, py, _ = harness.chunk_rays(sc, 1, 48, 0, torch.device("cpu"))
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays

    with torch.no_grad():
        want = trainer.model(generate_rays(trainer.cameras, cam, px, py), use_average_appearance=True)
        origins, dirs = ref.rays(sc["c2w"], sc["focal"], sc["cx"], sc["cy"], cam, px, py)
        got = ref.forward(params, cell["config"]["model"] | {"uncertainty_channels": 1}, origins, dirs, cam)
    for k in ("rgb", "accumulation", "depth", "expected_depth", "depth_var", "rgb_var"):
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k


def test_ensemble_chunk_equals_the_programs_fused_render():
    from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel
    from uncertainty_nerf_gs_torch.scripts.eval_uncertainty import build_ensemble_chunk_fn
    from uncertainty_nerf_gs_torch.cameras.cameras import generate_rays

    cell = tiny.cell("ensemble5-eval", members=3)
    cfg, tr = cell["config"], cell["traffic"]
    cams = scene.cameras(tr, 5, 1, torch.device("cpu"))
    model = NerfactoModel(harness.program_config(cfg["model"]), device=torch.device("cpu"))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    stacked = weights.draw(shapes, 3, cfg["table_scale"], 11, torch.device("cpu"))
    chunk_fn = build_ensemble_chunk_fn(model, stacked, table_dtype="bf16")
    cam, px, py, _ = harness.chunk_rays(cams, 2, 48, 1, torch.device("cpu"))
    want = chunk_fn(generate_rays(harness.program_cameras(cams), cam, px, py))
    origins, dirs = ref.rays(cams["c2w"], cams["focal"], cams["cx"], cams["cy"], cam, px, py)
    got = ref_ensemble.render_chunk(stacked, ref_ensemble.pack_ensemble(stacked, cfg["model"]), cfg["model"],
                                    origins, dirs)
    assert set(got) == set(want)
    for k in got:
        assert torch.allclose(got[k], want[k], rtol=1e-5, atol=1e-6), k
