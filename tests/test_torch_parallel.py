"""The port's mesh forms on the CPU (``parallel/mesh.py``,
``ensemble_parallel.py``, ``ensemble_fused.py``'s ``mesh=`` branch,
``splat_parallel.py``), held against the port's unsharded forms and the
JAX package's mesh forms at the same layout.

The port's ranks are processes of a ``torch.distributed`` gloo group, spawned
with ``torch.multiprocessing`` (tests/torch_mesh_worker.py, which imports
no JAX), meeting through a file under the test's temporary directory, and
each joined under a time limit of its own (``RANK_TIMEOUT_S``), so that a
hung collective fails its test and nothing else. The parent starts them all,
computes the JAX side on the conftest's virtual CPU devices meanwhile, and
reads what the ranks saved. Layouts: 2x1 and 1x2 ("data" x "member") for
every form, 2x2 for the train step and the fused render.

Bars. Against the port's unsharded forms only the order of the sums changes:
a train step's losses within MESH_LOSS_RTOL, its first moments within
MESH_MU_L2 and its parameters by ``check_step``'s Adam rule; the renders at
TOL, the splat bands at SPLAT_FWD_TOL (a band's offset subtracted from a
mean above the band rounds). Against JAX's mesh forms the unsharded parity
bars: TRAIN_LOSS_RTOL and CPU_TRAIN_GRAD_L2, OUTPUT_TOLS and MOMENT_TOL
(every ray: the tables are drawn at +-CELL_SCALE, where no sample of these
inputs lies within a last bit of a cell face), SPLAT_FWD_TOL.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_mesh_worker
from test_torch_ensemble import _compare, bundles
from test_torch_ensemble_train import GROUPS, H, N_CAMS, W, _batches, check_step
from torch_parity import (
    CPU_TRAIN_GRAD_L2,
    SPLAT_FWD_TOL,
    TOL,
    TRAIN_LOSS_RTOL,
    draw_params,
    jax_draws,
    small_config_kwargs,
)

from uncertainty_nerf_gs_tpu.data.synthetic import hemisphere_cameras as j_hemisphere
from uncertainty_nerf_gs_tpu.engine import optimizers as jopt
from uncertainty_nerf_gs_tpu.models import nerfacto as jnerf
from uncertainty_nerf_gs_tpu.ops import gaussians as jgauss
from uncertainty_nerf_gs_tpu.parallel import ensemble_fused as jef
from uncertainty_nerf_gs_tpu.parallel import ensemble_parallel as jpar
from uncertainty_nerf_gs_tpu.parallel import mesh as jmesh
from uncertainty_nerf_gs_tpu.parallel.splat_parallel import rasterize_gaussians_sharded as j_sharded

from uncertainty_nerf_gs_torch import interop
from uncertainty_nerf_gs_torch.data.synthetic import hemisphere_cameras as t_hemisphere
from uncertainty_nerf_gs_torch.engine import optimizers as topt
from uncertainty_nerf_gs_torch.models import nerfacto as tnerf
from uncertainty_nerf_gs_torch.ops.gaussians import Projection
from uncertainty_nerf_gs_torch.ops.rasterize import rasterize_gaussians
from uncertainty_nerf_gs_torch.parallel import ensemble_fused as tef
from uncertainty_nerf_gs_torch.parallel import ensemble_parallel as tpar
from uncertainty_nerf_gs_torch.parallel import mesh as tmesh

M, RAYS, STEP = 2, 32, 300
CELL_SCALE = 0.2
RANK_TIMEOUT_S = 120
# the port's mesh step against its one-rank step: only the gradients' and
# losses' sums over the shards change order (float32)
MESH_LOSS_RTOL = 1e-5
MESH_MU_L2 = 1e-4
# the small config cut to one proposal field of two levels: the JAX side
# traces a step at three layouts, so its size sets the file's time
MESH_CONFIG = small_config_kwargs(
    num_levels=2, num_proposal_samples=(16,), num_nerf_samples=8,
    proposal_net_args=(dict(num_levels=2, max_res=32, log2_hashmap_size=9, hidden_dim=16),))
LAYOUT_TASKS = {
    (2, 1): ("train", "render", "fused", "splat", "refuse"),
    (1, 2): ("train", "render"),
    (2, 2): ("train", "fused"),
}


def _ids(layout):
    return f"{layout[0]}x{layout[1]}"


def _np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _splat_scene(rng, n=80, w=64, h=48):
    """tests/test_splat.py's ``_random_scene`` (w x h, n Gaussians, a
    5-channel payload): the JAX projection, opacities and payload."""
    viewmat = jnp.eye(4, dtype=jnp.float32)
    means = jnp.asarray(np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n),
                                  rng.uniform(1.5, 4.0, n)], -1).astype(np.float32))
    scales = jnp.asarray(rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32))
    quats = jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32))
    proj = jgauss.project_gaussians(means, scales, quats, viewmat, 60.0, 60.0, w / 2, h / 2, w, h)
    opac = jnp.asarray(rng.uniform(0.2, 0.9, n).astype(np.float32)) * proj.compensation
    payload = jnp.asarray(rng.uniform(0.0, 1.0, (n, 5)).astype(np.float32))
    return proj, opac, payload, w, h


def _spawn(tmp_path, layout, payload_path):
    """Start the layout's ranks; returns (processes, output paths)."""
    ctx = mp.get_context("spawn")
    world = layout[0] * layout[1]
    tag = _ids(layout)
    outs = [str(tmp_path / f"out_{tag}_{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=torch_mesh_worker.run,
                         args=(r, world, str(tmp_path / f"rdzv_{tag}"), layout, str(payload_path), outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs


def _join(procs, outs, deadline) -> list[dict] | str:
    """Each rank joined under its own limit (the time left to ``deadline``,
    at most RANK_TIMEOUT_S): the ranks' results, or why there are none."""
    failed = None
    for r, p in enumerate(procs):
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            failed = failed or f"rank {r} did not finish within {RANK_TIMEOUT_S} s"
        elif p.exitcode != 0:
            failed = failed or f"rank {r} exited with {p.exitcode}"
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
    if failed:
        return failed
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every layout's ranks, the JAX side and the port's unsharded forms
    on the same inputs."""
    tmp_path = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(0)
    kw = MESH_CONFIG
    tcfg, jcfg = tnerf.NerfactoConfig(**kw), jnerf.NerfactoConfig(**kw)
    tmodel, jmodel = tnerf.NerfactoModel(tcfg, device="cpu"), jnerf.NerfactoModel(jcfg)
    like = interop.params_to_jax(tmodel.state_dict())
    trees = [draw_params(like, rng, cell_scale=CELL_SCALE) for _ in range(M)]
    jstacked = jax.tree_util.tree_map(lambda *xs: jnp.asarray(np.stack(xs)), *trees)
    tstacked = interop.ensemble_params_from_jax(_np_tree(jstacked))
    images = rng.uniform(0, 1, (N_CAMS, H, W, 3)).astype(np.float32)
    rows = np.stack([rng.integers(0, N_CAMS, RAYS), rng.integers(0, H, RAYS), rng.integers(0, W, RAYS)], axis=1)
    jb, tb = _batches(images, rows)
    key = jax.random.PRNGKey(5)
    draws = jax_draws(jcfg, key, RAYS, per_member=M)
    jrays, trays = bundles(rng, RAYS)
    splat = _splat_scene(rng)
    sproj = Projection(*(torch.from_numpy(np.array(x)) for x in splat[0]))
    payload = dict(config=kw, cameras=(N_CAMS, H, W), groups=GROUPS, step=STEP, stacked=tstacked, batch=tb,
                   draws=draws, rays=tuple(trays),
                   splat=dict(proj=tuple(sproj), opacities=torch.from_numpy(np.array(splat[1])),
                              payload=torch.from_numpy(np.array(splat[2])), width=splat[3], height=splat[4]))
    started = {}
    for layout, tasks in LAYOUT_TASKS.items():
        path = tmp_path / f"payload_{_ids(layout)}.pt"
        torch.save(dict(payload, tasks=tasks), path)
        started[layout] = _spawn(tmp_path, layout, path)
    deadline = time.monotonic() + RANK_TIMEOUT_S

    # the JAX mesh forms, at the same layouts, meanwhile
    tgroups = {k: topt.OptimizerGroupConfig(**v) for k, v in GROUPS.items()}
    tx = jopt.make_optimizer(jax.tree_util.tree_map(lambda x: x[0], jstacked),
                             {k: jopt.OptimizerGroupConfig(**v) for k, v in GROUPS.items()})
    jcams = j_hemisphere(N_CAMS, height=H, width=W, seed=1)
    jopt_state = jax.vmap(tx.init)(jstacked)
    jax_side = {}
    for layout, tasks in LAYOUT_TASKS.items():
        mesh = jmesh.make_mesh(*layout, devices=jax.devices()[:layout[0] * layout[1]])
        got = {}
        if "train" in tasks:
            step = jpar.build_ensemble_train_step(jmodel, jcfg, jcams, tx, mesh=mesh)
            params, opt_state, losses = step(jmesh.shard_members(jstacked, mesh),
                                             jmesh.shard_members(jopt_state, mesh),
                                             jmesh.shard_batch(jb, mesh), key, jnp.int32(STEP))
            got["train"] = dict(losses=np.asarray(losses), params=interop.ensemble_params_from_jax(_np_tree(params)),
                                mu=interop.opt_state_from_jax(_np_tree(opt_state))["exp_avg"])
        if "render" in tasks:
            out = jpar.build_ensemble_render(jmodel, mesh=mesh, parity_mode=False)(
                jmesh.shard_members(jstacked, mesh), jmesh.shard_batch(jrays, mesh))
            got["render"] = {k: np.asarray(v) for k, v in out.items()}
        if "fused" in tasks and layout == (2, 1):
            out = jef.build_fused_ensemble_render(jmodel, mesh=mesh)(
                jmesh.replicate(jstacked, mesh), jmesh.replicate(jef.pack_ensemble_tables(jmodel, jstacked), mesh),
                jmesh.shard_batch(jrays, mesh))
            got["fused"] = {k: np.asarray(v) for k, v in out.items()}
        if "splat" in tasks:
            img, alpha, _ = jax.jit(functools.partial(j_sharded, width=splat[3], height=splat[4], mesh=mesh,
                                                      capacity=128, tile_chunk=2, backend="xla"))(*splat[:3])
            got["splat"] = {"image": np.asarray(img), "alpha": np.asarray(alpha)}
        jax_side[layout] = got

    # the port's unsharded forms
    step = tpar.build_ensemble_train_step(tmodel, tcfg, t_hemisphere(N_CAMS, height=H, width=W, seed=1), tgroups,
                                          device="cpu")
    state = step.init(tstacked, step=STEP)
    losses = step(state, tb, draws=draws)
    single = dict(train=dict(losses=losses.numpy(), params=state.params, mu=state.moments["exp_avg"]),
                  render=tpar.build_ensemble_render(tmodel, parity_mode=False)(tstacked, trays),
                  fused=tef.build_fused_ensemble_render(tmodel)(tstacked, tef.pack_ensemble_tables(tmodel, tstacked),
                                                                trays))
    out = rasterize_gaussians(sproj, payload["splat"]["opacities"], payload["splat"]["payload"], splat[3], splat[4],
                              capacity=128)
    single["splat"] = {"image": out.image, "alpha": out.alpha, "max_overflow": out.max_overflow}
    ranks = {layout: _join(*started[layout], deadline) for layout in LAYOUT_TASKS}
    return dict(ranks=ranks, jax=jax_side, single=single, start=tstacked)


def _ranks(mesh_runs, layout):
    ranks = mesh_runs["ranks"][layout]
    assert not isinstance(ranks, str), ranks
    return ranks


def _assemble_train(ranks, layout):
    """The ranks' train results -> (M,) losses and the stacked parameters
    and first moments; the replicas along "data" equal bit for bit."""
    num_data, num_member = layout
    losses = ranks[0]["train"]["losses"]
    params, mu = {}, {}
    for r, res in enumerate(ranks):
        t = res["train"]
        assert torch.equal(t["losses"], losses), r
        replica = ranks[(r % num_member)]["train"]
        for k in t["params"]:
            assert torch.equal(t["params"][k], replica["params"][k]) and torch.equal(t["mu"][k], replica["mu"][k])
    for c in range(num_member):
        t = ranks[c]["train"]
        assert t["members"] == list(range(c * M // num_member, (c + 1) * M // num_member))
    for k in ranks[0]["train"]["params"]:
        params[k] = torch.cat([ranks[c]["train"]["params"][k] for c in range(num_member)])
        mu[k] = torch.cat([ranks[c]["train"]["mu"][k] for c in range(num_member)])
    return dict(losses=losses.numpy(), params=params, mu=mu)


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)], ids=_ids)
def test_mesh_train_step_matches_unsharded_and_jax(mesh_runs, layout):
    """``build_ensemble_train_step(mesh=)`` with members over "member" and
    rays over "data" (each rank its rows of the members' draws): the same
    losses on every rank, the replicas along "data" equal bit for bit, and
    ``check_step`` against the port's one-rank step (MESH_LOSS_RTOL,
    MESH_MU_L2) and against JAX's mesh step at the same layout
    (TRAIN_LOSS_RTOL, CPU_TRAIN_GRAD_L2)."""
    got = _assemble_train(_ranks(mesh_runs, layout), layout)
    check_step(got, mesh_runs["single"]["train"], mesh_runs["start"], 1, MESH_LOSS_RTOL, MESH_MU_L2)
    check_step(got, mesh_runs["jax"][layout]["train"], mesh_runs["start"], 1, TRAIN_LOSS_RTOL, CPU_TRAIN_GRAD_L2)


def _same_on_every_rank(ranks, task):
    first = ranks[0][task]
    for r in ranks[1:]:
        assert set(r[task]) == set(first) and all(torch.equal(r[task][k], first[k]) for k in first)
    return first


@pytest.mark.parametrize("layout", [(2, 1), (1, 2)], ids=_ids)
def test_mesh_render_matches_unsharded_and_jax(mesh_runs, layout):
    """``build_ensemble_render(mesh=)``: the members' outputs gathered over
    "member" before they combine, the rays over "data"; the same on every
    rank, at TOL from the unsharded render and at the parity bars from
    JAX's mesh render (parity_mode False: the combined variances)."""
    got = _same_on_every_rank(_ranks(mesh_runs, layout), "render")
    single = mesh_runs["single"]["render"]
    assert set(got) == set(single)
    for k, v in single.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
    want = mesh_runs["jax"][layout]["render"]
    _compare(want, {k: v.numpy() for k, v in got.items()}, np.zeros(RAYS, bool))


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)], ids=_ids)
def test_fused_render_mesh_matches_unsharded_and_jax(mesh_runs, layout):
    """``build_fused_ensemble_render(mesh=)``: rays over the whole mesh, the
    tables and parameters replicated (``replicate``), the outputs gathered;
    the same on every rank, at TOL from the unsharded render, and at the
    parity bars from JAX's (tests/test_ensemble_fused.py:528-546's oracle,
    its rays over a 2-device "data" axis)."""
    got = _same_on_every_rank(_ranks(mesh_runs, layout), "fused")
    single = mesh_runs["single"]["fused"]
    assert set(got) == set(single)
    for k, v in single.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **TOL)
    if layout == (2, 1):
        _compare(mesh_runs["jax"][layout]["fused"], {k: v.numpy() for k, v in got.items()}, np.zeros(RAYS, bool))


def test_rasterize_sharded_matches_single_and_jax(mesh_runs):
    """``rasterize_gaussians_sharded`` over 2 "data" ranks (tests/
    test_splat.py:509-530's oracle): image and alpha the same on both
    ranks, at SPLAT_FWD_TOL from the unsharded rasterization and from JAX's
    sharded one on the same JAX projection; the overflow all-reduced."""
    got = _same_on_every_rank(_ranks(mesh_runs, (2, 1)), "splat")
    single = mesh_runs["single"]["splat"]
    want = mesh_runs["jax"][(2, 1)]["splat"]
    assert got["image"].shape == single["image"].shape == want["image"].shape
    for k in ("image", "alpha"):
        np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), err_msg=k, **SPLAT_FWD_TOL)
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **SPLAT_FWD_TOL)
    assert int(got["max_overflow"]) == int(single["max_overflow"])
    assert float(got["alpha"].max()) > 0.5


def test_mesh_refuses_unequal_shards(mesh_runs):
    """A batch whose rows do not split into equal shards over "data" is
    refused on every rank: the gradient's mean over the shards is the
    batch's only over equal shards."""
    for res in _ranks(mesh_runs, (2, 1)):
        assert "equal shards" in res["refuse"]
    with pytest.raises(ValueError, match="equal shards"):
        tmesh.split_rows(torch.zeros(5, 2), 0, 2)


def test_make_mesh_without_cuda_raises(monkeypatch):
    """``device_type`` None is the card, as everywhere in the port; without
    a process group the mesh is refused too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh(1, 1, device_type="cpu")
