"""How far the port is from the JAX package on the parity tests' inputs.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py [nerfacto] [splat] [composite] [train] [ensemble]
        [splat_refine] [mcdropout] [laplace]

Each named section, or all eight. Nerfacto (tests/test_torch_model.py::test_model_eval_forward_matches_jax):
the rays whose lookups flipped a hash-grid cell between the port and JAX's
eager forward, then per output the largest absolute and relative deviation
on the other rays, beside the JAX package's own jit-vs-eager deviation.

Splat (tests/test_torch_splat_model.py): per render_splat output the largest
absolute deviation; the loss terms' relative deviations and each gradient's
largest deviation over its largest entry; and per trainer step the losses'
relative and the parameters' absolute deviations.

Composite (tests/test_torch_splat_ops.py::test_composite_matches_jax_pallas):
per case and per column family of the VJP, the largest entry, the largest
deviation, the elementwise misses of atol 1e-4 + rtol 1e-3, and each
float32 version's distance to a float64 evaluation.

Train (tests/test_torch_train.py::test_trainer_loss_and_grads_match_jax):
per case the loss terms' relative deviation and each gradient's relative L2
deviation from the jitted JAX trainer, the port's beside the JAX package's
own eager evaluation's.

Ensemble (tests/test_torch_ensemble.py::test_fused_render_matches_jax and
test_per_member_render_matches_jax): for the fused render (both proposal
stride settings) and the per-member render of three members, the rays that
flipped a cell, then per output the largest absolute and relative deviation
from JAX's jitted render on the other rays.

Splat refine (tests/test_torch_splat_refine.py::test_trainer_refines_like_jax):
per step of the run through two refines and an opacity reset, the loss
terms' largest relative deviation and, per parameter and per group's Adam
moments, the largest deviation as a share of its bar.

MC-dropout (tests/test_torch_mcdropout.py): the bf16 MLP's largest
deviation from flax's over the output's largest magnitude (the basis of
BF16_MLP_TOL), with and without dropout, beside the float32 MLP's; a
mixed_precision model's outputs against the JAX package's (the basis of
BF16_MODEL_TOL), beside both float32 models'; the MC
render's per-output deviations on the rays that kept their cells; and one
MC-dropout training batch's loss terms and gradients, the port's beside the
JAX package's own eager evaluation's.

Laplace (tests/test_torch_laplace.py): the diagonal GGN's largest deviation
per leaf over the leaf's largest entry (the basis of LAPLACE_GGN_TOL) for
both density activations, and ``laplace_render``'s per-output deviations.

The tolerances in tests/torch_parity.py are set from this report.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_model import _bundles, _flipped, _model_pair  # noqa: E402
from torch_parity import OUTPUT_TOLS, rays  # noqa: E402


def nerfacto() -> None:
    rng = np.random.default_rng(0)
    jmodel, tmodel, tree = _model_pair(rng, background_color="white")
    o, d, ci = rays(rng, 256)
    jb, tb = _bundles(o, d, ci)
    eager = jmodel.apply({"params": tree}, jb, train=True)
    jitted = jax.jit(lambda p, rb: jmodel.apply({"params": p}, rb))(tree, jb)
    t_all = tmodel(tb, return_intermediates=True)
    flipped = _flipped(jmodel.config, jb, eager["sdist_list"], tmodel, tb, t_all["sdist_list"])
    print(f"{flipped.sum()} of {flipped.size} rays flipped a cell (port vs JAX eager)")
    keep = ~flipped
    for k in OUTPUT_TOLS:
        want = np.asarray(eager[k]).reshape(256, -1)[keep]
        for name, other in (("port", t_all[k].numpy()), ("JAX jit", np.asarray(jitted[k]))):
            err = np.abs(other.reshape(256, -1)[keep] - want)
            rel = err / np.maximum(np.abs(want), 1e-12)
            print(f"{k:15s} {name:8s} max abs {err.max():.3e}  max rel {rel.max():.3e}")


def splat() -> None:
    import jax.numpy as jnp
    import torch

    import test_torch_splat_model as m

    rng = np.random.default_rng(0)
    for active in (False, True):
        for mode in ("moments", "indirection"):
            cfg_kw = m._config_kwargs(uncertainty_channels=int(active), depth_var_mode=mode)
            p, alive = m._params(rng, m.jsf.SplatfactoConfig(**cfg_kw))
            j_out, t_out = m._render_pair(p, alive, cfg_kw, background=np.float32([0.2, 0.5, 0.9]))
            dev = {k: float(np.abs(t_out[k].detach().numpy() - np.asarray(v)).max())
                   for k, v in j_out.items() if k not in ("visible", "raster_overflow")}
            print(f"render active={active} {mode}: " +
                  ", ".join(f"{k} {v:.2e}" for k, v in dev.items()))

    jcfg = m.jsf.SplatfactoConfig(**m._config_kwargs())
    p, alive = m._params(rng, jcfg)
    gt = rng.uniform(size=(m.H, m.W, 3)).astype(np.float32)

    def j_loss(params):
        out = m.jsf.render_splat(params, jnp.asarray(alive), jnp.asarray(m.C2W), *m.INTRINSICS,
                                 m.W, m.H, jcfg, sh_deg=1, background=jnp.ones(3))
        return m.jsf.splatfacto_loss(out, jnp.asarray(gt), params, jcfg)

    (j_total, j_losses), j_g = jax.value_and_grad(j_loss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tcfg = m.tsf.SplatfactoConfig(**m._config_kwargs())
    tp = {k: v.requires_grad_(True) for k, v in m.splat_params_from_jax(p).items()}
    out = m.tsf.render_splat(tp, torch.from_numpy(alive), torch.from_numpy(m.C2W), *m.INTRINSICS,
                             m.W, m.H, tcfg, sh_deg=1, background=torch.ones(3))
    total, losses = m.tsf.splatfacto_loss(out, torch.from_numpy(gt), tp, tcfg)
    total.backward()
    print("loss rel dev: " + ", ".join(
        f"{k} {abs(float(losses[k]) / float(j_losses[k]) - 1):.2e}" for k in losses))
    print("grad max dev / largest entry: " + ", ".join(
        f"{k} {float((tp[k].grad - torch.from_numpy(np.asarray(j_g[k]))).abs().max()) / float(np.abs(j_g[k]).max()):.2e}"
        for k in tp))

    jtr, ttr = m.trainer_pair()
    for step in range(2):
        j_l, t_l = jtr.train_step(jax.random.PRNGKey(1)), ttr.train_step()
        print(f"trainer step {step}: loss rel dev " + ", ".join(
            f"{k} {abs(t_l[k] / j_l[k] - 1):.2e}" for k in j_l))
        print(f"trainer step {step}: param max abs dev " + ", ".join(
            f"{k} {float(np.abs(ttr.params[k].detach().numpy() - np.asarray(v)).max()):.2e}"
            for k, v in jtr.params.items()))


def composite() -> None:
    import jax.numpy as jnp
    import torch

    import test_torch_splat_ops as o
    from torch_parity import PACKED_FAMILIES, SPLAT_GRAD_TOL, composite_vjp_float64

    for case in o.CASES:
        rng = np.random.default_rng(0)  # the tests' rng fixture
        packed, pix, counts = o._packed_case(rng, case)
        t, _, d = packed.shape
        g_img = rng.normal(size=(t, 256, d - 6)).astype(np.float32)
        g_alpha = rng.normal(size=(t, 256)).astype(np.float32)
        _, vjp = jax.vjp(lambda p: o.j_composite(p, jnp.asarray(pix), jnp.asarray(counts)),
                         jnp.asarray(packed))
        want = torch.from_numpy(np.asarray(vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))[0]))
        tp, tpix, tcount, tg_img, tg_alpha = (
            torch.from_numpy(x) for x in (packed, pix, counts, g_img, g_alpha))
        got = o.tc.composite_bwd(tp, tpix, tcount, *o.tc.composite_fwd(tp, tpix, tcount),
                                 tg_img, tg_alpha)
        exact = composite_vjp_float64(tp, tpix, tcount, tg_img, tg_alpha)
        print(f"composite VJP {case}, port against JAX Pallas (interpret):")
        for fam, cols in PACKED_FAMILIES.items():
            g, w, e = got[..., cols], want[..., cols], exact[..., cols]
            miss = int((~torch.isclose(g, w, **SPLAT_GRAD_TOL)).sum())
            print(f"  {fam:8s} largest {float(w.abs().max()):.3e}  max dev {float((g - w).abs().max()):.3e}"
                  f"  elementwise misses {miss}  port to float64 {float((g - e).abs().max()):.3e}"
                  f"  JAX to float64 {float((w - e).abs().max()):.3e}")


def train() -> None:
    from test_torch_train import train_loss_and_grads
    from torch_parity import grad_l2_error

    from torch_parity import WELL_CONDITIONED_DENSITY_SHIFT

    # the trainer test's two cases, then its well-conditioned one
    for case in (("zero", "white", 0.0), ("random", "last_sample", 0.0),
                 ("random", "white", WELL_CONDITIONED_DENSITY_SHIFT)):
        outputs = {}
        want, got, want_g, got_g, replaced = train_loss_and_grads(
            np.random.default_rng(0), *case[:2], density_shift=case[2], outputs=outputs)
        eager, _, eager_g, _, _ = train_loss_and_grads(
            np.random.default_rng(0), *case[:2], jit=False, density_shift=case[2])
        acc, var = outputs["accumulation"], outputs["rgb_var"]
        print(f"train {case}: {replaced} rays replaced for flipping a cell; accumulation median "
              f"{float(acc.median()):.3f}, min {float(acc.min()):.3f}; rgb_var min {float(var.min()):.2e}")
        for k in want:
            print(f"  {k:16s} port {abs(got[k] - want[k]) / abs(want[k]):.2e}  "
                  f"JAX eager {abs(eager[k] - want[k]) / abs(want[k]):.2e}")
        rows = sorted(((grad_l2_error(k, got_g[k], w), grad_l2_error(k, eager_g[k], w), k)
                       for k, w in want_g.items()), reverse=True)
        for port, jax_eager, k in rows[:8]:
            print(f"  {k:40s} relative L2: port {port:.2e}  JAX eager {jax_eager:.2e}")


def ensemble() -> None:
    import test_torch_ensemble as te

    stride_config = dict(
        num_proposal_samples=(64, 24),
        proposal_net_args=(dict(num_levels=2, max_res=8, log2_hashmap_size=9, hidden_dim=16),
                           dict(num_levels=2, max_res=16, log2_hashmap_size=9, hidden_dim=16)))
    cases = [("fused, anchor stride", dict(proposal_anchor_stride=True), stride_config),
             ("fused, exact", dict(proposal_anchor_stride=False), stride_config),
             ("per member", None, {})]
    for label, kw, over in cases:
        rng = np.random.default_rng(0)
        jmodel, tmodel, stacked, tstacked = te.ensemble_pair(**over)
        jb, tb = te.bundles(rng)
        if kw is None:
            want, got, j_sdist, t_sdist = te.per_member_pair(jmodel, tmodel, stacked, tstacked, jb, tb)
        else:
            want, got, j_sdist, t_sdist = te.fused_pair(jmodel, tmodel, stacked, tstacked, jb, tb, **kw)
            j_sdist, t_sdist = [j_sdist], [t_sdist]
        flipped = te.flipped_rays(jmodel, tmodel, jb, tb, j_sdist, t_sdist)
        print(f"ensemble {label}: {flipped.sum()} of {flipped.size} rays flipped a cell")
        keep = ~flipped
        for k in sorted(want):
            if np.ndim(want[k]) == 0:
                continue
            w = want[k].reshape(flipped.size, -1)[keep]
            err = np.abs(got[k].reshape(flipped.size, -1)[keep] - w)
            rel = err / np.maximum(np.abs(w), 1e-12)
            print(f"  {k:20s} max abs {err.max():.3e}  max rel {rel.max():.3e}")


def splat_refine() -> None:
    import test_torch_splat_refine as r

    for step, jtr, ttr, j_l, t_l in r.refining_run():
        dev = r.trainer_deviations(jtr, ttr)
        worst = sorted(dev.items(), key=lambda kv: -kv[1])[:3]
        loss = "" if j_l is None else "loss rel dev " + ", ".join(
            f"{k} {abs(t_l[k] / j_l[k] - 1):.2e}" for k in j_l if k != "num_alive") + "; "
        print(f"step {step}: {loss}largest shares of the bars " + ", ".join(f"{k} {v:.3f}" for k, v in worst))


def mcdropout() -> None:
    import test_torch_mcdropout as m
    from torch_parity import grad_l2_error

    for drops in ((), (-1,)):
        got, want, f32 = m.bf16_pair(np.random.default_rng(0), drops)
        scale = np.abs(want).max()
        print(f"bf16 MLP, dropout {drops}: port {np.abs(got.numpy() - want).max() / scale:.3e} of the output's "
              f"largest |y| {scale:.3f}; the float32 MLP {np.abs(f32 - want).max() / scale:.3e}")
    want, got, want32, got32, flipped = m.mixed_precision_pair(np.random.default_rng(0))
    print(f"mixed_precision model: {flipped.sum()} of {flipped.size} rays flipped a cell; on the others, the "
          "largest deviation from the JAX bf16 model over the output's largest |y| (basis of BF16_MODEL_TOL)")
    for k in sorted(OUTPUT_TOLS):
        w = want[k][~flipped]
        scale = np.abs(w).max()
        print(f"  {k:16s} port bf16 {np.abs(got[k][~flipped] - w).max() / scale:.3e}  JAX float32 "
              f"{np.abs(want32[k][~flipped] - w).max() / scale:.3e}  port float32 "
              f"{np.abs(got32[k][~flipped] - w).max() / scale:.3e}")
    want, got, flipped, *_ = m.mc_render_pair(np.random.default_rng(0))
    keep = ~flipped
    print(f"MC render: {flipped.sum()} of {flipped.size} rays flipped a cell")
    for k in sorted(want):
        if np.ndim(want[k]) == 0:
            continue
        w = want[k].reshape(flipped.size, -1)[keep]
        err = np.abs(got[k].numpy().reshape(flipped.size, -1)[keep] - w)
        print(f"  {k:20s} max abs {err.max():.3e}  max rel {(err / np.maximum(np.abs(w), 1e-12)).max():.3e}")
    want_t, got_t, want_g, ttr, _ = m.mc_trainer_pair(np.random.default_rng(0))
    eager_t, _, eager_g, _, _ = m.mc_trainer_pair(np.random.default_rng(0), jit=False)
    for k in want_t:
        print(f"  {k:16s} port {abs(got_t[k] - want_t[k]) / abs(want_t[k]):.2e}  "
              f"JAX eager {abs(eager_t[k] - want_t[k]) / abs(want_t[k]):.2e}")
    rows = sorted(((grad_l2_error(k, p.grad, want_g[k]), grad_l2_error(k, eager_g[k], want_g[k]), k)
                   for k, p in ttr.params().items()), reverse=True)
    for port, jax_eager, k in rows[:6]:
        print(f"  {k:40s} relative L2: port {port:.2e}  JAX eager {jax_eager:.2e}")


def laplace() -> None:
    import test_torch_laplace as lt

    from uncertainty_nerf_gs_torch import interop

    for activation in ("softplus", "trunc_exp"):
        got, want = lt.fit_pair(np.random.default_rng(0), activation)
        back = interop.laplace_posterior_to_jax(got)
        for head in ("density_head", "rgb_head"):
            for leaf in ("kernel", "bias"):
                w = np.asarray(getattr(want, head)[leaf])
                print(f"GGN ({activation}) {head}.{leaf}: max abs dev {np.abs(back[head][leaf] - w).max():.3e} "
                      f"= {np.abs(back[head][leaf] - w).max() / np.abs(w).max():.3e} of the largest entry")
    for case in (("white", False), ("last_sample", False), ("white", True)):
        want, got = lt.render_pair(np.random.default_rng(0), *case)
        print(f"laplace_render {case}: " + ", ".join(
            f"{k} {np.abs(got[k] - want[k]).max():.2e}" for k in sorted(want)))


def tables() -> None:
    """The eval tables (tests/test_torch_eval_tables.py): the bf16 and int8
    lookups' deviation from the JAX package's, relative to each level's
    largest entry; the fused render on bf16 and int8 tables against the JAX
    package's eager and jitted renders; and the face-consistency training
    batch (tests/test_torch_hybrid.py)."""
    import jax.numpy as jnp
    import test_torch_eval_tables as tt
    import test_torch_train as ttrain
    import torch
    from torch_parity import grad_l2_error

    from uncertainty_nerf_gs_tpu.ops import encodings as jenc
    from uncertainty_nerf_gs_tpu.parallel import ensemble_fused as jef
    from uncertainty_nerf_gs_torch.ops import encodings as tenc
    from uncertainty_nerf_gs_torch.parallel import ensemble_fused as tef

    for seed in range(4):
        rng = np.random.default_rng(seed)
        for _, m, feats, res, sizes in tt.LOOKUP_CASES:
            port, jrows = tt._level_rows(rng, m, feats, sizes)
            for dtype in ("bf16", "int8"):
                tp, tj = tt._packed_forms(port, jrows, dtype)
                pts = rng.uniform(0, 1, (150, 3)).astype(np.float32)
                want = np.asarray(jenc.packed_cell_lookup(tj, jnp.asarray(pts), res, sizes, m, feats), np.float32)
                got = tenc.packed_cell_lookup(tp, torch.from_numpy(pts), res, sizes, m, feats).numpy()
                scale = np.abs(want.reshape(-1, len(res), feats)).max(axis=(0, 2))
                dev = (np.abs(got - want).reshape(-1, len(res), feats).max(axis=(0, 2)) / scale).max()
                print(f"lookup {dtype} M={m} F={feats} seed {seed}: max deviation {dev:.3e} of a level's "
                      f"largest entry, {int((got != want).sum())} of {got.size} features differ")
    for seed in range(3):
        rng = np.random.default_rng(seed)
        jmodel, tmodel, stacked, tstacked = tt.ensemble_pair(**tt.HYBRID)
        jb, tb = tt.bundles(rng)
        jst = jax.tree_util.tree_map(jnp.asarray, stacked)
        for dtype in ("bf16", "int8"):
            packed = jef.pack_ensemble_tables(jmodel, jst, table_dtype=tt.JDTYPES[dtype])
            fn = jef.build_fused_ensemble_render(jmodel).__wrapped__
            eager, jitted = fn(jst, packed, jb), jax.jit(fn)(jst, packed, jb)
            with torch.no_grad():
                got = tef.build_fused_ensemble_render(tmodel)(
                    tstacked, tef.pack_ensemble_tables(tmodel, tstacked, table_dtype=dtype), tb)
            for k in ("rgb", "depth"):
                e, j, g = (np.asarray(x[k], np.float32) for x in (eager, jitted, got))
                print(f"fused {dtype} seed {seed} {k}: port against JAX eager {np.abs(g - e).max():.3e}, "
                      f"JAX jitted against its eager {np.abs(j - e).max():.3e}")
    result = ttrain.train_loss_and_grads(np.random.default_rng(0), "zero", "white",
                                         config=dict(grid_layout="hybrid", face_consistency_mult=1.0))
    want_terms, got_terms, want_grads, got_grads, replaced = result
    print(f"face-consistency batch: face loss {got_terms['face_consistency_loss']:.6e} against "
          f"{want_terms['face_consistency_loss']:.6e}; {replaced} rays replaced")
    rows = sorted(((grad_l2_error(k, got_grads[k], w), k) for k, w in want_grads.items()), reverse=True)
    for err, k in rows[:6]:
        print(f"  {k:40s} relative L2 {err:.2e}")


if __name__ == "__main__":
    sections = dict(nerfacto=nerfacto, splat=splat, composite=composite, train=train, ensemble=ensemble,
                    splat_refine=splat_refine, mcdropout=mcdropout, laplace=laplace, tables=tables)
    for name in sys.argv[1:] or sections:
        sections[name]()
