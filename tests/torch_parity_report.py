"""How far the port is from the JAX package on the parity tests' inputs.

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py [nerfacto] [splat] [composite] [train]

Each named section, or all four. Nerfacto (tests/test_torch_model.py::test_model_eval_forward_matches_jax):
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


if __name__ == "__main__":
    sections = dict(nerfacto=nerfacto, splat=splat, composite=composite, train=train)
    for name in sys.argv[1:] or sections:
        sections[name]()
