"""Parity of the port's splat ops against the JAX package, on the CPU:
projection, SH colors, tile counts, selection and pack, the tile compositor
(the JAX Pallas kernels in interpret mode against the port's plain versions,
which are what the CUDA kernels K2 and K3 are held to on the card), the
whole rasterizer and SSIM. Tolerances are stated in tests/torch_parity.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    PACKED_FAMILIES,
    SPLAT_FWD_ATOL,
    SPLAT_GRAD_TOL,
    TOL,
    composite_vjp_float64,
    grad_mismatch,
)

from uncertainty_nerf_gs_tpu.metrics import image_metrics as jmetrics
from uncertainty_nerf_gs_tpu.ops import gaussians as jg
from uncertainty_nerf_gs_tpu.ops import rasterize as jr
from uncertainty_nerf_gs_tpu.ops import sh as jsh
from uncertainty_nerf_gs_tpu.ops.rasterize_pallas import composite_tiles as j_composite

from uncertainty_nerf_gs_torch.metrics import image_metrics as tmetrics
from uncertainty_nerf_gs_torch.ops import composite as tc
from uncertainty_nerf_gs_torch.ops import gaussians as tg
from uncertainty_nerf_gs_torch.ops import rasterize as tr
from uncertainty_nerf_gs_torch.ops import sh as tsh

VIEWMAT = np.eye(4, dtype=np.float32)  # camera at the origin looking along +z
FOCAL = 50.0


def _gaussians(rng, n):
    """(means, scales, quats) in front of VIEWMAT, as numpy."""
    means = np.stack(
        [rng.uniform(-1.0, 1.0, n), rng.uniform(-0.8, 0.8, n), rng.uniform(1.5, 4.0, n)], -1
    ).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    return means, scales, quats


def _camera(w, h):
    return FOCAL, FOCAL, w / 2, h / 2, w, h


def _to_torch(proj: jg.Projection) -> tg.Projection:
    return tg.Projection(*(torch.from_numpy(np.array(x)) for x in proj))


def _scene(rng, n=60, w=64, h=48, opacity_mult=1.0):
    """A JAX Projection and (opacity, payload) as numpy: the rasterizer's
    inputs, shared by both packages so that selection compares exactly."""
    means, scales, quats = _gaussians(rng, n)
    proj = jg.project_gaussians(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(VIEWMAT),
        *_camera(w, h),
    )
    opac = rng.uniform(0.2, 0.9, n).astype(np.float32) * np.asarray(proj.compensation)
    opac = np.minimum(opac * opacity_mult, 0.995).astype(np.float32)
    payload = rng.uniform(0.0, 1.0, (n, 5)).astype(np.float32)
    return proj, opac, payload, w, h


def test_quat_to_rotmat_matches_jax(rng):
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q[0] = 0.0  # a dead slot
    want = np.asarray(jg.quat_to_rotmat(jnp.asarray(q)))
    got = tg.quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    s = rng.uniform(0.01, 0.5, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tg.scale_rot_to_cov3d(torch.from_numpy(s), torch.from_numpy(q)).numpy(),
        np.asarray(jg.scale_rot_to_cov3d(jnp.asarray(s), jnp.asarray(q))), **TOL,
    )


def test_project_gaussians_matches_jax(rng):
    means, scales, quats = _gaussians(rng, 200)
    means[:5, 2] = -1.0  # behind the camera
    means[5:10, 0] = 40.0  # outside the image
    w, h = 64, 48
    c2w = np.array([[0.9, 0.1, 0.0, 0.2], [-0.1, 0.9, 0.1, -0.1],
                    [0.0, -0.1, 1.0, 0.3], [0, 0, 0, 1]], np.float32)
    want = jg.project_gaussians(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                                jnp.asarray(c2w), *_camera(w, h))
    got = tg.project_gaussians(torch.from_numpy(means), torch.from_numpy(scales),
                               torch.from_numpy(quats), torch.from_numpy(c2w), *_camera(w, h))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 100 < got.valid.sum() <= 190  # the 10 behind or outside are culled
    for name in ("means2d", "depths", "conics", "radii", "compensation"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name, **TOL
        )


def test_collapsed_gaussian_grads_finite_and_match_jax():
    """A scale-collapsed Gaussian (det underflows float32) gets compensation
    0 with finite gradients, as the JAX package's safe sqrt gives
    (tests/test_splat.py:594), and the gradients equal jax.grad's."""
    means = np.array([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0]], np.float32)
    scales = np.array([[0.1, 0.1, 0.1], [1e-10, 1e-10, 1e-10]], np.float32)
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (2, 1))
    cam = _camera(64, 48)

    def j_loss(m, s, q):
        p = jg.project_gaussians(m, s, q, jnp.asarray(VIEWMAT), *cam)
        return jnp.sum(p.compensation * 0.7) + jnp.sum(p.means2d) + jnp.sum(p.conics)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (means, scales, quats)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (means, scales, quats)]
    p = tg.project_gaussians(*ts, torch.from_numpy(VIEWMAT), *cam)
    (p.compensation.sum() * 0.7 + p.means2d.sum() + p.conics.sum()).backward()
    comp = p.compensation.detach()
    assert float(comp[1]) == 0.0 and float(comp[0]) > 0.9
    for t, w in zip(ts, want):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    assert ts[1].grad[0].abs().sum() > 0


@pytest.mark.parametrize("degree", [1, 3, 4])
def test_eval_sh_colors_matches_jax(rng, degree):
    nb = (degree + 1) ** 2
    coeffs = rng.normal(size=(50, nb, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    for active in (None, 0, degree - 1):
        want = jsh.eval_sh_colors(degree, jnp.asarray(coeffs), jnp.asarray(dirs), active)
        got = tsh.eval_sh_colors(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs), active)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=str(active), **TOL)


def test_tile_hit_counts_exact(rng):
    proj, _, _, w, h = _scene(rng, n=150, w=70, h=50)
    want = jr.tile_hit_counts(proj, w, h)
    got = tr.tile_hit_counts(_to_torch(proj), w, h)
    np.testing.assert_array_equal(got.tile.numpy(), np.asarray(want.tile))
    np.testing.assert_array_equal(got.row.numpy(), np.asarray(want.row))
    assert got.tile.numpy().max() > 10


@pytest.mark.parametrize("capacity,row_capacity", [(128, None), (16, None), (32, 40)])
def test_select_and_pack_exact(rng, capacity, row_capacity):
    """The same rows, counts, overflows and pixel centers as the JAX
    package's gather pack, with and without truncation at either level."""
    proj, opac, payload, w, h = _scene(rng, n=150, w=70, h=50)
    want = jr.select_and_pack(proj, jnp.asarray(opac), jnp.asarray(payload), w, h,
                              capacity=capacity, tile_chunk=4, row_capacity=row_capacity)
    got = tr.select_and_pack(_to_torch(proj), torch.from_numpy(opac), torch.from_numpy(payload),
                             w, h, capacity=capacity, row_capacity=row_capacity)
    t = got.num_tiles
    assert t == want.num_tiles == 5 * 4
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed)[:t])
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts)[:t])
    np.testing.assert_array_equal(got.overflows.numpy(), np.asarray(want.overflows).reshape(-1)[:t])
    np.testing.assert_array_equal(got.pix.numpy(), np.asarray(want.pix)[:t])
    if capacity < 128:
        assert got.overflows.max() > 0


def _packed_case(rng, case):
    """Packed compositor inputs from the JAX package's own pack, as numpy.
    "saturated": 300 near-opaque Gaussians on 32x32 at capacity 512
    (tests/test_splat.py:471-483), crossing 128-row batches; "exit": a tile
    whose first 128 rows saturate every pixel, so that the saturation exit
    skips its last 172 live rows; "zero_count": tile 0 emptied;
    "one_channel": C = 1."""
    if case == "exit":
        packed = np.zeros((2, 384, 12), np.float32)
        pix = np.asarray(jr.select_and_pack(*_scene(rng, n=5, w=32, h=16),
                                            capacity=8, tile_chunk=4).pix)[:2]
        packed[0, :300, :2] = rng.uniform(4.0, 12.0, (300, 2))  # over tile 0
        packed[0, :300, 2] = packed[0, :300, 4] = 1e-3  # wide, round footprints
        packed[0, :300, 5] = rng.uniform(0.5, 0.99, 300)
        packed[0, :300, 6:] = rng.uniform(0.0, 1.0, (300, 6))
        return packed, pix, np.array([300, 0], np.int32)
    if case == "saturated":
        proj, opac, payload, w, h = _scene(rng, n=300, w=32, h=32, opacity_mult=20.0)
        cap = 512
    else:
        proj, opac, payload, w, h = _scene(rng, n=60)
        cap = 128
    if case == "one_channel":
        payload = payload[:, :1]
    sp = jr.select_and_pack(proj, jnp.asarray(opac), jnp.asarray(payload), w, h,
                            capacity=cap, tile_chunk=4)
    packed = np.array(sp.packed)
    counts = np.array(sp.counts)
    if case == "zero_count":
        counts[0] = 0
        packed[0] = 0.0
    return packed, np.asarray(sp.pix), counts


CASES = ["plain", "saturated", "exit", "zero_count", "one_channel"]


@pytest.mark.parametrize("case", CASES)
def test_composite_matches_jax_pallas(rng, case):
    """The plain forward and backward (the CPU branch of K2 / K3's wrappers)
    against the JAX Pallas kernels in interpret mode: values at atol 2e-5,
    the VJP at atol 1e-4, rtol 1e-3 (on the exit case, atol relative to the
    largest entry of each column family)."""
    packed, pix, counts = _packed_case(rng, case)
    t, _, d = packed.shape
    g_img = rng.normal(size=(t, 256, d - 6)).astype(np.float32)
    g_alpha = rng.normal(size=(t, 256)).astype(np.float32)
    (j_img, j_alpha), vjp = jax.vjp(
        lambda p: j_composite(p, jnp.asarray(pix), jnp.asarray(counts)), jnp.asarray(packed)
    )
    (j_g,) = vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))
    tp, tpix, tcount = (torch.from_numpy(x) for x in (packed, pix, counts))
    img, alpha = tc.composite_fwd(tp, tpix, tcount)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), atol=SPLAT_FWD_ATOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha), atol=SPLAT_FWD_ATOL)
    # the backward reads its per-pixel total from the forward's outputs
    g = tc.composite_bwd(tp, tpix, tcount, img, alpha, torch.from_numpy(g_img),
                         torch.from_numpy(g_alpha))
    if case == "exit":
        # the conic entries span 1e-8 to 1e2, and both float32 versions miss
        # a float64 evaluation of the largest by about 1e-3: each column
        # family is held relative to its own largest entry
        assert not grad_mismatch(g, torch.from_numpy(np.asarray(j_g)),
                                 families=PACKED_FAMILIES).any()
    else:
        np.testing.assert_allclose(g.numpy(), np.asarray(j_g), **SPLAT_GRAD_TOL)
    rows = tc.executed_rows(tp, tpix, tcount)
    if case == "saturated":
        assert float(alpha.max()) > 0.9999 and (tcount > 128).any()
    if case == "exit":
        assert rows.tolist() == [128, 0]
        assert float(g[0, 128:].abs().max()) == 0.0
    else:
        assert torch.equal(rows, tcount.long())
    if case == "zero_count":
        assert float(img[0].abs().max()) == 0.0 and float(g[0].abs().max()) == 0.0


def test_composite_vjp_matches_autograd(rng):
    """On unsaturated inputs the analytic backward equals torch autograd of
    the plain forward."""
    packed, pix, counts = _packed_case(rng, "plain")
    tp = torch.from_numpy(packed).requires_grad_(True)
    tpix, tcount = torch.from_numpy(pix), torch.from_numpy(counts)
    img, alpha = tc.composite_tiles_reference(tp, tpix, tcount)
    g_img = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32))
    g_alpha = torch.from_numpy(rng.normal(size=alpha.shape).astype(np.float32))
    (img * g_img).sum().add((alpha * g_alpha).sum()).backward()
    got = tc.composite_tiles_vjp_reference(tp.detach(), tpix, tcount, img.detach(),
                                           alpha.detach(), g_img, g_alpha)
    np.testing.assert_allclose(got.numpy(), tp.grad.numpy(), **SPLAT_GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_composite_vjp_total_from_outputs_matches_float64(rng, case):
    """The plain backward, its total taken from the float32 forward's
    outputs, against the same arithmetic in float64, each column family of
    g_packed relative to its own largest entry: where rows saturate, the
    suffix total - prefix cancels, and a total read from img and alpha
    rounds otherwise than a running sum of the same terms."""
    packed, pix, counts = _packed_case(rng, case)
    t, _, d = packed.shape
    tp, tpix, tcount = (torch.from_numpy(x) for x in (packed, pix, counts))
    g_img = torch.from_numpy(rng.normal(size=(t, 256, d - 6)).astype(np.float32))
    g_alpha = torch.from_numpy(rng.normal(size=(t, 256)).astype(np.float32))
    img, alpha = tc.composite_fwd(tp, tpix, tcount)
    got = tc.composite_bwd(tp, tpix, tcount, img, alpha, g_img, g_alpha)
    exact = composite_vjp_float64(tp, tpix, tcount, g_img, g_alpha)
    assert float(exact.abs().max()) > 0
    assert not grad_mismatch(got, exact, families=PACKED_FAMILIES).any()


@pytest.mark.parametrize("case", ["plain", "saturated", "exit"])
def test_composite_autograd_uses_saved_outputs(rng, case):
    """Autograd through composite_tiles gives, bit for bit, what
    composite_bwd gives with the forward's own img and alpha."""
    packed, pix, counts = _packed_case(rng, case)
    tp = torch.from_numpy(packed).requires_grad_(True)
    tpix, tcount = torch.from_numpy(pix), torch.from_numpy(counts)
    img, alpha = tc.composite_tiles(tp, tpix, tcount)
    g_img = torch.from_numpy(rng.normal(size=img.shape).astype(np.float32))
    g_alpha = torch.from_numpy(rng.normal(size=alpha.shape).astype(np.float32))
    torch.autograd.backward((img, alpha), (g_img, g_alpha))
    want = tc.composite_bwd(tp.detach(), tpix, tcount, img.detach(), alpha.detach(), g_img,
                            g_alpha)
    assert torch.equal(tp.grad, want)
    # other outputs give another gradient: the saved ones are what it read
    other = tc.composite_bwd(tp.detach(), tpix, tcount, img.detach() * 0.5,
                             alpha.detach() * 0.5, g_img, g_alpha)
    assert not torch.equal(tp.grad, other)


def test_rasterize_matches_jax_and_reference(rng):
    """rasterize_gaussians against JAX rasterize_gaussians(backend="pallas")
    and against the port's own rasterize_reference: values, and the
    gradients of the screen means, the opacity and the payload."""
    proj, opac, payload, w, h = _scene(rng, n=60)
    kw = dict(capacity=128)

    def j_loss(mu, op, pv):
        out = jr.rasterize_gaussians(proj._replace(means2d=mu), op, pv, w, h,
                                     backend="pallas", tile_chunk=4, **kw)
        return jnp.sum(out.image**2) + jnp.sum(out.alpha * 0.3), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(
        proj.means2d, jnp.asarray(opac), jnp.asarray(payload)
    )
    tproj = _to_torch(proj)
    ts = [x.clone().requires_grad_(True) for x in
          (tproj.means2d, torch.from_numpy(opac), torch.from_numpy(payload))]
    out = tr.rasterize_gaussians(tproj._replace(means2d=ts[0]), ts[1], ts[2], w, h, **kw)
    assert int(out.max_overflow) == int(j_out.max_overflow) == 0
    with torch.no_grad():
        ref_img, ref_alpha = tr.rasterize_reference(tproj, ts[1], ts[2], w, h)
    for got, want in ((out.image, j_out.image), (out.alpha, j_out.alpha),
                      (out.image, ref_img), (out.alpha, ref_alpha)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=SPLAT_FWD_ATOL)
    ((out.image**2).sum() + (out.alpha * 0.3).sum()).backward()
    for t, want, name in zip(ts, j_grads, ("means2d", "opacity", "payload")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), err_msg=name,
                                   **SPLAT_GRAD_TOL)
    # the oracle's own gradients (autograd through its cumprod)
    ref_ts = [t.detach().clone().requires_grad_(True) for t in ts]
    ref_img, ref_alpha = tr.rasterize_reference(tproj._replace(means2d=ref_ts[0]), *ref_ts[1:], w, h)
    ((ref_img**2).sum() + (ref_alpha * 0.3).sum()).backward()
    for t, r, name in zip(ts, ref_ts, ("means2d", "opacity", "payload")):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), err_msg=name,
                                   **SPLAT_GRAD_TOL)


def test_ssim_matches_jax(rng):
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    for x, y in ((a, b), (a, a), (b, np.full_like(b, 0.5))):
        want = float(jmetrics.ssim(jnp.asarray(x), jnp.asarray(y)))
        got = float(tmetrics.ssim(torch.from_numpy(x), torch.from_numpy(y)))
        assert got == pytest.approx(want, abs=2e-6)
