"""Shared inputs and rules for the port's parity tests (tests/test_torch_*.py)
and the tolerances chip_smoke.py holds the kernels to (it imports this module
on a machine without JAX, so JAX is imported only inside functions).

Inputs are drawn with numpy from a seed and handed to both packages as
arrays; weights are drawn by ``interop.draw_params`` at scales that give
peaked compositing weights. Tolerances:

* ``TOL`` (atol 2e-5, rtol 1e-4) is the repo's float32 bar, the JAX
  package's own Pallas-vs-XLA bar. It holds module by module.
* The composited outputs of a whole forward hold ``OUTPUT_TOLS``: rgb,
  accumulation and depth at atol 5e-4, rtol 2e-3; the second-moment outputs
  (expected depth, depth variance, rgb variance and their roots) at atol
  1e-3, rtol 1e-2. Sums are taken in another order in the two packages (MKL
  matmuls and torch.cumsum against XLA's), so densities differ in their last
  bits. The inverse-CDF resampler divides by a bin's CDF step, the 1/x
  spacing map multiplies an s-edge's error by 2 t^2, and the random tables
  (+-2 at res 256) have steep features, so a last-bit difference grows to
  about 1e-5 relative in the sample positions and more in the outputs. The
  JAX package's own jitted forward is further from its eager forward than
  the port is: on the model test's inputs (far plane 1000, the rays that
  did not flip between the port and JAX's eager forward) jit-vs-eager
  reaches 7e-3 absolute on rgb and 1e-1 relative on depth variance (its own
  cell flips included), the port 2.8e-4 and 2.2e-3. The report
  ``python tests/torch_parity_report.py`` prints these numbers.
* A ray one of whose samples crossed a hash-grid cell face between the two
  packages is not comparable: the cell layout stores each cell's corners on
  their own, so the features jump at the face by about the table's scale.
  ``lookup_cells_jax`` and ``NerfactoModel.lookup_cells`` find such rays
  exactly, from each package's own sample edges. Every other ray must meet
  ``OUTPUT_TOLS`` on every output; the flipped ones are counted and bounded by
  ``MAX_FLIPPED_RAY_SHARE``. The JAX package flips cells against itself
  too: its jitted and eager forwards order sums differently.
"""

from __future__ import annotations

import numpy as np

from uncertainty_nerf_gs_torch.interop import draw_params  # noqa: F401

TOL = dict(atol=2e-5, rtol=1e-4)
COMPOSITE_TOL = dict(atol=5e-4, rtol=2e-3)
MOMENT_TOL = dict(atol=1e-3, rtol=1e-2)
OUTPUT_TOLS = {
    "rgb": COMPOSITE_TOL,
    "accumulation": COMPOSITE_TOL,
    "depth": COMPOSITE_TOL,
    "expected_depth": MOMENT_TOL,
    "depth_var": MOMENT_TOL,
    "depth_std": MOMENT_TOL,
    "rgb_var": MOMENT_TOL,
    "rgb_std": MOMENT_TOL,
}
MAX_FLIPPED_RAY_SHARE = 0.1
# chip_smoke.py's render chunk and training step, kernel path against plain
# path at full width (4,096 rays over 256 -> 96 -> 48 samples, 26 levels,
# random tables +-2), hold no bar of flipped rays: K1 and K4 equal their
# plain versions bit for bit, so the two paths' forwards must be equal in
# every bit. Before that, a last-bit difference in a proposal's density or
# in the resampler's cdf moved samples across cell faces: 39 of 4,096 rays
# flipped in the render chunk (bar MAX_FLIPPED_RAY_SHARE) and 83 in the
# training step (bar 0.03; 1,526-1,555 while K1's plain version summed in
# another order; NVIDIA H100 80GB HBM3, 700.00 W).

# The splat path (tests/test_torch_splat_*.py and chip_smoke.py). The
# compositor's bars are the JAX package's own Pallas-vs-XLA bars
# (tests/test_splat.py:374-396): images and alphas atol 2e-5, gradients
# through the analytic backward atol 1e-4, rtol 1e-3; its suffix
# total - prefix cancels, and float32 sums in another order move it by more
# than the forward moves.
SPLAT_FWD_ATOL = 2e-5
SPLAT_FWD_TOL = dict(atol=SPLAT_FWD_ATOL, rtol=1e-4)
SPLAT_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# render_splat's outputs: depth_std = sqrt(depth_var) with depth_var floored
# at 1e-5, where sqrt's slope is 1 / (2 sqrt(1e-5)) = 158: depth_var's bar
# carried through the root
SPLAT_OUTPUT_TOLS = {"depth_std": dict(atol=SPLAT_FWD_ATOL / (2 * 1e-5**0.5), rtol=1e-4)}
# Loss terms and the parameters after two trainer steps, port against JAX:
# the report measures at most 1.3e-6 relative on the loss terms and 9.5e-7
# absolute on the parameters (opacity logits near -2), so these bars keep a
# margin of about ten.
SPLAT_LOSS_RTOL = 1e-5
SPLAT_STEP_PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
# Gradients whose magnitudes span decades are held to SPLAT_GRAD_TOL relative
# to the largest entry of their own family (grad_mismatch): each parameter's
# gradient is one family, and g_packed's columns form four, PACKED_FAMILIES.
# K3 and the plain backward sum each row over the tile's pixels in another
# order, and the suffix total - prefix magnifies the difference where it
# cancels, most in the conic entries, whose magnitudes reach 1e3 where the
# mean entries stay near 1e-2; a family's bar is therefore its own.
PACKED_FAMILIES = {
    "mean": slice(0, 2),
    "conic": slice(2, 5),
    "opacity": slice(5, 6),
    "payload": slice(6, None),
}
# The hash-grid lookup's backward (K5 on the card, autograd through the
# plain lookup elsewhere) sums each cell's contributions in another order:
# K5 in a fixed tree over the cell's lookups sorted by id. A cell of a
# coarse dense level takes hundreds of lookups, a hashed level's a few, so
# a cell gradient is held level by level against the largest entry of its
# own level, and the position gradient against its own largest entry, at
# the compositor backward's bar.
GRID_GRAD_TOL = SPLAT_GRAD_TOL
# One training batch's loss terms and gradients, port against JAX on the
# CPU and the kernel path against the plain path on the card, on the rays
# whose lookups stayed in their cells. Active-nerfacto's NLL divides by the
# rendered rgb variance, which two float32 orderings move by up to 1e-2
# relative on rays of low accumulation (MOMENT_TOL); with random weights
# such rays dominate the loss and its gradients. A gradient is held in
# relative L2 norm (``grad_l2_error``), a cell table level by level. A
# missing stop-gradient (the last-sample background's) moves the field's
# gradients by 30 times their norm. Numbers from ``python
# tests/torch_parity_report.py train`` (CPU) and chip_smoke.py (card):
# * TRAIN_GRAD_L2, the card's training check: while K4 differed from its
#   plain version in the last bits, the kernel path was 2.264e-2 from the
#   plain path (the main field's cells; bar 4.5e-2; before that 5.4e-2 to
#   8.6e-2, bar 2e-1). With K4 equal to its plain version the forwards are
#   the same and the bar measures K5 against autograd alone: 4.2e-6 to
#   4.8e-6 (proposal 0's cells; the main field's 3.2e-7 to 3.8e-7) on all
#   4,096 rays in six runs over four calls (NVIDIA H100 80GB HBM3,
#   700.00 W); it moves from run to run with the plain path's autograd
#   backward, as K5 repeats bit for bit. The bar keeps a margin of about 20.
# * CPU_TRAIN_GRAD_L2, the trainer test's two random-weight cases, port
#   against the jitted JAX gradients: up to 3.18e-2 (camera_opt of the
#   last-sample case; its field cells 2.31e-2; the other case 8.8e-3); the
#   JAX package's own eager gradients are 3.16e-2 from its jitted ones
#   there, so the bar keeps a margin of 1.6 over both.
# * WELL_CONDITIONED_TRAIN_GRAD_L2, the same test with every density head's
#   bias raised by WELL_CONDITIONED_DENSITY_SHIFT: accumulation 0.999 to 1,
#   rgb variances 0.035 and above, far off the 1e-6 floor; the port is up
#   to 1.41e-4 from JAX (camera_opt; JAX eager 1.25e-4). The bar keeps a
#   margin of about 7.
TRAIN_LOSS_RTOL = 5e-3
TRAIN_GRAD_L2 = 1e-4
CPU_TRAIN_GRAD_L2 = 5e-2
WELL_CONDITIONED_DENSITY_SHIFT = 6.0
WELL_CONDITIONED_TRAIN_GRAD_L2 = 1e-3


def grad_l2_error(name, got, want) -> float:
    """||got - want|| / ||want||, for a cell table (name ending in
    ``cells``, (L, ...)) the largest over its levels."""
    if name.endswith("cells"):
        return max(grad_l2_error("", g, w) for g, w in zip(got, want))
    scale = float(want.norm())
    return float((got - want).norm()) / scale if scale > 0 else float(got.norm())


def family_scale(want, families=None):
    """The largest ``|want|`` of each entry's family, broadcastable against
    ``want``: one family for the whole tensor, or one per named slice of its
    last dimension."""
    mag = want.abs()
    if families is None:
        return mag.amax()
    scale = mag.new_zeros(mag.shape[-1])
    for cols in families.values():
        scale[cols] = mag[..., cols].amax()
    return scale


def grad_mismatch(got, want, tol=SPLAT_GRAD_TOL, families=None):
    """Torch tensors -> bool tensor of entries where ``|got - want|`` exceeds
    ``atol * s + rtol * |want|``, s the largest ``|want|`` of the entry's
    family (``family_scale``). Where a saturated tile drives the suffix
    total - prefix to cancel, both float32 versions (the JAX kernel's and the
    port's) miss a float64 evaluation by about 1e-5 of the family's largest
    entry."""
    return (got - want).abs() > tol["atol"] * family_scale(want, families) + tol["rtol"] * want.abs()


def composite_vjp_float64(packed, pix, counts, g_img, g_alpha):
    """The plain compositor's VJP in float64, its total taken from the plain
    forward's float64 outputs: the witness both float32 versions are held
    beside. Torch tensors in, float32 (T, K, 6 + C) out."""
    from uncertainty_nerf_gs_torch.ops import composite as tc

    p64, pix64, gi64, ga64 = (x.double() for x in (packed, pix, g_img, g_alpha))
    img, alpha = tc.composite_tiles_reference(p64, pix64, counts)
    return tc.composite_tiles_vjp_reference(p64, pix64, counts, img, alpha, gi64, ga64).float()


def small_config_kwargs(**overrides) -> dict:
    """A small active-nerfacto config: 4 main levels at 2^10 (levels with
    res^3 > 1024 are hashed), two 3-level proposal fields."""
    kw = dict(
        uncertainty_channels=1,
        num_images=3,
        num_levels=4,
        max_res=256,
        log2_hashmap_size=10,
        background_color="white",
        proposal_net_args=(
            dict(num_levels=3, max_res=64, log2_hashmap_size=10, hidden_dim=16),
            dict(num_levels=3, max_res=128, log2_hashmap_size=10, hidden_dim=16),
        ),
    )
    kw.update(overrides)
    return kw


def rays(rng: np.random.Generator, n: int, num_images: int = 3):
    """Rays from around (0, 0, 2) toward the origin: (origins, directions,
    camera_indices) as numpy arrays."""
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, 2])
    d = rng.normal(size=(n, 3)).astype(np.float32) * 0.3 + np.float32([0, 0, -1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ci = rng.integers(0, num_images, n).astype(np.int32)
    return o, d, ci


def lookup_cells_jax(config, ray_bundle, sdist_list) -> np.ndarray:
    """The JAX side of ``NerfactoModel.lookup_cells``, with the JAX package's
    own functions: (R, K) cell index of every hash-grid lookup of the eval
    forward (scene contraction on), given its per-field spacing edges
    (``apply(train=True)["sdist_list"]``)."""
    # imported here: chip_smoke.py reads this module's tolerances on a
    # machine without JAX
    import jax.numpy as jnp

    from uncertainty_nerf_gs_tpu.ops import encodings as jenc
    from uncertainty_nerf_gs_tpu.ops import sampling as jsamp
    from uncertainty_nerf_gs_tpu.ops import spatial as jsp

    rb = ray_bundle._replace(
        nears=jnp.full_like(ray_bundle.nears, config.near_plane),
        fars=jnp.full_like(ray_bundle.fars, config.far_plane),
    )
    grids = [
        (a.get("num_levels", 5), 16, a.get("max_res", 128), a.get("log2_hashmap_size", 17))
        for a in config.proposal_net_args
    ] + [(config.num_levels, config.base_res, config.max_res, config.log2_hashmap_size)]
    n = rb.origins.shape[0]
    cols = []
    for (levels, min_res, max_res, log2), edges in zip(grids, sdist_list):
        pos = jsamp._edges_to_samples(
            rb, edges, jsamp.spacing_piecewise, jsamp.spacing_piecewise_inv
        ).positions
        flat = jsp.contract_to_unit_cube(pos).reshape(-1, 3)
        for res in jenc.hash_grid_resolutions(levels, min_res, max_res):
            idx, _ = jenc.cell_indices(flat, int(res), 2**log2)
            cols.append(np.asarray(idx).reshape(n, -1))
    return np.concatenate(cols, axis=1).astype(np.int64)


def ray_mismatch(want: dict, got: dict, tols=OUTPUT_TOLS) -> np.ndarray:
    """(R,) bool: rays where any output named in ``tols`` misses its
    tolerance."""
    bad = None
    for k, tol in tols.items():
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        miss = ~np.isclose(b, a, **tol)
        miss = miss.reshape(miss.shape[0], -1).any(-1) if miss.ndim else miss
        bad = miss if bad is None else bad | miss
    return bad
