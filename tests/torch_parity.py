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
* The deep ensemble's renders (tests/test_torch_ensemble.py) hold the same
  bars: each member output its ``OUTPUT_TOLS`` entry, and the combined
  variances and deviations (``*_var_alea``, ``*_var_epi``,
  ``*_var_combined``, ``*_std_combined``) ``MOMENT_TOL``; a ray is excluded
  when any lookup of the shared chain (fused) or of any member (per
  member) flipped a cell. ``python tests/torch_parity_report.py ensemble``
  measures at most 2.7e-4 relative (per member, ``rgb_var_epi``) on three
  members with no ray flipped.
"""

from __future__ import annotations

import re

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
# margin of about ten. The trainer past warmup (tests/test_torch_splat_
# refine.py: seven steps from JAX's state three steps in, through two
# refines, whose split samples' 3x3 products round differently, and an
# opacity reset) holds the same bars: at most 3.1e-6 relative on the loss
# terms (the NLL of a step after a refine) and 0.128 of the parameter bar
# (``python tests/torch_parity_report.py splat_refine``).
SPLAT_LOSS_RTOL = 1e-5
SPLAT_STEP_PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
# Adam's moments in the same run, atol relative to the largest entry of the
# group's moment: at most 0.107 of this bar (the means' second moments).
SPLAT_MOMENT_TOL = dict(atol=1e-5, rtol=1e-4)
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
# The packed-row gather's backward (ops/rasterize.py::PackedRowGather):
# each Gaussian's row is a sum over the tiles it lands in. The port adds in
# ascending (tile, slot) order, JAX's gather transpose in another, so on the
# CPU it is held to jax.vjp and to float64 at the float32 bar TOL (a row
# sums at most a few dozen unit-normal entries in the tests). On the card
# csrc/packed_rows.cu adds in the plain version's order: chip_smoke.py
# requires the two equal bit for bit, and two launches equal bit for bit.
PACKED_ROWS_TOL = TOL
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
    forward (scene contraction on; the cell or hybrid layout; an mlp
    proposal makes none), given its per-field spacing edges
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
        None if a.get("field_type", config.proposal_field_type) == "mlp"  # no lookup
        else (a.get("num_levels", 5), 16, a.get("max_res", 128), a.get("log2_hashmap_size", 17))
        for a in config.proposal_net_args
    ] + [(config.num_levels, config.base_res, config.max_res, config.log2_hashmap_size)]
    n = rb.origins.shape[0]
    cols = []
    for grid, edges in zip(grids, sdist_list):
        if grid is None:
            continue
        levels, min_res, max_res, log2 = grid
        pos = jsamp._edges_to_samples(
            rb, edges, jsamp.spacing_piecewise, jsamp.spacing_piecewise_inv
        ).positions
        flat = jsp.contract_to_unit_cube(pos).reshape(-1, 3)
        for res in jenc.hash_grid_resolutions(levels, min_res, max_res):
            # the hybrid layout's dense levels hold res^3 cells
            dense = config.grid_layout == "hybrid" and jenc.hybrid_is_dense(int(res), 2**log2)
            idx, _ = jenc.cell_indices(flat, int(res), int(res) ** 3 if dense else 2**log2)
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


# The bf16 MLP (``compute_dtype``, the configs' ``mixed_precision``) against
# flax's nn.Dense(dtype=bf16): both round every layer's input, weight, bias,
# product and activation to bf16 (8 bits of mantissa, 3.9e-3 relative), and
# dropout divides by keep_prob rounded to bf16 as jnp's weak-typed scalar
# is. ``python tests/torch_parity_report.py mcdropout`` measures 0 with and
# without dropout; the port's float32 MLP is 5.5e-3 to 9.3e-3 of the largest
# |y| away (seeds 0-5). The bar: atol 1e-3 of the output's largest magnitude
# (a quarter of one bf16 step there) and no rtol, so a float32 MLP fails it
# by a factor of 5 or more.
BF16_MLP_TOL = dict(atol=1e-3, rtol=0.0)

# A whole mixed_precision NerfactoModel (bf16 MLPs in both proposal fields
# and the main field) against the JAX package's, eval forward on rays that
# flipped no cell: the float32 hash-grid features differ in their last bits
# (TOL), which flips a bf16 rounding now and then, and a proposal density's
# flip moves the next level's samples. Each output is held to atol
# BF16_MODEL_TOL times its largest magnitude over those rays.
# ``python tests/torch_parity_report.py mcdropout`` measures at most 2.7e-3
# (accumulation); the JAX package's own float32 model is 0.22 (rgb) to 0.82
# (depth_var) from its bf16 one, and so is the port's: bf16 proposal
# densities move the samples, so mixed precision changes every output.
BF16_MODEL_TOL = 5e-3

# The Laplace posterior (tests/test_torch_laplace.py): the diagonal and full
# GGN are sums of squared (and crossed) Jacobians of the rendered colour over
# every ray of the batches, on rays that flipped no cell; the forward's
# float32 differences (OUTPUT_TOLS' rgb at 2.8e-4 relative) enter squared.
# Held leaf by leaf: atol relative to the leaf's largest entry, and rtol.
# ``python tests/torch_parity_report.py laplace`` measures at most 1.15e-4
# of the largest entry (trunc_exp's density kernel; softplus 8.8e-5), a
# margin of about 9. The MC-dropout training batch's gradients hold
# CPU_TRAIN_GRAD_L2: the port is 1.66e-2 from the jitted JAX gradients on
# the main field's cells, as far as the JAX package's own eager gradients.
LAPLACE_GGN_TOL = dict(atol=1e-3, rtol=1e-2)

# Dropout (tests/test_torch_mcdropout.py). The port's MLP applies the same
# masks as flax's nn.Dropout when they are imposed on both: the MLP, the
# MC-dropout render and a training batch then hold the f32 bars above. The
# JAX package draws its masks inside nn.Dropout from flax's rng streams,
# which torch cannot replay: ``impose_dropout`` replaces each draw with a
# given mask, and ``record_dropout`` draws each mask as nn.Dropout does and
# sows it, so that a test can hand the JAX package's own masks to the port.
# A mask's port name is ``"{mlp}.{layer}"`` (``fields/nerfacto_field.py``):
# flax names an MLP's dropouts Dropout_0, Dropout_1, ... in layer order.
def dropout_layers(num_layers: int, layers) -> list[int]:
    """An MLP's dropout layers in ascending order, ``-1`` the last."""
    return sorted({num_layers - 1 if d == -1 else d for d in layers})


def jax_dropout_name(path: tuple, layers_by_mlp: dict) -> str:
    """The port's name of the flax Dropout at ``path`` (its module path)."""
    mlp, drop = (path[-2] if len(path) > 1 else "root"), path[-1]
    return f"{mlp}.{layers_by_mlp[mlp][int(drop.split('_')[1])]}"


def impose_dropout(masks: dict, layers_by_mlp: dict):
    """A ``flax.linen.intercept_methods`` context in which every
    non-deterministic nn.Dropout call applies ``masks[name]`` (bool numpy)
    instead of a draw, as nn.Dropout applies its own."""
    import flax.linen as nn
    import jax.numpy as jnp
    from jax import lax

    def interceptor(next_fun, args, kwargs, context):
        if not (isinstance(context.module, nn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        if kwargs.get("deterministic", context.module.deterministic) or context.module.rate == 0.0:
            return next_fun(*args, **kwargs)
        keep = 1.0 - context.module.rate
        mask = jnp.asarray(masks[jax_dropout_name(context.module.path, layers_by_mlp)])
        assert mask.shape == x.shape, (context.module.path, mask.shape, x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))

    return nn.intercept_methods(interceptor)


def record_dropout():
    """A ``flax.linen.intercept_methods`` context in which nn.Dropout draws
    its mask as it does itself (``make_rng`` of its collection, then
    ``bernoulli``) and sows it as ``intermediates/.../mask``: apply with
    ``mutable=["intermediates"]`` to read the masks back."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax import lax

    def interceptor(next_fun, args, kwargs, context):
        module = context.module
        if not (isinstance(module, nn.Dropout) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        if kwargs.get("deterministic", module.deterministic) or module.rate == 0.0:
            return next_fun(*args, **kwargs)
        keep = 1.0 - module.rate
        mask = jax.random.bernoulli(module.make_rng(module.rng_collection), p=keep, shape=x.shape)
        module.sow("intermediates", "mask", mask)
        return lax.select(mask, x / keep, jnp.zeros_like(x))

    return nn.intercept_methods(interceptor)


def recorded_masks(intermediates, layers_by_mlp: dict) -> dict:
    """``record_dropout``'s sown masks -> {port name: bool numpy mask}."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(intermediates):
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        i = keys.index("mask")
        out[jax_dropout_name(keys[:i], layers_by_mlp)] = np.asarray(leaf)
    return out


# The data layer (tests/test_torch_data.py). The dataparsers, the numpy
# writers' poses and seed points, the corruption noise and the flags hold
# exactly: both packages run the same numpy arithmetic. The synthetic
# scene's dense render (256 uniform samples through the analytic density)
# holds the repo's float32 bar; the sum over samples is taken in another
# order, and the depths are ~2-4, so the bar is absolute and relative. The
# separable blur is the same float32 numpy convolution in both packages.
SYNTHETIC_TOL = dict(atol=2e-5, rtol=1e-5)
# The expected depth divides by the accumulation: it is held where the
# accumulation reaches this (measured: 4.3e-6 at 1e-2, 3.9e-5 at 1e-3).
MIN_DEPTH_ACC = 1e-2
BLUR_ATOL = 1e-6

# The CLI slice (tests/test_torch_cli.py): the port's eval_uncertainty.main
# on a run the JAX package trained, against the JAX package's main on the
# same run, metric by metric (deviations measured on the CPU with that
# test's runs; ROADMAP section 3 lists them). Deterministic renders
# (active-nerfacto, the splat render, the fused ensemble) agree to 1e-7
# relative in PSNR, NLL, LPIPS and AUCE; SSIM's filter sums in another
# order (1.4e-4 relative); AUSE ranks 1,152 pixels by their predicted
# deviation, and near-ties swap (3.2e-3 relative). MC-dropout draws its
# masks, and the Laplace render its normal samples, from each package's own
# generator: the sampled deviations move AUSE by up to 4.3 % and the mean
# variance by 2.0 % (MC-dropout, 10 samples); the Laplace case reads the
# JAX package's GGN cache, so only its 100 samples differ.
_CLI_EXACT = dict(atol=1e-5, rtol=1e-5)
_CLI_SSIM = dict(atol=1e-5, rtol=1e-3)
_CLI_AUSE = dict(atol=0.0, rtol=1e-2)
_CLI_SAMPLED_AUSE = dict(atol=0.0, rtol=0.15)
_AUSE_KEYS = ("rgb_ause_mae", "rgb_ause_mse", "rgb_ause_rmse")
CLI_METRIC_TOLS = {
    "active-nerfacto": {"default": _CLI_EXACT, "ssim": _CLI_SSIM, **{k: _CLI_AUSE for k in _AUSE_KEYS}},
    "active-splatfacto": {"default": _CLI_EXACT, "ssim": _CLI_SSIM, **{k: _CLI_AUSE for k in _AUSE_KEYS}},
    "ensemble": {"default": _CLI_EXACT, "ssim": _CLI_SSIM, **{k: _CLI_AUSE for k in _AUSE_KEYS}},
    "ensemble-hybrid-bf16": {"default": _CLI_EXACT, "ssim": _CLI_SSIM, **{k: _CLI_AUSE for k in _AUSE_KEYS}},
    "ensemble-corner": {"default": _CLI_EXACT, "ssim": _CLI_SSIM, **{k: _CLI_AUSE for k in _AUSE_KEYS}},
    "nerfacto-mcdropout": {"default": dict(atol=1e-5, rtol=1e-3), "ssim": _CLI_SSIM,
                           "rgb_avg_var": dict(atol=0.0, rtol=0.1), "rgb_auce_length": dict(atol=0.0, rtol=0.05),
                           **{k: _CLI_SAMPLED_AUSE for k in _AUSE_KEYS}},
    "nerfacto-laplace": {"default": dict(atol=1e-5, rtol=1e-3), "ssim": dict(atol=1e-5, rtol=5e-3),
                         "rgb_avg_var": dict(atol=0.0, rtol=1e-2), **{k: _CLI_SAMPLED_AUSE for k in _AUSE_KEYS}},
}

# The fused ensemble's bf16 and int8 tables (tests/test_torch_eval_tables.py).
# A bf16 lookup rounds each weight and each product to bf16 and the float32
# sum of the 8 products to bf16, in both packages; where the sums are taken
# in another order a sum near a bf16 rounding boundary could round the other
# way, so BF16_LOOKUP_TOL allows one bf16 step (2^-8 relative) of the
# level's largest entry. ``python tests/torch_parity_report.py tables``
# measures 0: the port's bf16 lookup equals the JAX package's eager one bit
# for bit. The int8 lookup's arithmetic is float32 (exact int8 values, the
# scale on the weight) and holds TOL (1.4e-7 of a level's largest entry).
# A fused render on bf16 or int8 tables holds OUTPUT_TOLS against the JAX
# package's eager render (rgb at most 2.7e-4, the float32 MLPs' noise); the
# JAX package's jitted bf16 render is up to 2.7e-2 (rgb) from its own eager
# one, as XLA fuses the bf16 products into the sum without their rounding,
# so the jitted render is not the reference there.
BF16_LOOKUP_TOL = dict(atol=2.0**-8)


# -- host builds of the CUDA sources (tests/host_cuda/cuda_shim.h) -------------


def host_launches(text: str) -> str:
    """CUDA source with each launch ``kernel<<<grid, threads, ...>>>(args)``
    rewritten to ``host_launch(kernel, grid, threads, ...)(args)``
    (tests/host_cuda/cuda_shim.h), which runs the kernel's blocks on the
    host, block after block; ``kernel`` is the name before ``<<<`` with its
    template arguments."""
    out, done = [], 0
    for m in re.finditer(r"<<<(.*?)>>>", text, flags=re.S):
        j = m.start()
        if text[j - 1] == ">":  # template arguments: back to their '<'
            depth = 0
            while True:
                j -= 1
                depth += {">": 1, "<": -1}.get(text[j], 0)
                if depth == 0:
                    break
        while text[j - 1].isalnum() or text[j - 1] == "_":
            j -= 1
        out += [text[done:j], f"host_launch({text[j:m.start()]}, {m.group(1)})"]
        done = m.end()
    return "".join(out + [text[done:]])
