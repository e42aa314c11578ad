"""Shared inputs and rules for the port's parity tests (tests/test_torch_*.py).

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

import jax.numpy as jnp
import numpy as np

from uncertainty_nerf_gs_tpu.ops import encodings as jenc
from uncertainty_nerf_gs_tpu.ops import sampling as jsamp
from uncertainty_nerf_gs_tpu.ops import spatial as jsp

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
