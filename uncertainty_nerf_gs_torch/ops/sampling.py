"""Ray sampling: spaced (uniform) samplers and PDF resampling.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/sampling.py``. All samplers work
in a normalized spacing domain s in [0, 1]; the piecewise spacing function is
linear up to the scene midpoint and 1/x beyond. The JAX package's
``ops/prefix.py`` exists only for the TPU's lowering of a lane-axis cumsum
and has no counterpart here. ``sample_pdf``'s bracket-and-interpolate step
is ``ops/pdf_resample.py``, a CUDA kernel on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from uncertainty_nerf_gs_torch.ops.pdf_resample import resample_edges


class RayBundle(NamedTuple):
    origins: torch.Tensor  # (R, 3)
    directions: torch.Tensor  # (R, 3) unit
    nears: torch.Tensor  # (R,)
    fars: torch.Tensor  # (R,)
    camera_indices: torch.Tensor  # (R,) int


class RaySamples(NamedTuple):
    origins: torch.Tensor  # (R, 3)
    directions: torch.Tensor  # (R, 3)
    starts: torch.Tensor  # (R, S) euclidean bin starts
    ends: torch.Tensor  # (R, S) euclidean bin ends
    spacing_edges: torch.Tensor  # (R, S+1) normalized s-space edges
    camera_indices: torch.Tensor  # (R,)

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def midpoints(self) -> torch.Tensor:
        return 0.5 * (self.starts + self.ends)

    @property
    def positions(self) -> torch.Tensor:
        return (
            self.origins[..., None, :]
            + self.directions[..., None, :] * self.midpoints[..., None]
        )


# -- spacing functions -------------------------------------------------------


def spacing_piecewise(x: torch.Tensor) -> torch.Tensor:
    """t -> s: linear for t<1, 1 - 1/(2t) beyond (UniformLinDispPiecewise)."""
    return torch.where(
        x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp(x, min=1e-9))
    )


def spacing_piecewise_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(
        x < 0.5, 2.0 * x, 1.0 / torch.clamp(2.0 - 2.0 * x, min=1e-9)
    )


def spacing_uniform(x: torch.Tensor) -> torch.Tensor:
    return x


def spacing_uniform_inv(x: torch.Tensor) -> torch.Tensor:
    return x


def _edges_to_samples(
    ray_bundle: RayBundle,
    s_edges: torch.Tensor,
    spacing_fn: Callable,
    spacing_fn_inv: Callable,
) -> RaySamples:
    s_near = spacing_fn(ray_bundle.nears)[..., None]
    s_far = spacing_fn(ray_bundle.fars)[..., None]
    t_edges = spacing_fn_inv(s_edges * (s_far - s_near) + s_near)
    return RaySamples(
        origins=ray_bundle.origins,
        directions=ray_bundle.directions,
        starts=t_edges[..., :-1],
        ends=t_edges[..., 1:],
        spacing_edges=s_edges,
        camera_indices=ray_bundle.camera_indices,
    )


def _linspace01(n: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` to the bit: arange(n) times the float32
    reciprocal of n - 1, with the last entry exactly 1."""
    step = 1.0 / torch.tensor(max(n - 1, 1), dtype=torch.float32)
    out = torch.arange(n, dtype=torch.float32).mul_(step)
    out[-1] = 1.0
    return out.to(device)


def _check_draws(draws: torch.Tensor | None, shape, device) -> torch.Tensor | None:
    """A stratified sampler's (R, K) uniform [0, 1) draws on ``device``, or
    None (eval)."""
    if draws is not None and tuple(draws.shape) != tuple(shape):
        raise ValueError(f"draws must be {tuple(shape)}, got {tuple(draws.shape)}")
    return None if draws is None else draws.to(device)


def sample_uniform(
    ray_bundle: RayBundle,
    num_samples: int,
    draws: torch.Tensor | None = None,
    spacing_fn: Callable = spacing_piecewise,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
) -> RaySamples:
    """Stratified (train: ``draws`` (R, S+1) uniform in [0, 1), where the
    JAX package takes a key) or centered (eval) spaced sampling."""
    num_rays = ray_bundle.origins.shape[0]
    device = ray_bundle.origins.device
    edges = _linspace01(num_samples + 1, device).expand(num_rays, num_samples + 1)
    draws = _check_draws(draws, (num_rays, num_samples + 1), device)
    if draws is not None:
        # jitter interior edges within their bins (stratified, bins stay sorted)
        jitter = (draws - 0.5) * (1.0 / num_samples)
        jitter[:, 0].clamp_(min=0.0)
        jitter[:, -1].clamp_(max=0.0)
        edges = edges + jitter
    return _edges_to_samples(ray_bundle, edges, spacing_fn, spacing_fn_inv)


def sample_pdf(
    ray_bundle: RayBundle,
    s_edges: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    draws: torch.Tensor | None = None,
    histogram_padding: float = 0.01,
    spacing_fn: Callable = spacing_piecewise,
    spacing_fn_inv: Callable = spacing_piecewise_inv,
    eps: float = 1e-5,
) -> RaySamples:
    """Importance-resample new bin edges from a weights histogram.

    s_edges: (R, S+1) existing normalized edges; weights: (R, S). Evenly
    spaced u at eval, stratified u from ``draws`` (R, N+1) uniform in
    [0, 1) otherwise. The eval queries are one row expanded over the
    rays, and ``sample_uniform``'s edges one expanded linspace: the
    resampler reads both in place.
    """
    num_rays = weights.shape[0]
    device = weights.device
    n_new = num_samples + 1
    draws = _check_draws(draws, (num_rays, n_new), device)
    if draws is not None:
        u = (torch.arange(n_new, dtype=torch.float32, device=device) + draws) / n_new
    else:
        u = (torch.arange(n_new, dtype=torch.float32, device=device) + 0.5) / n_new
    u = torch.clamp(u, 0.0, 1.0 - 1e-6).expand(num_rays, n_new)

    new_edges = resample_edges(
        weights.detach().contiguous(), s_edges.detach(), u, histogram_padding, eps
    )
    return _edges_to_samples(ray_bundle, new_edges, spacing_fn, spacing_fn_inv)
