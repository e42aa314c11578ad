"""Volumetric ray-march compositing: weights and renderers.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/raymarch.py``: the renderers
and nerfacto's two regularizers, the interlevel (proposal) loss and the
distortion loss. R rays, S samples per ray; ``weights`` are compositing
weights; the losses work in normalized s-space.
"""

from __future__ import annotations

import torch


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = alpha_i * T_i: alpha = 1 - exp(-sigma delta),
    T_i = exp(-sum_{j<i} sigma_j delta_j). (R, S) -> (R, S)."""
    tau = densities * deltas
    alphas = 1.0 - torch.exp(-tau)
    accum = torch.cumsum(tau, dim=-1)
    trans = torch.exp(-(accum - tau))
    return alphas * trans


def render_rgb(
    weights: torch.Tensor,
    rgbs: torch.Tensor,
    background: torch.Tensor | None = None,
) -> torch.Tensor:
    """(R, S) weights x (R, S, 3) rgbs -> (R, 3); optional background comp."""
    comp = torch.sum(weights[..., None] * rgbs, dim=-2)
    if background is not None:
        acc = torch.sum(weights, dim=-1, keepdim=True)
        comp = comp + (1.0 - acc) * background
    return comp


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-1)


def render_expected_depth(
    weights: torch.Tensor, steps: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """Accumulation-normalized expected termination depth (R,)."""
    acc = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * steps, dim=-1) / (acc + eps)
    lo = torch.amin(steps, dim=-1)
    hi = torch.amax(steps, dim=-1)
    return torch.minimum(torch.maximum(depth, lo), hi)


def render_median_depth(weights: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Depth where the cumulative weight first reaches 0.5 (R,)."""
    cum = torch.cumsum(weights, dim=-1)
    split = torch.full(
        weights.shape[:-1] + (1,), 0.5, dtype=weights.dtype, device=weights.device
    )
    idx = torch.searchsorted(cum.contiguous(), split, right=False)
    idx = torch.clamp(idx, 0, steps.shape[-1] - 1)
    return torch.gather(steps, -1, idx)[..., 0]


def render_uncertainty(betas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """UncertaintyRenderer semantics: sum(weights * betas) over samples.
    Callers pass ``weights**2`` to propagate variances."""
    return torch.sum(betas * weights, dim=-1)


def depth_variance(
    weights: torch.Tensor, steps: torch.Tensor, depth: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """Analytic depth variance sum_i w_i (t_i - d)^2 + eps."""
    return torch.sum(weights * (steps - depth[..., None]) ** 2, dim=-1) + eps


# ---------------------------------------------------------------------------
# Mip-NeRF 360 regularizers (nerfacto's interlevel and distortion losses).
# ---------------------------------------------------------------------------


def take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``torch.gather(values, -1, idx)`` written as an index into the
    flattened values. Its backward is index_put's accumulation, which on
    the card sorts the indices and adds each entry's gradients in order;
    gather's backward is a scatter_add whose float atomics add in no fixed
    order, so a training step would not repeat bit for bit."""
    k, m = values.shape[-1], idx.shape[-1]
    flat = values.reshape(-1, k)
    rows = torch.arange(flat.shape[0], device=idx.device)[:, None] * k
    return flat.reshape(-1)[idx.reshape(-1, m) + rows].reshape(idx.shape)


def _outer_measure(t0: torch.Tensor, t1: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """For each interval of t0, the total w1 mass of the t1 bins that
    overlap it. t0: (R, S0+1) query edges; t1: (R, S1+1) envelope edges;
    w1: (R, S1) envelope weights. Returns (R, S0)."""
    cw1 = torch.cat([torch.zeros_like(w1[..., :1]), torch.cumsum(w1, dim=-1)], dim=-1)
    t1 = t1.contiguous()
    idx_lo = torch.searchsorted(t1, t0[..., :-1].contiguous(), right=True) - 1
    idx_hi = torch.searchsorted(t1, t0[..., 1:].contiguous(), right=False)
    top = cw1.shape[-1] - 1
    idx_lo = torch.clamp(idx_lo, 0, top)
    idx_hi = torch.clamp(idx_hi, 0, top)
    return take_rows(cw1, idx_hi) - take_rows(cw1, idx_lo)


def interlevel_loss(
    final_sdist: torch.Tensor,
    final_weights: torch.Tensor,
    prop_sdists: list[torch.Tensor],
    prop_weights: list[torch.Tensor],
    eps: float = 1e-7,
) -> torch.Tensor:
    """Proposal loss: the final weight mass each proposal envelope fails to
    cover. final_sdist (R, S+1) and final_weights (R, S) are detached here;
    the gradient reaches the proposal weights only."""
    c = final_sdist.detach()
    w = final_weights.detach()
    total = 0.0
    for cp, wp in zip(prop_sdists, prop_weights):
        w_outer = _outer_measure(c, cp, wp)
        excess = torch.clamp(w - w_outer, min=0.0)
        total = total + torch.mean(excess**2 / (w + eps))
    return total


def distortion_loss(sdist: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360 distortion loss in s-space, O(S) by cumsums.
    sdist: (R, S+1) normalized edges; weights: (R, S)."""
    mids = 0.5 * (sdist[..., 1:] + sdist[..., :-1])
    deltas = sdist[..., 1:] - sdist[..., :-1]
    # pairwise term: 2 sum_i w_i (m_i csum_{j<i} w_j - csum_{j<i} w_j m_j)
    cw = torch.cumsum(weights, dim=-1)
    cwm = torch.cumsum(weights * mids, dim=-1)
    cw_ex = cw - weights
    cwm_ex = cwm - weights * mids
    pairwise = 2.0 * torch.sum(weights * (mids * cw_ex - cwm_ex), dim=-1)
    self_term = torch.sum(weights**2 * deltas, dim=-1) / 3.0
    return torch.mean(pairwise + self_term)
