"""Inverse-CDF resampling of bin edges, the proposal sampler's core.

A frozen copy of the plain version of the port's resampler: nerfstudio's
``sample_pdf`` (pad the weights, normalise, cumulative sum, bracket each
query, interpolate), with every sum taken in float64 in one fixed order and
each cdf entry rounded to float32 once. The order is that of a warp that
owns 8 (up to 128 bins: 4) consecutive bins a lane, scans 32 lanes at a
time and carries from tile to tile, so that a correct kernel of that design
gives these bits; any correct order gives them to float64's own error.
"""

from __future__ import annotations

import torch


def _lane_layout(num_bins: int) -> tuple[int, int]:
    per = 8 if (num_bins - 1).bit_length() > 7 else 4
    return per, 32 * per


def _cdf(weights: torch.Tensor, histogram_padding: float, eps: float) -> torch.Tensor:
    """[0, clip(inclusive cumsum(pdf), 0, 1)]: (R, S + 1) in float32."""
    num_rays, num_bins = weights.shape
    hp = float(torch.tensor(histogram_padding, dtype=torch.float32))
    eps = float(torch.tensor(eps, dtype=torch.float32))
    per, tile = _lane_layout(num_bins)
    tiles = -(-num_bins // tile)
    dev = weights.device
    w = torch.zeros(num_rays, tiles * tile, dtype=torch.float64, device=dev)
    w[:, :num_bins] = weights
    w = w.reshape(num_rays, tiles, 32, per)
    valid = (torch.arange(tiles * tile, device=dev) < num_bins).reshape(tiles, 32, per)
    lane = torch.arange(32, device=dev)
    local = w.new_zeros(num_rays, 32)
    for t in range(tiles):
        for k in range(per):
            local = local + torch.where(valid[t, :, k], w[:, t, :, k] + hp, 0.0)
    for off in (16, 8, 4, 2, 1):
        local = local + local[:, lane ^ off]
    w_sum = local[:, :1]
    padding = torch.clamp(eps - w_sum, min=0.0)
    pad_bin = padding / padding.new_tensor(float(num_bins))
    denom = w_sum + padding
    pdf = torch.where(valid, ((w + hp) + pad_bin[:, :, None, None]) / denom[:, :, None, None], 0.0)
    carry = w.new_zeros(num_rays, 1)
    cdf = []
    for t in range(tiles):
        run = w.new_zeros(num_rays, 32)
        for k in range(per):
            run = run + pdf[:, t, :, k]
        incl = run
        for off in (1, 2, 4, 8, 16):
            shifted = torch.cat([incl.new_zeros(num_rays, off), incl[:, :-off]], dim=1)
            incl = torch.where(lane >= off, incl + shifted, incl)
        acc = carry + torch.cat([incl.new_zeros(num_rays, 1), incl[:, :-1]], dim=1)
        carry = carry + incl[:, 31:]
        entries = []
        for k in range(per):
            acc = acc + pdf[:, t, :, k]
            entries.append(acc)
        cdf.append(torch.stack(entries, dim=-1).reshape(num_rays, tile))
    cdf = torch.clamp(torch.cat(cdf, dim=1)[:, :num_bins], 0.0, 1.0).to(weights.dtype)
    return torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)


@torch.no_grad()
def resample_edges(weights: torch.Tensor, s_edges: torch.Tensor, u: torch.Tensor,
                   histogram_padding: float = 0.01, eps: float = 1e-5) -> torch.Tensor:
    """(R, S) weights, (R, S + 1) sorted edges, (R, N) sorted queries in
    [0, 1) -> (R, N) new edges."""
    num_bins = weights.shape[1]
    cdf = _cdf(weights, histogram_padding, eps)
    idx = torch.sum(cdf[:, :, None] <= u[:, None, :], dim=1) - 1
    idx = torch.clamp(idx, 0, num_bins - 1)
    c0 = torch.gather(cdf, -1, idx)
    c1 = torch.gather(cdf, -1, idx + 1)
    e0 = torch.gather(s_edges, -1, idx)
    e1 = torch.gather(s_edges, -1, idx + 1)
    frac = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-12), torch.zeros_like(u))
    return e0 + frac * (e1 - e0)
