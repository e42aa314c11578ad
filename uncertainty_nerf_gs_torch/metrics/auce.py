"""Area Under the Calibration Error curve (AUCE) for Gaussian intervals.

Counterpart of ``uncertainty_nerf_gs_tpu/metrics/auce.py`` (the reference's
``metrics/auce.py``): for the 99 significance levels alpha = 0.01, ...,
0.99, the central Gaussian interval ``mu +- Phi^-1(1 - alpha / 2) sigma``;
its empirical coverage and mean length, and the trapezoid integrals over
alpha of |coverage - (1 - alpha)| (``auc_abs_error``), of the length
(``auc_length``) and of the coverage error's negative part
(``auc_neg_error``). Coverage for every alpha is one sort and one
``searchsorted`` of the standardized residuals |target - mu| / sigma.
"""

from __future__ import annotations

import torch

NUM_ALPHAS = 99


def _alphas_and_z(device) -> tuple[torch.Tensor, torch.Tensor]:
    """alpha (99,) float32, (i + 1) times float32(0.01) as XLA computes the
    JAX package's ``(i + 1) / 100`` on the CPU, and z = Phi^-1(1 - alpha /
    2): the float32 argument, then ``ndtri`` in float64 rounded to float32
    (the JAX package's float32 ``norm.ppf`` is within 2.5e-6 of it)."""
    step = torch.tensor(0.01, dtype=torch.float32, device=device)
    alphas = (torch.arange(NUM_ALPHAS, dtype=torch.float32, device=device) + 1.0) * step
    z = torch.special.ndtri((1.0 - alphas / 2.0).to(torch.float64)).to(torch.float32)
    return alphas, z


def auce(
    mean_values: torch.Tensor,
    sigma_values: torch.Tensor,
    target_values: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """mean_values, sigma_values (>= 0), target_values (n,); mask (n,) bool:
    when given, the metric on the masked subset (invalid residuals are
    never covered, sigma's mean is the masked one). Returns the reference's
    keys: per-alpha ``coverage_values``, ``avg_length_values``,
    ``coverage_error_values``, ``abs_coverage_error_values``,
    ``neg_coverage_error_values`` (99 each) and the scalars
    ``auc_abs_error_values``, ``auc_length_values``,
    ``auc_neg_error_values``."""
    mean_values = mean_values.reshape(-1).to(torch.float32)
    sigma_values = sigma_values.reshape(-1).to(torch.float32)
    target_values = target_values.reshape(-1).to(torch.float32)
    n = mean_values.shape[0]
    alphas, z = _alphas_and_z(mean_values.device)

    abs_resid = torch.abs(target_values - mean_values)
    # sigma == 0 covers the target iff the residual is 0
    standardized = torch.where(
        sigma_values > 0.0,
        abs_resid / torch.clamp(sigma_values, min=1e-38),
        torch.where(abs_resid == 0.0, 0.0, torch.inf),
    )
    if mask is None:
        n_valid = torch.tensor(float(n), dtype=torch.float32, device=mean_values.device)
        sigma_mean = torch.mean(sigma_values)
    else:
        mask = mask.reshape(-1)
        n_valid = torch.clamp(torch.sum(mask).to(torch.float32), min=1.0)
        standardized = torch.where(mask, standardized, torch.inf)
        sigma_mean = torch.sum(torch.where(mask, sigma_values, 0.0)) / n_valid
    sorted_std = torch.sort(standardized).values
    # coverage(alpha) = #{standardized <= z_alpha} / n: the interval is closed
    counts = torch.searchsorted(sorted_std, z, right=True)
    coverage = counts.to(torch.float32) / n_valid
    avg_length = 2.0 * z * sigma_mean

    coverage_error = coverage - (1.0 - alphas)
    abs_coverage_error = torch.abs(coverage_error)
    neg_coverage_error = (torch.abs(coverage_error) - coverage_error) / 2.0
    return {
        "coverage_values": coverage,
        "avg_length_values": avg_length,
        "coverage_error_values": coverage_error,
        "abs_coverage_error_values": abs_coverage_error,
        "neg_coverage_error_values": neg_coverage_error,
        "auc_abs_error_values": torch.trapezoid(abs_coverage_error, alphas),
        "auc_length_values": torch.trapezoid(avg_length, alphas),
        "auc_neg_error_values": torch.trapezoid(neg_coverage_error, alphas),
    }
