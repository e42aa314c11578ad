"""Area Under the Sparsification Error curve (AUSE).

Counterpart of ``uncertainty_nerf_gs_tpu/metrics/ause.py`` (the reference's
``metrics/ause.py``, from CF-NeRF): 100 removal ratios r = 0, 0.01, ...,
0.99; at each, the "oracle" curve keeps the ``int((1 - r) n)`` smallest
errors sorted by the error itself, the "by-variance" curve the same count
sorted by the predicted uncertainty (ascending); each point is the mean of
the kept errors (``mae``/``mse``) or its root (``rmse``); both curves are
normalized by their joint maximum, and AUSE is the trapezoid integral of
their difference over the ratios. Each curve is one stable sort and one
cumulative sum, taken on the host so that it adds in one order on the card
too; ties keep their index order, as ``jnp.argsort`` does.
"""

from __future__ import annotations

import torch

NUM_RATIOS = 100


def ratios_removed(device=None) -> torch.Tensor:
    """The 100 removal ratios in float32, i * float32(0.01): the JAX
    package's ``jnp.linspace(0, 1, 100, endpoint=False)`` as XLA computes it
    on the CPU (iota times the float32 reciprocal of 100), so that the keep
    counts ``int((1 - r) n)`` are the same."""
    return torch.arange(NUM_RATIOS, dtype=torch.float32, device=device) * torch.tensor(
        0.01, dtype=torch.float32, device=device)


def keep_counts(ratio_removed: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """int((1 - r) n_valid) in float32 for each ratio, clamped to [1,
    n_valid] so that tiny inputs keep a non-empty slice; n_valid an int32
    tensor."""
    keep = ((1.0 - ratio_removed) * n_valid.to(torch.float32)).to(torch.int32)
    return torch.minimum(torch.clamp(keep, min=1), n_valid)


def _prefix_sums(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` of a 1-D tensor, added in one fixed order on the card
    too: CUDA's 1-D floating-point cumsum is a CUB scan whose partial sums
    meet in no fixed order, so the same image scored twice moved AUSE in its
    last bits. The host's sequential sum takes a few hundred microseconds
    for an image's pixels."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=0)
    return torch.cumsum(x.cpu(), dim=0).to(x.device)


def ause(
    unc_vec: torch.Tensor,
    err_vec: torch.Tensor,
    err_type: str = "rmse",
    mask: torch.Tensor | None = None,
):
    """unc_vec, err_vec (n,): uncertainty and true error per pixel; mask
    (n,) bool: when given, the metric on the masked subset (masked-out
    entries sort to the tail and the keep counts index the valid prefix).
    Returns (ratio_removed, oracle_curve, by_var_curve, ause_value)."""
    if err_type not in ("rmse", "mae", "mse"):
        raise ValueError(f"unknown err_type {err_type!r}")
    unc_vec = unc_vec.reshape(-1).to(torch.float32)
    err_vec = err_vec.reshape(-1).to(torch.float32)
    n, device = err_vec.shape[0], err_vec.device
    if mask is None:
        n_valid = torch.tensor(n, dtype=torch.int32, device=device)
        to_tail = None
    else:
        mask = mask.reshape(-1)
        n_valid = torch.sum(mask).to(torch.int32)
        to_tail = torch.where(mask, 0.0, torch.inf)

    ratio_removed = ratios_removed(device)
    keep = keep_counts(ratio_removed, n_valid)
    counts = torch.arange(1, n + 1, dtype=torch.float32, device=device)

    def curve(order_key: torch.Tensor) -> torch.Tensor:
        if to_tail is not None:
            order_key = order_key + to_tail  # invalid entries sort last
        order = torch.sort(order_key, stable=True).indices
        prefix_mean = _prefix_sums(err_vec[order]) / counts
        vals = prefix_mean[keep.long() - 1]
        return torch.sqrt(vals) if err_type == "rmse" else vals

    oracle = curve(err_vec)
    by_var = curve(unc_vec)
    max_val = torch.maximum(torch.max(oracle), torch.max(by_var))
    oracle = oracle / max_val
    by_var = by_var / max_val
    value = torch.trapezoid(by_var - oracle, ratio_removed)
    return ratio_removed, oracle, by_var, value
