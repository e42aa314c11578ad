"""Image-quality metrics: SSIM.

Counterpart of the SSIM of ``uncertainty_nerf_gs_tpu/metrics/
image_metrics.py`` (Gaussian 11x11 window, sigma 1.5, k1 0.01, k2 0.03,
valid padding), which the splat loss needs. PSNR, LPIPS and the masked
variants come with the eval port.

The separable filter is a float32 convolution; on the card it must not run
in TF32 (``torch.backends.cudnn.allow_tf32 = False``), or the loss drifts by
about 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _gaussian_window(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    half = (kernel_size - 1) / 2.0
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - half
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _filter2d_separable(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Valid-padding separable filter over H and W of an (H, W, C) image."""
    k = window.shape[0]
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W), one channel per batch entry
    x = F.conv2d(x, window.reshape(1, 1, k, 1))
    x = F.conv2d(x, window.reshape(1, 1, 1, k))
    return x[:, 0].permute(1, 2, 0)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    window = _gaussian_window(kernel_size, sigma, pred.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_p = _filter2d_separable(pred, window)
    mu_t = _filter2d_separable(target, window)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    # clamp the variances at 0: E[x^2] - mu^2 can go slightly negative in
    # float32 on near-constant windows
    sigma_pp = torch.clamp(_filter2d_separable(pred * pred, window) - mu_pp, min=0.0)
    sigma_tt = torch.clamp(_filter2d_separable(target * target, window) - mu_tt, min=0.0)
    sigma_pt = _filter2d_separable(pred * target, window) - mu_pt

    ssim_map = ((2.0 * mu_pt + c1) * (2.0 * sigma_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (sigma_pp + sigma_tt + c2)
    )
    return torch.mean(ssim_map)
