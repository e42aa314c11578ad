"""Image-quality metrics: PSNR, SSIM, LPIPS and their masked variants.

Counterpart of ``uncertainty_nerf_gs_tpu/metrics/image_metrics.py``: PSNR
at data range 1, SSIM with a Gaussian 11x11 window (sigma 1.5, k1 0.01, k2
0.03, valid padding; the splat loss uses it too), LPIPS through
``ops/lpips.py`` (the random-feature fallback unless weights are given), and
the reference's masked PSNR, SSIM (windows whose centre pixel is in the
mask) and LPIPS (the spatial map averaged over the mask). Images are
(H, W, C) floats in [0, 1].

The separable filter is a float32 convolution; on the card it must not run
in TF32 (``torch.backends.cudnn.allow_tf32 = False``), or the loss drifts by
about 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uncertainty_nerf_gs_torch.ops import lpips as _lpips


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


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over all pixels and channels."""
    mse = torch.mean((pred.to(torch.float32) - target.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def lpips(pred: torch.Tensor, target: torch.Tensor, params=None) -> torch.Tensor:
    """Perceptual distance between (H, W, 3) images; see ``ops/lpips.py``."""
    return _lpips.lpips(pred, target, params=params)


def masked_psnr(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, data_range: float = 1.0
) -> torch.Tensor:
    """PSNR over the pixels where ``mask`` (H, W) is true."""
    m = mask[..., None].to(torch.float32)
    se = ((pred - target) ** 2) * m
    mse = torch.sum(se) / torch.clamp(torch.sum(m) * pred.shape[-1] / m.shape[-1], min=1.0)
    return 10.0 * torch.log10(data_range**2 / mse)


def masked_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
) -> torch.Tensor:
    """Mean SSIM over the windows whose centre pixel is in ``mask`` (H, W).
    The variances are not clamped, as in the JAX package's masked SSIM."""
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    window = _gaussian_window(kernel_size, 1.5, pred.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p = _filter2d_separable(pred, window)
    mu_t = _filter2d_separable(target, window)
    sigma_pp = _filter2d_separable(pred * pred, window) - mu_p * mu_p
    sigma_tt = _filter2d_separable(target * target, window) - mu_t * mu_t
    sigma_pt = _filter2d_separable(pred * target, window) - mu_p * mu_t
    ssim_map = ((2.0 * mu_p * mu_t + c1) * (2.0 * sigma_pt + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (sigma_pp + sigma_tt + c2)
    )
    half = (kernel_size - 1) // 2
    m = mask[half:-half, half:-half, None].to(torch.float32)
    return torch.sum(ssim_map * m) / torch.clamp(
        torch.sum(m) * ssim_map.shape[-1] / m.shape[-1], min=1.0)


def masked_lpips(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None, params=None
) -> torch.Tensor:
    """LPIPS averaged over ``mask`` (H, W), or over every pixel without one:
    the spatial LPIPS map's ``sum(map * mask) / sum(mask)``."""
    lmap = _lpips.lpips_spatial(pred, target, params=params)
    if mask is None:
        return torch.mean(lmap)
    m = mask.to(torch.float32)
    return torch.sum(lmap * m) / torch.clamp(torch.sum(m), min=1.0)
