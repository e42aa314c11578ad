"""Splatfacto-family 3D Gaussian Splatting model (plain and active).

Counterpart of ``uncertainty_nerf_gs_tpu/models/splatfacto.py``:

  * splatfacto, and active-splatfacto (``uncertainty_channels=1``): a
    per-Gaussian learned log-uncertainty rasterized as softplus + beta_min,
    a Gaussian-NLL RGB loss and an opacity loss on visible Gaussians;
  * rgb, depth, depth^2 and uncertainty composite in ONE multi-channel pass
    through ``ops/rasterize.py`` (kernels K2 / K3 on the card);
  * the Gaussians live in a fixed-capacity buffer with an ``alive`` mask;
  * screen-space positional gradients come from a zero "grad tap" added to
    the projected means.

Parameters are a flat dict of tensors with the JAX package's names and
layouts (``means``, ``scales``, ``quats``, ``opacities``, ``features_dc``,
``features_rest``, ``log_uncertainties``). Refinement (densify, split,
cull), ``probe_tile_counts`` and ``tune_rasterize_capacity`` come with the
refinement slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from uncertainty_nerf_gs_torch.metrics.image_metrics import ssim
from uncertainty_nerf_gs_torch.ops import sh as sh_ops
from uncertainty_nerf_gs_torch.ops.gaussians import project_gaussians
from uncertainty_nerf_gs_torch.ops.rasterize import rasterize_gaussians


@dataclasses.dataclass(frozen=True)
class SplatfactoConfig:
    """Splatfacto hyper-parameters (nerfstudio defaults) and the
    active-splatfacto knobs; a copy of the JAX package's config, field for
    field, so one set of keyword arguments builds both."""

    capacity: int = 1 << 15  # fixed Gaussian buffer size (alive mask inside)
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    num_random: int = 5000  # random-init count when no SfM points
    random_scale: float = 1.0  # random-init cube half-extent
    # refinement schedule
    warmup_length: int = 500
    refine_every: int = 100
    densify_grad_thresh: float = 0.0008
    densify_size_thresh: float = 0.01
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    stop_split_at: int = 15000
    reset_alpha_every: int = 30  # in units of refine_every
    n_split_samples: int = 2
    continue_cull_post_densification: bool = True
    # losses
    ssim_lambda: float = 0.2
    use_scale_regularization: bool = False
    max_gauss_ratio: float = 10.0
    # rendering
    near_plane: float = 0.01
    background_color: str = "random"  # random | white | black
    rasterize_capacity: int = 512
    tile_chunk: int = 64  # read by the JAX package only: K2 takes every tile in one launch
    rasterize_backend: str = "auto"  # auto | pallas (both K2 / K3); xla | matmul raise
    rasterize_row_capacity: int | None = None  # None = max(4 * capacity, 1024)
    rasterize_capacity_auto: bool = False  # the port raises: tuning is not ported yet
    rasterize_capacity_max: int = 4096
    rasterize_capacity_margin: float = 1.25
    capacity_retune_every: int = 0  # the port raises on > 0, as above
    rasterize_pack_via: str = "gather"  # gather | matmul: the same rows, gathered
    # "moments" = in-pass E[d^2] - E[d]^2; "indirection" = the reference's
    # two-pass (d_i - D)^2 re-rasterize
    depth_var_mode: str = "moments"
    # active-splatfacto
    uncertainty_channels: int = 0
    beta_min: float = 0.01
    rendered_uncertainty_eps: float = 1e-6
    opacity_loss_mult: float = 0.01
    refine_cap_to_budget: bool = True
    nll_ramp_after_reset: int = 0


class SplatState(NamedTuple):
    """Non-optimized per-Gaussian strategy state (all (capacity,) leaves)."""

    alive: torch.Tensor  # bool
    grad_accum: torch.Tensor  # accumulated ||d loss / d means2d|| (pixels)
    vis_count: torch.Tensor  # int32 steps in frustum since the last refine
    max_radii: torch.Tensor  # max screen radius fraction since the last refine


# nerfstudio's fixed eval background for background_color="random"
EVAL_BACKGROUND_RANDOM = (0.1490, 0.1647, 0.2157)


def fixed_background(config: SplatfactoConfig, device=None) -> torch.Tensor:
    """Deterministic eval/render background for a config."""
    if config.background_color == "white":
        return torch.ones(3, device=device)
    if config.background_color == "black":
        return torch.zeros(3, device=device)
    return torch.tensor(EVAL_BACKGROUND_RANDOM, dtype=torch.float32, device=device)


def opengl_to_viewmat(c2w: torch.Tensor) -> torch.Tensor:
    """(3, 4) OpenGL camera-to-world -> (4, 4) OpenCV world-to-camera."""
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=c2w.dtype, device=c2w.device))
    r = c2w[:3, :3] @ flip  # now +z forward
    t = c2w[:3, 3]
    w2c = torch.eye(4, dtype=c2w.dtype, device=c2w.device)
    w2c[:3, :3] = r.T
    w2c[:3, 3] = -r.T @ t
    return w2c


def init_gaussians(
    generator: torch.Generator,
    config: SplatfactoConfig,
    points: torch.Tensor | None = None,
    colors: torch.Tensor | None = None,
) -> tuple[dict[str, torch.Tensor], SplatState]:
    """Fixed-capacity Gaussian buffer from points or a random cube, on the
    generator's device: scales from the mean 3-NN distance, random unit
    quats, opacity logit(0.1), SH dc from the colors; active-splatfacto adds
    ``log_uncertainties`` ~ N(0, 0.1^2). Random draws come from
    ``generator``."""
    cap = config.capacity
    dev = generator.device
    if points is None:
        n = min(config.num_random, cap)
        points = (torch.rand((n, 3), generator=generator, device=dev) * 2.0 - 1.0) * config.random_scale
        colors = torch.rand((n, 3), generator=generator, device=dev)
    n = min(points.shape[0], cap)
    points = points[:n].to(device=dev, dtype=torch.float32)
    colors = (
        colors[:n].to(device=dev, dtype=torch.float32) if colors is not None
        else torch.full((n, 3), 0.5, device=dev)
    )

    # mean 3-NN distance in row chunks, so no (n, n) matrix is built
    chunk = 256
    nn3 = []
    for start in range(0, n, chunk):
        blk = points[start : start + chunk]
        d2 = torch.sum((blk[:, None] - points[None]) ** 2, dim=-1)  # (chunk, n)
        rows = torch.arange(start, start + blk.shape[0], device=dev)
        d2[torch.arange(blk.shape[0], device=dev), rows] = 1e10
        nn3.append(torch.topk(d2, min(3, n), dim=1, largest=False).values)
    avg_dist = torch.sqrt(torch.clamp(torch.mean(torch.cat(nn3), dim=-1), min=1e-12))
    log_scales = torch.log(torch.clamp(avg_dist, min=1e-6))[:, None].repeat(1, 3)

    def pad(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        return torch.cat([x, torch.full((cap - n,) + x.shape[1:], fill, dtype=x.dtype, device=dev)])

    nb = sh_ops.num_sh_bases(config.sh_degree)
    dc = (colors - 0.5) / 0.28209479177387814  # inverse SH dc
    quats = torch.randn((n, 4), generator=generator, device=dev)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    params = {
        "means": pad(points),
        "scales": pad(log_scales, -10.0),
        "quats": pad(quats),
        "opacities": pad(torch.full((n,), math.log(0.1 / 0.9), device=dev), -10.0),
        "features_dc": pad(dc),
        "features_rest": pad(torch.zeros((n, nb - 1, 3), device=dev)),
    }
    if config.uncertainty_channels:
        params["log_uncertainties"] = pad(
            0.1 * torch.randn((n, 1), generator=generator, device=dev)
        )
    state = SplatState(
        alive=torch.arange(cap, device=dev) < n,
        grad_accum=torch.zeros(cap, device=dev),
        vis_count=torch.zeros(cap, dtype=torch.int32, device=dev),
        max_radii=torch.zeros(cap, device=dev),
    )
    return params, state


def active_sh_degree(step: int, config: SplatfactoConfig) -> int:
    return min(step // config.sh_degree_interval, config.sh_degree)


def _rasterize(proj, opac, payload, width, height, config):
    return rasterize_gaussians(
        proj, opac, payload, width, height,
        capacity=config.rasterize_capacity,
        backend=config.rasterize_backend,
        row_capacity=config.rasterize_row_capacity,
        pack_via=config.rasterize_pack_via,
    )


def render_splat(
    params: dict[str, torch.Tensor],
    alive: torch.Tensor,
    c2w: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    config: SplatfactoConfig,
    sh_deg: int | None = None,
    background: torch.Tensor | None = None,
    means2d_tap: torch.Tensor | None = None,
) -> dict[str, Any]:
    """Render one camera: rgb / depth / depth_var / accumulation (and
    uncertainty for active) in one multi-channel rasterize pass.

    ``means2d_tap``: optional (capacity, 2) zeros added to the screen
    positions; its gradient is the densification signal.
    """
    proj = project_gaussians(
        params["means"], torch.exp(params["scales"]), params["quats"],
        opengl_to_viewmat(c2w), fx, fy, cx, cy, width, height,
        near=config.near_plane,
    )
    proj = proj._replace(valid=proj.valid & alive)
    if means2d_tap is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_tap)

    viewdirs = params["means"] - c2w[:3, 3][None]
    coeffs = torch.cat([params["features_dc"][:, None, :], params["features_rest"]], dim=1)
    if sh_deg is None:
        sh_deg = config.sh_degree
    rgbs = torch.clamp(
        sh_ops.eval_sh_colors(config.sh_degree, coeffs, viewdirs, sh_deg) + 0.5, min=0.0
    )  # (N, 3)

    opac = torch.sigmoid(params["opacities"]) * proj.compensation
    depth = proj.depths
    channels = [rgbs, depth[:, None], (depth**2)[:, None]]
    if config.uncertainty_channels:
        unc = F.softplus(params["log_uncertainties"][:, 0]) + config.beta_min
        channels.append(unc[:, None])
    out = _rasterize(proj, opac, torch.cat(channels, dim=-1), width, height, config)
    img, alpha = out.image, out.alpha
    alpha_safe = torch.clamp(alpha, min=1e-10)

    dev = img.device
    if background is None:
        background = torch.zeros(3, device=dev) if config.background_color == "black" else torch.ones(3, device=dev)
    rgb = img[..., :3] + (1.0 - alpha[..., None]) * background
    # alpha-normalized depth; uncovered pixels get the largest covered depth
    d1 = img[..., 3] / alpha_safe
    d2 = img[..., 4] / alpha_safe
    covered = alpha > 0.0
    far_fill = torch.max(torch.where(covered, d1, torch.zeros_like(d1)))
    d1 = torch.where(covered, d1, far_fill)
    d2 = torch.where(covered, d2, far_fill**2)
    if config.depth_var_mode == "indirection":
        # the reference's two-pass variance: fetch D at each Gaussian's
        # floored center, re-rasterize (d_i - D)^2 with C = 1. Clamping
        # before the integer cast keeps the bounds tests below exact.
        xy = torch.clamp(
            torch.floor(proj.means2d), -1.0, float(max(width, height) + 1)
        ).to(torch.int64)
        valid_pix = (xy[:, 0] > 0) & (xy[:, 0] < width) & (xy[:, 1] > 0) & (xy[:, 1] < height)
        fetched = d1[torch.clamp(xy[:, 1], 0, height - 1), torch.clamp(xy[:, 0], 0, width - 1)]
        delta = torch.where(valid_pix, depth - fetched, depth)
        raw2 = _rasterize(proj, opac, (delta**2)[:, None], width, height, config).image[..., 0]
        depth_var = torch.where(covered, raw2 / alpha_safe, torch.max(raw2))
    elif config.depth_var_mode == "moments":
        depth_var = torch.clamp(d2 - d1**2, min=0.0) + 1e-5
    else:
        raise ValueError(f"unknown depth_var_mode {config.depth_var_mode!r}")

    outputs: dict[str, Any] = {
        "rgb": torch.clamp(rgb, 0.0, 1.0),
        "depth": d1,
        "depth_var": depth_var,
        "depth_std": torch.sqrt(depth_var),
        "accumulation": alpha,
        "background": background,
        "radii": proj.radii,
        "visible": proj.valid,
        "raster_overflow": out.max_overflow,
    }
    if config.uncertainty_channels:
        # the composited softplus channel is a per-pixel std (betas)
        rgb_std = torch.clamp(img[..., 5], min=0.0)
        outputs["uncertainty"] = rgb_std
        outputs["rgb_std"] = rgb_std
        outputs["rgb_var"] = rgb_std**2
    return outputs


def splatfacto_loss(
    outputs: dict[str, torch.Tensor],
    image: torch.Tensor,
    params: dict[str, torch.Tensor],
    config: SplatfactoConfig,
    nll_weight: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Train loss: splatfacto L1 + SSIM; active adds the Gaussian NLL and
    the visible-Gaussian opacity loss; optional scale regularization.
    ``nll_weight`` blends the NLL with plain L1 when
    ``nll_ramp_after_reset > 0``."""
    pred = outputs["rgb"]
    gt = image
    losses: dict[str, torch.Tensor] = {}
    simloss = 1.0 - ssim(pred, gt)
    if config.uncertainty_channels:
        var = torch.clamp(outputs["rgb_var"], min=config.rendered_uncertainty_eps)
        nll = (
            torch.mean((pred - gt) ** 2 / (2.0 * var[..., None]))
            + 0.5 * torch.mean(torch.log(var))
            + 4.0
        )
        if config.nll_ramp_after_reset > 0:
            l1 = torch.mean(torch.abs(pred - gt))
            nll = nll_weight * nll + (1.0 - nll_weight) * l1
        losses["nll_loss"] = (1.0 - config.ssim_lambda) * nll
        vis = outputs["visible"].to(pred.dtype)
        op = torch.sigmoid(params["opacities"])
        losses["opacity_loss"] = config.opacity_loss_mult * (
            torch.sum(op * vis) / torch.clamp(torch.sum(vis), min=1.0)
        )
    else:
        losses["main_loss"] = (1.0 - config.ssim_lambda) * torch.mean(torch.abs(pred - gt))
    losses["ssim_loss"] = config.ssim_lambda * simloss
    if config.use_scale_regularization:
        s = torch.exp(params["scales"])
        ratio = torch.amax(s, dim=-1) / torch.clamp(torch.amin(s, dim=-1), min=1e-8)
        losses["scale_reg"] = 0.1 * torch.mean(
            torch.clamp(ratio, min=config.max_gauss_ratio) - config.max_gauss_ratio
        )
    return sum(losses.values()), losses


@torch.no_grad()
def accumulate_stats(
    state: SplatState,
    tap_grad: torch.Tensor,
    radii: torch.Tensor,
    visible: torch.Tensor,
    width: int,
    height: int,
) -> SplatState:
    """Per-step strategy-state update from the means2d grad tap, in units
    of half the larger image side, as splatfacto."""
    gnorm = torch.linalg.vector_norm(tap_grad, dim=-1) * 0.5 * max(width, height)
    zero = torch.zeros_like(gnorm)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visible, gnorm, zero),
        vis_count=state.vis_count + visible.to(torch.int32),
        max_radii=torch.maximum(
            state.max_radii, torch.where(visible, radii / max(width, height), zero)
        ),
    )


@torch.no_grad()
def reset_opacities(
    params: dict[str, torch.Tensor], config: SplatfactoConfig
) -> dict[str, torch.Tensor]:
    """Opacity reset: clamp to twice the cull threshold, so that culling
    re-evaluates everything."""
    t = config.cull_alpha_thresh * 2.0
    out = dict(params)
    out["opacities"] = torch.clamp(params["opacities"], max=math.log(t / (1.0 - t)))
    return out
