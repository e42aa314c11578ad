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
``features_rest``, ``log_uncertainties``).

Refinement (``refine_gaussians``: densify by duplicating small and
splitting large high-gradient Gaussians, then cull) keeps the buffer's
shape: new rows go into dead slots by a cumsum compaction
(``_compact_into_free``). ``probe_tile_counts`` and
``tune_rasterize_capacity`` size the rasterizer's per-tile and per-row
budgets from exact hit counts on probe cameras.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from uncertainty_nerf_gs_torch.metrics.image_metrics import ssim
from uncertainty_nerf_gs_torch.ops import sh as sh_ops
from uncertainty_nerf_gs_torch.ops.gaussians import Projection, project_gaussians, quat_to_rotmat
from uncertainty_nerf_gs_torch.ops.rasterize import TILE, TileCounts, rasterize_gaussians, tile_hit_counts
from uncertainty_nerf_gs_torch.utils.tracing import span


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
    rasterize_capacity_auto: bool = False  # tune_rasterize_capacity at trainer start
    rasterize_capacity_max: int = 4096
    rasterize_capacity_margin: float = 1.25
    capacity_retune_every: int = 0  # re-probe every this many steps, growing only (0: off)
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


def _project(params, alive, c2w, fx, fy, cx, cy, width, height, config) -> Projection:
    """The Gaussians in the camera's screen space, the dead slots invalid."""
    proj = project_gaussians(
        params["means"], torch.exp(params["scales"]), params["quats"],
        opengl_to_viewmat(c2w), fx, fy, cx, cy, width, height,
        near=config.near_plane,
    )
    return proj._replace(valid=proj.valid & alive)


@torch.no_grad()
def probe_tile_counts(
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
) -> TileCounts:
    """Exact per-tile and per-row hit counts of one camera: the projection
    ``render_splat`` makes, then ``ops.rasterize.tile_hit_counts``."""
    proj = _project(params, alive, c2w, fx, fy, cx, cy, width, height, config)
    return tile_hit_counts(proj, width, height)


def _round_up(x: float, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def tune_rasterize_capacity(
    config: SplatfactoConfig,
    params: dict[str, torch.Tensor],
    alive: torch.Tensor,
    cameras,
    max_probes: int = 8,
) -> SplatfactoConfig:
    """``config`` with ``rasterize_capacity`` and ``rasterize_row_capacity``
    set to the largest tile and row hit counts over up to ``max_probes``
    evenly spaced cameras, times ``rasterize_capacity_margin``, rounded up
    (to 64 and 128) and clamped (``rasterize_capacity_max``; the buffer's
    capacity). At the probed cameras nothing overflows unless the clamp
    bites."""
    n_cams = len(cameras)
    idxs = sorted({int(i) for i in np.linspace(0, n_cams - 1, min(max_probes, n_cams))})
    max_tile = max_row = 0
    for i in idxs:
        counts = probe_tile_counts(
            params, alive, cameras.camera_to_worlds[i], float(cameras.fx[i]), float(cameras.fy[i]),
            float(cameras.cx[i]), float(cameras.cy[i]), cameras.width, cameras.height, config,
        )
        max_tile = max(max_tile, int(counts.tile.max()))
        max_row = max(max_row, int(counts.row.max()))
    m = config.rasterize_capacity_margin
    cap = min(max(_round_up(max_tile * m, 64), 64), config.rasterize_capacity_max)
    row_cap = min(max(_round_up(max_row * m, 128), 4 * cap, 1024), int(params["means"].shape[0]))
    return dataclasses.replace(config, rasterize_capacity=cap, rasterize_row_capacity=row_cap)


def _rasterize(proj, opac, payload, width, height, config):
    """``rasterize_gaussians`` at the config's budgets, in the span
    ``ungs.splat.rasterize`` (sort, cull, pack and K2): its tiles and their
    slots, ``tiles`` x ``rasterize_capacity``."""
    tiles = -(-width // TILE) * -(-height // TILE)
    with span("ungs.splat.rasterize", tiles=tiles, tile_slots=tiles * config.rasterize_capacity):
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
    with span("ungs.splat.project", gaussians=params["means"].shape[0]):
        proj = _project(params, alive, c2w, fx, fy, cx, cy, width, height, config)
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


def _compact_into_free(
    params: dict[str, torch.Tensor],
    state: SplatState,
    new_params: dict[str, torch.Tensor],
    want_new: torch.Tensor,
) -> tuple[dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter the rows of ``new_params`` that ``want_new`` marks into the
    dead slots, in order of rank. Returns (params, alive, num_dropped,
    written): rows beyond the free slots are dropped and counted; written
    marks the slots that took a row. Static shapes throughout: every row
    that takes no slot is sent to a pad row at index ``capacity``, which is
    cut off after the scatter (JAX's ``mode="drop"``). Several rows write
    that pad row, in an order the card does not fix; no other slot is
    written twice."""
    cap = state.alive.shape[0]
    dev = state.alive.device
    free = ~state.alive
    free_rank = torch.cumsum(free, 0) - 1  # int64: the rank of each free slot
    num_free = free.sum()
    new_rank = torch.cumsum(want_new, 0) - 1
    fits = want_new & (new_rank < num_free)
    num_dropped = want_new.sum() - fits.sum()

    pad_index = torch.full_like(free_rank, cap)
    # the slot of the r-th free slot, by rank r; the pad entry is cut
    slot_of_rank = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
    slot_of_rank[torch.where(free, free_rank, pad_index)] = torch.arange(cap, device=dev)
    dest = torch.where(fits, slot_of_rank[torch.clamp(new_rank, 0, cap - 1)],
                       torch.full_like(new_rank, cap))

    def scatter(v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        padded = torch.cat([v, torch.zeros((1,) + v.shape[1:], dtype=v.dtype, device=dev)])
        padded[dest] = rows
        return padded[:cap]

    out = {k: scatter(v, new_params[k]) for k, v in params.items()}
    alive = scatter(state.alive, torch.ones_like(want_new))
    written = scatter(torch.zeros_like(state.alive), torch.ones_like(want_new))
    return out, alive, num_dropped, written


@torch.no_grad()
def refine_decisions(
    params: dict[str, torch.Tensor],
    state: SplatState,
    config: SplatfactoConfig,
    step: int,
    scene_extent: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The admitted decisions of ``refine_gaussians`` at this state: the
    (capacity,) masks of the slots that split and of those that duplicate,
    after the budget cap, and the number of candidates the cap turned away."""
    alive = state.alive
    avg_grad = state.grad_accum / torch.clamp(state.vis_count, min=1)
    high_grad = (avg_grad > config.densify_grad_thresh) & alive
    scales = torch.exp(params["scales"])
    max_scale = torch.amax(scales, dim=-1)

    do_densify = step < config.stop_split_at
    check_screen = step > config.stop_screen_size_at

    splits = high_grad & (max_scale > config.densify_size_thresh * scene_extent)
    if check_screen:
        splits = splits | (alive & (state.max_radii > config.split_screen_size))
    dups = high_grad & ~splits
    splits = splits & do_densify
    dups = dups & do_densify

    num_budget_capped = torch.zeros((), dtype=torch.int64, device=alive.device)
    if config.refine_cap_to_budget:
        # Admit candidates by descending average gradient while their
        # children fit the free slots: a split funds n_split_samples - 1 new
        # rows (sample 0 replaces the original in place), a dup one. An
        # unfunded split leaves its original untouched. The sort is stable,
        # so equal gradients admit the lower slot first, as in JAX.
        n_child = config.n_split_samples - 1
        cost = splits.to(torch.int64) * n_child + dups.to(torch.int64)
        cand = splits | dups
        prio = torch.where(cand, avg_grad, torch.full_like(avg_grad, -math.inf))
        order = torch.argsort(-prio, stable=True)
        keep = torch.zeros_like(cand)
        keep[order] = torch.cumsum(cost[order], 0) <= (~alive).sum()
        num_budget_capped = (cand & ~keep).sum()
        splits = splits & keep
        dups = dups & keep
    return splits, dups, num_budget_capped


def refine_gaussians(
    params: dict[str, torch.Tensor],
    state: SplatState,
    config: SplatfactoConfig,
    step: int,
    scene_extent: float = 1.0,
    generator: torch.Generator | None = None,
    eps: torch.Tensor | None = None,
) -> tuple[dict[str, torch.Tensor], SplatState, dict[str, torch.Tensor]]:
    """One splatfacto refinement pass: duplicate small and split large
    high-gradient Gaussians, then cull by opacity, world scale and screen
    size, all as masks over the fixed-capacity buffer. Returns new
    parameter tensors, the strategy state (statistics zeroed) and the
    counts for logging, with ``touched_slots``: the slots whose Gaussian was
    replaced, whose optimizer moments the trainer zeroes.

    The split samples are ``eps * scales`` rotated into each Gaussian's
    frame, with ``eps`` standard normal of shape (n_split_samples,
    capacity, 3): given, or drawn from ``generator``.
    """
    cap = config.capacity
    alive = state.alive
    splits, dups, num_budget_capped = refine_decisions(params, state, config, step, scene_extent)
    scales = torch.exp(params["scales"])
    check_screen = step > config.stop_screen_size_at

    # -- children: dup copies, then split samples 1..S-1; sample 0 of a
    # split overwrites its original in place
    n_samp = config.n_split_samples
    if eps is None:
        eps = torch.randn((n_samp, cap, 3), generator=generator, device=alive.device)
    rot = quat_to_rotmat(params["quats"])  # (N, 3, 3)
    offsets = torch.einsum("nij,snj->sni", rot, eps * scales[None])
    split_means = params["means"][None] + offsets  # (S, N, 3)
    split_scales = torch.log(torch.clamp(scales / 1.6, min=1e-10))

    def child_rows(means_rows, scales_rows):
        return {k: means_rows if k == "means" else scales_rows if k == "scales" else v
                for k, v in params.items()}

    children = [child_rows(params["means"], params["scales"])] + [
        child_rows(split_means[s], split_scales) for s in range(1, n_samp)
    ]
    new_rows = {k: torch.cat([c[k] for c in children]) for k in params}
    want_new = torch.cat([dups] + [splits] * (n_samp - 1))

    params = dict(params)
    params["means"] = torch.where(splits[:, None], split_means[0], params["means"])
    params["scales"] = torch.where(splits[:, None], split_scales, params["scales"])
    params, new_alive, dropped, written = _compact_into_free(params, state, new_rows, want_new)

    # -- cull. A slot with a non-finite leaf (any leaf, log_uncertainties
    # included) fails no ordinary test, NaN comparing False, and would hold
    # its slot for good: it is culled explicitly.
    cull = torch.sigmoid(params["opacities"]) < config.cull_alpha_thresh
    finite = torch.ones_like(alive)
    for v in params.values():
        finite = finite & torch.isfinite(v.reshape(cap, -1)).all(dim=1)
    cull = cull | ~finite
    if step > config.refine_every * config.reset_alpha_every:
        cull = cull | (
            torch.amax(torch.exp(params["scales"]), dim=-1) > config.cull_scale_thresh * scene_extent
        )
        if check_screen:
            cull = cull | (state.max_radii > config.cull_screen_size)
    new_alive = new_alive & ~cull

    info = {
        "num_alive": new_alive.sum(),
        "num_split": splits.sum(),
        "num_dup": dups.sum(),
        "num_culled": (cull & alive).sum(),
        "num_nonfinite": (~finite & alive).sum(),
        "num_dropped_capacity": dropped,
        "num_budget_capped": num_budget_capped,
        "touched_slots": written | splits,
    }
    dev = alive.device
    new_state = SplatState(
        alive=new_alive,
        grad_accum=torch.zeros(cap, device=dev),
        vis_count=torch.zeros(cap, dtype=torch.int32, device=dev),
        max_radii=torch.zeros(cap, device=dev),
    )
    return params, new_state, info
