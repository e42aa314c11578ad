"""Nerfacto-family model: proposal-sampled NeRF with uncertainty heads.

Counterpart of ``uncertainty_nerf_gs_tpu/models/nerfacto.py``. One model
covers plain nerfacto (``uncertainty_channels=0``) and active-nerfacto
(``uncertainty_channels=1``: an aleatoric RGB variance head, rendered with
squared weights). The forward is the two-level proposal hierarchy (uniform
256 -> pdf 96 -> pdf 48 on the main field); each ``sample_pdf`` runs the
resampling kernel (K1) and each field's hash grid the cell-lookup kernels
(K4, K5 in training) on the card. ``forward(train=False)`` is the eval
forward, under ``torch.no_grad()``; ``forward(train=True)`` is the training
forward, with autograd, stratified draws and the proposal annealing, and
``nerfacto_loss`` its loss. ``deterministic_dropout=False`` applies the
field's MLP dropout (nerfacto-mcdropout), its masks drawn from
``dropout_generator`` or given as ``dropout_masks``; ``forward_mc`` runs
several dropout draws on one proposal chain and one lookup of the field.
``mixed_precision`` runs every field's MLP in bf16 (``ops/mlp.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from uncertainty_nerf_gs_torch.fields.nerfacto_field import (
    NerfactoField,
    ProposalDensityField,
    _normalize_positions,
)
from uncertainty_nerf_gs_torch.ops import raymarch
from uncertainty_nerf_gs_torch.ops.backend import resolve_device
from uncertainty_nerf_gs_torch.ops.encodings import cell_indices
from uncertainty_nerf_gs_torch.ops.mlp import Dropout
from uncertainty_nerf_gs_torch.ops.sampling import (
    RayBundle,
    _edges_to_samples,
    sample_pdf,
    sample_uniform,
    spacing_piecewise,
    spacing_piecewise_inv,
)
from uncertainty_nerf_gs_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class NerfactoConfig:
    """Model hyper-parameters (nerfstudio NerfactoModelConfig defaults, plus
    the reference's uncertainty knobs); a copy of the JAX package's."""

    near_plane: float = 0.05
    far_plane: float = 1000.0
    num_images: int = 1
    # sampling
    num_proposal_samples: tuple = (256, 96)
    num_nerf_samples: int = 48
    proposal_weights_anneal_max_num_iters: int = 1000
    proposal_weights_anneal_slope: float = 10.0
    # main field
    num_levels: int = 16
    base_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 19
    features_per_level: int = 2
    hidden_dim: int = 64
    hidden_dim_color: int = 64
    geo_feat_dim: int = 15
    num_layers: int = 2
    num_layers_color: int = 3
    appearance_embed_dim: int = 32
    use_appearance_embedding: bool = True
    average_init_density: float = 0.01
    use_scene_contraction: bool = True
    aabb: Any = None
    background_color: str = "last_sample"  # random | last_sample | white | black
    # proposal fields: "hash" (nerfstudio's) or "mlp" (the JAX package's
    # gather-free frequency-encoded MLP); per net through
    # proposal_net_args[i]["field_type"]
    proposal_field_type: str = "hash"
    # hash-grid layout: "cell" (one cell row a lookup), "corner" (tcnn's
    # semantics: eight corner reads a lookup, corners shared) or "hybrid"
    # (canonical corner grids at the dense levels, hashed cells above)
    grid_layout: str = "cell"
    proposal_net_args: tuple = (
        dict(num_levels=5, max_res=128, log2_hashmap_size=17, hidden_dim=16),
        dict(num_levels=5, max_res=256, log2_hashmap_size=17, hidden_dim=16),
    )
    # losses
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.002
    face_consistency_mult: float = 0.0
    face_consistency_samples: int = 1024
    # uncertainty (active-nerfacto)
    uncertainty_channels: int = 0
    beta_min: float = 0.01
    density_loss_mult: float = 0.01
    rendered_uncertainty_eps: float = 1e-6
    # dropout (mc-dropout)
    density_dropout_layers: tuple = ()
    rgb_dropout_layers: tuple = ()
    dropout_rate: float = 0.0
    density_activation: str = "trunc_exp"
    # bf16 hidden MLP compute
    mixed_precision: bool = False
    # rendering
    eval_num_rays_per_chunk: int = 1 << 12


class NerfactoModel(nn.Module):
    """Proposal-sampled hash-grid NeRF; see module docstring. ``device=None``
    is the card, and raises when there is none."""

    def __init__(
        self,
        config: NerfactoConfig,
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = config
        if cfg.aabb is None and not cfg.use_scene_contraction:
            # Blender-style unit-box default when contraction is disabled
            cfg = dataclasses.replace(cfg, aabb=((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5)))
        self.config = cfg
        compute_dtype = torch.bfloat16 if cfg.mixed_precision else None
        kw = dict(device=resolve_device(device), generator=generator)
        self.num_proposal_levels = len(cfg.proposal_net_args)
        for i, args in enumerate(cfg.proposal_net_args):
            self.add_module(f"proposal_{i}", ProposalDensityField(
                num_levels=args.get("num_levels", 5),
                base_res=16,
                max_res=args.get("max_res", 128),
                log2_hashmap_size=args.get("log2_hashmap_size", 17),
                hidden_dim=args.get("hidden_dim", 16),
                use_scene_contraction=cfg.use_scene_contraction,
                aabb=cfg.aabb,
                compute_dtype=compute_dtype,
                field_type=args.get("field_type", cfg.proposal_field_type),
                grid_layout=cfg.grid_layout,
                **kw,
            ))
        self.field = NerfactoField(
            num_images=cfg.num_images,
            num_levels=cfg.num_levels,
            base_res=cfg.base_res,
            max_res=cfg.max_res,
            log2_hashmap_size=cfg.log2_hashmap_size,
            features_per_level=cfg.features_per_level,
            num_layers=cfg.num_layers,
            hidden_dim=cfg.hidden_dim,
            geo_feat_dim=cfg.geo_feat_dim,
            num_layers_color=cfg.num_layers_color,
            hidden_dim_color=cfg.hidden_dim_color,
            appearance_embed_dim=cfg.appearance_embed_dim,
            use_appearance_embedding=cfg.use_appearance_embedding,
            use_scene_contraction=cfg.use_scene_contraction,
            aabb=cfg.aabb,
            num_uncertainty_channels=cfg.uncertainty_channels,
            beta_min=cfg.beta_min,
            density_activation=cfg.density_activation,
            density_dropout_layers=cfg.density_dropout_layers,
            rgb_dropout_layers=cfg.rgb_dropout_layers,
            dropout_rate=cfg.dropout_rate,
            compute_dtype=compute_dtype,
            grid_layout=cfg.grid_layout,
            **kw,
        )

    def _background(self, rgbs: torch.Tensor, draw: torch.Tensor | None) -> torch.Tensor:
        """The background colour: ``draw`` (R, 3) for ``random`` in
        training, zeros for ``random`` at eval; ``last_sample`` carries no
        gradient, as in the JAX package."""
        mode = self.config.background_color
        if mode == "white":
            return torch.ones(3, device=rgbs.device)
        if mode == "last_sample":
            return rgbs[..., -1, :].detach()
        if mode == "random" and draw is not None:
            return draw
        return torch.zeros(3, device=rgbs.device)

    def _next_counts(self) -> list[int]:
        """Samples each ``sample_pdf`` draws: the next proposal's, then the
        main field's."""
        cfg = self.config
        return list(cfg.num_proposal_samples[1:self.num_proposal_levels]) + [cfg.num_nerf_samples]

    def draw(self, num_rays: int, generator: torch.Generator) -> dict[str, Any]:
        """The training forward's random draws, uniform in [0, 1), in the JAX
        package's order: the stratified jitter of ``sample_uniform``
        (R, S0 + 1), one (R, N + 1) per ``sample_pdf``, and the ``random``
        background (R, 3)."""
        cfg = self.config

        def rand(*shape):
            return torch.rand(shape, generator=generator, device=generator.device)

        draws = {
            "uniform": rand(num_rays, cfg.num_proposal_samples[0] + 1),
            "pdf": [rand(num_rays, n + 1) for n in self._next_counts()],
        }
        if cfg.background_color == "random":
            draws["background"] = rand(num_rays, 3)
        return draws

    def _fields(self) -> list[nn.Module]:
        """The fields in the order the forward queries them."""
        props = [getattr(self, f"proposal_{i}") for i in range(self.num_proposal_levels)]
        return props + [self.field]

    def _with_planes(self, ray_bundle: RayBundle) -> RayBundle:
        cfg = self.config
        return ray_bundle._replace(
            nears=torch.full_like(ray_bundle.nears, cfg.near_plane),
            fars=torch.full_like(ray_bundle.fars, cfg.far_plane),
        )

    @torch.no_grad()
    def lookup_cells(
        self, ray_bundle: RayBundle, sdist_list: list[torch.Tensor]
    ) -> torch.Tensor:
        """(R, K) hash-grid cell index of each of the K lookups per ray that
        the forward makes from the spacing edges ``sdist_list`` (one (R, S+1)
        array per field, as ``return_intermediates`` gives them).

        Two runs that agree here read the same cells. Where they differ, a
        sample crossed a cell face between the runs; the cell layout stores
        each cell's corners on their own, so the features jump there and the
        two runs' outputs for that ray are not comparable. An mlp proposal
        makes no lookup."""
        ray_bundle = self._with_planes(ray_bundle)
        num_rays = ray_bundle.origins.shape[0]
        cols = []
        for field, edges in zip(self._fields(), sdist_list):
            enc = getattr(field, "encoding", None)
            if enc is None:
                continue
            positions = _edges_to_samples(
                ray_bundle, edges, spacing_piecewise, spacing_piecewise_inv
            ).positions
            normalized, _ = _normalize_positions(
                positions, field.use_scene_contraction, field.aabb
            )
            for res, size in zip(enc.resolutions, enc.level_sizes):
                idx, _ = cell_indices(normalized.reshape(-1, 3), int(res), size)
                cols.append(idx.reshape(num_rays, -1))
        return torch.cat(cols, dim=1)

    def forward(
        self,
        ray_bundle: RayBundle,
        *,
        train: bool = False,
        proposal_anneal: float = 1.0,
        generator: torch.Generator | None = None,
        draws: dict[str, Any] | None = None,
        use_average_appearance: bool = False,
        return_intermediates: bool = False,
        deterministic_dropout: bool = True,
        dropout_generator: torch.Generator | None = None,
        dropout_masks: dict[str, torch.Tensor] | None = None,
        dropout: Dropout | None = None,
        with_grad: bool = False,
    ) -> dict[str, torch.Tensor]:
        """One ray batch. ``train=False``: the eval forward, without
        gradients, or with them where ``with_grad`` asks (the JAX package's
        ``apply(train=False)`` under ``jax.jacrev``: the pose gradient). ``train=True``: the training forward, with autograd; the
        proposal weights resample as ``w ** proposal_anneal``; the draws are
        ``draws`` (``draw()``'s layout; the parity tests inject the JAX
        package's) or fresh ones from ``generator``, and with neither the
        sampling is the eval's. Train mode adds ``weights_list`` and
        ``sdist_list``; ``return_intermediates`` adds the field's last-layer
        inputs, the final samples' geometry and, as ``sdist_list``, the
        spacing edges each field was queried at. ``deterministic_dropout=
        False`` applies the field's dropout with masks from
        ``dropout_generator`` or ``dropout_masks`` (named as
        ``fields/nerfacto_field.py`` names them), or from ``dropout``, a
        source used as it is."""
        if not deterministic_dropout and dropout is None:
            dropout = Dropout(dropout_generator, dropout_masks)
        kw = dict(use_average_appearance=use_average_appearance,
                  return_intermediates=return_intermediates,
                  dropout=None if deterministic_dropout else dropout)
        if not train:
            if with_grad:
                return self._forward(ray_bundle, False, 1.0, None, **kw)
            return self._eval_forward(ray_bundle, **kw)
        if draws is None and generator is not None:
            draws = self.draw(ray_bundle.origins.shape[0], generator)
        return self._forward(ray_bundle, True, proposal_anneal, draws, **kw)

    @torch.no_grad()
    def _eval_forward(self, ray_bundle: RayBundle, **kw) -> dict[str, torch.Tensor]:
        return self._forward(ray_bundle, False, 1.0, None, **kw)

    def _forward(
        self,
        ray_bundle: RayBundle,
        train: bool,
        proposal_anneal: float,
        draws: dict[str, Any] | None,
        use_average_appearance: bool,
        return_intermediates: bool,
        dropout: Dropout | None,
    ) -> dict[str, torch.Tensor]:
        ray_bundle = self._with_planes(ray_bundle)
        draws = draws or {}
        with span("ungs.nerfacto.proposals"):
            rs, weights_list, sdist_list = self._proposals(ray_bundle, proposal_anneal, draws)
        with span("ungs.nerfacto.field", samples=rs.starts.numel()):
            field_out = self.field(
                rs.positions,
                ray_bundle.directions,
                ray_bundle.camera_indices,
                use_average_appearance=use_average_appearance,
                dropout=dropout,
            )
        with span("ungs.nerfacto.composite"):
            return self._render(field_out, rs, draws, weights_list if train else None,
                                sdist_list if train or return_intermediates else None,
                                return_intermediates)

    @torch.no_grad()
    def forward_mc(
        self,
        ray_bundle: RayBundle,
        dropouts: list[Dropout],
        use_average_appearance: bool = False,
    ) -> list[dict[str, torch.Tensor]]:
        """The eval forward once per dropout draw, each equal to
        ``forward(deterministic_dropout=False)`` with that draw's masks; the
        proposal chain (its hash-grid lookups and both resamples) and the
        field's lookup run once for all of them (``NerfactoField.
        forward_mc``)."""
        ray_bundle = self._with_planes(ray_bundle)
        rs, _, _ = self._proposals(ray_bundle, 1.0, {})
        outs = self.field.forward_mc(rs.positions, ray_bundle.directions, ray_bundle.camera_indices,
                                     dropouts, use_average_appearance=use_average_appearance)
        return [self._render(f, rs, {}, None, None, False) for f in outs]

    def _proposals(self, ray_bundle, proposal_anneal, draws):
        """The proposal hierarchy: the main field's samples, and each
        proposal's weights and spacing edges."""
        cfg = self.config
        pdf_draws = draws.get("pdf", [None] * self.num_proposal_levels)

        weights_list, sdist_list = [], []
        rs = sample_uniform(ray_bundle, cfg.num_proposal_samples[0], draws=draws.get("uniform"))
        for i, n_next in enumerate(self._next_counts()):
            sdist_list.append(rs.spacing_edges)
            d = getattr(self, f"proposal_{i}")(rs.positions)
            w = raymarch.render_weights(d, rs.deltas)
            weights_list.append(w)
            # sample_pdf detaches the weights, as the JAX package's stop_gradient
            if isinstance(proposal_anneal, torch.Tensor):  # computed on the device
                w_annealed = torch.where(proposal_anneal == 1.0, w, w**proposal_anneal)
            else:
                w_annealed = w if proposal_anneal == 1.0 else w**proposal_anneal
            rs = sample_pdf(ray_bundle, rs.spacing_edges, w_annealed, n_next, draws=pdf_draws[i])
        return rs, weights_list, sdist_list

    def _render(self, field_out, rs, draws, weights_list, sdist_list, return_intermediates):
        """Composite the main field's outputs; ``weights_list`` and
        ``sdist_list`` (the proposals', or None) are added with the main
        field's appended."""
        cfg = self.config
        density = cfg.average_init_density * field_out.density
        weights = raymarch.render_weights(density, rs.deltas)

        steps = rs.midpoints
        background = self._background(field_out.rgb, draws.get("background"))
        rgb = raymarch.render_rgb(weights, field_out.rgb, background)
        depth = raymarch.render_median_depth(weights, steps).detach()
        depth_var = raymarch.depth_variance(weights, steps, depth)
        outputs = {
            "rgb": rgb,
            "accumulation": raymarch.render_accumulation(weights),
            "depth": depth,
            "expected_depth": raymarch.render_expected_depth(weights, steps),
            "depth_var": depth_var,
            "depth_std": torch.sqrt(depth_var),
            "density_mean": torch.mean(density),
        }
        if cfg.uncertainty_channels:
            betas = torch.nan_to_num(field_out.uncertainty, nan=0.0)
            rgb_var = raymarch.render_uncertainty(betas, weights**2)
            outputs["rgb_var"] = rgb_var
            outputs["rgb_std"] = torch.sqrt(rgb_var)
        if weights_list is not None:
            outputs["weights_list"] = weights_list + [weights]
        if sdist_list is not None:
            outputs["sdist_list"] = sdist_list + [rs.spacing_edges]
        if return_intermediates:
            outputs["trunk"] = field_out.trunk
            outputs["color_penultimate"] = field_out.color_penultimate
            outputs["deltas"] = rs.deltas
            outputs["steps"] = steps
        return outputs


def nerfacto_loss(
    outputs: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    config: NerfactoConfig,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Training loss of a train-mode forward. Plain nerfacto: MSE +
    interlevel + distortion. Active: the Gaussian NLL
    ``mean((pred - gt)^2 / (2 var)) + 0.5 mean(log var) + 4.0`` plus the
    density L1, in place of the MSE."""
    gt = batch["image"]
    pred = outputs["rgb"]
    losses: dict[str, torch.Tensor] = {}
    if config.uncertainty_channels:
        # torch.maximum, as jnp.maximum, halves the gradient at a tie
        var = torch.maximum(
            outputs["rgb_var"], outputs["rgb_var"].new_full((), config.rendered_uncertainty_eps)
        )
        losses["nll_loss"] = (
            torch.mean((pred - gt) ** 2 / (2.0 * var[..., None]))
            + 0.5 * torch.mean(torch.log(var))
            + 4.0
        )
        losses["density_l1_loss"] = config.density_loss_mult * outputs["density_mean"]
    else:
        losses["rgb_loss"] = torch.mean((pred - gt) ** 2)
    final_sdist = outputs["sdist_list"][-1]
    final_weights = outputs["weights_list"][-1]
    losses["interlevel_loss"] = config.interlevel_loss_mult * raymarch.interlevel_loss(
        final_sdist, final_weights, outputs["sdist_list"][:-1], outputs["weights_list"][:-1]
    )
    losses["distortion_loss"] = config.distortion_loss_mult * raymarch.distortion_loss(
        final_sdist, final_weights
    )
    total = sum(losses.values())
    return total, losses


def proposal_anneal_factor(step: int | torch.Tensor, config: NerfactoConfig) -> float | torch.Tensor:
    """Nerfacto's proposal-weight annealing, bias(x, s) = s x / ((s - 1) x + 1)
    with x = clip(step / n, 0, 1), in float32 as the JAX package computes it.
    A step held on the device gives a float32 0-dim tensor there, the same
    bits as the host's float."""
    if isinstance(step, torch.Tensor):
        x = torch.clamp(step.to(torch.float32) / float(np.float32(config.proposal_weights_anneal_max_num_iters)),
                        0.0, 1.0)
        s = float(np.float32(config.proposal_weights_anneal_slope))
        return s * x / ((s - 1.0) * x + 1.0)
    f32 = np.float32
    x = np.clip(f32(step) / f32(config.proposal_weights_anneal_max_num_iters), f32(0), f32(1))
    s = f32(config.proposal_weights_anneal_slope)
    return float(s * x / ((s - f32(1.0)) * x + f32(1.0)))
