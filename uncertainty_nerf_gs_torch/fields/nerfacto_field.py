"""Nerfacto-style radiance field (hash grid + MLPs) with uncertainty hooks.

Counterpart of ``uncertainty_nerf_gs_tpu/fields/nerfacto_field.py``, with
the cell, hybrid and corner grid layouts (``grid_layout``;
``ops/encodings.py``).
The base MLP ends in a shared trunk from which ``density_head``,
``geo_head`` and the optional aleatoric ``unc_head`` branch; the color MLP
(``color_trunk``) ends in a separate ``rgb_head`` before the sigmoid. Module
and parameter names follow the flax tree, so ``interop.py`` maps weights
one to one. A ``Dropout`` passed to a forward applies the MLPs' dropout
(MC-dropout); its masks are named ``base_mlp.{layer}`` and
``color_trunk.{layer}``. ``forward_mc`` evaluates several dropout draws
and runs once what no draw changes: the hash-grid lookup and the layers
before the first dropout. ``ProposalDensityField(field_type="mlp")`` is the
JAX package's gather-free proposal: the NeRF frequency encoding of the
normalized position (5 frequencies and the input) into its MLP.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from uncertainty_nerf_gs_torch.ops.activations import shifted_softplus, trunc_exp
from uncertainty_nerf_gs_torch.ops.encodings import (
    CellHashEncoding,
    HashEncoding,
    HybridHashEncoding,
    nerf_encoding,
    sh_encoding,
)
from uncertainty_nerf_gs_torch.ops.mlp import MLP, Dropout, init_dense
from uncertainty_nerf_gs_torch.ops.spatial import contract_to_unit_cube, normalize_aabb


class FieldOutputs(NamedTuple):
    density: torch.Tensor  # (..., S)
    rgb: torch.Tensor  # (..., S, 3)
    uncertainty: torch.Tensor | None  # (..., S) aleatoric betas, or None
    density_before_activation: torch.Tensor  # (..., S)
    trunk: torch.Tensor  # (..., S, W) shared base features
    color_penultimate: torch.Tensor  # (..., S, W) rgb_head inputs


# The JAX package's layouts: "corner" is tcnn's (eight corner reads a lookup)
_GRID_LAYOUTS = {"cell": CellHashEncoding, "corner": HashEncoding, "hybrid": HybridHashEncoding}


def _encoding(grid_layout: str, **kw) -> nn.Module:
    if grid_layout not in _GRID_LAYOUTS:
        raise ValueError(f"unknown grid_layout {grid_layout!r}; one of {sorted(_GRID_LAYOUTS)}")
    return _GRID_LAYOUTS[grid_layout](**kw)


@functools.lru_cache(maxsize=None)
def _box(aabb: tuple, device: torch.device) -> torch.Tensor:
    """The (2, 3) box on ``device``, made once: a captured training step
    (``NerfactoTrainer``'s CUDA graph) cannot hold a host-to-device copy."""
    return torch.as_tensor(aabb, dtype=torch.float32, device=device)


def _normalize_positions(positions, use_scene_contraction: bool, aabb):
    """Hash-grid inputs in [0, 1]^3 and the inside-the-box selector."""
    if use_scene_contraction:
        normalized = contract_to_unit_cube(positions)
        selector = torch.ones(
            positions.shape[:-1], dtype=positions.dtype, device=positions.device
        )
    else:
        box = _box(tuple(tuple(float(v) for v in row) for row in aabb), positions.device)
        normalized = normalize_aabb(positions, box)
        inside = torch.all((normalized >= 0.0) & (normalized <= 1.0), dim=-1)
        selector = inside.to(positions.dtype)
        normalized = torch.clamp(normalized, 0.0, 1.0)
    return normalized, selector


def _scope(dropout: Dropout | None, prefix: str) -> Dropout | None:
    return None if dropout is None else dropout.scoped(prefix)


class NerfactoField(nn.Module):
    """Hash-grid NeRF field; see module docstring."""

    def __init__(
        self,
        num_images: int = 1,
        num_levels: int = 16,
        base_res: int = 16,
        max_res: int = 2048,
        log2_hashmap_size: int = 19,
        features_per_level: int = 2,
        num_layers: int = 2,
        hidden_dim: int = 64,
        geo_feat_dim: int = 15,
        num_layers_color: int = 3,
        hidden_dim_color: int = 64,
        appearance_embed_dim: int = 32,
        use_appearance_embedding: bool = True,
        use_scene_contraction: bool = True,
        aabb: Any = None,
        num_uncertainty_channels: int = 0,
        beta_min: float = 0.01,
        density_activation: str = "trunc_exp",
        density_dropout_layers: Sequence[int] = (),
        rgb_dropout_layers: Sequence[int] = (),
        dropout_rate: float = 0.0,
        sh_levels: int = 4,
        compute_dtype: Any = None,
        grid_layout: str = "cell",
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.use_scene_contraction = use_scene_contraction
        self.aabb = aabb
        self.num_uncertainty_channels = num_uncertainty_channels
        self.beta_min = beta_min
        self.density_activation = density_activation
        self.sh_levels = sh_levels
        self.use_appearance_embedding = use_appearance_embedding
        self.appearance_embed_dim = appearance_embed_dim
        kw = dict(device=device, generator=generator)

        self.encoding = _encoding(
            grid_layout,
            num_levels=num_levels,
            min_res=base_res,
            max_res=max_res,
            log2_hashmap_size=log2_hashmap_size,
            features_per_level=features_per_level,
            **kw,
        )
        self.base_mlp = MLP(
            self.encoding.output_dim,
            num_layers=max(num_layers - 1, 1),
            layer_width=hidden_dim,
            out_dim=hidden_dim,
            out_activation=torch.relu,
            dropout_layers=density_dropout_layers,
            dropout_rate=dropout_rate,
            compute_dtype=compute_dtype,
            **kw,
        )
        self.density_head = init_dense(nn.Linear(hidden_dim, 1, device=device), generator)
        self.geo_head = init_dense(
            nn.Linear(hidden_dim, geo_feat_dim, device=device), generator
        )
        if num_uncertainty_channels:
            self.unc_head = init_dense(
                nn.Linear(hidden_dim, num_uncertainty_channels, device=device),
                generator,
            )
        color_in = geo_feat_dim + sh_levels**2
        if use_appearance_embedding:
            self.appearance_embedding = nn.Embedding(
                num_images, appearance_embed_dim, device=device
            )
            with torch.no_grad():
                self.appearance_embedding.weight.normal_(
                    0.0, appearance_embed_dim**-0.5, generator=generator
                )
            color_in += appearance_embed_dim
        self.color_trunk = MLP(
            color_in,
            num_layers=max(num_layers_color - 1, 1),
            layer_width=hidden_dim_color,
            out_dim=hidden_dim_color,
            out_activation=torch.relu,
            dropout_layers=rgb_dropout_layers,
            dropout_rate=dropout_rate,
            compute_dtype=compute_dtype,
            **kw,
        )
        self.rgb_head = init_dense(
            nn.Linear(hidden_dim_color, 3, device=device), generator
        )

    def _activate_density(self, raw: torch.Tensor) -> torch.Tensor:
        if self.density_activation == "trunc_exp":
            return trunc_exp(raw)
        return F.softplus(raw)

    def _features(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Hash-grid features and the inside-the-box selector."""
        normalized, selector = _normalize_positions(
            positions, self.use_scene_contraction, self.aabb
        )
        return self.encoding(normalized), selector

    def get_trunk(
        self, positions: torch.Tensor, dropout: Dropout | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Hash encode + base trunk. Returns (trunk (..., W), selector)."""
        feats, selector = self._features(positions)
        return self.base_mlp(feats, _scope(dropout, "base_mlp")), selector

    def _density_heads(self, trunk: torch.Tensor, selector: torch.Tensor):
        raw = self.density_head(trunk)[..., 0]
        density = self._activate_density(raw) * selector
        unc = None
        if self.num_uncertainty_channels:
            unc = shifted_softplus(self.unc_head(trunk)[..., 0], self.beta_min)
        return density, unc, raw

    def get_density(self, positions: torch.Tensor, dropout: Dropout | None = None):
        """Density (+ optional aleatoric channel) at positions (..., 3).
        Returns (density, trunk, uncertainty or None, raw density)."""
        trunk, selector = self.get_trunk(positions, dropout)
        density, unc, raw = self._density_heads(trunk, selector)
        return density, trunk, unc, raw

    def get_color_features(
        self,
        trunk: torch.Tensor,
        directions: torch.Tensor,
        camera_indices: torch.Tensor,
        use_average_appearance: bool = False,
        dropout: Dropout | None = None,
    ) -> torch.Tensor:
        """Color-MLP penultimate features; per-ray inputs broadcast over samples."""
        inp = self._color_inputs(trunk, directions, camera_indices, use_average_appearance)
        return self.color_trunk(inp, _scope(dropout, "color_trunk"))

    def _color_inputs(self, trunk, directions, camera_indices, use_average_appearance):
        """The color MLP's input: geo features, SH of the direction and the
        appearance embedding."""
        geo = self.geo_head(trunk)
        sh = sh_encoding(directions, levels=self.sh_levels)
        sh = sh[..., None, :].expand(trunk.shape[:-1] + (sh.shape[-1],))
        parts = [geo, sh]
        if self.use_appearance_embedding:
            shape = trunk.shape[:-1] + (self.appearance_embed_dim,)
            if use_average_appearance:
                embed = torch.mean(self.appearance_embedding.weight, dim=0).expand(shape)
            else:
                # an index, not the module's call: its backward is index_put's
                # sorted accumulation, which adds in a fixed order on the card
                # (nn.Embedding's backward does not)
                embed = self.appearance_embedding.weight[camera_indices][..., None, :]
                embed = embed.expand(shape)
            parts.append(embed)
        return torch.cat(parts, dim=-1)

    def forward_from_feats(
        self,
        feats: torch.Tensor,
        selector: torch.Tensor,
        directions: torch.Tensor,
        camera_indices: torch.Tensor,
        use_average_appearance: bool = False,
        dropout: Dropout | None = None,
    ) -> FieldOutputs:
        """Full field forward from precomputed hash-grid features."""
        return self._outputs(
            feats, selector, directions, camera_indices, [dropout], use_average_appearance
        )[0]

    def forward(
        self,
        positions: torch.Tensor,
        directions: torch.Tensor,
        camera_indices: torch.Tensor,
        use_average_appearance: bool = False,
        dropout: Dropout | None = None,
    ) -> FieldOutputs:
        """positions (R, S, 3); directions (R, 3); camera_indices (R,)."""
        feats, selector = self._features(positions)
        return self.forward_from_feats(
            feats, selector, directions, camera_indices, use_average_appearance, dropout
        )

    def forward_mc(
        self,
        positions: torch.Tensor,
        directions: torch.Tensor,
        camera_indices: torch.Tensor,
        dropouts: list[Dropout],
        use_average_appearance: bool = False,
    ) -> list[FieldOutputs]:
        """One forward per dropout draw in ``dropouts``, each equal to
        ``forward(..., dropout=d)``."""
        feats, selector = self._features(positions)
        return self._outputs(
            feats, selector, directions, camera_indices, dropouts, use_average_appearance
        )

    def _outputs(
        self, feats, selector, directions, camera_indices, dropouts, use_average_appearance
    ) -> list[FieldOutputs]:
        """The outputs for each draw in ``dropouts`` (None for none), with
        every layer before a draw first changes anything run once: the base
        MLP's layers before its first dropout and, where it has none, its
        trunk, the density heads and the color MLP's layers before its
        first dropout."""
        base, color = self.base_mlp, self.color_trunk
        h = base.layers(feats, feats, 0, stop=base.first_dropout)
        outs = []
        for i, d in enumerate(dropouts):
            if i == 0 or base.drops:
                trunk = base.layers(h, feats, base.first_dropout, _scope(d, "base_mlp"))
                density, unc, raw = self._density_heads(trunk, selector)
                inp = self._color_inputs(trunk, directions, camera_indices, use_average_appearance)
                hc = color.layers(inp, inp, 0, stop=color.first_dropout)
            pen = color.layers(hc, inp, color.first_dropout, _scope(d, "color_trunk"))
            outs.append(FieldOutputs(density=density, rgb=torch.sigmoid(self.rgb_head(pen)),
                                     uncertainty=unc, density_before_activation=raw, trunk=trunk,
                                     color_penultimate=pen))
        return outs

    def density_fn(self, positions: torch.Tensor) -> torch.Tensor:
        """Density-only evaluation."""
        return self.get_density(positions)[0]


class ProposalDensityField(nn.Module):
    """Small density-only field for the proposal hierarchy: nerfacto's
    ``HashMLPDensityField`` (``field_type="hash"``), or the JAX package's
    gather-free ``"mlp"`` variant (frequency encoding, no grid)."""

    def __init__(
        self,
        num_levels: int = 5,
        base_res: int = 16,
        max_res: int = 128,
        log2_hashmap_size: int = 17,
        features_per_level: int = 2,
        num_layers: int = 2,
        hidden_dim: int = 16,
        use_scene_contraction: bool = True,
        aabb: Any = None,
        compute_dtype: Any = None,
        field_type: str = "hash",
        num_frequencies: int = 5,
        grid_layout: str = "cell",
        *,
        device: torch.device | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if field_type not in ("hash", "mlp"):
            raise ValueError(f"unknown proposal field_type {field_type!r}")
        self.field_type = field_type
        self.num_frequencies = num_frequencies
        self.use_scene_contraction = use_scene_contraction
        self.aabb = aabb
        kw = dict(device=device, generator=generator)
        if field_type == "mlp":
            in_dim = 3 + 3 * 2 * num_frequencies  # the input, then sin and cos of each frequency
        else:
            self.encoding = _encoding(
                grid_layout,
                num_levels=num_levels,
                min_res=base_res,
                max_res=max_res,
                log2_hashmap_size=log2_hashmap_size,
                features_per_level=features_per_level,
                **kw,
            )
            in_dim = self.encoding.output_dim
        self.mlp = MLP(
            in_dim,
            num_layers=num_layers,
            layer_width=hidden_dim,
            out_dim=1,
            compute_dtype=compute_dtype,
            **kw,
        )

    def density_from_feats(self, feats: torch.Tensor, selector: torch.Tensor) -> torch.Tensor:
        """Density from precomputed grid features."""
        return trunc_exp(self.mlp(feats)[..., 0]) * selector

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        normalized, selector = _normalize_positions(
            positions, self.use_scene_contraction, self.aabb
        )
        if self.field_type == "mlp":
            feats = nerf_encoding(normalized, num_frequencies=self.num_frequencies, min_freq_exp=0.0,
                                  max_freq_exp=float(self.num_frequencies - 1), include_input=True)
        else:
            feats = self.encoding(normalized)
        return self.density_from_feats(feats, selector)
