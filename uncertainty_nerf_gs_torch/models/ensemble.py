"""Deep-ensemble rendering: M members' parameters over one model.

Counterpart of ``uncertainty_nerf_gs_tpu/models/ensemble.py``. The members
are one dict of (M, ...) tensors under the model's state-dict names
(``interop.stack_params``); ``member_apply`` runs one member through any of
the model's methods with ``torch.func.functional_call``, which puts member
m's slices (views, not copies) in place of the model's own parameters for
the call. ``ensemble_render`` is the per-member render
(``member_outputs``: each member's own eval forward, with its own proposal
chain); ``combine_ensemble_outputs`` is the reference's combination rule
(``ensemble_pipeline.py:159-190``):

* every output key -> mean over members;
* with aleatoric heads (``rgb_std`` and ``depth_std`` present), for rgb and
  depth: ``*_var_alea`` the channel-averaged member mean of the predicted
  variance, ``*_var_epi`` the channel-averaged unbiased variance across
  members of the means, and their sum as ``*_var_combined`` /
  ``*_std_combined``; ``parity_mode=True`` keeps ``*_var``/``*_std`` as the
  member means, as the reference's later keys overwrite them, and
  ``parity_mode=False`` writes the combined values there;
* without them, ``*_std`` the channel-averaged unbiased std across members
  for rgb, depth and expected depth, and ``*_var`` its square.

``ensemble_render_splat`` renders a splat ensemble: the members share the
buffer's capacity and differ in their parameters and alive masks, so they
stack on a leading axis; each member is one ``render_splat`` (one K2 launch
a member on the card), and the members' outputs are combined by the same
rule.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
from torch import nn
from torch.func import functional_call

from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel
from uncertainty_nerf_gs_torch.models.splatfacto import SplatfactoConfig, render_splat
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle


class _Method(nn.Module):
    """``fn(model, *args, **kwargs)`` as a module's forward, so that
    ``functional_call`` can swap a member's parameters in for any method."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def member_params(stacked_params: Mapping[str, torch.Tensor], m: int) -> dict[str, torch.Tensor]:
    """Member m's parameters: views into the stacked tensors."""
    return {k: v[m] for k, v in stacked_params.items()}


def member_apply(model: nn.Module, params: Mapping[str, torch.Tensor], fn: Callable, *args, **kwargs):
    """``fn(model, *args, **kwargs)`` with ``params`` (a state dict's names
    and shapes) in place of the model's parameters for the call."""
    return functional_call(_Method(model, fn), {f"model.{k}": v for k, v in params.items()},
                           args, kwargs)


def _channel_mean(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``.mean(dim=-1)`` channel reduction: a trailing axis
    of 3 (rgb channels) is averaged, a trailing 1 squeezed; anything else
    (an (H, W) splat map) passes through."""
    if x.dim() > 1 and x.shape[-1] == 3:
        return torch.mean(x, dim=-1)
    if x.dim() > 1 and x.shape[-1] == 1:
        return x[..., 0]
    return x


def stack_outputs(outputs: list[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """M members' output dicts -> one dict of (M, ...) tensors."""
    return {k: torch.stack([o[k] for o in outputs]) for k in outputs[0]}


def member_outputs(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    ray_bundle: RayBundle,
    use_average_appearance: bool = True,
) -> dict[str, torch.Tensor]:
    """Each member's own eval forward of a ray chunk, one after another (its
    own proposal chain: K1 twice and K4 three times a member on the card),
    stacked: a dict of (M, ...) outputs."""
    m = next(iter(stacked_params.values())).shape[0]
    return stack_outputs([
        member_apply(model, member_params(stacked_params, j),
                     lambda mdl, rb: mdl(rb, use_average_appearance=use_average_appearance), ray_bundle)
        for j in range(m)
    ])


def ensemble_render(
    model: NerfactoModel,
    stacked_params: Mapping[str, torch.Tensor],
    ray_bundle: RayBundle,
    use_average_appearance: bool = True,
) -> dict[str, torch.Tensor]:
    """Ensemble mean and epistemic/aleatoric variance for a ray chunk:
    ``member_outputs``, then ``combine_ensemble_outputs``."""
    return combine_ensemble_outputs(member_outputs(model, stacked_params, ray_bundle, use_average_appearance))


def combine_ensemble_outputs(
    stacked: Mapping[str, torch.Tensor], parity_mode: bool = True
) -> dict[str, torch.Tensor]:
    """Reduce a dict of (M, ...) member outputs to mean and uncertainty; see
    the module docstring."""
    outputs: dict[str, Any] = {k: torch.mean(v, dim=0) for k, v in stacked.items()}
    if "rgb_std" in stacked and "depth_std" in stacked:
        for k in ("rgb", "depth"):
            var_alea = _channel_mean(torch.mean(stacked[k + "_var"], dim=0))
            var_epi = _channel_mean(torch.var(stacked[k], dim=0, unbiased=True))
            outputs[k + "_var_alea"] = var_alea
            outputs[k + "_var_epi"] = var_epi
            outputs[k + "_var_combined"] = var_epi + var_alea
            outputs[k + "_std_combined"] = torch.sqrt(var_epi + var_alea)
            if not parity_mode:
                outputs[k + "_var"] = outputs[k + "_var_combined"]
                outputs[k + "_std"] = outputs[k + "_std_combined"]
    else:
        for k in ("rgb", "depth", "expected_depth"):
            if k in stacked:
                outputs[k + "_std"] = _channel_mean(torch.std(stacked[k], dim=0, unbiased=True))
                outputs[k + "_var"] = outputs[k + "_std"] ** 2
    return outputs


def ensemble_render_splat(
    stacked_params: Mapping[str, torch.Tensor],
    stacked_alive: torch.Tensor,
    c2w: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
    config: SplatfactoConfig,
    background: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The splat ensemble's combined outputs for one camera: each member's
    ``render_splat`` at the full SH degree, then
    ``combine_ensemble_outputs`` without the per-Gaussian and overflow
    keys."""
    outs = [
        render_splat(member_params(stacked_params, m), stacked_alive[m], c2w, fx, fy, cx, cy,
                     width, height, config, sh_deg=config.sh_degree, background=background)
        for m in range(stacked_alive.shape[0])
    ]
    keys = [k for k in outs[0] if k not in ("radii", "visible", "raster_overflow")]
    return combine_ensemble_outputs(stack_outputs([{k: o[k] for k in keys} for o in outs]))
