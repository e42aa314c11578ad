"""MC-dropout inference: ``mc_samples`` stochastic forwards of a ray chunk.

Counterpart of ``uncertainty_nerf_gs_tpu/models/mcdropout.py``. The JAX
package ``vmap``s the eval forward over ``mc_samples`` dropout keys; what
does not depend on the key (the proposal chain, its two resamples and the
field's hash-grid lookup) stays unbatched there. The port runs those once a
chunk too (``NerfactoModel.forward_mc``): a chunk launches K1 twice and K4
three times whatever ``mc_samples`` is, and repeats only the MLP layers from
the first dropout on, the heads and the compositing.

Outputs match the JAX package's: the mean over samples of every output,
plus ``{rgb,depth,expected_depth}_std`` (the standard deviation over
samples with ``ddof=1``, averaged over channels) and ``_var`` (its square).
"""

from __future__ import annotations

from typing import Sequence

import torch

from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoModel
from uncertainty_nerf_gs_torch.ops.mlp import Dropout
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle

_MC_KEYS = ("rgb", "depth", "expected_depth")


@torch.no_grad()
def mc_dropout_render(
    model: NerfactoModel,
    ray_bundle: RayBundle,
    mc_samples: int,
    generator: torch.Generator | None = None,
    masks: Sequence[dict[str, torch.Tensor]] | None = None,
    use_average_appearance: bool = True,
) -> dict[str, torch.Tensor]:
    """Mean and spread over ``mc_samples`` dropout-perturbed eval forwards.
    Each sample's masks come from ``generator``, or are ``masks[i]`` (names
    as ``fields/nerfacto_field.py`` gives them)."""
    if masks is not None and len(masks) != mc_samples:
        raise ValueError(f"{len(masks)} mask sets for {mc_samples} samples")
    dropouts = [Dropout(masks=m) for m in masks] if masks is not None else [
        Dropout(generator=generator) for _ in range(mc_samples)]
    samples = model.forward_mc(ray_bundle, dropouts, use_average_appearance=use_average_appearance)
    stacked = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    outputs = {k: torch.mean(v, dim=0) for k, v in stacked.items()}
    for k in _MC_KEYS:
        if k in stacked:
            std = torch.std(stacked[k], dim=0, correction=1)
            if std.dim() > 1 and std.shape[-1] > 1:
                std = torch.mean(std, dim=-1)
            outputs[k + "_std"] = std
            outputs[k + "_var"] = std**2
    return outputs
