"""Post-hoc linearized Laplace approximation over the field's last layers.

Counterpart of ``uncertainty_nerf_gs_tpu/models/laplace.py`` (nerfacto-
laplace), with its semantics:

* ``fit_laplace``: the diagonal GGN of the sum-reduction MSE loss (scale 2,
  no normalisation over rays or channels) with respect to the density and
  rgb heads, ``sum_{rays, channels} 2 (d rgb / d theta)^2``, from per-ray
  Jacobians (``torch.func.vmap`` of ``jacrev``) of the rendered colour as a
  function of the two heads. The field's trunk and colour features come
  from the eval forward (``return_intermediates``) under ``no_grad``: a
  batch launches K1 twice and K4 three times, and no K5.
* ``laplace_render``: for a linear head under a diagonal Gaussian weight
  posterior the pre-activation is Gaussian, ``N(W x + b, sum_i var_wi x_i^2
  + var_b)``; it is sampled directly and pushed through the activation
  (biased MC variance ``E[f^2] - E[f]^2``). The rgb variance is ReLU'd,
  channel-averaged and rendered with squared weights; depth uses
  rectified-Gaussian density draws (std floored at 1e-10) averaged over
  their compositing weights.
* ``fit_laplace_full_cov`` / ``sample_laplace_full_cov``: the full GGN of
  each head and joint weight draws from ``N(theta, (GGN + p I)^-1)``.

Head parameters are in this package's layout (``weight`` (out, in),
``bias``); ``interop.laplace_posterior_from_jax`` converts the JAX
package's. The full-covariance matrices flatten each head as the JAX
package does (bias, then the (in, out) kernel row by row), so the two
packages' matrices compare entry for entry. Random normal draws are taken
as arguments (the parity tests hand in the JAX package's) or drawn from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.func import jacrev, vmap

from uncertainty_nerf_gs_torch.models.nerfacto import NerfactoConfig, NerfactoModel
from uncertainty_nerf_gs_torch.ops import raymarch
from uncertainty_nerf_gs_torch.ops.activations import trunc_exp
from uncertainty_nerf_gs_torch.ops.sampling import RayBundle

HEADS = ("density_head", "rgb_head")


class LaplacePosterior(NamedTuple):
    """Diagonal GGN for the density and rgb heads: {"weight", "bias"} each,
    in the heads' own shapes."""

    density_head: dict
    rgb_head: dict


def _density_activation(config: NerfactoConfig) -> Callable:
    if config.density_activation == "trunc_exp":
        return lambda x: config.average_init_density * trunc_exp(x)
    return lambda x: config.average_init_density * F.softplus(x)


def _heads(model: NerfactoModel) -> dict:
    """The two heads' parameters, detached: {head: {"weight", "bias"}}."""
    return {h: {k: getattr(getattr(model.field, h), k).detach() for k in ("weight", "bias")}
            for h in HEADS}


def _render_ray_from_heads(
    heads: dict, trunk: torch.Tensor, pen: torch.Tensor, deltas: torch.Tensor, config: NerfactoConfig
) -> torch.Tensor:
    """Rendered rgb (3,) of one ray, trunk (S, W), pen (S, Wc), deltas (S,),
    as a function of the two heads' parameters."""
    act = _density_activation(config)
    d, r = heads["density_head"], heads["rgb_head"]
    raw = trunk @ d["weight"].T + d["bias"]
    density = act(raw[..., 0])
    weights = raymarch.render_weights(density[None, :], deltas[None, :])[0]
    rgb_s = torch.sigmoid(pen @ r["weight"].T + r["bias"])
    comp = torch.sum(weights[:, None] * rgb_s, dim=0)
    if config.background_color == "last_sample":
        comp = comp + (1.0 - torch.sum(weights)) * rgb_s[-1]
    elif config.background_color == "white":
        comp = comp + (1.0 - torch.sum(weights))
    return comp


def _intermediates(model: NerfactoModel, ray_bundle: RayBundle, **kw) -> dict:
    return model(ray_bundle, train=False, return_intermediates=True, **kw)


def fit_laplace(
    model: NerfactoModel, batch_iter: Callable[[int], RayBundle], config: NerfactoConfig,
    n_iters: int = 300,
) -> LaplacePosterior:
    """The diagonal GGN over ``n_iters`` batches (``batch_iter(step)`` -> a
    RayBundle of training rays; the reference default is 300 batches of
    4,096 rays)."""
    heads = _heads(model)
    jac_fn = vmap(jacrev(_render_ray_from_heads), in_dims=(None, 0, 0, 0, None))
    total = None
    for i in range(n_iters):
        inter = _intermediates(model, batch_iter(i))
        jacs = jac_fn(heads, inter["trunk"], inter["color_penultimate"], inter["deltas"], config)
        # the GGN of MSELoss(reduction="sum"): d2L/df2 = 2
        g = {h: {k: 2.0 * torch.sum(v**2, dim=(0, 1)) for k, v in jacs[h].items()} for h in HEADS}
        total = g if total is None else {
            h: {k: total[h][k] + g[h][k] for k in g[h]} for h in HEADS}
    return LaplacePosterior(density_head=total["density_head"], rgb_head=total["rgb_head"])


def _linear_posterior_moments(x, head, head_ggn, prior_prec: float, eps: float):
    """Mean and variance of y = W x + b under the diagonal posterior; x
    (..., D), weight (O, D). Returns mu (..., O), var (..., O)."""
    var_weight = 1.0 / (head_ggn["weight"] + prior_prec + eps)
    var_bias = 1.0 / (head_ggn["bias"] + prior_prec + eps)
    mu = x @ head["weight"].T + head["bias"]
    var = (x**2) @ var_weight.T + var_bias
    return mu, var


def _pushforward_moments(mu, var, activation: Callable, noise: torch.Tensor):
    """MC mean and biased variance of activation(N(mu, var)) over the
    leading axis of ``noise`` (n_samples, *mu.shape)."""
    std = torch.sqrt(torch.clamp(var, min=0.0))
    f = activation(mu[None] + std[None] * noise)
    f_mean = torch.mean(f, dim=0)
    return f_mean, torch.mean(f**2, dim=0) - f_mean**2


def laplace_draws(shape: tuple, n_samples: int, num_density_draws: int,
                  generator: torch.Generator) -> dict:
    """The render's standard normal draws for rays of samples ``shape`` (R,
    S), in the JAX package's order: the density pushforward's, the rgb
    pushforward's and the density draws'."""
    def normal(*s):
        return torch.randn(s, generator=generator, device=generator.device)

    return dict(density=normal(n_samples, *shape), rgb=normal(n_samples, *shape, 3),
                draws=normal(num_density_draws, *shape))


@torch.no_grad()
def laplace_render(
    model: NerfactoModel,
    posterior: LaplacePosterior,
    ray_bundle: RayBundle,
    config: NerfactoConfig,
    noise: dict | None = None,
    generator: torch.Generator | None = None,
    n_samples: int = 100,
    prior_prec: float = 1.0,
    eps: float = 1e-9,
    use_deterministic_density: bool = False,
    num_density_draws: int = 100,
) -> dict[str, torch.Tensor]:
    """Predictive mean and spread of a ray chunk (the reference's
    ``get_outputs_unc``). ``noise`` holds the standard normal draws
    (``laplace_draws``' layout: ``density`` (n_samples, R, S), ``rgb``
    (n_samples, R, S, 3), ``draws`` (num_density_draws, R, S)), or they are
    drawn from ``generator``."""
    inter = _intermediates(model, ray_bundle, use_average_appearance=True)
    trunk, pen = inter["trunk"], inter["color_penultimate"]
    deltas, steps = inter["deltas"], inter["steps"]
    if noise is None:
        noise = laplace_draws(tuple(deltas.shape), n_samples, num_density_draws, generator)
    heads = _heads(model)
    act = _density_activation(config)

    # density posterior (activated space)
    mu_d, var_d = _linear_posterior_moments(
        trunk, heads["density_head"], posterior.density_head, prior_prec, eps)
    density_mean, density_var = _pushforward_moments(mu_d[..., 0], var_d[..., 0], act, noise["density"])
    # rgb posterior through the sigmoid, channel-averaged variance
    mu_y, var_y = _linear_posterior_moments(pen, heads["rgb_head"], posterior.rgb_head, prior_prec, eps)
    rgb_mean, rgb_var = _pushforward_moments(mu_y, var_y, torch.sigmoid, noise["rgb"])
    rgb_var = torch.clamp(rgb_var, min=0.0).mean(dim=-1)  # (R, S)

    weights = raymarch.render_weights(density_mean, deltas)
    dev = weights.device
    if config.background_color == "last_sample":
        background = rgb_mean[..., -1, :]
    elif config.background_color == "white":
        background = torch.ones(3, device=dev)
    else:
        background = torch.zeros(3, device=dev)
    rgb = raymarch.render_rgb(weights, rgb_mean, background)
    rgb_var_rendered = raymarch.render_uncertainty(rgb_var, weights**2)

    if use_deterministic_density:
        weights_d = weights
    else:
        density_std = torch.clamp(torch.sqrt(torch.clamp(density_var, min=0.0)), min=1e-10)
        density_std = torch.nan_to_num(density_std, nan=1e-10)
        sampled = torch.relu(density_mean[None] + density_std[None] * noise["draws"])
        weights_d = torch.mean(raymarch.render_weights(sampled, deltas[None]), dim=0)

    depth = raymarch.render_median_depth(weights_d, steps)
    depth_var = raymarch.depth_variance(weights_d, steps, depth)
    return {
        "rgb": rgb,
        "rgb_var": rgb_var_rendered,
        "rgb_std": torch.sqrt(rgb_var_rendered),
        "accumulation": raymarch.render_accumulation(weights_d),
        "depth": depth,
        "depth_var": depth_var,
        "depth_std": torch.sqrt(depth_var),
        "expected_depth": raymarch.render_expected_depth(weights_d, steps),
    }


# -- the full-covariance variant (reference laplace_field.py:570-608) ----------


def _flatten_head(head: dict) -> torch.Tensor:
    """The JAX package's order: the bias, then the (in, out) kernel row by
    row."""
    return torch.cat([head["bias"].reshape(-1), head["weight"].T.reshape(-1)])


def _unflatten_head(flat: torch.Tensor, like: dict) -> dict:
    """Inverse of ``_flatten_head`` over a leading batch of rows."""
    nb = like["bias"].numel()
    out_dim, in_dim = like["weight"].shape
    lead = flat.shape[:-1]
    return {"bias": flat[..., :nb].reshape(lead + like["bias"].shape),
            "weight": flat[..., nb:].reshape(lead + (in_dim, out_dim)).transpose(-1, -2)}


def fit_laplace_full_cov(
    model: NerfactoModel, batch_iter: Callable[[int], RayBundle], config: NerfactoConfig,
    n_iters: int = 50,
) -> dict[str, torch.Tensor]:
    """Each head's full GGN, {"density_head": (D, D), "rgb_head": (D', D')}
    (D its parameter count, in ``_flatten_head``'s order), summed over
    ``n_iters`` batches of per-ray ``J^T J`` (scale 2); the cross-head
    block is dropped, as the reference treats each layer apart."""
    heads = _heads(model)
    theta = torch.cat([_flatten_head(heads[h]) for h in HEADS])
    d_size = _flatten_head(heads["density_head"]).numel()

    def render(flat, tr, pe, de):
        split = {"density_head": _unflatten_head(flat[:d_size], heads["density_head"]),
                 "rgb_head": _unflatten_head(flat[d_size:], heads["rgb_head"])}
        return _render_ray_from_heads(split, tr, pe, de, config)

    def ray_contrib(tr, pe, de):
        jac = jacrev(render)(theta, tr, pe, de)  # (3, dim)
        return jac.T @ jac

    total = torch.zeros((theta.numel(), theta.numel()), device=theta.device)
    for i in range(n_iters):
        inter = _intermediates(model, batch_iter(i))
        contrib = vmap(ray_contrib)(inter["trunk"], inter["color_penultimate"], inter["deltas"])
        total = total + 2.0 * torch.sum(contrib, dim=0)
    return {"density_head": total[:d_size, :d_size], "rgb_head": total[d_size:, d_size:]}


def sample_laplace_full_cov(
    head: dict,
    full_ggn: torch.Tensor,
    n_samples: int = 100,
    prior_prec: float = 1.0,
    eps: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Joint weight draws theta ~ N(theta_map, (GGN + p I)^-1) of one head:
    {"weight": (n, out, in), "bias": (n, out)}. ``eps`` (n, D) standard
    normal draws, or drawn from ``generator``."""
    theta = _flatten_head(head)
    dim = theta.numel()
    prec = full_ggn + prior_prec * torch.eye(dim, device=theta.device)
    lower = torch.linalg.cholesky(prec)
    if eps is None:
        eps = torch.randn((n_samples, dim), generator=generator, device=theta.device)
    # L^T z = eps gives z ~ N(0, prec^-1)
    z = torch.linalg.solve_triangular(lower.T, eps.T, upper=True).T
    return _unflatten_head(theta[None] + z, head)
