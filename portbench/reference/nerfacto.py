"""Plain PyTorch nerfacto: rays, proposal sampling, the cell hash grid, the
field's MLPs, compositing, active-nerfacto's loss and per-group Adam.

The reference the benchmark holds the program to. It follows nerfstudio's
nerfacto and the uncertainty plugin's active variant as the configuration
files under ``portbench/configs`` state them: two proposal density fields
(256 -> 96 -> 48 samples, piecewise spacing, Mip-NeRF 360 contraction), a
cell-layout hash grid (each cell stores its 8 corners, F features each;
corner order c = 4x + 2y + z; a level's cell is its dense index where
res^3 fits the table, else the spatial hash of its base corner), a one-layer
base MLP into density, geometry and aleatoric-variance heads, spherical
harmonics of degree 3 and an appearance embedding into the colour MLP, the
Gaussian NLL with the density L1, the interlevel and distortion losses, and
Adam with nerfstudio's exponential decay after a linear warmup.

Parameters come as one dict of tensors under the module paths the
configuration file lists (``field.encoding.cells``,
``field.base_mlp.dense_0.weight``, ...). Everything here is float32 with
TF32 off unless a caller turns it on (the benchmark's control does). It
imports nothing of the measured program.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.k1 import resample_edges

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
_TRUNC_MAX = 15.0


# -- the hash grid ----------------------------------------------------------


def grid_resolutions(num_levels: int, min_res: int, max_res: int) -> list[int]:
    """N_l = floor(N_min * b^l), tcnn's growth factor b."""
    growth = math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1)) if num_levels > 1 else 1.0
    return [int(math.floor(min_res * growth**lvl)) for lvl in range(num_levels)]


def cell_indices(positions: torch.Tensor, res: int, table_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 3) positions in [0, 1] -> (cell index (n,), corner weights (n, 8))."""
    scaled = positions * res
    base = torch.floor(torch.clamp(scaled, 0, res * (1 - 1e-7))).to(torch.int64)
    base = torch.clamp(base, max=res - 1)
    frac = scaled - base.to(scaled.dtype)
    if res**3 <= table_size:
        idx = base[..., 0] + res * (base[..., 1] + res * base[..., 2])
    else:
        h = (base[..., 0] * _PRIMES[0]) & _U32
        h = h ^ ((base[..., 1] * _PRIMES[1]) & _U32)
        h = h ^ ((base[..., 2] * _PRIMES[2]) & _U32)
        idx = h % table_size
    wx = torch.stack([1.0 - frac[..., 0], frac[..., 0]], -1)
    wy = torch.stack([1.0 - frac[..., 1], frac[..., 1]], -1)
    wz = torch.stack([1.0 - frac[..., 2], frac[..., 2]], -1)
    w = (wx[..., :, None, None] * wy[..., None, :, None] * wz[..., None, None, :]).reshape(
        positions.shape[:-1] + (8,))
    return idx, w


def corner_sum(products: torch.Tensor) -> torch.Tensor:
    """(n, 8, ...) -> (n, ...): ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))."""
    pairs = products[:, 0::2] + products[:, 1::2]
    quads = pairs[:, 0::2] + pairs[:, 1::2]
    return quads[:, 0] + quads[:, 1]


def grid_lookup(cells: torch.Tensor, positions: torch.Tensor, resolutions, table_size: int,
                features: int) -> torch.Tensor:
    """cells (L, rows, 128) with 128 / (8 F) cells a row; positions (n, 3) ->
    (n, L F), level-major. Differentiable by autograd."""
    outs = []
    for lvl, res in enumerate(resolutions):
        idx, w = cell_indices(positions, int(res), table_size)
        corners = cells[lvl].reshape(-1, 8, features)[idx]
        outs.append(corner_sum(corners * w[..., None]))
    return torch.cat(outs, dim=-1)


# -- activations, encodings, space -------------------------------------------


class _TruncExp(torch.autograd.Function):
    """exp(min(x, 15)); its gradient g exp(clip(x, -15, 15))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=_TRUNC_MAX))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -_TRUNC_MAX, _TRUNC_MAX))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def sh_encoding(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 3 of unit directions: (..., 16)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [
        torch.full_like(x, 0.28209479177387814),
        0.4886025119029199 * y, 0.4886025119029199 * z, 0.4886025119029199 * x,
        1.0925484305920792 * xy, 1.0925484305920792 * yz, 0.9461746957575601 * zz - 0.31539156525252005,
        1.0925484305920792 * xz, 0.5462742152960396 * (xx - yy),
        0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * xy * z,
        0.4570457994644658 * y * (5.0 * zz - 1.0), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.4570457994644658 * x * (5.0 * zz - 1.0), 1.445305721320277 * z * (xx - yy),
        0.5900435899266435 * x * (xx - 3.0 * yy),
    ]
    return torch.stack(comps, dim=-1)


def contract(x: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360's contraction under the L-inf norm, then [-2, 2]^3 -> [0, 1]^3."""
    mag = torch.clamp(torch.amax(torch.abs(x), dim=-1, keepdim=True), min=1e-9)
    contracted = torch.where(mag <= 1.0, x, (2.0 - 1.0 / mag) * (x / mag))
    return (contracted + 2.0) / 4.0


def mlp(params: Mapping[str, torch.Tensor], prefix: str, x: torch.Tensor, layers: int,
        out_relu: bool) -> torch.Tensor:
    """``layers`` linear layers ``{prefix}dense_{i}``, ReLU between them."""
    h = x
    for i in range(layers):
        h = F.linear(h, params[f"{prefix}dense_{i}.weight"], params[f"{prefix}dense_{i}.bias"])
        if i < layers - 1:
            h = torch.relu(h)
    return torch.relu(h) if out_relu else h


# -- cameras and rays --------------------------------------------------------


def _skew(v: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def so3xr3(tangent: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 6) [translation, rotation] -> (..., 3, 4); Rodrigues with the
    Taylor branch (and a finite gradient) at |omega|^2 <= eps^2."""
    omega = tangent[..., 3:]
    k = _skew(omega)
    theta_sq = torch.sum(omega * omega, dim=-1, keepdim=True)[..., None]
    safe = theta_sq > eps * eps
    theta = torch.sqrt(torch.where(safe, theta_sq, 1.0))
    a = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta_sq / 6.0)
    b = torch.where(safe, (1.0 - torch.cos(theta)) / torch.where(safe, theta_sq, 1.0), 0.5 - theta_sq / 24.0)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    rot = eye + a * k + b * (k @ k)
    return torch.cat([rot, tangent[..., :3, None]], dim=-1)


def rays(c2w: torch.Tensor, focal: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, cam: torch.Tensor,
         px: torch.Tensor, py: torch.Tensor, pose_tangents: torch.Tensor | None = None):
    """OpenGL pinhole rays through pixel centres: (origins, unit directions)."""
    pose = c2w[cam]
    if pose_tangents is not None:
        delta = so3xr3(pose_tangents[cam])
        r = delta[..., :3, :3] @ pose[..., :3, :3]
        t = (delta[..., :3, :3] @ pose[..., :3, 3:])[..., 0] + delta[..., :3, 3]
        pose = torch.cat([r, t[..., None]], dim=-1)
    u = (px + 0.5 - cx[cam]) / focal[cam]
    v = (py + 0.5 - cy[cam]) / focal[cam]
    dirs = torch.stack([u, -v, -torch.ones_like(u)], dim=-1)
    dirs = torch.einsum("rij,rj->ri", pose[..., :3, :3], dirs)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return pose[..., :3, 3], dirs


# -- sampling ----------------------------------------------------------------


def _spacing(x):
    return torch.where(x < 1.0, x / 2.0, 1.0 - 1.0 / (2.0 * torch.clamp(x, min=1e-9)))


def _spacing_inv(x):
    return torch.where(x < 0.5, 2.0 * x, 1.0 / torch.clamp(2.0 - 2.0 * x, min=1e-9))


def _linspace01(n: int, device) -> torch.Tensor:
    step = float(1.0 / torch.tensor(max(n - 1, 1), dtype=torch.float32))
    out = torch.arange(n, dtype=torch.float32, device=device).mul_(step)
    out[-1:].fill_(1.0)
    return out


def _t_edges(s_edges: torch.Tensor, near: torch.Tensor, far: torch.Tensor) -> torch.Tensor:
    s_near = _spacing(near)[..., None]
    s_far = _spacing(far)[..., None]
    return _spacing_inv(s_edges * (s_far - s_near) + s_near)


def uniform_edges(num_rays: int, num_samples: int, draws: torch.Tensor | None, device) -> torch.Tensor:
    edges = _linspace01(num_samples + 1, device).expand(num_rays, num_samples + 1)
    if draws is not None:
        jitter = (draws - 0.5) * (1.0 / num_samples)
        jitter[:, 0].clamp_(min=0.0)
        jitter[:, -1].clamp_(max=0.0)
        edges = edges + jitter
    return edges


def pdf_edges(s_edges: torch.Tensor, weights: torch.Tensor, num_samples: int,
              draws: torch.Tensor | None) -> torch.Tensor:
    n_new = num_samples + 1
    base = torch.arange(n_new, dtype=torch.float32, device=weights.device)
    u = (base + draws) / n_new if draws is not None else (base + 0.5) / n_new
    u = torch.clamp(u, 0.0, 1.0 - 1e-6).expand(weights.shape[0], n_new)
    return resample_edges(weights.detach().contiguous(), s_edges.detach(), u)


class Samples:
    """Samples of R rays between edges (R, S + 1) of the spacing domain."""

    def __init__(self, origins, dirs, near, far, s_edges):
        self.s_edges = s_edges
        t = _t_edges(s_edges, near, far)
        self.starts, self.ends = t[..., :-1], t[..., 1:]
        self.deltas = self.ends - self.starts
        self.mids = 0.5 * (self.starts + self.ends)
        self.positions = origins[..., None, :] + dirs[..., None, :] * self.mids[..., None]


# -- compositing and losses ----------------------------------------------------


def render_weights(density: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    tau = density * deltas
    alphas = 1.0 - torch.exp(-tau)
    accum = torch.cumsum(tau, dim=-1)
    return alphas * torch.exp(-(accum - tau))


def composite(weights, rgbs, mids, betas=None) -> dict[str, torch.Tensor]:
    """rgb over the last sample's colour, accumulation, median and expected
    depth, depth variance, and with ``betas`` the rendered RGB variance."""
    background = rgbs[..., -1, :].detach()
    acc = torch.sum(weights, dim=-1)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2) + (1.0 - acc[..., None]) * background
    cum = torch.cumsum(weights, dim=-1)
    half = torch.full(weights.shape[:-1] + (1,), 0.5, dtype=weights.dtype, device=weights.device)
    idx = torch.clamp(torch.searchsorted(cum.contiguous(), half, right=False), 0, mids.shape[-1] - 1)
    depth = torch.gather(mids, -1, idx)[..., 0].detach()
    expected = torch.sum(weights * mids, dim=-1) / (acc + 1e-10)
    expected = torch.minimum(torch.maximum(expected, torch.amin(mids, dim=-1)), torch.amax(mids, dim=-1))
    depth_var = torch.sum(weights * (mids - depth[..., None]) ** 2, dim=-1) + 1e-5
    out = {"rgb": rgb, "accumulation": acc, "depth": depth, "expected_depth": expected,
           "depth_var": depth_var, "depth_std": torch.sqrt(depth_var)}
    if betas is not None:
        rgb_var = torch.sum(torch.nan_to_num(betas, nan=0.0) * weights**2, dim=-1)
        out["rgb_var"] = rgb_var
        out["rgb_std"] = torch.sqrt(rgb_var)
    return out


def _rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    k, m = values.shape[-1], idx.shape[-1]
    flat = values.reshape(-1, k)
    offsets = torch.arange(flat.shape[0], device=idx.device)[:, None] * k
    return flat.reshape(-1)[idx.reshape(-1, m) + offsets].reshape(idx.shape)


def interlevel_loss(final_edges, final_w, prop_edges, prop_w, eps: float = 1e-7) -> torch.Tensor:
    c, w = final_edges.detach(), final_w.detach()
    total = 0.0
    for cp, wp in zip(prop_edges, prop_w):
        cw = torch.cat([torch.zeros_like(wp[..., :1]), torch.cumsum(wp, dim=-1)], dim=-1)
        cp = cp.contiguous()
        top = cw.shape[-1] - 1
        lo = torch.clamp(torch.searchsorted(cp, c[..., :-1].contiguous(), right=True) - 1, 0, top)
        hi = torch.clamp(torch.searchsorted(cp, c[..., 1:].contiguous(), right=False), 0, top)
        outer = _rows(cw, hi) - _rows(cw, lo)
        total = total + torch.mean(torch.clamp(w - outer, min=0.0) ** 2 / (w + eps))
    return total


def distortion_loss(edges: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    deltas = edges[..., 1:] - edges[..., :-1]
    cw = torch.cumsum(w, dim=-1)
    cwm = torch.cumsum(w * mids, dim=-1)
    pairwise = 2.0 * torch.sum(w * (mids * (cw - w) - (cwm - w * mids)), dim=-1)
    return torch.mean(pairwise + torch.sum(w**2 * deltas, dim=-1) / 3.0)


# -- the model -----------------------------------------------------------------


def _proposal_density(params, i: int, cfg: Mapping[str, Any], positions: torch.Tensor) -> torch.Tensor:
    args = cfg["proposal_net_args"][i]
    res = grid_resolutions(args["num_levels"], 16, args["max_res"])
    norm = contract(positions)
    feats = grid_lookup(params[f"proposal_{i}.encoding.cells"], norm.reshape(-1, 3), res,
                        2 ** args["log2_hashmap_size"], 2).reshape(*positions.shape[:-1], -1)
    return trunc_exp(mlp(params, f"proposal_{i}.mlp.", feats, 2, False)[..., 0])


def field_heads(params, cfg, feats, dirs, cam, average_appearance: bool):
    """The main field's MLPs on grid features (R, S, L F): (density, rgb,
    aleatoric betas or None)."""
    trunk = mlp(params, "field.base_mlp.", feats, max(cfg["num_layers"] - 1, 1), True)
    density = trunc_exp(F.linear(trunk, params["field.density_head.weight"],
                                 params["field.density_head.bias"])[..., 0])
    betas = None
    if cfg["uncertainty_channels"]:
        betas = F.softplus(F.linear(trunk, params["field.unc_head.weight"],
                                    params["field.unc_head.bias"])[..., 0]) + cfg["beta_min"]
    geo = F.linear(trunk, params["field.geo_head.weight"], params["field.geo_head.bias"])
    sh = sh_encoding(dirs)
    sh = sh[..., None, :].expand(trunk.shape[:-1] + (sh.shape[-1],))
    table = params["field.appearance_embedding.weight"]
    shape = trunk.shape[:-1] + (table.shape[1],)
    embed = (torch.mean(table, dim=0).expand(shape) if average_appearance
             else table[cam][..., None, :].expand(shape))
    pen = mlp(params, "field.color_trunk.", torch.cat([geo, sh, embed], dim=-1),
              max(cfg["num_layers_color"] - 1, 1), True)
    rgb = torch.sigmoid(F.linear(pen, params["field.rgb_head.weight"], params["field.rgb_head.bias"]))
    return density, rgb, betas


def main_features(params, cfg, positions: torch.Tensor) -> torch.Tensor:
    res = grid_resolutions(cfg["num_levels"], cfg["base_res"], cfg["max_res"])
    norm = contract(positions)
    return grid_lookup(params["field.encoding.cells"], norm.reshape(-1, 3), res, 2 ** cfg["log2_hashmap_size"],
                       cfg["features_per_level"]).reshape(*positions.shape[:-1], -1)


def anneal_factor(step: torch.Tensor, cfg) -> torch.Tensor:
    """Nerfacto's proposal-weight anneal s x / ((s - 1) x + 1), x = clip(step / n, 0, 1)."""
    x = torch.clamp(step.to(torch.float32) / float(np.float32(cfg["proposal_weights_anneal_max_num_iters"])),
                    0.0, 1.0)
    s = float(np.float32(cfg["proposal_weights_anneal_slope"]))
    return s * x / ((s - 1.0) * x + 1.0)


def forward(params, cfg, origins, dirs, cam, draws: Mapping[str, Any] | None = None,
            anneal: torch.Tensor | None = None) -> dict[str, Any]:
    """One ray batch. ``draws`` (uniform, pdf) make it the training forward,
    with the proposals' weights and edges in the outputs; without them it
    is the eval forward, with the average appearance."""
    num_rays, device = origins.shape[0], origins.device
    near = torch.full((num_rays,), cfg["near_plane"], device=device)
    far = torch.full((num_rays,), cfg["far_plane"], device=device)
    train = draws is not None
    counts = list(cfg["num_proposal_samples"][1:]) + [cfg["num_nerf_samples"]]
    s = Samples(origins, dirs, near, far,
                uniform_edges(num_rays, cfg["num_proposal_samples"][0], draws["uniform"] if train else None, device))
    weights_list, edges_list = [], []
    for i, n_next in enumerate(counts):
        edges_list.append(s.s_edges)
        w = render_weights(_proposal_density(params, i, cfg, s.positions), s.deltas)
        weights_list.append(w)
        if train:
            w = torch.where(anneal == 1.0, w, w**anneal)
        s = Samples(origins, dirs, near, far, pdf_edges(s.s_edges, w, n_next, draws["pdf"][i] if train else None))
    density, rgb, betas = field_heads(params, cfg, main_features(params, cfg, s.positions), dirs, cam,
                                      average_appearance=not train)
    density = cfg["average_init_density"] * density
    weights = render_weights(density, s.deltas)
    out = composite(weights, rgb, s.mids, betas)
    out["density_mean"] = torch.mean(density)
    if train:
        out["weights_list"] = weights_list + [weights]
        out["edges_list"] = edges_list + [s.s_edges]
    return out


def loss(out, gt: torch.Tensor, cfg) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Active-nerfacto's loss terms (NLL, density L1, interlevel, distortion)
    and their sum; plain nerfacto's MSE without an aleatoric head."""
    terms: dict[str, torch.Tensor] = {}
    if cfg["uncertainty_channels"]:
        var = torch.maximum(out["rgb_var"], out["rgb_var"].new_full((), cfg["rendered_uncertainty_eps"]))
        terms["nll_loss"] = (torch.mean((out["rgb"] - gt) ** 2 / (2.0 * var[..., None]))
                             + 0.5 * torch.mean(torch.log(var)) + 4.0)
        terms["density_l1_loss"] = cfg["density_loss_mult"] * out["density_mean"]
    else:
        terms["rgb_loss"] = torch.mean((out["rgb"] - gt) ** 2)
    terms["interlevel_loss"] = cfg["interlevel_loss_mult"] * interlevel_loss(
        out["edges_list"][-1], out["weights_list"][-1], out["edges_list"][:-1], out["weights_list"][:-1])
    terms["distortion_loss"] = cfg["distortion_loss_mult"] * distortion_loss(
        out["edges_list"][-1], out["weights_list"][-1])
    return sum(terms.values()), terms


# -- the optimizer -------------------------------------------------------------


def group_of(name: str) -> str:
    top = name.split(".")[0]
    if top.startswith("proposal"):
        return "proposal_networks"
    return "camera_opt" if top == "camera_opt" else "fields"


def scheduled_lr(group: Mapping[str, float], count: int) -> float:
    """Linear warmup from 0 over ``warmup_steps``, then lr (lr_final / lr)^(t
    / max_steps), bounded by lr_final; computed in float32."""
    f32 = np.float32
    lr, final, steps, warm = (f32(group["lr"]), f32(group["lr_final"]), f32(group["max_steps"]),
                              f32(group.get("warmup_steps", 0)))
    t = f32(count)
    if warm > 0 and t < warm:
        return float(lr * t / warm)
    t = t - warm if warm > 0 else t
    if t <= 0:
        return float(lr)
    return float(max(lr * (final / lr) ** (t / steps), final))


class Adam:
    """Adam (b1 0.9, b2 0.999) with a schedule, a step count and eps per
    group, from zero moments and counts."""

    b1, b2 = 0.9, 0.999

    def __init__(self, params: Mapping[str, torch.Tensor], groups: Mapping[str, Mapping[str, float]]):
        self.groups = groups
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = {g: 0 for g in groups}

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor]) -> None:
        lrs = {g: scheduled_lr(self.groups[g], self.count[g]) for g in self.groups}
        for g in self.groups:
            self.count[g] += 1
        for name, p in params.items():
            g = grads[name]
            group = group_of(name)
            t = self.count[group]
            self.m[name].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[name].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            m_hat = self.m[name] / (1.0 - self.b1**t)
            v_hat = self.v[name] / (1.0 - self.b2**t)
            p.sub_(lrs[group] * m_hat / (torch.sqrt(v_hat) + self.groups[group]["eps"]))


# -- training steps --------------------------------------------------------------


def draw_batch(gen: torch.Generator, num_rays: int, images: torch.Tensor, cfg) -> dict[str, Any]:
    """One step's random draws, in the order the trainer under test takes them
    from one generator: camera, column and row of each ray, then the
    stratified jitter of the uniform sampler and one row a resample."""
    n, h, w = images.shape[:3]
    device = images.device

    def randint(high):
        return torch.randint(0, high, (num_rays,), generator=gen, device=device)

    cam, px, py = randint(n), randint(w), randint(h)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    counts = list(cfg["num_proposal_samples"][1:]) + [cfg["num_nerf_samples"]]
    draws = {"uniform": rand(num_rays, cfg["num_proposal_samples"][0] + 1),
             "pdf": [rand(num_rays, c + 1) for c in counts]}
    return {"cam": cam, "px": px.to(torch.float32), "py": py.to(torch.float32), "gt": images[cam, py, px],
            "draws": draws}


def train_steps(params: Mapping[str, torch.Tensor], cfg, groups, scene, gen_state: torch.Tensor,
                num_steps: int, num_rays: int, half_batch: bool = False) -> dict[str, Any]:
    """``num_steps`` steps from ``params`` (copied), step 0 and a fresh
    optimizer, the draws from a generator in ``gen_state`` on the scene's
    device. Returns each step's total loss,
    each leaf's first-step gradient and its change over the steps.
    ``half_batch`` plants a fault: each step's second half of rays left out,
    the loss the mean over the first."""
    device = scene["images"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(p, groups)
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    losses, first_grad = [], None
    for i in range(num_steps):
        b = draw_batch(gen, num_rays, scene["images"], cfg)
        if half_batch:
            keep = num_rays // 2
            b = {k: ({"uniform": v["uniform"][:keep], "pdf": [d[:keep] for d in v["pdf"]]} if k == "draws"
                     else v[:keep]) for k, v in b.items()}
        origins, dirs = rays(scene["c2w"], scene["focal"], scene["cx"], scene["cy"], b["cam"], b["px"], b["py"],
                             p.get("camera_opt"))
        step = torch.tensor(i, dtype=torch.int64, device=device)
        out = forward(p, cfg, origins, dirs, b["cam"], b["draws"], anneal_factor(step, cfg))
        total, _ = loss(out, b["gt"], cfg)
        grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        grads = {k: (torch.zeros_like(v) if g is None else g) for (k, v), g in zip(p.items(), grads)}
        if i == 0:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(p, grads)
        losses.append(float(total.detach()))
    change = {k: (p[k].detach() - start[k]) for k in p}
    return {"losses": losses, "first_grad": first_grad, "change": change}
