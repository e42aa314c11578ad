"""Plain PyTorch active-splatfacto: EWA projection, SH colours, per-pixel
compositing over 16 x 16 tiles, the active loss and one Adam update a leaf.

The reference the benchmark holds the program's splat step to. It follows
3D Gaussian Splatting (Kerbl et al., SIGGRAPH 2023) as nerfstudio's
splatfacto defines it on gsplat 0.1.11, with the per-Gaussian
log-uncertainty of the uncertainty plugin's active-splatfacto, as the
configuration file ``portbench/configs/active-splatfacto.json`` states
them:

* projection: the covariance R S S^T R^T from each Gaussian's quaternion
  (w, x, y, z) and scales, the Jacobian of the pinhole at the camera-space
  point with x / z and y / z clipped to 1.3 tan(fov / 2), a blur of 0.3 px
  added to the 2-D covariance and the opacity times its compensation
  sqrt(det(S) / det(S + 0.3 I)), the 3-sigma radius of the larger
  eigenvalue; a Gaussian is drawn where it lies beyond the near plane, its
  2-D covariance is positive and its radius box meets the image;
* colour: real spherical harmonics of degree 3 (16 bases) in the direction
  from the camera, plus 0.5, clamped at 0; opacity sigmoid(o); the
  uncertainty channel softplus(u) + beta_min;
* compositing, by the rules of the configuration's ``compositing`` block:
  per pixel, front to back in the stable depth order of the drawn
  Gaussians, over every Gaussian whose radius box meets the pixel's tile (a
  box's edges count), alpha = min(``alpha_clamp``, opacity exp(-sigma)),
  zeroed where sigma < 0 or alpha < ``alpha_min``, weight alpha T; a tile's
  hits in batches of ``exit_batch``, and none from the first batch at whose
  start every pixel's T is at most ``exit_transmittance``; no capacity and
  no cull of rows, so a hit the program drops shows as a gap;
* outputs: rgb on the step's background, depth and depth^2 normalised by
  the accumulation (uncovered pixels get the largest covered depth), the
  moments depth variance E[d^2] - E[d]^2 clamped at 0 plus 1e-5, the
  composited uncertainty (a standard deviation) and the accumulation;
* loss: (1 - lambda) NLL (squared error over twice the clamped variance,
  half the log variance, plus 4), lambda (1 - SSIM) with an 11 x 11
  Gaussian window (sigma 1.5, valid padding), lambda 0.2, and 0.01 x the
  mean opacity of the drawn Gaussians;
* update: Adam (b1 0.9, b2 0.999, eps 1e-15) a leaf, its learning rate
  lr (lr_final / lr)^(t / max_steps) at the group's count t.

Departures from gsplat 0.1.11 and the plugin, each the configuration's:
gsplat stops a pixel once its transmittance falls below 1e-4, the
configuration's ``compositing`` block a tile once every pixel's is at most
1e-8, at the start of a batch of 128 rows (the weights it leaves out are
below 1e-8, but behind a pixel whose NLL variance sits at its 1e-6 floor
their gradients are not, so the rule is part of what the step computes);
gsplat rounds the radius up to
whole pixels and takes max(0.1, b^2 - det) under its square root, here
the radius is not rounded and the floor is 0.01; the plugin's
``depth_var_mode="indirection"`` re-rasterizes (d_i - D)^2 in a second
pass, the configuration's ``"moments"`` takes the variance from one pass.

At 524,288 slots and 800 x 800 the image is composited in blocks of tiles
(tiles with about as many hits together): without grad for the image,
then the loss and its gradient with respect to the composited image by
autograd on the image alone, then each block again with grad, its slice of
that gradient carried back to the projected quantities, and those once to
the leaves. Everything is float32 with TF32 off unless a caller asks for
another ``dtype``. It imports nothing of the measured program.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

TILE = 16
PIXELS = TILE * TILE
BLUR = 0.3
B1, B2 = 0.9, 0.999
BLOCK_ELEMENTS = 1 << 25  # (tile, hit, pixel) entries a block of tiles holds at once
LEAVES = ("means", "scales", "quats", "opacities", "features_dc", "features_rest", "log_uncertainties")

_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154, -0.4570457994644658,
          1.445305721320277, -0.5900435899266435)


# -- projection and colour -----------------------------------------------------


def rotations(quats: torch.Tensor) -> torch.Tensor:
    """(N, 4) quaternions (w, x, y, z) -> (N, 3, 3) rotation matrices."""
    w, x, y, z = (quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def world_to_camera(c2w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An OpenGL camera-to-world (3, 4) as the OpenCV world-to-camera
    rotation and translation (+z forward, +y down)."""
    r = c2w[:, :3] * torch.tensor([1.0, -1.0, -1.0], dtype=c2w.dtype, device=c2w.device)
    return r.T, -r.T @ c2w[:, 3]


def project(means, scales, quats, c2w, fx, fy, cx, cy, width, height, near) -> dict[str, torch.Tensor]:
    """Screen-space means, depths, conics (a, b, c of the inverse 2-D
    covariance), radii, compensation and the drawn mask of (N,) Gaussians
    with linear ``scales``."""
    r_wc, t_wc = world_to_camera(c2w)
    p = means @ r_wc.T + t_wc
    z = p[:, 2]
    zs = torch.clamp(z, min=near)
    u, v = p[:, 0] / zs, p[:, 1] / zs
    lim_x, lim_y = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    tu, tv = torch.clamp(u, -lim_x, lim_x), torch.clamp(v, -lim_y, lim_y)
    mean2d = torch.stack([fx * u + cx, fy * v + cy], -1)
    m = rotations(quats) * scales[:, None, :]
    cov_cam = r_wc @ (m @ m.transpose(1, 2)) @ r_wc.T
    zero = torch.zeros_like(zs)
    jac = torch.stack([torch.stack([fx / zs, zero, -fx * tu / zs], -1),
                       torch.stack([zero, fy / zs, -fy * tv / zs], -1)], -2)
    cov = jac @ cov_cam @ jac.transpose(1, 2)
    a0, b0, c0 = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    det0 = a0 * c0 - b0 * b0
    a, c = a0 + BLUR, c0 + BLUR
    det = a * c - b0 * b0
    det_pos = torch.clamp(det, min=1e-12)
    ratio = det0 / det_pos
    ok = ratio > 1e-6
    compensation = torch.where(ok, torch.sqrt(torch.where(ok, ratio, torch.ones_like(ratio))), torch.zeros_like(ratio))
    conic = torch.stack([c / det_pos, -b0 / det_pos, a / det_pos], -1)
    mid = 0.5 * (a + c)
    radius = 3.0 * torch.sqrt(torch.clamp(mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01)), min=0.0))
    drawn = (z > near) & (det > 0.0) & (radius > 0.0) & (mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < width) \
        & (mean2d[:, 1] + radius > 0) & (mean2d[:, 1] - radius < height)
    radius = torch.where(drawn, radius, torch.zeros_like(radius))
    return {"mean2d": mean2d, "depth": z, "conic": conic, "radius": radius, "compensation": compensation,
            "drawn": drawn}


def sh_colors(coeffs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """(N, 16, 3) coefficients and (N, 3) directions -> (N, 3) colours of the
    bands up to ``degree``, plus 0.5, clamped at 0."""
    x, y, z = (dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)).unbind(-1)
    basis = [torch.full_like(x, _SH_C0)]
    if degree >= 1:
        basis += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [_SH_C2[0] * x * y, _SH_C2[1] * y * z, _SH_C2[2] * (2 * zz - xx - yy), _SH_C2[3] * x * z,
                  _SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [_SH_C3[0] * y * (3 * xx - yy), _SH_C3[1] * x * y * z, _SH_C3[2] * y * (4 * zz - xx - yy),
                  _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), _SH_C3[4] * x * (4 * zz - xx - yy),
                  _SH_C3[5] * z * (xx - yy), _SH_C3[6] * x * (xx - 3 * yy)]
    basis = torch.stack(basis, -1)
    return torch.clamp(torch.einsum("nb,nbc->nc", basis, coeffs[:, :basis.shape[1]]) + 0.5, min=0.0)


def splats(params: Mapping[str, torch.Tensor], rows: torch.Tensor, camera: Mapping[str, Any], cfg: Mapping[str, Any],
           sh_degree: int, payload_bf16: bool = False) -> dict[str, torch.Tensor]:
    """The projected rows ``rows`` of the buffer: screen quantities, the
    opacity with its compensation and the payload (rgb, depth, depth^2,
    uncertainty), differentiable in ``params``. ``payload_bf16`` rounds the
    payload to bfloat16 (a planted fault)."""
    pick = {k: v[rows] for k, v in params.items()}
    cam = camera
    pr = project(pick["means"], torch.exp(pick["scales"]), pick["quats"], cam["c2w"], cam["fx"], cam["fy"], cam["cx"],
                 cam["cy"], cam["width"], cam["height"], cfg["near_plane"])
    coeffs = torch.cat([pick["features_dc"][:, None], pick["features_rest"]], 1)
    rgb = sh_colors(coeffs, pick["means"] - cam["c2w"][:, 3], sh_degree)
    d = pr["depth"]
    payload = [rgb, d[:, None], (d * d)[:, None]]
    if cfg["uncertainty_channels"]:
        payload.append((F.softplus(pick["log_uncertainties"][:, 0]) + cfg["beta_min"])[:, None])
    payload = torch.cat(payload, -1)
    if payload_bf16:
        payload = payload.to(torch.bfloat16).to(payload.dtype)
    pr.update(opacity=torch.sigmoid(pick["opacities"]) * pr["compensation"], payload=payload)
    return pr


# -- tiles --------------------------------------------------------------------------


def tile_lists(sp: Mapping[str, torch.Tensor], width: int, height: int, budget: int | None = None
               ) -> dict[str, torch.Tensor]:
    """Each tile's hits in depth order: (P,) row of each hit (into ``sp``'s
    rows) grouped by tile, and each tile's count and first hit. A hit is a
    drawn Gaussian whose box [mean - radius, mean + radius] meets the tile's
    [16 t, 16 t + 16] on both axes. ``budget`` keeps each tile's nearest
    ``budget`` hits (a planted fault)."""
    nx, ny = -(-width // TILE), -(-height // TILE)
    dev = sp["depth"].device
    drawn = torch.nonzero(sp["drawn"])[:, 0]
    order = drawn[torch.argsort(sp["depth"][drawn], stable=True)]
    m, r = sp["mean2d"].detach()[order], sp["radius"].detach()[order]
    lo = torch.clamp(torch.floor((m - r[:, None]) / TILE) - 1, min=0).to(torch.int64)
    hi = torch.minimum(torch.floor((m + r[:, None]) / TILE) + 1, torch.tensor([nx - 1.0, ny - 1.0], device=dev))
    hi = hi.to(torch.int64)
    span_x, span_y = torch.clamp(hi[:, 0] - lo[:, 0] + 1, min=0), torch.clamp(hi[:, 1] - lo[:, 1] + 1, min=0)
    per = span_x * span_y
    which = torch.repeat_interleave(torch.arange(order.shape[0], device=dev), per)
    k = torch.arange(which.shape[0], device=dev) - torch.repeat_interleave(torch.cumsum(per, 0) - per, per)
    tx, ty = lo[which, 0] + k % span_x[which], lo[which, 1] + k // span_x[which]
    mx, my, rr = m[which, 0], m[which, 1], r[which]
    x0, y0 = (tx * TILE).to(m.dtype), (ty * TILE).to(m.dtype)
    hit = (mx + rr >= x0) & (mx - rr <= x0 + TILE) & (my + rr >= y0) & (my - rr <= y0 + TILE)
    tile, which = (ty * nx + tx)[hit], which[hit]
    by_tile = torch.argsort(tile, stable=True)  # depth order kept inside a tile
    tile, rows = tile[by_tile], order[which[by_tile]]
    counts = torch.bincount(tile, minlength=nx * ny)
    first = torch.cumsum(counts, 0) - counts
    if budget is not None:
        keep = torch.arange(tile.shape[0], device=dev) - first[tile] < budget
        tile, rows = tile[keep], rows[keep]
        counts = torch.clamp(counts, max=budget)
        first = torch.cumsum(counts, 0) - counts
    return {"rows": rows, "counts": counts, "first": first, "nx": nx, "ny": ny}


def blocks(counts: torch.Tensor, limit: int = BLOCK_ELEMENTS) -> list[torch.Tensor]:
    """Tiles with hits grouped by count, most first, so that a block's tiles
    x its largest count x 256 pixels stays within ``limit`` (a tile above
    it goes alone)."""
    order = torch.argsort(counts, descending=True, stable=True).tolist()
    cnt = counts.tolist()
    out, cur = [], []
    for t in order:
        if cnt[t] == 0:
            break
        if cur and (len(cur) + 1) * cnt[cur[0]] * PIXELS > limit:
            out.append(cur)
            cur = []
        cur.append(t)
    if cur:
        out.append(cur)
    return [torch.tensor(b, device=counts.device) for b in out]


def composite_block(sp: Mapping[str, torch.Tensor], lists: Mapping[str, Any], tiles: torch.Tensor,
                    rules: Mapping[str, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 256, C) images and (B, 256) accumulations of a block of tiles,
    every hit composited front to back by the compositing ``rules``;
    differentiable in ``sp``."""
    counts = lists["counts"][tiles]
    kmax = int(counts.max())
    slot = torch.arange(kmax, device=tiles.device)
    live = slot[None] < counts[:, None]
    at = torch.where(live, lists["first"][tiles, None] + slot[None], torch.zeros_like(slot[None]))
    rows = lists["rows"][at] if lists["rows"].numel() else torch.zeros_like(at)
    mean, conic = sp["mean2d"][rows], sp["conic"][rows]  # (B, K, 2), (B, K, 3)
    opacity, payload = sp["opacity"][rows], sp["payload"][rows]
    dtype = mean.dtype
    j = torch.arange(PIXELS, device=tiles.device)
    px = ((tiles % lists["nx"]) * TILE)[:, None] + (j % TILE)[None] + 0.5  # (B, 256)
    py = ((tiles // lists["nx"]) * TILE)[:, None] + (j // TILE)[None] + 0.5
    dx = px.to(dtype)[:, None, :] - mean[..., 0, None]
    dy = py.to(dtype)[:, None, :] - mean[..., 1, None]
    sigma = 0.5 * (conic[..., 0, None] * dx * dx + conic[..., 2, None] * dy * dy) + conic[..., 1, None] * dx * dy
    alpha = torch.clamp(opacity[..., None] * torch.exp(-sigma), max=rules["alpha_clamp"])
    alpha = torch.where((sigma >= 0) & (alpha >= rules["alpha_min"]) & live[..., None], alpha, torch.zeros_like(alpha))
    trans = torch.cumprod(1.0 - alpha, dim=1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
    # a tile stops before the first batch at whose start no pixel's
    # transmittance exceeds the exit's, and composites none after it
    batch = rules["exit_batch"]
    starts = torch.arange(0, kmax, batch, device=tiles.device)
    runs = (counts[:, None] > starts[None]) & (trans.detach()[:, starts].amax(-1) > rules["exit_transmittance"])
    runs = torch.cumprod(runs.to(torch.int32), dim=1).bool().repeat_interleave(batch, dim=1)[:, :kmax]
    w = torch.where(runs[..., None], alpha * trans, torch.zeros_like(alpha))  # (B, K, 256)
    return torch.einsum("bkp,bkc->bpc", w, payload), w.sum(1)


def _image(tiles_img: torch.Tensor, nx: int, ny: int, width: int, height: int) -> torch.Tensor:
    """(T, 256, ...) tiles -> (H, W, ...)."""
    rest = tiles_img.shape[2:]
    out = tiles_img.reshape(ny, nx, TILE, TILE, *rest).transpose(1, 2).reshape(ny * TILE, nx * TILE, *rest)
    return out[:height, :width]


def _tiles(img: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
    """(H, W, ...) -> (T, 256, ...), the pad beyond the image zero."""
    h, w = img.shape[:2]
    full = img.new_zeros((ny * TILE, nx * TILE, *img.shape[2:]))
    full[:h, :w] = img
    return full.reshape(ny, TILE, nx, TILE, *img.shape[2:]).transpose(1, 2).reshape(ny * nx, PIXELS, *img.shape[2:])


def composite(sp, lists, width: int, height: int, rules: Mapping[str, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """The (H, W, C) composited payload and (H, W) accumulation, without grad."""
    t = lists["nx"] * lists["ny"]
    c = sp["payload"].shape[1]
    img = sp["payload"].new_zeros((t, PIXELS, c))
    acc = sp["payload"].new_zeros((t, PIXELS))
    with torch.no_grad():
        for tiles in blocks(lists["counts"]):
            img[tiles], acc[tiles] = composite_block(sp, lists, tiles, rules)
    return _image(img, lists["nx"], lists["ny"], width, height), _image(acc, lists["nx"], lists["ny"], width, height)


# -- outputs, loss, gradients ---------------------------------------------------------


def outputs(img: torch.Tensor, acc: torch.Tensor, background: torch.Tensor, cfg: Mapping[str, Any]
            ) -> dict[str, torch.Tensor]:
    """The rendered channels from the composited payload and accumulation."""
    safe = torch.clamp(acc, min=1e-10)
    covered = acc > 0
    d1, d2 = img[..., 3] / safe, img[..., 4] / safe
    far = torch.max(torch.where(covered, d1, torch.zeros_like(d1)))
    d1 = torch.where(covered, d1, far)
    d2 = torch.where(covered, d2, far * far)
    out = {"rgb": torch.clamp(img[..., :3] + (1.0 - acc[..., None]) * background, 0.0, 1.0), "depth": d1,
           "depth_var": torch.clamp(d2 - d1 * d1, min=0.0) + 1e-5, "accumulation": acc}
    if cfg["uncertainty_channels"]:
        out["uncertainty"] = torch.clamp(img[..., 5], min=0.0)
    return out


def ssim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of (H, W, 3) images: 11 x 11 Gaussian window (sigma 1.5),
    valid padding, k1 0.01, k2 0.03, data range 1."""
    g = torch.exp(-((torch.arange(11, dtype=pred.dtype, device=pred.device) - 5.0) ** 2) / (2 * 1.5**2))
    g = g / g.sum()

    def blur(x):
        x = x.permute(2, 0, 1)[:, None]
        return F.conv2d(F.conv2d(x, g.reshape(1, 1, 11, 1)), g.reshape(1, 1, 1, 11))[:, 0]

    c1, c2 = 0.01**2, 0.03**2
    mp, mt = blur(pred), blur(gt)
    vp = torch.clamp(blur(pred * pred) - mp * mp, min=0.0)
    vt = torch.clamp(blur(gt * gt) - mt * mt, min=0.0)
    cov = blur(pred * gt) - mp * mt
    return torch.mean((2 * mp * mt + c1) * (2 * cov + c2) / ((mp * mp + mt * mt + c1) * (vp + vt + c2)))


def image_loss(out: Mapping[str, torch.Tensor], gt: torch.Tensor, cfg: Mapping[str, Any]) -> torch.Tensor:
    """The loss's terms that read the image: the NLL and SSIM."""
    lam = cfg["ssim_lambda"]
    pred = out["rgb"]
    var = torch.clamp(out["uncertainty"] ** 2, min=cfg["rendered_uncertainty_eps"])
    nll = torch.mean((pred - gt) ** 2 / (2.0 * var[..., None])) + 0.5 * torch.mean(torch.log(var)) + 4.0
    return (1.0 - lam) * nll + lam * (1.0 - ssim(pred, gt))


def step_gradients(params: Mapping[str, torch.Tensor], alive: torch.Tensor, camera: Mapping[str, Any],
                   background: torch.Tensor, gt: torch.Tensor, cfg: Mapping[str, Any], sh_degree: int,
                   payload_bf16: bool = False, budget: int | None = None, block_limit: int = BLOCK_ELEMENTS
                   ) -> dict[str, Any]:
    """One step's render, loss and every leaf's gradient. The image is
    composited without grad; the loss's gradient with respect to it comes
    from autograd on the image alone; each block of tiles is composited
    again with grad and its slice of that gradient carried back to the
    projected quantities, which carry their sum to the leaves once."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    rows = torch.nonzero(alive)[:, 0]
    sp = splats(leaves, rows, camera, cfg, sh_degree, payload_bf16)
    lists = tile_lists(sp, camera["width"], camera["height"], budget)
    taps = {k: sp[k].detach().requires_grad_(True) for k in ("mean2d", "conic", "opacity", "payload")}
    img, acc = composite(taps, lists, camera["width"], camera["height"], cfg["compositing"])
    img.requires_grad_(True)
    acc.requires_grad_(True)
    with torch.enable_grad():
        out = outputs(img, acc, background, cfg)
        loss_img = image_loss(out, gt, cfg)
        g_img, g_acc = torch.autograd.grad(loss_img, (img, acc))
    nx, ny = lists["nx"], lists["ny"]
    g_img_t, g_acc_t = _tiles(g_img, nx, ny), _tiles(g_acc, nx, ny)
    for tiles in blocks(lists["counts"], block_limit):
        b_img, b_acc = composite_block(taps, lists, tiles, cfg["compositing"])
        torch.autograd.backward((b_img, b_acc), (g_img_t[tiles], g_acc_t[tiles]))
    drawn = torch.zeros_like(alive)
    drawn[rows] = sp["drawn"]
    vis = drawn.to(leaves["opacities"].dtype)
    opacity_loss = cfg["opacity_loss_mult"] * torch.sum(torch.sigmoid(leaves["opacities"]) * vis) / torch.clamp(
        vis.sum(), min=1.0)
    grads_at = [taps[k].grad for k in taps]
    torch.autograd.backward([sp[k] for k in taps] + [opacity_loss],
                            [g if g is not None else torch.zeros_like(taps[k]) for k, g in zip(taps, grads_at)]
                            + [torch.ones_like(opacity_loss)])
    with torch.no_grad():
        outs = outputs(img.detach(), acc.detach(), background, cfg)
    return {"loss": float(loss_img.detach() + opacity_loss.detach()),
            "grads": {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in leaves.items()},
            "outputs": outs, "counts": lists["counts"]}


@torch.no_grad()
def render(params, alive, camera, background, cfg, sh_degree: int, payload_bf16: bool = False,
           budget: int | None = None) -> dict[str, torch.Tensor]:
    """One image's outputs, without grad."""
    sp = splats(params, torch.nonzero(alive)[:, 0], camera, cfg, sh_degree, payload_bf16)
    lists = tile_lists(sp, camera["width"], camera["height"], budget)
    img, acc = composite(sp, lists, camera["width"], camera["height"], cfg["compositing"])
    return outputs(img, acc, background, cfg)


def scheduled_lr(group: Mapping[str, float], count: int) -> float:
    """lr (lr_final / lr)^(t / max_steps), bounded by lr_final; lr at t <= 0."""
    lr, final, steps = group["lr"], group["lr_final"], group["max_steps"]
    if count <= 0 or steps <= 0 or final == lr:
        return lr
    bound = max if final < lr else min
    return bound(lr * (final / lr) ** (count / steps), final)


def adam_update(params: dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor], state: dict[str, Any],
                groups: Mapping[str, Mapping[str, float]]) -> None:
    """One Adam update a leaf, in place: ``state`` holds each leaf's
    ``exp_avg``, ``exp_avg_sq``, ``adam_count`` and ``schedule_count``."""
    for k, p in params.items():
        st, g = state[k], grads[k]
        lr = scheduled_lr(groups[k], st["schedule_count"])
        st["adam_count"] += 1
        t = st["adam_count"]
        st["exp_avg"].mul_(B1).add_(g, alpha=1.0 - B1)
        st["exp_avg_sq"].mul_(B2).add_(g * g, alpha=1.0 - B2)
        m_hat = st["exp_avg"] / (1.0 - B1**t)
        v_hat = st["exp_avg_sq"] / (1.0 - B2**t)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + groups[k]["eps"]))
        st["schedule_count"] += 1


def train_steps(params: Mapping[str, torch.Tensor], alive: torch.Tensor, adam: Mapping[str, Any],
                steps: list[Mapping[str, Any]], cfg: Mapping[str, Any], groups: Mapping[str, Mapping[str, float]],
                sh_degree: int, dtype: torch.dtype = torch.float32, **faults) -> dict[str, Any]:
    """``len(steps)`` steps from ``params`` (copied to ``dtype``) and the Adam
    state ``adam`` (per leaf ``exp_avg``, ``exp_avg_sq``, ``adam_count``,
    ``schedule_count``); each step a dict of ``camera``, ``background`` and
    ``image``. Returns each step's loss, the first step's gradient and
    outputs, and each leaf's change over the steps, in float32."""
    p = {k: v.detach().to(dtype).clone() for k, v in params.items()}
    start = {k: v.clone() for k, v in p.items()}
    state = {k: {"exp_avg": adam["exp_avg"][k].to(dtype).clone(), "exp_avg_sq": adam["exp_avg_sq"][k].to(dtype).clone(),
                 "adam_count": int(adam["adam_count"][k]), "schedule_count": int(adam["schedule_count"][k])}
             for k in p}
    losses, first = [], None
    for s in steps:
        cam = {**s["camera"], "c2w": s["camera"]["c2w"].to(dtype)}
        r = step_gradients(p, alive, cam, s["background"].to(dtype), s["image"].to(dtype), cfg, sh_degree, **faults)
        losses.append(r["loss"])
        if first is None:
            first = r
        adam_update(p, r["grads"], state, groups)
    return {"losses": losses, "grad": {k: v.float() for k, v in first["grads"].items()},
            "outputs": {k: v.float() for k, v in first["outputs"].items()}, "counts": first["counts"],
            "change": {k: (p[k] - start[k]).float() for k in p}}


def leaf_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """|prog - ref| / |ref| over one leaf, in float64 (0 where both are 0)."""
    diff = float(torch.linalg.vector_norm((prog.double() - ref.double()).flatten()))
    scale = float(torch.linalg.vector_norm(ref.double().flatten()))
    return diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)


def norm_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """| |prog| - |ref| | / |ref| over one leaf, in float64: for a change of
    float32 parameters, whose every entry carries the rounding of its
    storage (up to half a unit in the last place of the parameter, which
    exceeds a small step), so that entrywise gaps measure the storage."""
    a = float(torch.linalg.vector_norm(prog.double().flatten()))
    b = float(torch.linalg.vector_norm(ref.double().flatten()))
    return abs(a - b) / b if b > 0 else (0.0 if a == 0 else math.inf)
