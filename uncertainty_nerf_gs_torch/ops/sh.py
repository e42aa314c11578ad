"""Spherical-harmonic colors for Gaussian splatting.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/sh.py``: per-Gaussian
view-dependent color ``rgb = sum_i c_i Y_i(d)`` with the real-SH constants
standard across 3DGS implementations (degree <= 4), and the band mask that
ramps the active degree up during training.
"""

from __future__ import annotations

import torch

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)^2) real-SH basis."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full(dirs.shape[:-1], _C0, dtype=dirs.dtype, device=dirs.device)]
    if degree >= 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1),
            _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3),
            _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh_colors(
    degree: int,
    coeffs: torch.Tensor,
    dirs: torch.Tensor,
    active_degree: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, B, 3) SH coefficients (B >= (degree+1)^2) and (N, 3) viewing
    directions (need not be normalized) -> (N, 3) ``sum c_i Y_i``; callers
    add 0.5 and clamp. ``active_degree`` zeroes the bands above it."""
    d = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    basis = sh_basis(degree, d)  # (N, B)
    nb = num_sh_bases(degree)
    if active_degree is not None:
        band = torch.floor(
            torch.sqrt(torch.arange(nb, dtype=torch.float32, device=dirs.device))
        ).to(torch.int32)
        basis = basis * (band[None, :] <= active_degree)
    return torch.einsum("nb,nbc->nc", basis, coeffs[:, :nb, :])
