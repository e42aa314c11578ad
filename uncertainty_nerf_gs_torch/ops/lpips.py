"""LPIPS-style learned perceptual distance.

Counterpart of ``uncertainty_nerf_gs_tpu/ops/lpips.py``: the LPIPS graph on
an AlexNet-shaped backbone (5 conv stages with max-pools after the first
two, unit-normalized feature differences, a per-layer 1x1 weighting, a
spatial mean), with ``load_params`` for converted official weights (an
``.npz`` of the torch state dict's tensors) and ``init_random_params``, the
fixed-seed random-feature fallback, drawn with numpy in the JAX package's
order so that both packages hold the same weights. The official AlexNet
weights are not in the repo; scores of the fallback are comparable within a
run but are not the published LPIPS scale.

Images are (H, W, 3) in [0, 1]; inputs under 64 pixels a side are first
up-sampled by an integer factor (``ops/resize.py``, JAX's bilinear
resize), as the JAX package does. The convolutions are ``F.conv2d``, the
JAX package's ``lax.conv``; on the card they must not run in TF32
(``torch.backends.cudnn.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from uncertainty_nerf_gs_torch.ops.resize import resize_bilinear

# AlexNet-feature geometry: (out_ch, kernel, stride, pad) per conv stage.
_ALEX_STAGES = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = (0, 1)  # max-pool (kernel 3, stride 2) after these stages
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_MIN_SIZE = 64  # below this the stride and pool chain empties a spatial dim


def init_random_params(seed: int = 0, device=None) -> dict[str, Any]:
    """Fixed-seed random backbone and uniform linear heads (the fallback):
    He-normal conv weights from ``np.random.default_rng(seed)``, zero
    biases, heads 1 / channels."""
    rng = np.random.default_rng(seed)
    params: dict[str, Any] = {"convs": [], "lins": []}
    in_ch = 3
    for out_ch, k, _, _ in _ALEX_STAGES:
        fan_in = in_ch * k * k
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in), (out_ch, in_ch, k, k))
        params["convs"].append({
            "w": torch.as_tensor(w, dtype=torch.float32, device=device),
            "b": torch.zeros(out_ch, dtype=torch.float32, device=device),
        })
        params["lins"].append(torch.full((out_ch,), 1.0 / out_ch, dtype=torch.float32, device=device))
        in_ch = out_ch
    return params


def load_params(path: str, device=None) -> dict[str, Any]:
    """Converted LPIPS weights from an ``.npz``: ``conv{i}_w`` (out, in, kh,
    kw), ``conv{i}_b`` (out,) and ``lin{i}`` (out,) for i in 0..4."""
    data = np.load(path)

    def t(key):
        return torch.as_tensor(data[key], dtype=torch.float32, device=device)

    return {
        "convs": [{"w": t(f"conv{i}_w"), "b": t(f"conv{i}_b")} for i in range(len(_ALEX_STAGES))],
        "lins": [t(f"lin{i}") for i in range(len(_ALEX_STAGES))],
    }


_DEFAULT_PARAMS: dict[torch.device, dict[str, Any]] = {}


def _default_params(device: torch.device) -> dict[str, Any]:
    if device not in _DEFAULT_PARAMS:
        _DEFAULT_PARAMS[device] = init_random_params(device=device)
    return _DEFAULT_PARAMS[device]


def _prep(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> the normalized (1, 3, H', W') network input."""
    h, w = img.shape[:2]
    if min(h, w) < _MIN_SIZE:
        scale = -(-_MIN_SIZE // min(h, w))  # integer up-sampling factor
        img = resize_bilinear(img, (h * scale, w * scale, 3))
    img = img.to(torch.float32) * 2.0 - 1.0
    shift = torch.tensor(_SHIFT, dtype=torch.float32, device=img.device)
    scale_ = torch.tensor(_SCALE, dtype=torch.float32, device=img.device)
    return ((img - shift) / scale_).permute(2, 0, 1)[None]


def _features(params, x: torch.Tensor) -> list[torch.Tensor]:
    feats = []
    for i, (conv, (_, _, stride, pad)) in enumerate(zip(params["convs"], _ALEX_STAGES)):
        x = torch.relu(F.conv2d(x, conv["w"], conv["b"], stride=stride, padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def _weighted_diffs(params, img0: torch.Tensor, img1: torch.Tensor) -> list[torch.Tensor]:
    """Per layer, the 1x1-weighted squared difference of the unit-normalized
    features, summed over channels and the batch of one: (h_l, w_l)."""
    f0 = _features(params, _prep(img0))
    f1 = _features(params, _prep(img1))
    return [
        torch.einsum("nchw,c->hw", (_unit_normalize(a) - _unit_normalize(b)) ** 2, lin)
        for a, b, lin in zip(f0, f1, params["lins"])
    ]


def lpips(img0: torch.Tensor, img1: torch.Tensor, params=None) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [0, 1]: the sum over
    layers of each weighted difference map's mean."""
    if params is None:
        params = _default_params(img0.device)
    total = torch.zeros((), dtype=torch.float32, device=img0.device)
    for d in _weighted_diffs(params, img0, img1):
        total = total + torch.mean(d)
    return total


def lpips_spatial(img0: torch.Tensor, img1: torch.Tensor, params=None) -> torch.Tensor:
    """Per-pixel LPIPS map (H, W): each layer's weighted difference map
    resized to the input's size (JAX's bilinear resize) and summed, the
    substrate of the masked LPIPS."""
    if params is None:
        params = _default_params(img0.device)
    h, w = img0.shape[:2]
    total = torch.zeros((h, w), dtype=torch.float32, device=img0.device)
    for d in _weighted_diffs(params, img0, img1):
        total = total + resize_bilinear(d, (h, w))
    return total
