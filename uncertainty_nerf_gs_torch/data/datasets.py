"""Image dataset: DataparserOutputs -> image stacks on the host.

Counterpart of ``uncertainty_nerf_gs_tpu/data/datasets.py``: images decode
to float32 in [0, 1], RGBA composited over the parser's alpha colour
(Blender), masks and GT depth where the parser lists them. The trainers move
the stack to the device once.

Files are decoded by extension (``data/image_io.py``): ``.png`` by the
port's own codec, anything else by PIL.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from uncertainty_nerf_gs_torch.data.dataparsers import DataparserOutputs
from uncertainty_nerf_gs_torch.data.image_io import read_image


def load_image(path: Path, alpha_color: np.ndarray | None = None) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]; RGBA composited over alpha_color."""
    arr = read_image(path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        bg = alpha_color if alpha_color is not None else np.ones(3, np.float32)
        arr = rgb * a + bg * (1.0 - a)
    return arr[..., :3]


def load_images(outputs: DataparserOutputs) -> np.ndarray:
    """Stack all images of a parsed split: (N, H, W, 3) float32."""
    return np.stack([load_image(p, outputs.alpha_color) for p in outputs.image_filenames])


def load_masks(outputs: DataparserOutputs) -> np.ndarray | None:
    """Stack per-image masks when the parser listed them: (N, H, W) bool,
    True = the pixel may be sampled (nerfstudio's sampler semantics)."""
    if not getattr(outputs, "mask_filenames", None):
        return None
    masks = []
    for p in outputs.mask_filenames:
        arr = read_image(p)
        if arr.ndim == 3:
            arr = arr[..., 0]
        masks.append(arr > 0)
    return np.stack(masks)


def load_depths(outputs: DataparserOutputs) -> np.ndarray | None:
    """Stack GT depth images when the parser listed them (blender-downscale
    test split)."""
    if not outputs.depth_filenames:
        return None
    return np.stack([read_image(p).astype(np.float32) for p in outputs.depth_filenames])
