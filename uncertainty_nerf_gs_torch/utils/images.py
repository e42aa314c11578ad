"""Image-export helpers; counterpart of ``uncertainty_nerf_gs_tpu/utils/
images.py``. The card's machine has no matplotlib: ``colorize`` reads the
port's own jet table (``utils/colormaps.py``), equal to matplotlib's bit for
bit in u8."""

from __future__ import annotations

import numpy as np

from uncertainty_nerf_gs_torch.utils import colormaps


def to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] float image -> u8."""
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def colorize(x: np.ndarray, lo: float | None = None,
             hi: float | None = None) -> np.ndarray:
    """Scalar map -> u8 rgb via matplotlib's jet (``utils/colormaps.py``).
    ``lo``/``hi`` pin the normalization window; the default is the map's own
    min/max. Channelled maps (H, W, C) are reduced to their per-pixel mean
    first."""
    x = np.asarray(x, np.float32)
    if x.ndim == 3:
        x = x.mean(-1)
    lo = float(np.nanmin(x)) if lo is None else lo
    hi = float(np.nanmax(x)) if hi is None else hi
    x = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    return colormaps.lookup(x, "jet")
