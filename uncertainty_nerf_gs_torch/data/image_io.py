"""Image files by extension: ``.png`` through the port's own codec
(``data/png.py``; the card's machine has no PIL), any other extension
through PIL, imported here, with an error naming the format when PIL is
missing. A codec choice by extension, not a fallback."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from uncertainty_nerf_gs_torch.data.png import png_size, read_png, write_png


def _pil(path: Path):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading or writing {Path(path).suffix or 'extensionless'} images needs PIL, "
            "which is not installed; only .png is decoded without it"
        ) from e
    return Image


def read_image(path: Path | str) -> np.ndarray:
    """The file's samples as ``np.asarray(PIL.Image.open(path))`` gives
    them."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return read_png(path)
    with _pil(path).open(path) as im:
        return np.asarray(im)


def write_image(path: Path | str, image: np.ndarray) -> None:
    """uint8 (or 16-bit gray) samples to ``path``, in the format its
    extension names."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        write_png(path, image)
    else:
        _pil(path).fromarray(np.asarray(image)).save(path)


def image_size(path: Path | str) -> tuple[int, int]:
    """(width, height) of an image file."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return png_size(path)
    with _pil(path).open(path) as im:
        return im.size
