"""Controlled-corruption harness: noise / blur injected into TRAIN images.

Counterpart of ``uncertainty_nerf_gs_tpu/data/corruption.py`` (the
reference's ``save_noisy_images.py``, the ``ut-save-noisy-images`` command):
Gaussian noise is added in [0, 1] space from ``np.random.default_rng(seed)``
(the same draws as the JAX package's), Gaussian blur uses an odd kernel
with OpenCV's default sigma rule, and only *training* images are corrupted:
nerfstudio's equally-spaced ``train_split_fraction=0.9`` split is recomputed
and eval images are copied through unmodified. Images are read and written
through ``data/image_io.py`` (PNG without PIL).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

from uncertainty_nerf_gs_torch.data.dataparsers import get_train_eval_split_fraction
from uncertainty_nerf_gs_torch.data.image_io import read_image, write_image

IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def add_gaussian_noise(
    img: np.ndarray, mean: float = 0.0, std_dev: float = 0.1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """uint8 image + N(mean, std^2) noise in [0, 1] space."""
    rng = rng or np.random.default_rng()
    x = img.astype(np.float32) / 255.0
    x = x + rng.normal(mean, std_dev, x.shape).astype(np.float32)
    return (np.clip(x, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def _cv2_default_sigma(kernel_size: int) -> float:
    """OpenCV's sigma when sigma=0 is passed: 0.3*((k-1)*0.5 - 1) + 0.8."""
    return 0.3 * ((kernel_size - 1) * 0.5 - 1.0) + 0.8


def _gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    x = np.arange(kernel_size, dtype=np.float64) - half
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def add_gaussian_blur(img: np.ndarray, kernel_size: int = 5) -> np.ndarray:
    """Separable Gaussian blur with reflect-101 borders (cv2 semantics,
    `save_noisy_images.py:31-40`). kernel_size must be odd."""
    if kernel_size % 2 != 1:
        raise ValueError("kernel_size must be odd")
    k = _gaussian_kernel1d(kernel_size, _cv2_default_sigma(kernel_size))
    x = img.astype(np.float32)
    pad = kernel_size // 2
    # reflect-101 (cv2 BORDER_DEFAULT): reflect without repeating the edge
    x = np.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 0, x)
    x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="valid"), 1, x)
    return np.clip(x.round(), 0, 255).astype(np.uint8)


def _as_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of the 8-bit images ``read_image`` gives:
    gray repeated, alpha dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (2, 4):
        img = img[..., :-1]
    return np.ascontiguousarray(np.broadcast_to(img, img.shape[:2] + (3,)))


def process_images(
    input_folder: Path | str,
    output_folder: Path | str,
    operation: str = "noise",
    mean: float = 0.0,
    std_dev: float = 0.1,
    kernel_size: int = 5,
    train_split_fraction: float = 0.9,
    seed: int | None = None,
) -> dict[str, list[str]]:
    """Corrupt train-split images, copy eval images through. Returns
    {"train": [...], "eval": [...]}."""
    input_folder = Path(input_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    filenames = sorted(
        f for f in (p.name for p in input_folder.iterdir())
        if f.lower().endswith(IMAGE_EXTS)
    )
    i_train, _ = get_train_eval_split_fraction(len(filenames), train_split_fraction)
    train_set = set(int(i) for i in i_train)

    done: dict[str, list[str]] = {"train": [], "eval": []}
    for idx, name in enumerate(filenames):
        src = input_folder / name
        dst = output_folder / name
        if idx in train_set:
            img = _as_rgb(read_image(src))
            if operation == "noise":
                out = add_gaussian_noise(img, mean, std_dev, rng)
            elif operation == "blur":
                out = add_gaussian_blur(img, kernel_size)
            else:
                raise ValueError(f"unknown operation {operation}")
            write_image(dst, out)
            done["train"].append(name)
        else:
            shutil.copyfile(src, dst)
            done["eval"].append(name)
    return done


def main(argv: list[str] | None = None) -> None:
    """CLI mirroring the reference argparse surface."""
    import argparse

    ap = argparse.ArgumentParser(description="corrupt train-split images")
    ap.add_argument("--input-folder", required=True)
    ap.add_argument("--output-folder", required=True)
    ap.add_argument("--operation", choices=("noise", "blur"), default="noise")
    ap.add_argument("--mean", type=float, default=0.0)
    ap.add_argument("--std-dev", type=float, default=0.1)
    ap.add_argument("--kernel-size", type=int, default=5)
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)
    done = process_images(
        args.input_folder, args.output_folder, args.operation,
        args.mean, args.std_dev, args.kernel_size, seed=args.seed,
    )
    print(f"corrupted {len(done['train'])} train images, "
          f"copied {len(done['eval'])} eval images")


if __name__ == "__main__":
    main()
