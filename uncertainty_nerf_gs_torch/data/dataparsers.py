"""Dataparsers: dataset dirs -> cameras + image lists + splits.

Counterpart of ``uncertainty_nerf_gs_tpu/data/dataparsers.py``, with the same
numpy arithmetic: frame sort by filename, per-frame vs global intrinsics,
``auto_orient_and_center_poses`` + auto pose scaling, scene AABB, downscale
resolution handling, applied_transform chaining, every split policy and the
ten registered parsers. The outputs hold the port's ``Cameras`` as float32
CPU tensors (the trainers move them to their device). Image sizes are read
through ``data/image_io.py`` (PNG without PIL); only ``blender-downscale``'s
LANCZOS copies need PIL.

Registry at the bottom maps the reference CLI names to parser callables.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Any, Callable

import numpy as np

import torch

from uncertainty_nerf_gs_torch.cameras.cameras import FISHEYE, PERSPECTIVE, Cameras
from uncertainty_nerf_gs_torch.data.image_io import image_size


def _f32(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# outputs + shared pose machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DataparserOutputs:
    """Parity surface of nerfstudio's `DataparserOutputs`."""

    image_filenames: list[Path]
    cameras: Cameras
    scene_box: np.ndarray  # (2, 3) aabb
    dataparser_scale: float
    dataparser_transform: np.ndarray  # (3, 4)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)
    depth_filenames: list[Path] | None = None
    mask_filenames: list[Path] | None = None
    alpha_color: np.ndarray | None = None


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-8:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> tuple[np.ndarray, np.ndarray]:
    """Orient mean camera-up to +z and center translations.

    poses: (N, 3, 4) or (N, 4, 4) OpenGL c2w. Returns (oriented (N, 3, 4),
    transform (3, 4)) with transform s.t. new = transform @ [pose; 0 0 0 1].
    Semantics of nerfstudio `camera_utils.auto_orient_and_center_poses`
    consumed at `robustnerf_dataparser.py:309-316`.
    """
    poses = poses[:, :3, :]
    origins = poses[:, :3, 3]
    if center_method == "poses":
        translation = origins.mean(axis=0)
    elif center_method == "focus":
        # nerfstudio camera_utils.focus_of_attention: least-squares point
        # closest to all optical axes (-z view directions)
        dirs = -poses[:, :3, 2:3]  # (N, 3, 1) forward
        m = np.eye(3)[None] - dirs @ dirs.transpose(0, 2, 1)  # (N, 3, 3)
        mt_m = m.transpose(0, 2, 1) @ m
        rhs = (mt_m @ origins[:, :, None]).mean(axis=0)  # (3, 1)
        translation = np.linalg.solve(mt_m.mean(axis=0), rhs)[:, 0]
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unsupported center method {center_method}")

    if method == "up":
        up = poses[:, :3, 1].mean(axis=0)
        rot = rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rot = np.eye(3)
    else:
        raise ValueError(f"unsupported orientation method {method}")

    transform = np.concatenate([rot, rot @ -translation[:, None]], axis=1)  # (3,4)
    bottom = np.array([[[0.0, 0.0, 0.0, 1.0]]]).repeat(len(poses), axis=0)
    homog = np.concatenate([poses, bottom], axis=1)  # (N, 4, 4)
    oriented = transform @ homog  # (N, 3, 4)
    return oriented.astype(np.float32), transform.astype(np.float32)


def get_train_eval_split_fraction(
    num_images: int, train_split_fraction: float = 0.9
) -> tuple[np.ndarray, np.ndarray]:
    """nerfstudio's equally-spaced split (recomputed by the corruption
    script, `save_noisy_images.py:60-72`)."""
    num_train = int(np.ceil(num_images * train_split_fraction))
    i_all = np.arange(num_images)
    i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    i_eval = np.setdiff1d(i_all, i_train)
    return i_train, i_eval


def get_train_eval_split_filename(
    basenames: list[str],
) -> tuple[np.ndarray, np.ndarray]:
    """Split by 'train'/'eval' filename markers (crab scene,
    `robustnerf_dataparser.py:278-283`)."""
    i_train = [i for i, b in enumerate(basenames) if "train" in b]
    i_eval = [i for i, b in enumerate(basenames) if "eval" in b]
    return np.array(i_train, dtype=int), np.array(i_eval, dtype=int)


def _torch_randperm(n: int, seed: int) -> np.ndarray:
    """torch.randperm with a manual seed: the reference's seeded splits
    (robustnerf seed 2023, sparse-mipnerf360 seed 2024)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=g).numpy()


# ---------------------------------------------------------------------------
# transforms.json (nerfstudio / COLMAP-style) parsing
# ---------------------------------------------------------------------------

MAX_AUTO_RESOLUTION = 1600


@dataclasses.dataclass(frozen=True)
class NerfstudioParserConfig:
    """Shared knobs of the COLMAP-style parsers (defaults =
    nerfstudio dataparser defaults unless a fork overrides)."""

    downscale_factor: int | None = None
    scene_scale: float = 1.0  # aabb half-extent
    scale_factor: float = 1.0  # additional pose scaling
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    load_3d_points: bool = True


def _get_fname(
    filepath: Path, data_dir: Path, downscale_factor: int | None
) -> tuple[Path, int]:
    """Resolve an image path honoring `images_{d}/` downscaled copies and
    the auto <=1600px rule (`robustnerf_dataparser.py:402-431`)."""
    if downscale_factor is None:
        # probe actual size for the auto rule
        test = data_dir / filepath
        try:
            w, h = image_size(test)
            # nerfstudio semantics: smallest power-of-two factor that brings
            # max(w, h) to <= MAX_AUTO_RESOLUTION (a ~3118px Mip-NeRF 360
            # image must parse at 2x, not full res)
            d = 0
            while max(w, h) // (2**d) > MAX_AUTO_RESOLUTION:
                d += 1
            downscale_factor = 2**d
        except Exception:
            downscale_factor = 1
    if downscale_factor > 1:
        cand = data_dir / f"{filepath.parent.name}_{downscale_factor}" / filepath.name
        if cand.exists():
            return cand, downscale_factor
    return data_dir / filepath, downscale_factor


def load_transforms_frames(
    data: Path,
) -> tuple[dict, list[dict], Path]:
    """Load transforms.json; frames sorted by file_path
    (`robustnerf_dataparser.py:117-124`)."""
    data = Path(data)
    if data.suffix == ".json":
        meta_path, data_dir = data, data.parent
    else:
        meta_path, data_dir = data / "transforms.json", data
    with open(meta_path) as f:
        meta = json.load(f)
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])
    return meta, frames, data_dir


_INTRINSIC_KEYS = ("fl_x", "fl_y", "cx", "cy", "w", "h",
                   "k1", "k2", "k3", "k4", "p1", "p2")


def _frame_intrinsics(meta: dict, frame: dict) -> dict[str, float]:
    """Per-frame overrides fall back to global values
    (`robustnerf_dataparser.py:98-158`)."""
    out = {}
    for k in _INTRINSIC_KEYS:
        v = frame.get(k, meta.get(k, 0.0))
        out[k] = float(v) if v is not None else 0.0
    return out


def _read_ply_points(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader (ascii / binary_little_endian) for SfM seeds —
    replaces open3d usage in `ood_mipnerf360_dataparser.py:330-383`."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[2] for l in header if l.startswith("element vertex")))
        props = [l.split()[2] for l in header if l.startswith("property")]
        type_map = {"float": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
                    "int": "i4", "short": "i2", "ushort": "u2"}
        types = [type_map[l.split()[1]] for l in header if l.startswith("property")]
        if fmt.startswith("binary_little"):
            dt = np.dtype(list(zip(props, ["<" + t for t in types])))
            arr = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        else:
            raw = np.loadtxt(f, max_rows=n)
            arr = np.core.records.fromarrays(raw.T[: len(props)], names=props)
    pts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
    if "red" in props:
        cols = np.stack([arr["red"], arr["green"], arr["blue"]], -1)
        cols = cols.astype(np.float32) / (255.0 if cols.max() > 1 else 1.0)
    else:
        cols = np.full_like(pts, 0.5)
    return pts, cols


def parse_nerfstudio(
    data: Path,
    split: str = "train",
    config: NerfstudioParserConfig | None = None,
    split_fn: Callable[[dict, list[dict], np.ndarray], tuple[np.ndarray, np.ndarray]]
    | None = None,
) -> DataparserOutputs:
    """The shared COLMAP-style parser body.

    split_fn(meta, frames, poses) -> (i_train, i_eval) plugs in each fork's
    policy; default is nerfstudio's equally-spaced fraction split.
    """
    config = config or NerfstudioParserConfig()
    meta, frames, data_dir = load_transforms_frames(data)

    poses = np.array(
        [np.array(fr["transform_matrix"], dtype=np.float64) for fr in frames]
    )  # (N, 4, 4) OpenGL c2w

    if split_fn is None:
        i_train, i_eval = get_train_eval_split_fraction(
            len(frames), config.train_split_fraction
        )
    else:
        i_train, i_eval = split_fn(meta, frames, poses)
    indices = np.asarray(i_train if split == "train" else i_eval, dtype=int)

    oriented, transform = auto_orient_and_center_poses(
        poses.astype(np.float64),
        method=meta.get("orientation_override", config.orientation_method),
        center_method=config.center_method,
    )
    scale = 1.0
    if config.auto_scale_poses:
        scale = 1.0 / max(float(np.max(np.abs(oriented[:, :3, 3]))), 1e-8)
    scale *= config.scale_factor
    oriented[:, :3, 3] *= scale

    # resolve filenames + downscale
    dfactor = config.downscale_factor
    image_filenames = []
    for fr in frames:
        fname, dfactor = _get_fname(Path(fr["file_path"]), data_dir, dfactor)
        image_filenames.append(fname)
    inv_d = 1.0 / dfactor

    intr = [_frame_intrinsics(meta, fr) for fr in frames]
    fx = np.array([i["fl_x"] for i in intr]) * inv_d
    fy = np.array([i["fl_y"] for i in intr]) * inv_d
    cx = np.array([i["cx"] for i in intr]) * inv_d
    cy = np.array([i["cy"] for i in intr]) * inv_d
    width = int(round(intr[0]["w"] * inv_d)) if intr[0]["w"] else 0
    height = int(round(intr[0]["h"] * inv_d)) if intr[0]["h"] else 0
    dist = np.stack(
        [
            np.array([i["k1"], i["k2"], i["k3"], i["k4"], i["p1"], i["p2"]])
            for i in intr
        ]
    )

    cam_type = FISHEYE if meta.get("camera_model") == "OPENCV_FISHEYE" else PERSPECTIVE

    sel = indices
    cameras = Cameras(
        camera_to_worlds=_f32(oriented[sel]),
        fx=_f32(fx[sel]),
        fy=_f32(fy[sel]),
        cx=_f32(cx[sel]),
        cy=_f32(cy[sel]),
        width=width,
        height=height,
        distortion_params=_f32(dist[sel]) if np.abs(dist).sum() > 0 else None,
        camera_type=cam_type,
    )

    aabb = config.scene_scale * np.array(
        [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], dtype=np.float32
    )
    metadata: dict[str, Any] = {"indices": sel, "num_frames_total": len(frames)}

    # applied_transform chaining (`robustnerf_dataparser.py:379-386`)
    if "applied_transform" in meta:
        applied = np.array(meta["applied_transform"], dtype=np.float64)
        homog = np.concatenate(
            [transform, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0
        )
        applied_h = np.concatenate(
            [applied[:3], np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0
        )
        transform = (homog @ applied_h)[:3].astype(np.float32)

    # SfM points for splatfacto seeding
    ply_path = meta.get("ply_file_path")
    if config.load_3d_points and ply_path and (data_dir / ply_path).exists():
        pts, cols = _read_ply_points(data_dir / ply_path)
        pts = (transform[:3, :3] @ pts.T + transform[:3, 3:4]).T * scale
        metadata["points3D_xyz"] = pts.astype(np.float32)
        metadata["points3D_rgb"] = cols

    return DataparserOutputs(
        image_filenames=[image_filenames[i] for i in sel],
        cameras=cameras,
        scene_box=aabb,
        dataparser_scale=float(scale),
        dataparser_transform=transform,
        metadata=metadata,
    )


# ---------------------------------------------------------------------------
# Blender parsing
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlenderParserConfig:
    scale_factor: float = 1.0
    alpha_color: str = "white"
    downscale_factor: int = 1


def parse_blender(
    data: Path,
    split: str = "train",
    config: BlenderParserConfig | None = None,
    frame_indices: np.ndarray | None = None,
    with_depth: bool = False,
) -> DataparserOutputs:
    """Blender synthetic `transforms_{split}.json` parser
    (`sparse_blender_dataparser.py`, `blender_downscale_dataparser.py`)."""
    config = config or BlenderParserConfig()
    data = Path(data)
    with open(data / f"transforms_{split if split != 'val' else 'test'}.json") as f:
        meta = json.load(f)
    frames = meta["frames"]
    if frame_indices is not None:
        # reference assumes 100-frame Blender sets; tolerate smaller trees
        frames = [frames[i] for i in frame_indices if i < len(frames)]

    image_filenames = [data / (fr["file_path"] + ".png") for fr in frames]
    poses = np.array(
        [np.array(fr["transform_matrix"], dtype=np.float32) for fr in frames]
    )[:, :3, :]
    poses[:, :3, 3] *= config.scale_factor

    # probe resolution from the first image
    w, h = image_size(image_filenames[0])
    d = config.downscale_factor
    w, h = w // d, h // d
    focal = 0.5 * w / math.tan(0.5 * float(meta["camera_angle_x"]))

    n = len(frames)
    cameras = Cameras(
        camera_to_worlds=_f32(poses),
        fx=torch.full((n,), focal, dtype=torch.float32),
        fy=torch.full((n,), focal, dtype=torch.float32),
        cx=torch.full((n,), w / 2.0, dtype=torch.float32),
        cy=torch.full((n,), h / 2.0, dtype=torch.float32),
        width=w,
        height=h,
    )
    depth_filenames = None
    if with_depth:
        # test split lists `*_depth_0001.png` GT depth
        # (`blender_downscale_dataparser.py:88-90`)
        depth_filenames = [
            Path(str(p).replace(".png", "_depth_0001.png")) for p in image_filenames
        ]
    alpha = (
        np.ones(3, np.float32)
        if config.alpha_color == "white"
        else np.zeros(3, np.float32)
    )
    return DataparserOutputs(
        image_filenames=image_filenames,
        cameras=cameras,
        scene_box=np.array([[-1.5, -1.5, -1.5], [1.5, 1.5, 1.5]], np.float32)
        * config.scale_factor,
        dataparser_scale=config.scale_factor,
        dataparser_transform=np.eye(4, dtype=np.float32)[:3],
        metadata={},
        depth_filenames=depth_filenames,
        alpha_color=alpha,
    )


# ---------------------------------------------------------------------------
# split policies (pure functions) + parser variants
# ---------------------------------------------------------------------------

# few-view LF / ScanNet splits, hard-coded per scene
# (`sparse_nerfstudio_dataparser.py:189-238`)
SPARSE_NERFSTUDIO_SCENES: dict[str, dict[str, Any]] = {
    "basket": dict(i_train=list(range(43, 50, 2)), i_val=list(range(42, 50, 2)), scene_scale=50.0),
    "africa": dict(i_train=list(range(5, 14, 2)), i_val=list(range(6, 14, 2)), scene_scale=36.0),
    "statue": dict(i_train=list(range(67, 76, 2)), i_val=list(range(68, 76, 2)), scene_scale=50.0),
    "torch": dict(i_train=list(range(8, 17, 2)), i_val=list(range(9, 17, 2)), scene_scale=72.0),
    "scene_079": dict(i_val=[4, 12, 20, 28, 37], num=40, scene_scale=150.0),
    "scene_000": dict(i_val=[4, 12, 20, 28, 36], num=40, scene_scale=140.0),
    "scene_316": dict(i_val=[4, 12, 20, 28, 36], num=40, scene_scale=100.0),
    "scene_158": dict(i_val=[4, 12, 20, 28, 36], num=40, scene_scale=2000.0),
}


def split_sparse_nerfstudio(scene: str) -> tuple[np.ndarray, np.ndarray, float]:
    spec = SPARSE_NERFSTUDIO_SCENES[scene]
    if "i_train" in spec:
        i_train = np.array(spec["i_train"])
        i_val = np.array(spec["i_val"])
    else:
        i_val = np.array(spec["i_val"])
        i_train = np.array([i for i in range(spec["num"]) if i not in spec["i_val"]])
    return i_train, i_val, spec["scene_scale"]


def split_sparse_mipnerf360(
    num_images: int,
    proportion_train_images: float,
    train_split_fraction: float = 0.9,
    seed_random_split: int = 2024,
) -> tuple[np.ndarray, np.ndarray]:
    """Nerfstudio split, then seeded-randperm subsample of the train set
    (`sparse_mipnerf360_dataparser.py:181-192`)."""
    i_train, i_eval = get_train_eval_split_fraction(num_images, train_split_fraction)
    perm = _torch_randperm(len(i_train), seed_random_split)
    keep = int(round(len(i_train) * proportion_train_images))
    return i_train[perm[:keep]], i_eval


def split_ood_mipnerf360(
    poses: np.ndarray,
    scene: str,
    train_split_fraction: float = 0.9,
) -> tuple[np.ndarray, np.ndarray]:
    """Half-hemisphere OOD: train keeps translation >= 0 along x (z for
    scene 'room'), eval keeps < 0 (`ood_mipnerf360_dataparser.py:183-205`)."""
    i_train, i_eval = get_train_eval_split_fraction(len(poses), train_split_fraction)
    t_idx = 0 if scene != "room" else 2
    t = poses[:, t_idx, 3]
    i_train = np.array([i for i in i_train if t[i] >= 0.0], dtype=int)
    i_eval = np.array([i for i in i_eval if t[i] < 0.0], dtype=int)
    return i_train, i_eval


def split_robustnerf(
    basenames: list[str],
    scene: str,
    train_split_clean_clutter_ratio: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Outlier-scene splits (`robustnerf_dataparser.py:209-283`)."""
    i_all = np.arange(len(basenames))
    if scene == "yoda":
        i_clean = [i for i, b in zip(i_all, basenames) if "clean" in b]
        i_clutter = [i for i, b in zip(i_all, basenames) if "clutter" in b]
        i_eval = [i for i, b in zip(i_all, basenames) if "extra" in b]
        assert len(i_clean) == len(i_clutter)
        r = train_split_clean_clutter_ratio
        if r == 0.0:
            i_train = list(i_clean)
        elif r == 1.0:
            i_train = list(i_clutter)
        else:
            perm = _torch_randperm(len(i_clutter), 2023)
            n_clutter = int(len(i_clutter) * r)
            i_train = [
                (i_clutter if k < n_clutter else i_clean)[idx]
                for k, idx in enumerate(perm)
            ]
        return np.array(i_train), np.array(i_eval)
    if scene == "and-bot":
        i_clean = [i for i, b in zip(i_all, basenames) if "IMG_1" in b]
        i_clutter = [i for i, b in zip(i_all, basenames) if "IMG_2" in b]
        return np.array(i_clutter), np.array(i_clean)
    if scene == "t_balloon_statue":
        return i_all[19:], i_all[:19]
    if scene == "crab":
        i_clutter, i_clean = get_train_eval_split_filename(basenames)
        return i_clutter, i_clean
    raise ValueError(f"unknown robustnerf scene {scene}")


def split_nerfonthego(data_dir: Path) -> tuple[list[str], list[str]]:
    """`split.json` with `clutter` (train) / `extra` (eval) lists
    (`nerfonthego_dataparser.py:184-198`)."""
    with open(Path(data_dir) / "split.json") as f:
        spec = json.load(f)
    return spec["clutter"], spec["extra"]


# fixed 100-image permutations from the reference (data constants,
# `sparse_blender_dataparser.py:38-61`); first `num_images` are the train set
SPARSE_BLENDER_PERMS: dict[str, list[int]] = {
    "seed1": [79, 37, 65, 54, 15, 20, 99, 25, 56, 17, 59, 93, 87, 66, 55, 73, 39,
              30, 16, 49, 60, 53, 83, 23, 88, 9, 18, 82, 74, 89, 58, 98, 48, 76,
              57, 90, 75, 86, 63, 24, 78, 10, 29, 19, 45, 81, 85, 52, 5, 67, 69,
              1, 92, 21, 68, 91, 31, 12, 35, 28, 42, 70, 44, 38, 84, 3, 51, 62,
              50, 41, 14, 8, 26, 13, 94, 0, 2, 77, 46, 64, 96, 43, 36, 61, 22,
              47, 95, 33, 11, 71, 72, 6, 27, 40, 4, 32, 97, 34, 7, 80],
    "seed2": [59, 42, 2, 27, 28, 75, 58, 68, 52, 74, 3, 73, 35, 47, 80, 29, 94,
              12, 56, 0, 92, 60, 61, 95, 63, 11, 48, 62, 39, 34, 50, 16, 76, 83,
              53, 23, 7, 69, 54, 38, 15, 99, 79, 72, 43, 10, 96, 71, 78, 32, 8,
              93, 86, 89, 84, 65, 4, 26, 51, 17, 57, 49, 66, 81, 20, 18, 19, 88,
              41, 24, 67, 25, 46, 82, 91, 13, 21, 45, 97, 77, 14, 36, 85, 1, 31,
              22, 87, 70, 64, 6, 55, 37, 9, 44, 90, 33, 40, 30, 98, 5],
    "seed3": [2, 49, 82, 31, 37, 12, 87, 42, 99, 85, 75, 22, 76, 50, 57, 30, 55,
              33, 54, 0, 73, 46, 80, 26, 71, 91, 96, 65, 97, 10, 78, 35, 86, 56,
              92, 24, 77, 16, 25, 89, 67, 28, 15, 6, 51, 43, 94, 32, 62, 72, 36,
              3, 70, 17, 20, 9, 53, 98, 21, 61, 68, 63, 59, 81, 48, 60, 58, 69,
              1, 47, 52, 13, 11, 74, 23, 83, 7, 66, 79, 19, 38, 29, 90, 27, 5,
              40, 95, 41, 34, 39, 88, 45, 14, 18, 93, 8, 84, 64, 44, 4],
}


def split_sparse_blender(
    seed_name: str = "seed1", num_images: int = 5
) -> np.ndarray:
    """First `num_images` of the fixed permutation
    (`sparse_blender_dataparser.py:101-110`)."""
    return np.array(SPARSE_BLENDER_PERMS[seed_name][:num_images])


def split_hh_blender(poses: np.ndarray, split: str) -> np.ndarray:
    """Half-hemisphere Blender: train/val where pose[0, 3] <= 0, test where
    > 0 (`hh_blender_dataparser.py:74-90`)."""
    x = poses[:, 0, 3]
    if split in ("train", "val"):
        return np.nonzero(x <= 0.0)[0]
    return np.nonzero(x > 0.0)[0]


# ---------------------------------------------------------------------------
# parser entry points (CLI-name compatible)
# ---------------------------------------------------------------------------


def sparse_nerfstudio(data: Path, split: str = "train", scene: str = "basket",
                      **kw) -> DataparserOutputs:
    i_train, i_val, scene_scale = split_sparse_nerfstudio(scene)
    cfg = NerfstudioParserConfig(
        downscale_factor=kw.pop("downscale_factor", 2),
        auto_scale_poses=False,
        scene_scale=scene_scale,
        **kw,
    )
    return parse_nerfstudio(
        data, split, cfg, split_fn=lambda m, f, p: (i_train, i_val)
    )


def sparse_mipnerf360(data: Path, split: str = "train",
                      proportion_train_images: float = 1.0,
                      **kw) -> DataparserOutputs:
    cfg = NerfstudioParserConfig(**kw)
    return parse_nerfstudio(
        data, split, cfg,
        split_fn=lambda m, f, p: split_sparse_mipnerf360(
            len(f), proportion_train_images, cfg.train_split_fraction
        ),
    )


def ood_mipnerf360(data: Path, split: str = "train", scene: str = "garden",
                   **kw) -> DataparserOutputs:
    cfg = NerfstudioParserConfig(**kw)
    return parse_nerfstudio(
        data, split, cfg,
        split_fn=lambda m, f, p: split_ood_mipnerf360(
            p, scene, cfg.train_split_fraction
        ),
    )


def robustnerf(data: Path, split: str = "train", scene: str = "yoda",
               train_split_clean_clutter_ratio: float = 1.0,
               **kw) -> DataparserOutputs:
    cfg = NerfstudioParserConfig(
        downscale_factor=kw.pop("downscale_factor", 8), **kw
    )

    def fn(meta, frames, poses):
        basenames = [os.path.basename(fr["file_path"]) for fr in frames]
        return split_robustnerf(basenames, scene, train_split_clean_clutter_ratio)

    return parse_nerfstudio(data, split, cfg, split_fn=fn)


def nerfonthego(data: Path, split: str = "train", **kw) -> DataparserOutputs:
    cfg = NerfstudioParserConfig(**kw)

    def fn(meta, frames, poses):
        clutter, extra = split_nerfonthego(
            Path(data) if Path(data).is_dir() else Path(data).parent
        )
        names = [os.path.basename(fr["file_path"]) for fr in frames]
        as_idx = lambda lst: np.array(
            [i for i, nm in enumerate(names)
             if nm in set(map(os.path.basename, map(str, lst))) or i in set(
                 x for x in lst if isinstance(x, int))],
            dtype=int,
        )
        return as_idx(clutter), as_idx(extra)

    return parse_nerfstudio(data, split, cfg, split_fn=fn)


def sparse_blender(data: Path, split: str = "train", seed_name: str = "seed1",
                   num_images: int = 5, **kw) -> DataparserOutputs:
    idx = split_sparse_blender(seed_name, num_images) if split == "train" else None
    return parse_blender(data, split, BlenderParserConfig(**kw), frame_indices=idx)


def blender_downscale(data: Path, split: str = "train", downscale_factor: int = 1,
                      **kw) -> DataparserOutputs:
    """Blender + on-disk `rgb_{d}x/<split>/` LANCZOS copies generated on
    first use (`blender_downscale_dataparser.py:142-172`); test split also
    carries GT depth files."""
    out = parse_blender(
        data, split,
        BlenderParserConfig(downscale_factor=downscale_factor, **kw),
        with_depth=(split == "test"),
    )
    if downscale_factor > 1:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError("blender-downscale makes its LANCZOS copies with PIL, which is not "
                               "installed; parse at downscale_factor=1 or write the copies elsewhere") from e

        resized_dir = Path(data) / f"rgb_{downscale_factor}x" / split
        resized_dir.mkdir(parents=True, exist_ok=True)
        new_names = []
        for p in out.image_filenames:
            tgt = resized_dir / Path(p).name
            if not tgt.exists():
                with Image.open(p) as im:
                    im = im.resize(
                        (im.width // downscale_factor, im.height // downscale_factor),
                        Image.LANCZOS,
                    )
                    im.save(tgt)
            new_names.append(tgt)
        out.image_filenames = new_names
    return out


def hh_blender(data: Path, split: str = "train", **kw) -> DataparserOutputs:
    with open(Path(data) / f"transforms_{split if split != 'val' else 'test'}.json") as f:
        meta = json.load(f)
    poses = np.array([fr["transform_matrix"] for fr in meta["frames"]])
    idx = split_hh_blender(poses, split)
    return parse_blender(data, split, BlenderParserConfig(**kw), frame_indices=idx)


DATAPARSERS: dict[str, Callable[..., DataparserOutputs]] = {
    # the reference's CLI names
    "nerfstudio-data": parse_nerfstudio,
    "blender-data": parse_blender,
    "sparse-nerfstudio": sparse_nerfstudio,
    "sparse-mipnerf360": sparse_mipnerf360,
    "ood-mipnerf360": ood_mipnerf360,
    "robustnerf": robustnerf,
    "nerfonthego": nerfonthego,
    "sparse-blender": sparse_blender,
    "blender-downscale": blender_downscale,
    "hh-blender": hh_blender,
}
