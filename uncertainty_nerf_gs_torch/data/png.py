"""An 8-bit PNG codec in zlib and numpy.

The card's machine has no PIL, so the port reads and writes PNG itself:
non-interlaced gray, gray + alpha, RGB and RGBA at 8 bits a sample, and
gray at 16 bits (depth maps), with all five scanline filters on decode.
``read_png`` returns what ``np.asarray(PIL.Image.open(path))`` returns for
those files: (H, W) for gray (uint16 for 16-bit gray), (H, W, 2) for gray +
alpha, (H, W, 3) and (H, W, 4) otherwise. ``write_png`` writes every row
with filter 0 (None); PIL reads such files back exactly. Palette, interlaced
and other bit depths are refused with a message that names them.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("truncated PNG file (no IEND chunk)")


def _header(body: bytes) -> tuple[int, int, int, int, int]:
    width, height, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return width, height, depth, color, interlace


def png_size(path: Path | str) -> tuple[int, int]:
    """(width, height) from the IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(33)
    kind, body = next(_chunks(head + b"\0" * 12))
    if kind != b"IHDR":
        raise ValueError(f"{path}: the first chunk is {kind!r}, not IHDR")
    width, height, *_ = _header(body)
    return width, height


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (height, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, expected {height * (stride + 1)}")
    data = data.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along the row, per channel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) & 255).astype(np.uint8).ravel()
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before it
            filt, up = line.tolist(), prev.tolist()
            rec = [0] * stride
            for i in range(stride):
                a = rec[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                rec[i] = (filt[i] + pred) & 255
            cur = np.array(rec, np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: Path | str | bytes) -> np.ndarray:
    """Decode a PNG file, or a PNG file's bytes; see the module docstring
    for what it takes."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    name = "PNG data" if isinstance(path, bytes) else path
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {color} (palette) is not supported; "
                         "gray, gray + alpha, RGB and RGBA are")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if depth != 8 and not (depth == 16 and color == 0):
        raise ValueError(f"{name}: {depth}-bit samples at colour type {color} are not supported; "
                         "8-bit, and 16-bit gray, are")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        return rows.view(">u2").reshape(height, width).astype(np.uint16)
    return rows.reshape(height, width) if channels == 1 else rows.reshape(height, width, channels)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path: Path | str, image: np.ndarray) -> None:
    """Encode ``image`` into a file; see ``png_bytes``."""
    Path(path).write_bytes(png_bytes(image))


def png_bytes(image: np.ndarray) -> bytes:
    """Encode ``image``: uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or
    (H, W, 4), or uint16 (H, W) as 16-bit gray. Returns the file's bytes."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    channels = 1 if image.ndim == 2 else image.shape[2]
    if image.ndim not in (2, 3) or channels not in _COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {image.shape} as PNG")
    if image.dtype == np.uint16 and channels == 1:
        depth, rows = 16, image.astype(">u2")
    elif image.dtype == np.uint8:
        depth, rows = 8, image
    else:
        raise ValueError(f"cannot write {image.dtype} samples at {channels} channels as PNG")
    height, width = image.shape[:2]
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(height, -1)
    filtered = np.concatenate([np.zeros((height, 1), np.uint8), raw], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, _COLOR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6))
            + _chunk(b"IEND", b""))
