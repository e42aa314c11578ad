"""An animated GIF codec in numpy, for the render CLI's previews.

The card's machine has no PIL, so the port writes its GIFs itself:
GIF89a, one global palette of 256 colours, the Netscape loop extension and
a graphic control block (the frame's delay) before every frame. The image
data is LZW with 9-bit codes that each carry one palette index, a clear
code after every ``_RUN`` of them so that the decoder's table never grows
past 9 bits: valid LZW that any decoder reads, written with numpy's bit
packing in place of a dictionary search (larger files; a preview's frames
are small).

``write_gif`` takes u8 RGB frames and a palette: a given (k, 3) table
(``utils/colormaps.TABLES["jet"]`` for jet-coloured maps), where every
pixel must be one of its colours and is written exactly; or, by default,
``UNIFORM_PALETTE``, 6 x 7 x 6 levels of red, green and blue, each channel
taken to its nearest level, at most ``UNIFORM_BOUND`` (25) away in any
channel. ``read_gif`` decodes what ``write_gif`` writes (and any GIF
whose frames are on one global palette, not interlaced): (frames (F, H, W,
3) u8, delays in ms).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_RUN = 250  # codes between clear codes: the decoder's table stays below 512 entries
_LEVELS = (6, 7, 6)
_STEPS = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.int64) for n in _LEVELS]
# palette index r * 42 + g * 6 + b of levels (r, g, b); 252 colours, padded to 256 with black
UNIFORM_PALETTE = np.concatenate([
    np.stack(np.meshgrid(*_STEPS, indexing="ij"), -1).reshape(-1, 3),
    np.zeros((256 - int(np.prod(_LEVELS)), 3), np.int64),
]).astype(np.uint8)
UNIFORM_BOUND = max(int(np.diff(s).max()) // 2 for s in _STEPS)  # a channel's nearest level: 25 away at most


def _uniform_indices(frame: np.ndarray) -> np.ndarray:
    """Each pixel's nearest level per channel -> its UNIFORM_PALETTE index."""
    idx = []
    for c, steps in enumerate(_STEPS):
        v = frame[..., c].astype(np.int64)
        k = np.clip(np.searchsorted(steps, v), 1, len(steps) - 1)
        idx.append(np.where(v - steps[k - 1] <= steps[k] - v, k - 1, k))
    return idx[0] * (_LEVELS[1] * _LEVELS[2]) + idx[1] * _LEVELS[2] + idx[2]


def _rgb_key(a: np.ndarray) -> np.ndarray:
    return (a[..., 0].astype(np.int64) << 16) | (a[..., 1].astype(np.int64) << 8) | a[..., 2]


def _palette_indices(frame: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Each pixel's index in ``palette`` (the first of equal colours); raises
    where a pixel is not one of its colours."""
    pk = _rgb_key(palette)
    order = np.argsort(pk, kind="stable")
    want = _rgb_key(frame)
    pos = np.clip(np.searchsorted(pk[order], want), 0, len(pk) - 1)
    if not np.array_equal(pk[order][pos], want):
        raise ValueError("a frame holds colours that are not in the given palette")
    return order[pos]


def _lzw(indices: np.ndarray) -> bytes:
    """LZW image data (minimum code size 8) of a frame's palette indices, in
    sub-blocks of at most 255 bytes and the block terminator."""
    pix = indices.reshape(-1).astype(np.int64)
    runs = [pix[i:i + _RUN] for i in range(0, pix.size, _RUN)]
    codes = np.concatenate([np.concatenate([[256], r]) for r in runs] + [np.array([257])])
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).reshape(-1)
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\0"


def write_gif(path: Path | str, frames, duration_ms: int, palette: np.ndarray | None = None,
              loop: int = 0) -> None:
    """Frames (H, W, 3) u8 as an animated GIF, ``duration_ms`` a frame
    (stored in hundredths of a second), looping ``loop`` times (0: forever);
    ``palette`` as the module docstring says."""
    frames = [np.asarray(f) for f in frames]
    if not frames or any(f.dtype != np.uint8 or f.ndim != 3 or f.shape != frames[0].shape or f.shape[2] != 3
                         for f in frames):
        raise ValueError("write_gif takes one or more (H, W, 3) u8 frames of one shape")
    h, w = frames[0].shape[:2]
    if palette is None:
        table, indexed = UNIFORM_PALETTE, [_uniform_indices(f) for f in frames]
    else:
        palette = np.asarray(palette, np.uint8)
        if palette.ndim != 2 or palette.shape[1] != 3 or not 1 <= len(palette) <= 256:
            raise ValueError(f"a palette holds 1 to 256 RGB colours, got shape {palette.shape}")
        table = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
        indexed = [_palette_indices(f, palette) for f in frames]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), table.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0"]
    delay = int(round(duration_ms / 10))
    for idx in indexed:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\0\0")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_lzw(idx))
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


def _lzw_decode(data: bytes, min_size: int) -> bytearray:
    """A frame's palette indices from its LZW image data (sub-blocks joined)."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table, size, prev = list(base), min_size + 1, None
    out = bytearray()
    acc = nbits = pos = 0
    while True:
        while nbits < size and pos < len(data):
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        if nbits < size:
            break
        code = acc & ((1 << size) - 1)
        acc >>= size
        nbits -= size
        if code == clear:
            table, size, prev = list(base), min_size + 1, None
            continue
        if code == eoi:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else table[prev] + table[prev][:1]
            table.append(table[prev] + entry[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        out += entry
        prev = code
    return out


def _sub_blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    parts = []
    while data[pos]:
        parts.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return b"".join(parts), pos + 1


def read_gif(path: Path | str) -> tuple[np.ndarray, list[int]]:
    """(frames (F, H, W, 3) u8, each frame's delay in ms) of a GIF file;
    each frame is drawn whole onto the logical screen (the frames
    ``write_gif`` writes cover it)."""
    data = Path(path).read_bytes()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_table = None
    if flags & 0x80:
        n = 2 << (flags & 7)
        global_table = np.frombuffer(data[pos:pos + 3 * n], np.uint8).reshape(n, 3)
        pos += 3 * n
    screen = np.zeros((h, w, 3), np.uint8)
    frames, delays, delay = [], [], 0
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:  # an extension: the graphic control block's delay, others skipped
            label = data[pos + 1]
            if label == 0xF9:
                delay = 10 * struct.unpack("<H", data[pos + 4:pos + 6])[0]
            _, pos = _sub_blocks(data, pos + 2)
            continue
        if kind != 0x2C:
            raise ValueError(f"{path}: unknown block {kind:#x} at byte {pos}")
        left, top, fw, fh, fflags = struct.unpack("<HHHHB", data[pos + 1:pos + 10])
        pos += 10
        if fflags & 0xC0 or global_table is None:
            raise ValueError(f"{path}: only frames on the global palette, not interlaced, are supported")
        min_size = data[pos]
        image, pos = _sub_blocks(data, pos + 1)
        idx = np.frombuffer(bytes(_lzw_decode(image, min_size)), np.uint8)[:fw * fh]
        if idx.size != fw * fh:
            raise ValueError(f"{path}: a frame holds {idx.size} of its {fw * fh} pixels")
        screen[top:top + fh, left:left + fw] = global_table[idx.reshape(fh, fw)]
        frames.append(screen.copy())
        delays.append(delay)
    return np.stack(frames), delays
