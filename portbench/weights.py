"""Seeded weights for the program and the reference alike.

One uniform draw in [-1, 1) on the card for every member and leaf, cut into
leaves and scaled: grid tables by the configuration's ``table_scale``
(values of a trained grid's order), linear weights to variance 1 / fan-in
(LeCun), the appearance embedding to variance 1 / its width, biases and the
camera optimizer's pose tangents zero.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch


def leaf_scale(name: str, shape: tuple[int, ...], table_scale: float) -> float:
    if name.endswith("encoding.cells"):
        return table_scale
    if name.endswith(".weight") and len(shape) == 2:  # (out, in) layers, (images, width) embeddings
        return math.sqrt(3.0 / shape[1])
    return 0.0  # biases, pose tangents


def draw(shapes: Mapping[str, tuple[int, ...]], members: int, table_scale: float, seed: int,
         device) -> dict[str, torch.Tensor]:
    """name -> (members, *shape) float32 tensor on ``device`` (views of one
    buffer), the same for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    flat = torch.empty(members * sum(sizes.values()), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = members * sizes[name]
        leaf = flat[at:at + n].view(members, *shape)
        leaf.mul_(leaf_scale(name, tuple(shape), table_scale))
        out[name] = leaf
        at += n
    return out
