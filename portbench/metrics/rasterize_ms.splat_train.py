"""Device milliseconds per step of the operations launched inside
``ungs.splat.rasterize``: the rasterizer's depth sort, tile and row cull,
pack and K2 (``ops/rasterize.py``). Left out where the stretch does not
hold one ``ungs.splat.step`` span a step, or none of
``ungs.splat.rasterize``."""


def read(t):
    s = t.spans
    if t.kind != "train" or s.count.get("ungs.splat.step") != t.units or "ungs.splat.rasterize" not in s.device_s:
        return None
    return 1e3 * s.device_s["ungs.splat.rasterize"] / t.units
