"""K2, the tile compositor's forward (``csrc/composite_tiles.cu``): its least
time per step (``yardstick/splat_bounds.py``, from the rows the traced
steps composite) over its kernel's device time per step. Left out where the
stretch does not hold one ``ungs.splat.step`` span a step."""


def read(t):
    bound = t.bound_ms_per_unit.get("composite_fwd")
    ms = t.device_ms(r"composite_fwd_kernel")
    if t.kind != "train" or not bound or ms <= 0 or t.spans.count.get("ungs.splat.step") != t.units:
        return None
    return 100.0 * bound * t.units / ms
