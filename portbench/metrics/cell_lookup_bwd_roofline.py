"""K5, the hash-grid lookup's backward: its least time per step (bytes of
the distinct cells a step's positions touch, or its operations) over its
kernels' device time per step."""


def read(t):
    bound = t.bound_ms_per_unit.get("cell_lookup_bwd")
    ms = t.device_ms(r"cell_lookup_bwd_(?!pos)")
    if not bound or ms <= 0:
        return None
    return 100.0 * bound * t.units / ms
