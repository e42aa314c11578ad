"""K4, the hash-grid lookup's forward: its least time per image (bytes of
the distinct cells each chunk's positions read, or its operations) over its
kernels' device time per image."""


def read(t):
    bound = t.bound_ms_per_unit.get("cell_lookup_fwd")
    ms = t.device_ms(r"cell_lookup_fwd")
    if not bound or ms <= 0:
        return None
    return 100.0 * bound * t.units / ms
