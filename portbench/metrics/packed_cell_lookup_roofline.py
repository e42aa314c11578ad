"""K6, the ensemble's member-packed lookup (dense and strided entries): its
least time per image (the distinct packed rows at the tables' bytes, or its
operations) over its kernels' device time per image."""


def read(t):
    bound = t.bound_ms_per_unit.get("packed_cell_lookup")
    ms = t.device_ms(r"packed_lookup_(fwd|strided)")
    if not bound or ms <= 0:
        return None
    return 100.0 * bound * t.units / ms
