"""The training step's matrix-product FLOPs (three forwards' worth, counted
from the configuration's shapes) over the traced span's length times the
peak of the precision the products run in."""


def read(t):
    if t.kind != "train" or t.window_s <= 0 or t.flops_per_unit <= 0:
        return None
    return 100.0 * t.flops_per_unit * t.units / (t.window_s * t.peak_flops)
