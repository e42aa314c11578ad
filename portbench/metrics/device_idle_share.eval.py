"""Share of the traced eval images in which the device ran nothing: 1 - the
union of its operations' intervals over the traced span."""


def read(t):
    if t.kind != "eval" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
