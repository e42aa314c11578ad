"""Share of the traced training launches in which the device ran nothing:
1 - the union of its operations' intervals over the traced span."""


def read(t):
    if t.kind != "train" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
