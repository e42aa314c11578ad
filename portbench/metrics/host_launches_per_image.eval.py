"""Kernel and graph launches the host made per image (the runtime's launch
calls in the traced span)."""


def read(t):
    if t.kind != "eval" or t.launches <= 0:
        return None
    return t.launches / t.units
