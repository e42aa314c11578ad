"""Device time per image of the matrix-product kernels (the fields' MLPs)."""


def read(t):
    if t.kind != "eval":
        return None
    ms = t.device_ms(r"gemm|gemv|xmma|cutlass")
    return ms / t.units if ms > 0 else None
