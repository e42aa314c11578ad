"""Device time per step of the optimizer's foreach kernels
(``multi_tensor_apply_kernel``: ScheduledAdam's passes over the
parameters)."""


def read(t):
    if t.kind != "train":
        return None
    ms = t.device_ms(r"multi_tensor_apply")
    return ms / t.units if ms > 0 else None
