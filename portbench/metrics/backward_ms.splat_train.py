"""Device milliseconds per step of the operations launched inside
``ungs.splat.backward``: ``total.backward()``: K3, the packed-row backward
(``csrc/packed_rows.cu``) and autograd through the projection, the SH
colours and the loss. Left out where the stretch does not hold one
``ungs.splat.step`` span a step, or none of ``ungs.splat.backward``."""


def read(t):
    s = t.spans
    if t.kind != "train" or s.count.get("ungs.splat.step") != t.units or "ungs.splat.backward" not in s.device_s:
        return None
    return 1e3 * s.device_s["ungs.splat.backward"] / t.units
