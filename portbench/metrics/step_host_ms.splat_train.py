"""Host milliseconds per step inside ``ungs.splat.step``:
``SplatfactoTrainer.train_step`` as the host runs it, its launches, its
waits and its read of the losses. Left out where the stretch does not hold
one span a step."""


def read(t):
    s = t.spans
    if t.kind != "train" or s.count.get("ungs.splat.step") != t.units:
        return None
    return 1e3 * s.host_s["ungs.splat.step"] / t.units
