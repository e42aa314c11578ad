"""Device milliseconds per image of the operations launched inside the
fused ensemble's members' stage (``ungs.ensemble.members``: the members'
MLPs and compositing). Left out where the stretch does not hold one image
span an image, or no members' stage."""


def read(t):
    s = t.spans
    if t.kind != "eval" or s.count.get("ungs.render.image") != t.units or "ungs.ensemble.members" not in s.device_s:
        return None
    return 1e3 * s.device_s["ungs.ensemble.members"] / t.units
