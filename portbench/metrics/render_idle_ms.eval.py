"""Device milliseconds per image spent idle in gaps that began inside the
eval renderer's image span (``ungs.render.image``): the card waiting on
the renderer's own host code, not on the caller's copy of the image to the
host. Left out where the stretch does not hold one span an image."""


def read(t):
    s = t.spans
    if t.kind != "eval" or s.count.get("ungs.render.image") != t.units:
        return None
    return 1e3 * s.idle_s.get("ungs.render.image", 0.0) / t.units
