"""Host milliseconds per image inside the eval renderer's image span
(``ungs.render.image``): the renderer's own host code for a whole image,
its chunk loop and the chunk functions' issue, up to the image's
assembly. Left out where the stretch does not hold one span an image."""


def read(t):
    s = t.spans
    if t.kind != "eval" or s.count.get("ungs.render.image") != t.units:
        return None
    return 1e3 * s.host_s["ungs.render.image"] / t.units
