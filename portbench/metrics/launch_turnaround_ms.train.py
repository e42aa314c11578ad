"""Device milliseconds per launch spent idle in gaps that did not begin in
a replay of the captured step (``ungs.train.replay``): each launch's host
read of its losses, its loop over the rows and the next launch's set-up up
to its first replay. Left out where the stretch does not hold one replay a
step, or no launch span."""


def read(t):
    s = t.spans
    if t.kind != "train" or s.count.get("ungs.train.replay") != t.units or not s.count.get("ungs.train.launch"):
        return None
    idle = t.window_s - t.busy_s - s.idle_s.get("ungs.train.replay", 0.0)
    return 1e3 * idle / s.count["ungs.train.launch"]
