"""One model's wall time an image over the run's window, on the host's
clock: the driver's ``eval_image_ms``, end to end in the ensemble's cell.
One model's image waits on the host that issues its 6,276 launches, so
this varies with the host from run to run; the cell's end-to-end time is
the device's (``eval_device_ms``)."""


def read(t):
    return t.window.get("eval_image_ms") if t.kind == "eval" else None
