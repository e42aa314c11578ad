"""Device milliseconds per step spent idle while the host was inside a
launch or copy call of the CUDA runtime (``cudaGraphLaunch``,
``cudaLaunchKernel``, ``cudaMemcpyAsync``): the card waiting for the next
captured step, or the copy of its losses, to be handed over. Replayed back
to back, the host waits inside ``cudaGraphLaunch`` for room in the launch
queue for most of a step, so its time there is not the issue cost; this
reads only the part of it the card waits for."""

import re

_DISPATCH = re.compile(r"^cuda(GraphLaunch|LaunchKernel|MemcpyAsync)")


def read(t):
    if t.kind != "train":
        return None
    s = sum(v for k, v in t.idle_by_host_op.items() if _DISPATCH.match(k))
    return 1e3 * s / t.units if s > 0 else None
