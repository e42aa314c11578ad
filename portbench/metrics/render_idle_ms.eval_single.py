"""``render_idle_ms.eval``, read in the one-model eval cell, whose end-to-end
time is the device's (``eval_device_ms``)."""

from portbench.harness import reader

read = reader("render_idle_ms.eval")
