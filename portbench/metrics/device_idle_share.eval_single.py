"""``device_idle_share.eval``, read in the one-model eval cell, whose image time has a
bound of its own (``eval_image_ms.single``)."""

from portbench.harness import reader

read = reader("device_idle_share.eval")
