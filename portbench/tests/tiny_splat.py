"""A tiny copy of the splat-train cell, for the CPU tests: its metrics as
``BENCHMARK.json`` gives them, the configuration's keys with a buffer of
256 slots (200 alive), four 48 x 40 training views from a camera distance
at which the spheres fill the image, and a few steps."""

from __future__ import annotations

from portbench import harness

NAME, CONFIG, TRAFFIC = "splat-train", "active-splatfacto", "splat-steps-800"


def cell(**model) -> dict:
    """The tiny cell; ``model`` overrides the configuration's model keys."""
    c = harness.load_cell(NAME)
    c["config"]["model"].update({"capacity": 256, "rasterize_capacity": 64, **model})
    c["config"]["state"]["live"] = 200
    c["traffic"].update(check_steps=2, warmup_steps=1, trace_steps=1)
    c["traffic"]["scene"].update(height=40, width=48, views=4, gt_samples=16, radius=1.6)
    return c
