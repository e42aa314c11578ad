"""Profiles one full-width active-nerfacto image on the card: the top
kernels, K1, and the count of device activities and copy kernels.

    python3 tests/torch_image_profile.py [CHECKOUT]

CHECKOUT (default: this one) is the repository whose port is profiled, for
example another commit unpacked with ``git archive`` whose
``NerfactoTrainer`` takes images and restores ``{"params": ...}``; the
measurement is always this checkout's ``chip_smoke.profile_nerfacto``, so
that two commits' counts come from one method. Exits non-zero without a
card.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_image_profile: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(root))  # the port under test
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import uncertainty_nerf_gs_torch

    print(f"profiling the port at {Path(uncertainty_nerf_gs_torch.__file__).parent}")
    trainer = smoke.build_nerfacto()
    trainer.render_image(0)  # warm-up: the kernels' build and first launches
    smoke.profile_nerfacto(trainer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
