"""PyTorch/CUDA port of ``uncertainty_nerf_gs_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package so that each function's counterpart is
found under the same name. Entry points take ``device=None`` and then run on
CUDA; they raise when no card is present (``ops.backend.resolve_device``).
Hand-written kernels live in ``csrc/`` and are dispatched through
``ops.backend``.
"""

from uncertainty_nerf_gs_torch.ops.backend import resolve_device

__all__ = ["resolve_device"]
