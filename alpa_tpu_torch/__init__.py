"""PyTorch/CUDA port of alpa_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, with its module names.  It
imports ``torch`` and never ``jax`` or ``alpa_tpu``.  Entry points run on
CUDA unless the caller passes ``device="cpu"`` (see ``platform.get_device``).
"""
from alpa_tpu_torch.platform import get_device

__all__ = ["get_device"]
