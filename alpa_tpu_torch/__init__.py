"""PyTorch/CUDA port of alpa_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, with its module names.  It
imports ``torch`` and never ``jax`` or ``alpa_tpu``.  Entry points run on
CUDA unless the caller asks for the CPU (``device="cpu"``, or
``devices=["cpu"]`` for a mesh; see ``platform.get_device``).
"""
from alpa_tpu_torch.api import (clear_executable_cache, grad, init,
                                mark_gradient, parallelize, shutdown,
                                value_and_grad)
from alpa_tpu_torch.device_mesh import get_seed, set_seed
from alpa_tpu_torch.parallel_method import ParallelMethod, ShardParallel
from alpa_tpu_torch.platform import get_device

__all__ = ["ParallelMethod", "ShardParallel", "clear_executable_cache",
           "get_device", "get_seed", "grad", "init", "mark_gradient",
           "parallelize", "set_seed", "shutdown", "value_and_grad"]
