"""PyTorch/CUDA port of alpa_tpu for NVIDIA Hopper.

A package of its own beside the JAX package, with its module names.  It
imports ``torch`` and never ``jax`` or ``alpa_tpu``.  Entry points run on
CUDA unless the caller asks for the CPU (``device="cpu"``, or
``devices=["cpu"]`` for a mesh; see ``platform.get_device``).
"""
from alpa_tpu_torch import fault
from alpa_tpu_torch.api import (clear_executable_cache, grad, init,
                                mark_gradient, parallelize, shutdown,
                                value_and_grad)
from alpa_tpu_torch.checkpoint import (CheckpointManager,
                                       RecoveryCheckpointer, RetentionPolicy)
from alpa_tpu_torch.device_mesh import (DistributedArray, get_seed,
                                        set_seed)
from alpa_tpu_torch.parallel_method import (DataParallel,
                                            LocalPipelineParallel,
                                            ParallelMethod, PipeshardParallel,
                                            ShardParallel, Zero2Parallel,
                                            Zero3Parallel,
                                            get_3d_parallel_method)
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    AutoLayerOption, FollowLayerOption, ManualLayerOption, automatic_remat,
    manual_remat)
from alpa_tpu_torch.pipeline_parallel.primitive_def import \
    mark_pipeline_boundary
from alpa_tpu_torch.pipeline_parallel.stage_construction import (
    AutoStageOption, ManualStageOption, UniformStageOption)
from alpa_tpu_torch.platform import get_device
from alpa_tpu_torch.serialization import (restore_checkpoint,
                                          save_checkpoint)
from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption
from alpa_tpu_torch.shard_parallel.manual_sharding import \
    ManualShardingOption

__all__ = ["AutoLayerOption", "AutoShardingOption", "AutoStageOption",
           "CheckpointManager", "RecoveryCheckpointer", "RetentionPolicy",
           "DataParallel", "DistributedArray", "FollowLayerOption", "LocalPipelineParallel",
           "ManualLayerOption", "ManualShardingOption", "ManualStageOption",
           "ParallelMethod", "PipeshardParallel", "ShardParallel",
           "UniformStageOption", "Zero2Parallel", "Zero3Parallel",
           "automatic_remat", "clear_executable_cache",
           "get_3d_parallel_method", "get_device", "get_seed", "grad", "init",
           "manual_remat", "mark_gradient", "mark_pipeline_boundary",
           "fault", "parallelize", "restore_checkpoint", "save_checkpoint",
           "set_seed", "shutdown", "value_and_grad"]
