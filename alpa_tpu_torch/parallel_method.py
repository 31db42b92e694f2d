"""Parallelization strategy objects.

Counterpart of ``alpa_tpu/parallel_method.py``: a ``ParallelMethod`` turns
a function and a mesh into an executable.  Ported: ``ShardParallel`` (with
gradient accumulation, the auto-sharding planner and manual specs),
``DataParallel``, ``Zero2Parallel`` and ``Zero3Parallel``;
``PipeshardParallel`` with manual, automatic and follow layers (remat
layers too), uniform, manual and automatic stages, on stage meshes of one
device or several (each planned as the JAX package plans a stage, run by
the SPMD executor, values moved between meshes as tiles);
``LocalPipelineParallel``; and ``get_3d_parallel_method``.  Everything
runs over the devices of one host (the SPMD executor,
``shard_parallel/spmd_partition.py``).
"""
from typing import Any, Optional, Sequence, Union

from alpa_tpu_torch.device_mesh import (LocalPhysicalDeviceMesh,
                                        PhysicalDeviceMesh,
                                        VirtualPhysicalMesh,
                                        get_global_physical_mesh,
                                        get_global_virtual_physical_mesh)
from alpa_tpu_torch.mesh_executable import NormalMeshExecutable
from alpa_tpu_torch.pipeline_parallel.layer_construction import \
    AutoLayerOption
from alpa_tpu_torch.pipeline_parallel.stage_construction import \
    ManualStageOption
from alpa_tpu_torch.platform import get_device
from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption
from alpa_tpu_torch.shard_parallel.manual_sharding import \
    ManualShardingOption


class ParallelMethod:
    """Base class.  ``donates_in_place``: the method runs the function
    eagerly and lets a donated ``TrainState`` update itself in place; a
    tracing method needs the function functional and frees donated inputs
    itself."""
    donates_in_place = True

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        """An executable running ``fun`` (flat args in, flat outs); the
        flat arguments' (shape, dtype) ``avals`` and which are batch and
        donated."""
        raise NotImplementedError


class ShardParallel(ParallelMethod):
    """Intra-op parallelism over one device mesh, optionally with gradient
    accumulation (``alpa_tpu/parallel_method.py:33``).  On one device with
    neither ``num_micro_batches > 1`` nor an option the function runs
    eagerly, a donated ``TrainState`` updated in place.  Otherwise the
    step is traced and compiled by ``compile_shard_executable``: planned
    (on more than one device, by the ILP or, for ``DataParallel`` and the
    ZeRO methods, by rules), its manual specs applied, rewritten for
    accumulation, and, on more than one device, partitioned into the
    program every device runs on its shards (the state stays sharded
    between steps: its leaves come back as ``DistributedArray``s)."""

    def __init__(self,
                 devices: Optional[Union[PhysicalDeviceMesh, Sequence]] = None,
                 num_micro_batches: Optional[int] = None,
                 auto_sharding_option: Optional[AutoShardingOption] = None,
                 manual_sharding_option: Optional[
                     ManualShardingOption] = None):
        if devices is not None and not isinstance(devices, PhysicalDeviceMesh):
            devices = LocalPhysicalDeviceMesh(list(devices))
        self.devices = devices
        self.num_micro_batches = num_micro_batches
        self.as_option = auto_sharding_option or AutoShardingOption()
        self.ms_option = manual_sharding_option
        # the eager path on one device, unless a compile is asked for
        self._eager = not (
            (num_micro_batches or 1) > 1 or auto_sharding_option is not None
            or manual_sharding_option is not None)

    @property
    def donates_in_place(self) -> bool:
        return self._eager and self._get_mesh().num_devices == 1

    def _get_mesh(self) -> PhysicalDeviceMesh:
        if self.devices is not None:
            return self.devices
        return get_global_physical_mesh(create_if_not_exist=True)

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        mesh = self._get_mesh()
        if self.donates_in_place and mesh.num_devices == 1:
            return NormalMeshExecutable(mesh, fun)
        from alpa_tpu_torch.shard_parallel.compile_executable import \
            compile_shard_executable
        in_paths = getattr(fun, "in_paths", None) or ("",) * len(avals)
        return compile_shard_executable(
            fun, mesh, avals, getattr(fun, "in_tree", None), in_paths,
            donated_invars, batch_invars, self.num_micro_batches,
            self.as_option, self.ms_option)


class DataParallel(ShardParallel):
    """Batch-dim data parallelism (``alpa_tpu/parallel_method.py:65``)."""

    def __init__(self, devices=None, num_micro_batches=None):
        super().__init__(
            devices, num_micro_batches,
            AutoShardingOption(enable_auto_sharding=False,
                               force_data_parallel=True,
                               force_batch_dim_to_mesh_dim=0))


class Zero2Parallel(ShardParallel):
    """Data parallelism with sharded optimizer state and reduce-scattered
    gradients (``alpa_tpu/parallel_method.py:76``)."""

    def __init__(self, devices=None, num_micro_batches=None):
        super().__init__(
            devices, num_micro_batches,
            AutoShardingOption(enable_auto_sharding=False,
                               force_data_parallel=True,
                               prefer_reduce_scatter=True))


class Zero3Parallel(ShardParallel):
    """Data parallelism with sharded parameters, gradients and optimizer
    state (``alpa_tpu/parallel_method.py:88``)."""

    def __init__(self, devices=None, num_micro_batches=None):
        super().__init__(
            devices, num_micro_batches,
            AutoShardingOption(enable_auto_sharding=False,
                               force_data_parallel=True,
                               prefer_reduce_scatter=True,
                               force_zero_stage_3=True))


class PipeshardParallel(ParallelMethod):
    """Inter-op (pipeline) parallelism over stage meshes, each planned for
    intra-op parallelism over its devices
    (``alpa_tpu/parallel_method.py:100``): the step is traced once, cut into
    forward and backward stages at the layer markers, and run by a static
    instruction program under ``pipeline_schedule`` ("gpipe", "1f1b",
    "1f1b_overlap_friendly"); a function without a gradient marker is
    forward-only and runs in forward stages under "inference".  The program
    is dispatched as the JAX driver's "auto" mode chooses, on CUDA by
    replaying each stage run as a CUDA graph.  ``devices`` is a
    ``VirtualPhysicalMesh`` or a device list; by default the global
    cluster's devices (every CUDA device,
    raising without CUDA, unless ``init`` named others).  A list may name one
    device more than once.  ``layer_option``: ``ManualLayerOption``,
    ``AutoLayerOption``, ``FollowLayerOption`` (any of them with
    ``remat_layer``), by default ``AutoLayerOption(layer_num=min(8,
    #devices))``; ``stage_option``: ``UniformStageOption`` (the default),
    ``ManualStageOption`` or ``AutoStageOption``.  A stage mesh of more
    than one device is planned with ``default_auto_sharding_option`` (by
    default ``AutoShardingOption()``: the intra-op ILP on the stage's graph,
    at the stage's logical shape if one is given); with
    ``enable_auto_sharding=False`` every stage input is replicated, unless
    a ZeRO stage of 2 or 3 shards the optimizer state (and parameters)
    over the stage's devices, as the JAX package plans a stage.
    ``stage_input_shardings`` is accepted and unused, as in the JAX
    package."""
    donates_in_place = False

    def __init__(self,
                 devices: Optional[Union[VirtualPhysicalMesh,
                                         Sequence]] = None,
                 num_micro_batches: int = 1,
                 default_auto_sharding_option: Any = None,
                 pipeline_schedule: str = "1f1b",
                 layer_option: Any = None,
                 stage_option: Any = None,
                 stage_input_shardings=None):
        if devices is not None and not isinstance(devices,
                                                  VirtualPhysicalMesh):
            devices = VirtualPhysicalMesh(list(devices))
        self.devices = devices
        self.num_micro_batches = num_micro_batches
        self.as_option = default_auto_sharding_option or AutoShardingOption()
        self.pipeline_schedule = pipeline_schedule
        self.layer_option = layer_option
        self.stage_option = stage_option
        self.stage_input_shardings = stage_input_shardings

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        from alpa_tpu_torch.pipeline_parallel.compile_executable import \
            compile_pipeshard_executable
        mesh = self.devices or get_global_virtual_physical_mesh(
            create_if_not_exist=True)
        in_paths = getattr(fun, "in_paths", None) or ("",) * len(avals)
        return compile_pipeshard_executable(
            fun, mesh, avals, batch_invars, donated_invars,
            self.num_micro_batches, self.pipeline_schedule,
            self.layer_option, self.stage_option, self.as_option, in_paths)


class LocalPipelineParallel(ParallelMethod):
    """The sliced layer graphs run in order on one device, a debugging aid
    that separates slicing faults from runtime faults
    (``alpa_tpu/parallel_method.py:133``, ``local_pipeline.py``).
    ``layer_option`` defaults to ``AutoLayerOption(layer_num=2)``;
    ``device`` to CUDA (raising without it)."""
    donates_in_place = False

    def __init__(self, device=None, layer_option: Any = None):
        self.device = get_device(device)
        self.layer_option = layer_option

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        del batch_invars, donated_invars
        from alpa_tpu_torch.pipeline_parallel.local_pipeline import \
            LocalPipelineExecutable
        return LocalPipelineExecutable(fun, avals, self.device,
                                       self.layer_option)


def get_3d_parallel_method(num_micro_batches: int,
                           data_parallel: int,
                           operator_parallel: int,
                           pipeline_parallel: int,
                           devices: Optional[Union[VirtualPhysicalMesh,
                                                   Sequence]] = None,
                           allow_degenerate_into_shard_parallel: bool = True):
    """The dp x op x pp method (``alpa_tpu/parallel_method.py:144``): the
    cluster in ``pipeline_parallel`` equal submeshes, one stage of
    ``AutoLayerOption(layer_num=pipeline_parallel)`` layers on each, on a
    (dp, op) logical mesh of its dp * op devices.  With
    ``pipeline_parallel == 1`` (and degeneration allowed) it is
    ``ShardParallel`` on a (dp, op) logical mesh, planned by rules and
    run over the devices.  With ``pipeline_parallel > 1`` the option is
    ``enable_auto_sharding=False``, under which the JAX package replicates
    every stage input (the stage computed alike on each of its devices;
    ROADMAP C records it), and the port does the same."""
    if devices is not None and not isinstance(devices, VirtualPhysicalMesh):
        devices = VirtualPhysicalMesh(list(devices))
    mesh = devices or get_global_virtual_physical_mesh(
        create_if_not_exist=True)
    dp, op, pp = data_parallel, operator_parallel, pipeline_parallel
    if dp * op * pp != mesh.num_devices:
        raise ValueError(f"dp({dp}) * op({op}) * pp({pp}) != "
                         f"#devices({mesh.num_devices})")
    if pp == 1 and allow_degenerate_into_shard_parallel:
        return ShardParallel(
            devices=list(mesh.devices.flat),
            num_micro_batches=num_micro_batches,
            auto_sharding_option=AutoShardingOption(
                enable_auto_sharding=False, force_data_parallel=(op == 1),
                logical_mesh_shape=(dp, op)))
    per_stage = dp * op
    if per_stage >= mesh.num_devices_per_host:
        submesh = (per_stage // mesh.num_devices_per_host,
                   mesh.num_devices_per_host)
    else:
        submesh = (1, per_stage)
    return PipeshardParallel(
        devices=mesh, num_micro_batches=num_micro_batches,
        default_auto_sharding_option=AutoShardingOption(
            enable_auto_sharding=False, force_data_parallel=(op == 1),
            logical_mesh_shape=(dp, op)),
        pipeline_schedule="1f1b",
        layer_option=AutoLayerOption(layer_num=pp),
        stage_option=ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(pp)],
            submesh_physical_shapes=[list(submesh) for _ in range(pp)],
            submesh_logical_shapes=[(dp, op) for _ in range(pp)],
            submesh_autosharding_option_dicts=[{} for _ in range(pp)]))
