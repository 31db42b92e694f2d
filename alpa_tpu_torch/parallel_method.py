"""Parallelization strategy objects.

Counterpart of ``alpa_tpu/parallel_method.py``: a ``ParallelMethod`` turns
a function and a mesh into an executable.  Ported: ``ShardParallel`` on one
device; ``PipeshardParallel`` with manual, automatic and follow layers
(remat layers too), uniform, manual and automatic stages, and one device
per stage mesh; ``LocalPipelineParallel``; and ``get_3d_parallel_method``
for data and operator parallelism of 1.  ``ShardParallel`` on a mesh of
more than one device, with gradient accumulation or with a sharding option
raises instead of running on one device, as does a stage of more than one
device: those come with the auto-sharding slice (ROADMAP A.3) and the
gradient-accumulation slice (A.4).
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
    """Intra-op parallelism over one device mesh; one device in this
    slice."""

    def __init__(self,
                 devices: Optional[Union[PhysicalDeviceMesh, Sequence]] = None,
                 num_micro_batches: Optional[int] = None,
                 auto_sharding_option=None,
                 manual_sharding_option=None):
        if devices is not None and not isinstance(devices, PhysicalDeviceMesh):
            devices = LocalPhysicalDeviceMesh(list(devices))
        if (num_micro_batches or 1) != 1:
            raise NotImplementedError(
                "gradient accumulation (num_micro_batches > 1) is not ported "
                "yet (ROADMAP A.4)")
        if auto_sharding_option is not None or manual_sharding_option is not None:
            raise NotImplementedError(
                "sharding options need the auto-sharding ILP, which is not "
                "ported yet (ROADMAP A.3)")
        self.devices = devices
        self.num_micro_batches = num_micro_batches

    def _get_mesh(self) -> PhysicalDeviceMesh:
        if self.devices is not None:
            return self.devices
        return get_global_physical_mesh(create_if_not_exist=True)

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        del avals, batch_invars, donated_invars
        mesh = self._get_mesh()
        if mesh.num_devices != 1:
            raise NotImplementedError(
                f"ShardParallel over {mesh.num_devices} devices needs the "
                "auto-sharding slice (ROADMAP A.3); this slice runs one "
                "device")
        return NormalMeshExecutable(mesh, fun)


class PipeshardParallel(ParallelMethod):
    """Inter-op (pipeline) parallelism over stage meshes of one device each
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
    ``ManualStageOption`` or ``AutoStageOption``.
    ``default_auto_sharding_option`` and ``stage_input_shardings`` raise
    (ROADMAP A.3), as does a stage mesh of more than one device."""
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
        if default_auto_sharding_option is not None or \
                stage_input_shardings is not None:
            raise NotImplementedError(
                "default_auto_sharding_option and stage_input_shardings need "
                "intra-op sharding inside a stage, which is not ported yet "
                "(ROADMAP A.3)")
        if devices is not None and not isinstance(devices,
                                                  VirtualPhysicalMesh):
            devices = VirtualPhysicalMesh(list(devices))
        self.devices = devices
        self.num_micro_batches = num_micro_batches
        self.pipeline_schedule = pipeline_schedule
        self.layer_option = layer_option
        self.stage_option = stage_option

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        from alpa_tpu_torch.pipeline_parallel.compile_executable import \
            compile_pipeshard_executable
        mesh = self.devices or get_global_virtual_physical_mesh(
            create_if_not_exist=True)
        return compile_pipeshard_executable(
            fun, mesh, avals, batch_invars, donated_invars,
            self.num_micro_batches, self.pipeline_schedule,
            self.layer_option, self.stage_option)


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
    ``AutoLayerOption(layer_num=pipeline_parallel)`` layers on each.  With
    ``pipeline_parallel == 1`` (and degeneration allowed) it is
    ``ShardParallel``.  A stage of more than one device (data or operator
    parallelism above 1) needs intra-op sharding and raises (ROADMAP
    A.3)."""
    if devices is not None and not isinstance(devices, VirtualPhysicalMesh):
        devices = VirtualPhysicalMesh(list(devices))
    mesh = devices or get_global_virtual_physical_mesh(
        create_if_not_exist=True)
    dp, op, pp = data_parallel, operator_parallel, pipeline_parallel
    if dp * op * pp != mesh.num_devices:
        raise ValueError(f"dp({dp}) * op({op}) * pp({pp}) != "
                         f"#devices({mesh.num_devices})")
    if dp * op != 1:
        raise NotImplementedError(
            f"get_3d_parallel_method with data_parallel={dp} and "
            f"operator_parallel={op}: a (dp, op) logical mesh in each stage "
            "needs intra-op sharding, which is not ported yet (ROADMAP A.3)")
    if pp == 1 and allow_degenerate_into_shard_parallel:
        return ShardParallel(devices=list(mesh.devices.flat),
                             num_micro_batches=num_micro_batches)
    return PipeshardParallel(
        devices=mesh, num_micro_batches=num_micro_batches,
        pipeline_schedule="1f1b",
        layer_option=AutoLayerOption(layer_num=pp),
        stage_option=ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(pp)],
            submesh_physical_shapes=[[1, 1] for _ in range(pp)]))
