"""Parallelization strategy objects.

Counterpart of ``alpa_tpu/parallel_method.py``: a ``ParallelMethod`` turns
a function and a mesh into an executable.  Ported: ``ShardParallel`` on one
device, and ``PipeshardParallel`` with ``ManualLayerOption``,
``UniformStageOption``/``ManualStageOption`` and one device per stage
mesh.  ``ShardParallel`` on a mesh of more than one device, with gradient
accumulation or with a sharding option raises instead of running on one
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
    check_layer_option
from alpa_tpu_torch.pipeline_parallel.stage_construction import \
    check_stage_option


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
    "1f1b_overlap_friendly").  ``devices`` is a ``VirtualPhysicalMesh`` or a
    device list; by default the global cluster's devices (every CUDA device,
    raising without CUDA, unless ``init`` named others).  A list may name one
    device more than once.  ``layer_option`` must be a ``ManualLayerOption``
    and ``stage_option`` a ``UniformStageOption`` or ``ManualStageOption``;
    ``default_auto_sharding_option`` and ``stage_input_shardings`` raise
    (ROADMAP A.3), as does ``AutoLayerOption``/``AutoStageOption`` (A.5)."""
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
        check_layer_option(layer_option)
        check_stage_option(stage_option)
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
