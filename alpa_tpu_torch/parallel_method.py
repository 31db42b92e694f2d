"""Parallelization strategy objects.

Counterpart of ``alpa_tpu/parallel_method.py``: a ``ParallelMethod`` turns
a function and a mesh into an executable.  This slice ports
``ShardParallel`` on one device.  On a mesh of more than one device, with
gradient accumulation or with a sharding option, it raises instead of
running on one device: those come with the auto-sharding slice (ROADMAP
A.3) and the gradient-accumulation slice (A.4).
"""
from typing import Optional, Sequence, Union

from alpa_tpu_torch.device_mesh import (LocalPhysicalDeviceMesh,
                                        PhysicalDeviceMesh,
                                        get_global_physical_mesh)
from alpa_tpu_torch.mesh_executable import NormalMeshExecutable


class ParallelMethod:
    """Base class."""

    def compile_executable(self, fun):
        """An executable running ``fun`` (flat args in, flat outs)."""
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

    def compile_executable(self, fun):
        mesh = self._get_mesh()
        if mesh.num_devices != 1:
            raise NotImplementedError(
                f"ShardParallel over {mesh.num_devices} devices needs the "
                "auto-sharding slice (ROADMAP A.3); this slice runs one "
                "device")
        return NormalMeshExecutable(mesh, fun)
