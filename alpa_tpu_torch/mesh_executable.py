"""Mesh executables: what ``@parallelize`` runs on one physical mesh.

Counterpart of ``alpa_tpu/mesh_executable.py`` (``MeshExecutable``,
``NormalMeshExecutable``).  PyTorch runs eagerly, so an executable holds
the function itself and runs it on flat, already tree-flattened arguments;
there is no compiled program.  ``launch_on_driver`` first puts host values
(numpy arrays, tensors on another device) on the mesh's device, as the
JAX version commits host arrays to their shardings.
"""
import itertools

import numpy as np
import torch

from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh

_exec_uuids = itertools.count(1)


class MeshExecutable:
    """Base class."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh):
        self.physical_mesh = physical_mesh
        self.exec_uuid = next(_exec_uuids)

    def launch_on_driver(self, *args):
        raise NotImplementedError

    def __call__(self, *args):
        return self.launch_on_driver(*args)

    def get_total_allocation_size(self) -> int:
        raise NotImplementedError


class NormalMeshExecutable(MeshExecutable):
    """A function over flat arguments, run on the mesh's one device.
    ``fun`` takes and returns flat lists."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh, fun):
        super().__init__(physical_mesh)
        if physical_mesh.num_devices != 1:
            raise NotImplementedError(
                f"NormalMeshExecutable runs on one device; got a mesh of "
                f"{physical_mesh.num_devices}")
        self.device = physical_mesh.flat_devices[0]
        self.fun = fun
        self._peak_bytes = -1

    def launch_on_driver(self, *flat_args):
        """Run on flat args; returns the flat outputs.  On a CUDA device it
        also records the allocator's peak over the launch."""
        args = self._prepare_args(flat_args)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        out = self.fun(*args)
        if cuda:
            self._peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return out

    def _prepare_args(self, flat_args):
        """Put numpy arrays and tensors on another device on the mesh's
        device; other leaves (Python numbers) pass as they are."""
        out = []
        for a in flat_args:
            if isinstance(a, np.ndarray):
                a = torch.tensor(a, device=self.device)
            elif isinstance(a, torch.Tensor) and a.device != self.device:
                a = a.to(self.device)
            out.append(a)
        return out

    def get_total_allocation_size(self) -> int:
        """Peak bytes the CUDA allocator held during the last launch (-1
        before a launch on a CUDA device)."""
        return self._peak_bytes
