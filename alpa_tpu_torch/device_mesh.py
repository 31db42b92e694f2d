"""Device meshes and the device cluster, single-host part.

Counterpart of ``alpa_tpu/device_mesh.py``: ``PhysicalDeviceMesh`` and
``LocalPhysicalDeviceMesh`` over this process's CUDA devices,
``DeviceCluster``, ``VirtualPhysicalMesh`` (the compile-time mesh that
pipeshard slices into stage meshes), the process-global cluster, mesh and
virtual mesh, and the global seed.  A mesh is a (host, device) grid of
``torch.device``s.  Without devices named, the CUDA devices are taken, and
the call raises when CUDA is missing; the CPU is used only when a caller
names it (``devices=["cpu"]``).

A device list may name one physical device more than once
(``devices=["cpu"] * 2``, or ``["cuda:0"] * 2`` on a one-card machine): the
counterpart of the JAX tests' virtual CPU devices, so that a pipeline of
one-device stage meshes runs where there are fewer cards than stages.
Logical meshes and multi-host clusters come with the auto-sharding slice.
"""
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpa_tpu_torch.platform import get_device


def _local_devices(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices named, each checked; else every local CUDA device."""
    if devices is None:
        get_device()   # raises when CUDA is missing
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [get_device(d) for d in devices]


class PhysicalDeviceMesh:
    """A 2-D (host x devices-per-host) grid of ``torch.device``s."""

    def __init__(self, devices):
        given = np.asarray(devices, dtype=object)
        grid = np.array([torch.device(d) for d in given.flat], dtype=object)
        grid = grid.reshape(given.shape if given.ndim == 2 else (1, -1))
        if given.ndim > 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (host, device) grid; "
                             f"got shape {grid.shape}")
        self.devices = grid

    @property
    def num_hosts(self) -> int:
        return self.devices.shape[0]

    @property
    def num_devices_per_host(self) -> int:
        return self.devices.shape[1]

    @property
    def num_devices(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_hosts, self.num_devices_per_host)

    @property
    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.flatten())

    def __repr__(self):
        return f"PhysicalDeviceMesh(shape={self.shape})"


class LocalPhysicalDeviceMesh(PhysicalDeviceMesh):
    """Mesh over this process's devices: the CUDA devices by default."""

    def __init__(self, devices: Optional[Sequence] = None):
        super().__init__(_local_devices(devices))


class DeviceCluster:
    """The visible device pool: one host, its CUDA devices by default."""

    def __init__(self, devices: Optional[Sequence] = None):
        self.devices = PhysicalDeviceMesh(_local_devices(devices)).devices
        self.num_hosts, self.num_devices_per_host = self.devices.shape

    @property
    def num_devices(self) -> int:
        return int(self.devices.size)

    def get_physical_mesh(self, num_devices_per_host: Optional[int] = None
                          ) -> PhysicalDeviceMesh:
        n = num_devices_per_host or self.num_devices_per_host
        return PhysicalDeviceMesh(self.devices[:, :n])

    def __repr__(self):
        return (f"DeviceCluster(num_hosts={self.num_hosts}, "
                f"num_devices_per_host={self.num_devices_per_host})")


class VirtualPhysicalMesh:
    """Compile-time mesh: a (host, device) grid that is sliced into stage
    meshes before any of them is used (``alpa_tpu/device_mesh.py:361``)."""

    def __init__(self, devices):
        self.devices = PhysicalDeviceMesh(devices).devices

    @property
    def num_hosts(self) -> int:
        return self.devices.shape[0]

    @property
    def num_devices_per_host(self) -> int:
        return self.devices.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_hosts, self.num_devices_per_host)

    @property
    def num_devices(self) -> int:
        return int(self.devices.size)

    def slice_1d(self, dim: int, indices: Sequence[Sequence[int]]
                 ) -> List["VirtualPhysicalMesh"]:
        """Submeshes along hosts (``dim=0``) or devices (``dim=1``)."""
        return [VirtualPhysicalMesh(self.devices[list(idx), :] if dim == 0
                                    else self.devices[:, list(idx)])
                for idx in indices]

    def slice_2d(self, host_indices, device_indices) -> "VirtualPhysicalMesh":
        return VirtualPhysicalMesh(
            self.devices[np.ix_(list(host_indices), list(device_indices))])

    def __repr__(self):
        return f"VirtualPhysicalMesh(shape={self.shape})"


global_cluster: Optional[DeviceCluster] = None
global_physical_mesh: Optional[PhysicalDeviceMesh] = None


def init_global_cluster(cluster: str = "local",
                        devices: Optional[Sequence] = None,
                        num_nodes: Optional[int] = None,
                        num_devices_per_node: Optional[int] = None):
    """Bring up the global cluster over this process's devices.  Only
    ``cluster="local"`` is ported; a multi-host cluster raises."""
    global global_cluster, global_physical_mesh
    if cluster != "local" or (num_nodes or 1) != 1:
        raise NotImplementedError(
            f"cluster={cluster!r} with num_nodes={num_nodes}: multi-host "
            "clusters are not ported yet (ROADMAP A.3, A.5)")
    global_cluster = DeviceCluster(devices)
    global_physical_mesh = global_cluster.get_physical_mesh(
        num_devices_per_host=num_devices_per_node)


def shutdown_global_cluster():
    global global_cluster, global_physical_mesh
    global_cluster = None
    global_physical_mesh = None


def get_global_physical_mesh(create_if_not_exist=False
                             ) -> Optional[PhysicalDeviceMesh]:
    global global_physical_mesh
    if global_physical_mesh is None and create_if_not_exist:
        global_physical_mesh = LocalPhysicalDeviceMesh()
    return global_physical_mesh


def get_global_virtual_physical_mesh(create_if_not_exist=False
                                     ) -> Optional[VirtualPhysicalMesh]:
    """The global cluster's devices as a virtual mesh; with
    ``create_if_not_exist`` and no cluster, every CUDA device (raising
    without CUDA)."""
    if global_cluster is not None:
        return VirtualPhysicalMesh(global_cluster.devices)
    if create_if_not_exist:
        return VirtualPhysicalMesh(DeviceCluster().devices)
    return None


_global_seed = 42


def set_seed(seed: int):
    global _global_seed
    _global_seed = seed


def get_seed() -> int:
    return _global_seed
