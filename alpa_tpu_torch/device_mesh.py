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

``LogicalDeviceMesh`` is the auto-sharding planner's view of a mesh: a
shape over the devices' ids and the alpha-beta collective costs per mesh
axis, in the JAX package's abstract units and with its default constants;
it also knows the device at each coordinate and the groups of devices
along each axis, over which the SPMD executor runs its collectives.
``DistributedArray`` is a value sharded over a logical mesh: one local
tensor per mesh position under a ``Spec`` (Alpa's ``DistributedArray``;
JAX's ``jax.Array`` holds them as its ``addressable_shards``).  Multi-host
clusters are not ported.
"""
import math
from typing import Any, List, Optional, Sequence, Tuple

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


class LogicalDeviceMesh:
    """A multi-dimensional logical view of a mesh's devices with an
    alpha-beta cost per collective and mesh axis
    (``alpa_tpu/device_mesh.py:71``): ``alpha`` is a latency per
    collective, ``beta`` the inverse bandwidth per byte along the axis,
    both in abstract units (JAX's defaults: alpha 1 on every axis, beta
    0.1 on axis 0 and 0.01 on the others).  A tie term per collective kind
    keeps the JAX model's all-gather > all-reduce > reduce-scatter >
    all-to-all order.  With a ``calibration`` that has collective fits
    (``mesh_profiling.CalibratedCostModel``) every cost is in seconds:
    its (alpha, beta) per kind, beta scaled on a slower axis by the
    abstract betas' ratio, no tie term; a kind it did not measure takes
    the most expensive measured fit."""

    _TIES = {"all_gather": 0.1, "all_reduce": 0.01, "reduce_scatter": 0.001,
             "all_to_all": 0.001}

    def __init__(self, physical_mesh, id_mesh,
                 mesh_alpha: Optional[Sequence[float]] = None,
                 mesh_beta: Optional[Sequence[float]] = None,
                 calibration: Optional[Any] = None):
        self.physical_mesh = physical_mesh
        self.id_mesh = np.asarray(id_mesh)
        ndim = self.id_mesh.ndim
        self.mesh_alpha = tuple(mesh_alpha) if mesh_alpha else (1.0,) * ndim
        self.mesh_beta = tuple(mesh_beta) if mesh_beta else tuple(
            [0.1] + [0.01] * (ndim - 1))[:ndim]
        self.calibration = calibration

    @property
    def calibrated(self) -> bool:
        """Whether collective costs come back in seconds (a calibration
        with collective fits; a dot-only one does not count)."""
        return (self.calibration is not None and
                bool(self.calibration.collective_ab))

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.id_mesh.shape

    @property
    def num_devices(self) -> int:
        return int(self.id_mesh.size)

    def _ab(self, kind: str, mesh_dim: int):
        if self.calibrated:
            ab = self.calibration.alpha_beta(kind)
            if ab is None:
                ab = max(self.calibration.collective_ab.values(),
                         key=lambda p: p[1])
            ratio = self.mesh_beta[mesh_dim] / min(self.mesh_beta)
            return ab[0], ab[1] * ratio, 0.0
        return (self.mesh_alpha[mesh_dim], self.mesh_beta[mesh_dim],
                self._TIES[kind])

    def all_gather_cost(self, num_bytes: float, mesh_dim: int) -> float:
        n = self.shape[mesh_dim]
        if n == 1:
            return 0.0
        a, b, tie = self._ab("all_gather", mesh_dim)
        return a + b * (n - 1) / n * num_bytes + tie

    def all_reduce_cost(self, num_bytes: float, mesh_dim: int) -> float:
        n = self.shape[mesh_dim]
        if n == 1:
            return 0.0
        a, b, tie = self._ab("all_reduce", mesh_dim)
        return a + b * 2 * (n - 1) / n * num_bytes + tie

    def reduce_scatter_cost(self, num_bytes: float, mesh_dim: int) -> float:
        n = self.shape[mesh_dim]
        if n == 1:
            return 0.0
        a, b, tie = self._ab("reduce_scatter", mesh_dim)
        return a + b * (n - 1) / n * num_bytes + tie

    def reduce_scatter_cost_quantized(self, num_bytes: float,
                                      mesh_dim: int,
                                      itemsize: int = 4) -> float:
        """The reduce-scatter of a gradient through the blockwise codec
        (``pipeline_parallel.reshard_codec``): one byte per element and
        one fp32 scale per 256 elements on the wire, and the encode and
        decode charged as two more latencies."""
        n = self.shape[mesh_dim]
        if n == 1:
            return 0.0
        a, b, tie = self._ab("reduce_scatter", mesh_dim)
        elems = max(0.0, float(num_bytes)) / max(1, int(itemsize))
        qb = elems + 4.0 * (math.ceil(elems / 256) if elems else 0)
        return 3 * a + b * (n - 1) / n * qb + tie

    def all_to_all_cost(self, num_bytes: float, mesh_dim: int) -> float:
        n = self.shape[mesh_dim]
        if n == 1:
            return 0.0
        a, b, tie = self._ab("all_to_all", mesh_dim)
        return a + b * (n - 1) / (n * n) * num_bytes + tie

    def flat_devices(self) -> List[torch.device]:
        """The device at each position of the logical mesh, in row-major
        order (a device named several times appears several times)."""
        devices = list(self.physical_mesh.devices.flatten())
        return [devices[i] for i in self.id_mesh.reshape(-1)]

    def coords(self, position: int) -> Tuple[int, ...]:
        """The coordinates of a row-major mesh position."""
        return tuple(int(c) for c in np.unravel_index(position, self.shape))

    def axis_groups(self, axis: int) -> List[List[int]]:
        """The positions along ``axis``, one group per setting of the other
        coordinates, each in the order of its ``axis`` coordinate."""
        pos = np.moveaxis(np.arange(self.num_devices).reshape(self.shape),
                          axis, -1)
        return [list(map(int, g)) for g in pos.reshape(-1, self.shape[axis])]

    def __repr__(self):
        return f"LogicalDeviceMesh(shape={self.shape})"


class DistributedArray:
    """A tensor of ``shape`` sharded over ``logical_mesh`` under ``spec``:
    ``shards[p]`` is the block (``sharding_spec.local_slices``) on the
    device at row-major position ``p``.  Positions that hold the same
    block (a replicated dim) hold equal values.  ``gather()`` assembles the
    full tensor."""

    def __init__(self, shards: Sequence[torch.Tensor], spec, logical_mesh,
                 shape: Sequence[int], dtype: torch.dtype):
        self.shards = list(shards)
        self.spec = tuple(tuple(a) for a in spec)
        self.logical_mesh = logical_mesh
        self.shape = tuple(int(x) for x in shape)
        self.dtype = dtype

    @classmethod
    def from_full(cls, tensor: torch.Tensor, spec, logical_mesh
                  ) -> "DistributedArray":
        """Each device's block of ``tensor``, copied to that device."""
        from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices
        devices = logical_mesh.flat_devices()
        shards = []
        for p, device in enumerate(devices):
            block = tensor
            for d, (off, size) in enumerate(local_slices(
                    tensor.shape, spec, logical_mesh.coords(p),
                    logical_mesh.shape)):
                if size != tensor.shape[d]:
                    block = block.narrow(d, off, size)
            shards.append(block.to(device, copy=True).contiguous())
        return cls(shards, spec, logical_mesh, tensor.shape, tensor.dtype)

    def gather(self, device=None) -> torch.Tensor:
        """The full tensor, on ``device`` (default: the first shard's), in
        memory of its own."""
        from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices
        device = torch.device(device) if device else self.shards[0].device
        if not any(self.spec):
            return self.shards[0].to(device, copy=True)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for p, shard in enumerate(self.shards):
            slices = local_slices(self.shape, self.spec,
                                  self.logical_mesh.coords(p),
                                  self.logical_mesh.shape)
            if slices in done:
                continue
            done.add(slices)
            out[tuple(slice(o, o + n) for o, n in slices)] = shard.to(device)
        return out

    def __repr__(self):
        return (f"DistributedArray(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.logical_mesh.shape})")


def _logical_mesh(mesh, mesh_shape, mesh_alpha, mesh_beta,
                  host_crossing_beta) -> LogicalDeviceMesh:
    mesh_shape = tuple(int(x) for x in (mesh_shape or mesh.shape))
    if int(np.prod(mesh_shape)) != mesh.num_devices:
        raise ValueError(f"logical shape {mesh_shape} != "
                         f"{mesh.num_devices} devices")
    id_mesh = np.arange(mesh.num_devices).reshape(mesh_shape)
    if mesh_beta is None:
        mesh_beta = host_crossing_beta(mesh_shape)
    return LogicalDeviceMesh(mesh, id_mesh, mesh_alpha, mesh_beta,
                             calibration=_calibration_for(mesh))


def _calibration_for(mesh) -> Optional[Any]:
    """The process-wide calibration (``mesh_profiling.
    get_global_calibration``) where it was measured over the backend of
    ``mesh``'s collectives (or names none), else None: a table of copies
    on one card never prices NCCL between cards, nor the reverse."""
    from alpa_tpu_torch.mesh_profiling import get_global_calibration
    from alpa_tpu_torch.shard_parallel.collectives import backend_of
    cal = get_global_calibration()
    if cal is None or cal.backend is None:
        return cal
    return cal if cal.backend == backend_of(list(mesh.devices.flat)) \
        else None


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

    def get_logical_mesh(self, mesh_shape: Optional[Sequence[int]] = None,
                         mesh_alpha=None, mesh_beta=None
                         ) -> LogicalDeviceMesh:
        """A logical mesh of ``mesh_shape`` (by default the physical shape)
        over this mesh's devices (``alpa_tpu/device_mesh.py:269``): a
        logical axis whose steps cross a host boundary in the host-major
        device order pays beta 0.1, the others 0.01."""

        def betas(shape):
            out = []
            for i, s in enumerate(shape):
                stride = int(np.prod(shape[i + 1:]))
                crosses = (self.num_hosts > 1 and s > 1 and
                           stride * s > self.num_devices_per_host)
                out.append(0.1 if crosses else 0.01)
            return tuple(out)

        return _logical_mesh(self, mesh_shape, mesh_alpha, mesh_beta, betas)

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
    meshes before any of them is used (``alpa_tpu/device_mesh.py:361``).
    ``device_ids``: each position's index in the mesh it was sliced from
    (its own row-major order, unsliced), which names the position where
    one device is named several times."""

    def __init__(self, devices, device_ids=None):
        self.devices = PhysicalDeviceMesh(devices).devices
        self.device_ids = (np.arange(self.devices.size).reshape(
            self.devices.shape) if device_ids is None else
            np.asarray(device_ids).reshape(self.devices.shape))

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
        return [VirtualPhysicalMesh(self.devices[list(idx), :], self.device_ids[
            list(idx), :]) if dim == 0 else VirtualPhysicalMesh(
                self.devices[:, list(idx)], self.device_ids[:, list(idx)])
                for idx in indices]

    def slice_2d(self, host_indices, device_indices) -> "VirtualPhysicalMesh":
        index = np.ix_(list(host_indices), list(device_indices))
        return VirtualPhysicalMesh(self.devices[index],
                                   self.device_ids[index])

    def get_logical_mesh(self, mesh_shape: Optional[Sequence[int]] = None,
                         mesh_alpha=None, mesh_beta=None
                         ) -> LogicalDeviceMesh:
        """A logical mesh over these devices (``alpa_tpu/device_mesh.py:409``):
        with more than one host, logical axis 0 pays beta 0.1, the others
        0.01."""
        return _logical_mesh(
            PhysicalDeviceMesh(self.devices), mesh_shape, mesh_alpha,
            mesh_beta, lambda shape: tuple(
                0.1 if (self.num_hosts > 1 and i == 0) else 0.01
                for i in range(len(shape))))

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
            "clusters are not ported yet (ROADMAP A.1)")
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
