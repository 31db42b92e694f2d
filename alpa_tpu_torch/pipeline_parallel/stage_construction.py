"""Stage construction: group layers into stages and slice the mesh.

Counterpart of ``alpa_tpu/pipeline_parallel/stage_construction.py``:
``UniformStageOption``, ``ManualStageOption`` and ``AutoStageOption`` (the
OSDI'22 stage DP of ``stage_dp.py``, whose optimum must put every stage on
one device until the intra-op ILP is ported, ROADMAP A.3), submesh
enumeration and mesh slicing.  The compile cache of the DP's decisions is
not ported (ROADMAP A.6).
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from alpa_tpu_torch.device_mesh import VirtualPhysicalMesh


@dataclasses.dataclass
class StageOption:
    """Base."""


@dataclasses.dataclass
class UniformStageOption(StageOption):
    """Evenly assign layers to stages, one stage per equal submesh."""
    num_stages: Optional[int] = None


@dataclasses.dataclass
class ManualStageOption(StageOption):
    """Explicit layer -> stage and stage -> submesh assignment."""
    forward_stage_layer_ids: List[List[int]] = None
    submesh_physical_shapes: List[Sequence[int]] = None
    submesh_logical_shapes: List[Sequence[int]] = None
    submesh_autosharding_option_dicts: List[Dict] = None


@dataclasses.dataclass
class AutoStageOption(StageOption):
    """Search the layer -> stage clustering and the submesh shapes with the
    stage DP.  ``memory_budget_per_device`` (bytes, None: unconstrained) and
    ``stage_imbalance_tolerance`` are ported.  ``submesh_logical_shape_space``
    is searched by the intra-op planner, and is kept for the API.  The
    fields of the communication term and of measured profiling
    (``use_hlo_cost_model``, ``profiling_mode``,
    ``profiling_database_filename``, ``measured_candidates_limit``,
    ``measured_compile_workers``) and ``cached_compute_cost`` raise when set
    to anything but their defaults (ROADMAP A.3, A.6)."""
    submesh_physical_shape_space: str = "power_of_two"
    submesh_logical_shape_space: str = "single_node_model_parallel"
    stage_imbalance_tolerance: float = np.inf
    use_hlo_cost_model: bool = True
    profiling_database_filename: Optional[str] = None
    profiling_mode: str = "cost_model"
    measured_candidates_limit: int = 16
    measured_compile_workers: int = 4
    cached_compute_cost: Optional[str] = None
    memory_budget_per_device: Optional[float] = None


def get_submesh_choices(num_hosts: int, num_devices_per_host: int,
                        space: str = "power_of_two"
                        ) -> List[Tuple[int, int]]:
    """The candidate submesh shapes: (1, 2^k) within a host, then (k, every
    device of a host) across hosts, k by ``space`` ("all",
    "power_of_two", "small_power_of_two")."""
    choices = []
    i = 1
    while i <= num_devices_per_host:
        choices.append((1, i))
        i *= 2
    if choices[-1][1] != num_devices_per_host:
        raise ValueError("num_devices_per_host must be a power of two")
    if space == "all":
        for k in range(2, num_hosts + 1):
            choices.append((k, num_devices_per_host))
    elif space == "power_of_two":
        k = 2
        while k <= num_hosts:
            choices.append((k, num_devices_per_host))
            k *= 2
    elif space == "small_power_of_two":
        k = 2
        while k <= min(num_hosts, 4):
            choices.append((k, num_devices_per_host))
            k *= 2
    else:
        raise ValueError(f"invalid submesh space: {space!r}")
    return choices


def get_sliced_virtual_submeshes(virtual_mesh: VirtualPhysicalMesh,
                                 submesh_shapes: List[Sequence[int]]
                                 ) -> List[VirtualPhysicalMesh]:
    """Carve the cluster into the requested submeshes, the JAX packing:
    whole-host slices first, sub-host slices left to right, returned in
    the order asked for."""
    num_hosts = virtual_mesh.num_hosts
    ndph = virtual_mesh.num_devices_per_host
    total = sum(int(np.prod(s)) for s in submesh_shapes)
    if total > virtual_mesh.num_devices:
        raise ValueError(f"requested {total} devices > "
                         f"{virtual_mesh.num_devices}")
    order = sorted(range(len(submesh_shapes)),
                   key=lambda i: (-int(submesh_shapes[i][0]),
                                  -int(np.prod(submesh_shapes[i]))))
    submeshes = [None] * len(submesh_shapes)
    host_ptr = dev_ptr = 0
    for i in order:
        h, d = int(submesh_shapes[i][0]), int(submesh_shapes[i][1])
        if h > 1 or d == ndph:
            if dev_ptr != 0:
                host_ptr, dev_ptr = host_ptr + 1, 0
            if host_ptr + h > num_hosts:
                raise ValueError(f"not enough hosts for {submesh_shapes}")
            submeshes[i] = virtual_mesh.slice_2d(
                range(host_ptr, host_ptr + h), range(d))
            host_ptr += h
        else:
            if dev_ptr + d > ndph:
                host_ptr, dev_ptr = host_ptr + 1, 0
            if host_ptr >= num_hosts:
                raise ValueError(f"not enough devices for {submesh_shapes}")
            submeshes[i] = virtual_mesh.slice_2d(
                [host_ptr], range(dev_ptr, dev_ptr + d))
            dev_ptr += d
    return submeshes


def uniform_layer_to_stage(num_layers: int, num_stages: int
                           ) -> List[List[int]]:
    """Evenly group forward layers into stages."""
    base, rem = divmod(num_layers, num_stages)
    out, start = [], 0
    for i in range(num_stages):
        size = base + (1 if i < rem else 0)
        out.append(list(range(start, start + size)))
        start += size
    return out


def cluster_layers_and_slice_mesh(num_forward_layers: int,
                                  virtual_mesh: VirtualPhysicalMesh,
                                  stage_option: Optional[StageOption],
                                  layer_comps=None,
                                  num_micro_batches: int = 1,
                                  schedule: str = "1f1b",
                                  objective: str = "training"):
    """``(forward_stage_layer_ids, submeshes, stage_dp_info)``; the info is
    None unless the stage DP ran (``AutoStageOption``, with ``objective``
    "training" or "inference")."""
    stage_option = stage_option or UniformStageOption()
    if isinstance(stage_option, ManualStageOption):
        return (stage_option.forward_stage_layer_ids,
                get_sliced_virtual_submeshes(
                    virtual_mesh, stage_option.submesh_physical_shapes), None)
    if isinstance(stage_option, AutoStageOption):
        from alpa_tpu_torch.pipeline_parallel.stage_dp import auto_stage_dp
        return auto_stage_dp(num_forward_layers, virtual_mesh, stage_option,
                             layer_comps, num_micro_batches,
                             schedule=schedule, objective=objective)
    num_stages = stage_option.num_stages
    if num_stages is None:
        num_stages = (virtual_mesh.num_hosts if virtual_mesh.num_hosts > 1
                      else min(num_forward_layers,
                               virtual_mesh.num_devices_per_host))
    num_stages = min(num_stages, num_forward_layers)
    fwd_ids = uniform_layer_to_stage(num_forward_layers, num_stages)
    if (virtual_mesh.num_hosts >= num_stages and
            virtual_mesh.num_hosts % num_stages == 0):
        hosts_per = virtual_mesh.num_hosts // num_stages
        shapes = [(hosts_per, virtual_mesh.num_devices_per_host)] * num_stages
    else:
        if virtual_mesh.num_devices % num_stages:
            raise ValueError(
                f"cannot split {virtual_mesh.num_devices} devices into "
                f"{num_stages} equal pipeline stages; pass a stage_option "
                "with num_stages dividing the device count")
        shapes = [(1, virtual_mesh.num_devices // num_stages)] * num_stages
    return fwd_ids, get_sliced_virtual_submeshes(virtual_mesh, shapes), None
