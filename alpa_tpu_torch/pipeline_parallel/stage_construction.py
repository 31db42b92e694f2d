"""Stage construction: group layers into stages and slice the mesh.

Counterpart of ``alpa_tpu/pipeline_parallel/stage_construction.py``:
``UniformStageOption``, ``ManualStageOption`` and ``AutoStageOption`` (the
OSDI'22 stage DP of ``stage_dp.py``), submesh enumeration and mesh
slicing.  Each stage gets a submesh of one or more devices, a logical
shape for its intra-op plan (None: the planner searches the shapes) and
its ``AutoShardingOption`` overrides
(``submesh_autosharding_option_dicts``).  The DP's decisions are written
through the compile cache (namespace ``stage_dp``) and replayed from it;
the DP runs inside a ``stage-dp`` span.
"""
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from alpa_tpu_torch.device_mesh import VirtualPhysicalMesh
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)


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
    ``stage_imbalance_tolerance`` are ported, and ``use_hlo_cost_model``
    (False: the ILP on every merged span, as on small search spaces; True:
    per-layer ILPs summed over larger ones).  ``submesh_logical_shape_space``
    is searched by the intra-op planner, and is kept for the API.
    ``profiling_database_filename``: a ``mesh_profiling`` database whose
    fit prices the cost tensor in seconds; ``profiling_mode="measured"``
    times up to ``measured_candidates_limit`` candidate stages on the
    devices (their spans merged on ``measured_compile_workers`` threads);
    ``cached_compute_cost``: an ``.npz`` file of the cost tensors, read
    where its key matches and written otherwise."""
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
                                  objective: str = "training",
                                  auto_sharding_option=None, root=None):
    """``(forward_stage_layer_ids, submeshes, logical_shapes, as_dicts,
    stage_dp_info)``: per stage its layers, its submesh, its logical mesh
    shape (None: searched by the intra-op planner) and its
    ``AutoShardingOption`` overrides.  The info is None unless the stage DP
    ran (``AutoStageOption``, with ``objective`` "training" or "inference";
    its communication term plans with ``auto_sharding_option``; measured
    profiling runs the layer graphs with ``root``'s constants).  The DP's
    decision is replayed from the compile cache where it holds one for
    the same layer graphs, mesh, backend, options and calibration."""
    stage_option = stage_option or UniformStageOption()
    if isinstance(stage_option, ManualStageOption):
        fwd_ids = stage_option.forward_stage_layer_ids
        logical_shapes = (stage_option.submesh_logical_shapes or
                          [None] * len(fwd_ids))
        as_dicts = (stage_option.submesh_autosharding_option_dicts or
                    [{}] * len(fwd_ids))
        return (fwd_ids, get_sliced_virtual_submeshes(
            virtual_mesh, stage_option.submesh_physical_shapes),
            [tuple(s) if s is not None else None for s in logical_shapes],
            [dict(d) for d in as_dicts], None)
    if isinstance(stage_option, AutoStageOption):
        return _auto_stages(num_forward_layers, virtual_mesh, stage_option,
                            layer_comps, num_micro_batches, schedule,
                            objective, auto_sharding_option, root)
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
    return (fwd_ids, get_sliced_virtual_submeshes(virtual_mesh, shapes),
            [None] * num_stages, [{} for _ in range(num_stages)], None)


def _stage_dp_key(cache, num_forward_layers, virtual_mesh, stage_option,
                  layer_comps, num_micro_batches, schedule, objective,
                  auto_sharding_option) -> str:
    """The compile-cache key of one stage-DP decision (``alpa_tpu/
    pipeline_parallel/stage_construction.py:203``): the layer graphs by
    content, the mesh's shape, device kind and backend, the options, and
    the fit the DP prices with (``stage_dp.stage_calibration``: the
    option's profiling database, else the global calibration), and the
    calibration token where replanning is on."""
    from alpa_tpu_torch.compile_cache import graph_fingerprint
    from alpa_tpu_torch.mesh_profiling import device_kind
    from alpa_tpu_torch.pipeline_parallel.stage_dp import stage_calibration
    from alpa_tpu_torch.shard_parallel.collectives import backend_of
    from alpa_tpu_torch.telemetry.calibration import calibration_cache_token
    devices = list(virtual_mesh.devices.flat)
    cal = stage_calibration(stage_option, virtual_mesh)
    tok = calibration_cache_token()
    return cache.make_key("stage_dp", [
        "cluster_layers_and_slice_mesh", repr(num_forward_layers),
        repr((virtual_mesh.num_hosts, virtual_mesh.num_devices_per_host)),
        device_kind(devices[0]), backend_of(devices), stage_option,
        repr(num_micro_batches),
        auto_sharding_option if auto_sharding_option is not None
        else "no-as-option", objective, schedule,
        repr(None if cal is None else (sorted(cal.dot_points),
                                       sorted(cal.collective_ab.items()))),
    ] + [graph_fingerprint(c.to_graph()) for c in layer_comps or ()]
        + ([tok] if tok else []))


def _auto_stages(num_forward_layers, virtual_mesh, stage_option,
                 layer_comps, num_micro_batches, schedule, objective,
                 auto_sharding_option, root):
    """The ``AutoStageOption`` branch: the stage DP, through the compile
    cache (only the submeshes' shapes are kept; they are sliced again
    from the live mesh on a hit)."""
    from alpa_tpu_torch.compile_cache import cache_enabled, get_compile_cache
    from alpa_tpu_torch.pipeline_parallel.stage_dp import auto_stage_dp
    cache = key = None
    if cache_enabled():
        cache = get_compile_cache()
        key = _stage_dp_key(cache, num_forward_layers, virtual_mesh,
                            stage_option, layer_comps, num_micro_batches,
                            schedule, objective, auto_sharding_option)
        entry = cache.get("stage_dp", key)
        if entry is not None:
            try:
                submeshes = get_sliced_virtual_submeshes(
                    virtual_mesh, entry["phys_shapes"])
                cache.record_saved_seconds("stage_dp",
                                           entry["info"]["seconds"])
                _ttrace.instant("stage-dp-cache-hit", "compile")
                info = dict(entry["info"], cache_hit=True)
                return (entry["fwd_ids"], submeshes,
                        [None] * len(entry["fwd_ids"]),
                        [{} for _ in entry["fwd_ids"]], info)
            except Exception:  # pylint: disable=broad-except
                logger.warning("cached stage-DP decision failed to replay; "
                               "re-solving", exc_info=True)
    tic = time.perf_counter()
    with _ttrace.span("stage-dp", "compile",
                      {"layers": num_forward_layers}
                      if _ttrace.enabled() else None):
        fwd_ids, submeshes, info = auto_stage_dp(
            num_forward_layers, virtual_mesh, stage_option, layer_comps,
            num_micro_batches, schedule=schedule, objective=objective,
            auto_sharding_option=auto_sharding_option, root=root)
    info["cache_hit"] = False
    if cache is not None:
        cache.record_solve_seconds("stage_dp", time.perf_counter() - tic)
        cache.put("stage_dp", key, {
            "fwd_ids": [list(f) for f in fwd_ids],
            "phys_shapes": [(sub.num_hosts, sub.num_devices_per_host)
                            for sub in submeshes],
            "info": info})
    return (fwd_ids, submeshes, [None] * len(fwd_ids),
            [{} for _ in fwd_ids], info)
