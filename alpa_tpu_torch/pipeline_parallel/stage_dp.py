"""Auto stage construction: the cost tensor and the OSDI'22 stage DP.

Counterpart of ``alpa_tpu/pipeline_parallel/stage_dp.py``.  The cost
tensor ``C[i, j, m]`` (layers i..j on submesh choice m) holds the JAX
package's static cost model (``mesh_profiling.estimate_stage_cost``): the
layers' forward flops (``node_flops``) x seconds per flop / the submesh's
devices, plus, on a submesh of more than one device, the intra-op ILP's
objective on a logical mesh of the submesh's shape (``(n, 1)`` within a
host).  With a calibration -- ``AutoStageOption.profiling_database_
filename``'s fit, else ``mesh_profiling.get_effective_calibration`` --
both terms are seconds; without one, ``DEFAULT_SEC_PER_FLOP`` and the
ILP's units x 1e-7.  On small search
spaces (``L * L * M <= 256``, or ``use_hlo_cost_model=False``) the ILP
runs on every merged span; on larger ones once per layer, a span's cost
the sum of its layers'.  The DP minimizing ``sum(stage costs) + (B - 1) *
max(stage cost)`` runs in the port's own native copy,
``csrc/stage_dp.cc``, built with ``g++`` at first use (``ops/_build.py``);
``_stage_dp_python`` is the same algorithm in Python, which the tests
hold the native solver to.

``profiling_mode="measured"`` replaces up to ``measured_candidates_limit``
entries by the candidates' times on the devices
(``mesh_profiling.refine_costs_measured``); ``cached_compute_cost`` names
an ``.npz`` file holding the tensors under ``compute_cost_cache_key``.
A forward-only function takes
the inference objective (JAX's ``objective="inference"``): B -> 4096, so
the slowest stage dominates, with one microbatch in flight per stage for
the memory check and no optimizer state in it.
"""
import ctypes
import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from alpa_tpu_torch.mesh_profiling import DEFAULT_SEC_PER_FLOP
from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.util import node_flops

logger = logging.getLogger(__name__)

# Must match csrc/stage_dp.cc kAbiVersion.
_ABI_VERSION = 2

# inflight_mode codes (csrc/stage_dp.cc inflight_count)
_INFLIGHT_MODES = {"1f1b": 0, "pipedream_flush": 0, "gpipe": 1,
                   "1f1b_overlap_friendly": 2, "inference": 3}

# seconds per flop of the cost model (uncalibrated, as in the JAX package)
SEC_PER_FLOP = DEFAULT_SEC_PER_FLOP

_lock = threading.Lock()
_lib = None


def load_native() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/stage_dp.cc``; raises when the
    build fails or the library's ABI version is not this module's."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build.load("stage_dp.cc")
            lib.stage_dp_abi_version.restype = ctypes.c_int32
            abi = int(lib.stage_dp_abi_version())
            if abi != _ABI_VERSION:
                raise RuntimeError(f"stage_dp.cc ABI {abi} != expected "
                                   f"{_ABI_VERSION}")
            f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.stage_dp_solve.restype = ctypes.c_int
            lib.stage_dp_solve.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, f64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                f64, f64, ctypes.c_double, i32, i32]
            _lib = lib
        return _lib


def stage_dp_solve(costs: np.ndarray,
                   submesh_sizes: Sequence[int],
                   num_devices: int,
                   num_micro_batches: int,
                   mem_param: Optional[np.ndarray] = None,
                   mem_act: Optional[np.ndarray] = None,
                   mem_budget: float = 0.0,
                   inflight_mode: str = "1f1b"
                   ) -> Optional[List[Tuple[int, int, int]]]:
    """Solve the stage-construction DP natively.

    ``costs``: (L, L, M); ``costs[i, j, m]`` is the cost of layers i..j
    (inclusive) on submesh m (inf: infeasible).  Memory feasibility is
    position-aware: the s-th stage from the pipeline's end holds
    ``inflight(s)`` microbatches of activations, by schedule
    (``inflight_mode``): "1f1b" min(s, B), "gpipe" B,
    "1f1b_overlap_friendly" min(2s - 1, B), "inference" 1; the check is
    ``mem_param + inflight(s) * mem_act <= mem_budget``.  Returns
    ``[(start_layer, end_layer_exclusive, submesh_index)]``, or None when
    no partition is feasible."""
    L, _, M = costs.shape
    costs = np.ascontiguousarray(costs, np.float64)
    sizes = np.ascontiguousarray(submesh_sizes, np.int64)
    mem_param = np.ascontiguousarray(
        np.zeros_like(costs) if mem_param is None else mem_param, np.float64)
    mem_act = np.ascontiguousarray(
        np.zeros_like(costs) if mem_act is None else mem_act, np.float64)
    starts = np.zeros(L, np.int32)
    meshes = np.zeros(L, np.int32)
    num = load_native().stage_dp_solve(
        L, M, num_devices, num_micro_batches,
        _INFLIGHT_MODES.get(inflight_mode, 0), costs, sizes, mem_param,
        mem_act, mem_budget, starts, meshes)
    if num < 0:
        return None
    return [(int(starts[t]), int(starts[t + 1]) if t + 1 < num else L,
             int(meshes[t])) for t in range(num)]


def _inflight_count(s, B, mode):
    b = max(B, 1)
    if mode == 1:  # gpipe
        return b
    if mode == 2:  # overlap-friendly 1f1b
        return min(2 * s - 1, b)
    if mode == 3:  # inference
        return 1
    return min(s, b)  # 1f1b


def _stage_dp_python(C, sizes, D, B, mem_param, mem_act, mem_budget, mode=0):
    """The algorithm of ``csrc/stage_dp.cc`` in Python (f[l][d][s] with the
    suffix-stage-count dimension for the position-aware memory check)."""
    L, _, M = C.shape
    INF = float("inf")
    finite = C[np.isfinite(C)]
    if finite.size == 0:
        return None
    best_obj, best_part = INF, None
    for t_max in np.unique(finite):
        if best_part is not None and (B - 1) * t_max >= best_obj:
            break
        f = np.full((L + 1, D + 1, L + 1), INF)
        cj = np.full((L + 1, D + 1, L + 1), -1, np.int32)
        cm = np.full((L + 1, D + 1, L + 1), -1, np.int32)
        f[L][0][0] = 0.0
        for l in range(L - 1, -1, -1):
            for d in range(1, D + 1):
                for s in range(1, L - l + 1):
                    inflight = _inflight_count(s, B, mode)
                    for j in range(l, L):
                        for m in range(M):
                            n = int(sizes[m])
                            if n > d:
                                continue
                            c = C[l, j, m]
                            if not np.isfinite(c) or c > t_max:
                                continue
                            if mem_budget > 0 and mem_param[l, j, m] + \
                                    inflight * mem_act[l, j, m] > mem_budget:
                                continue
                            rest = f[j + 1][d - n][s - 1]
                            if rest == INF:
                                continue
                            if c + rest < f[l][d][s]:
                                f[l][d][s] = c + rest
                                cj[l][d][s] = j
                                cm[l][d][s] = m
        s_best = int(np.argmin(f[0][D]))
        if f[0][D][s_best] == INF:
            continue
        obj = f[0][D][s_best] + (B - 1) * t_max
        if obj < best_obj:
            part, l, d, s, ok = [], 0, D, s_best, True
            while l < L:
                j, m = int(cj[l][d][s]), int(cm[l][d][s])
                if j < 0:
                    ok = False
                    break
                part.append((l, j + 1, m))
                d -= int(sizes[m])
                l = j + 1
                s -= 1
            if ok and d == 0 and s == 0:
                best_obj, best_part = obj, part
    return best_part


########################################
# the cost tensor and the DP -> stage assignment
########################################


def layer_flops(layer_comps) -> List[float]:
    """Forward flops of each layer computation (``node_flops``)."""
    return [sum(node_flops(n) for n in comp.nodes) for comp in layer_comps]


def compute_cost_cache_key(layer_comps, choices, profiling_mode,
                           with_memory=False, calibration=None,
                           db_file=None, measured_limit=None,
                           exact_ilp=None, sharding_option=None,
                           objective: str = "training") -> str:
    """The content key of the cost tensors (``alpa_tpu/pipeline_parallel/
    stage_dp.py:226``): the layers' graphs (``compile_cache.
    graph_fingerprint``), the submesh choices, the profiling mode (and in
    measured mode the limit), whether memory tensors were computed, the
    database file and the calibration's fit, the span strategy, the
    sharding option, the objective, and the calibration token under
    ``replan_mode != "off"``."""
    import hashlib
    from alpa_tpu_torch.compile_cache import graph_fingerprint
    from alpa_tpu_torch.telemetry.calibration import calibration_cache_token
    h = hashlib.sha256()
    for c in layer_comps:
        h.update(graph_fingerprint(c.to_graph()).encode())
    h.update(repr(list(choices)).encode())
    h.update(profiling_mode.encode())
    h.update(b"mem" if with_memory else b"nomem")
    h.update(repr(db_file).encode())
    if profiling_mode == "measured":
        h.update(repr(measured_limit).encode())
    h.update(repr(exact_ilp).encode())
    h.update(repr(sharding_option).encode())
    h.update(objective.encode())
    if calibration is not None:
        h.update(repr(sorted(calibration.dot_points)).encode())
        h.update(repr(sorted(calibration.collective_ab.items())).encode())
    tok = calibration_cache_token()
    if tok:
        h.update(tok.encode())
    return h.hexdigest()[:16]


def load_compute_cost_cache(path, key, shape):
    """``(costs, mem_param, mem_act)`` from ``path`` where its key and
    shapes match, else None."""
    import os
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key or z["costs"].shape != shape:
                logger.info("compute-cost cache %s stale (key/shape "
                            "mismatch); recomputing", path)
                return None
            return z["costs"], z["mem_param"], z["mem_act"]
    except Exception as e:  # pylint: disable=broad-except
        logger.warning("compute-cost cache %s unreadable: %s", path, e)
        return None


def save_compute_cost_cache(path, key, costs, mem_param, mem_act):
    try:
        np.savez(path, key=np.str_(key), costs=costs, mem_param=mem_param,
                 mem_act=mem_act)
    except OSError as e:
        logger.warning("saving compute-cost cache %s failed: %s", path, e)


def cost_logical_mesh(shape, calibration=None):
    """The cost model's logical mesh of a submesh of ``shape`` (hosts,
    devices per host), as the JAX package builds it: ``(n, 1)`` within a
    host, beta 0.1 on an axis across hosts and 0.01 on the others, with
    the ``calibration`` given."""
    from alpa_tpu_torch.device_mesh import LogicalDeviceMesh
    h, d = shape
    logical = (h * d, 1) if h == 1 else (h, d)
    return LogicalDeviceMesh(None, np.arange(h * d).reshape(logical),
                             mesh_beta=(0.1 if h > 1 else 0.01, 0.01),
                             calibration=calibration)


def stage_calibration(stage_option, virtual_mesh):
    """The calibration of the cost tensor: the fit of the option's
    ``profiling_database_filename`` (its entries of the virtual mesh's
    backend), else ``get_effective_calibration`` for that backend; None
    leaves the model uncalibrated."""
    from alpa_tpu_torch.mesh_profiling import (calibration_from_file,
                                               get_effective_calibration)
    from alpa_tpu_torch.shard_parallel.collectives import backend_of
    devices = list(getattr(virtual_mesh, "devices", np.empty(0)).flat)
    backend = backend_of(devices) if devices else None
    db_file = stage_option.profiling_database_filename
    cal = calibration_from_file(db_file, backend) if db_file else None
    if cal is None:
        platform = devices[0].type if devices else None
        cal = get_effective_calibration(platform, backend)
        if cal is not None and cal.backend not in (None, backend):
            cal = None
    return cal


def stage_cost_tensor(layer_comps, choices, stage_option, as_option,
                      info: Optional[dict] = None,
                      calibration=None) -> np.ndarray:
    """``C[i, j, m]``: layers i..j on submesh ``choices[m]``
    (``estimate_stage_cost``, exactly per merged span on small search
    spaces or with ``use_hlo_cost_model=False``, else as per-layer prefix
    sums)."""
    from alpa_tpu_torch.mesh_profiling import estimate_stage_cost
    L, M = len(layer_comps), len(choices)
    exact = (not stage_option.use_hlo_cost_model) or L * L * M <= 256
    costs = np.full((L, L, M), np.inf)
    for m, shape in enumerate(choices):
        logical = cost_logical_mesh(shape, calibration)
        if exact:
            for i in range(L):
                for j in range(i, L):
                    costs[i, j, m] = estimate_stage_cost(
                        layer_comps[i:j + 1], logical, as_option, info=info)
        else:
            per_layer = [estimate_stage_cost([c], logical, as_option,
                                             info=info)
                         for c in layer_comps]
            pref = np.concatenate([[0.0], np.cumsum(per_layer)])
            for i in range(L):
                for j in range(i, L):
                    costs[i, j, m] = pref[j + 1] - pref[i]
    return costs


def auto_stage_dp(num_layers, virtual_mesh, stage_option, layer_comps,
                  num_micro_batches, schedule: str = "1f1b",
                  objective: str = "training", auto_sharding_option=None,
                  root=None):
    """Fill the cost tensor and run the DP: the auto branch of
    ``cluster_layers_and_slice_mesh``.  Returns ``(forward stage layer
    ids, submeshes, info)``; ``info`` has the partition, the submesh
    choices, the per-layer flops, the cost tensor, the ILP solves behind
    it and their seconds, whether a calibration priced it, the entries
    measured,
    whether the tensors came from ``cached_compute_cost``, the solver and
    its seconds.  ``objective="inference"`` solves with B = 4096 and the
    "inference" inflight mode (JAX's ``inference_dp`` objective).
    ``root``: the traced module the layer graphs read their constants
    from, which measured profiling runs them with."""
    from alpa_tpu_torch.pipeline_parallel.stage_construction import (
        get_sliced_virtual_submeshes, get_submesh_choices)
    from alpa_tpu_torch.mesh_profiling import estimate_stage_memory_split
    from alpa_tpu_torch.shard_parallel.auto_sharding import \
        AutoShardingOption

    tic = time.perf_counter()
    choices = get_submesh_choices(virtual_mesh.num_hosts,
                                  virtual_mesh.num_devices_per_host,
                                  stage_option.submesh_physical_shape_space)
    sizes = [h * d for h, d in choices]
    L, M = num_layers, len(choices)
    flops = layer_flops(layer_comps)
    mem_budget = float(stage_option.memory_budget_per_device or 0.0)
    as_option = auto_sharding_option or AutoShardingOption()
    cost_info = {"ilp_solves": 0, "ilp_seconds": 0.0}
    cal = stage_calibration(stage_option, virtual_mesh)
    mode = stage_option.profiling_mode
    if mode not in ("cost_model", "measured"):
        raise ValueError(f"profiling_mode must be 'cost_model' or "
                         f"'measured', got {mode!r}")
    exact = (not stage_option.use_hlo_cost_model) or L * L * M <= 256
    cache_file = stage_option.cached_compute_cost
    cache_key = loaded = None
    if cache_file:
        cache_key = compute_cost_cache_key(
            layer_comps, choices, mode, with_memory=mem_budget > 0,
            calibration=cal, db_file=stage_option.profiling_database_filename,
            measured_limit=stage_option.measured_candidates_limit,
            exact_ilp=exact, sharding_option=as_option, objective=objective)
        loaded = load_compute_cost_cache(cache_file, cache_key, (L, L, M))
    refined = 0
    if loaded is not None:
        costs, mem_param, mem_act = loaded
    else:
        costs = stage_cost_tensor(layer_comps, choices, stage_option,
                                  as_option, cost_info, cal)
        mem_param = np.zeros((L, L, M))
        mem_act = np.zeros((L, L, M))
        if mem_budget > 0:
            for m, n_dev in enumerate(sizes):
                for i in range(L):
                    for j in range(i, L):
                        mem_param[i, j, m], mem_act[i, j, m] = \
                            estimate_stage_memory_split(
                                layer_comps[i:j + 1], n_dev, objective)
        if mode == "measured":
            from alpa_tpu_torch.mesh_profiling import refine_costs_measured
            if root is None:
                raise ValueError("profiling_mode='measured' runs the "
                                 "candidate stages: pass the traced root")
            refined = refine_costs_measured(
                costs, layer_comps, sizes, as_option, root,
                list(virtual_mesh.devices.flat),
                limit=stage_option.measured_candidates_limit,
                compile_workers=stage_option.measured_compile_workers)
        if cache_file:
            save_compute_cost_cache(cache_file, cache_key, costs, mem_param,
                                    mem_act)

    # cap the DP's stage costs at tolerance x the best one-stage cost
    tol = float(stage_option.stage_imbalance_tolerance)
    if np.isfinite(tol):
        whole = [costs[0, L - 1, m] for m in range(M)
                 if np.isfinite(costs[0, L - 1, m])]
        cap = tol * float(np.nanmin(whole or [np.inf]))
        costs = np.where(costs <= cap, costs, np.inf)

    # the inference objective: the slowest stage bounds a forward-only
    # pipeline's throughput, and each stage holds one microbatch
    if objective == "inference":
        b_eff, inflight_mode = 4096, "inference"
    else:
        b_eff, inflight_mode = num_micro_batches, schedule
    load_native()   # built at first use: not part of the solve
    solve_tic = time.perf_counter()
    part = stage_dp_solve(costs, sizes, virtual_mesh.num_devices, b_eff,
                          mem_param, mem_act, mem_budget=mem_budget,
                          inflight_mode=inflight_mode)
    solve_seconds = time.perf_counter() - solve_tic
    if part is None:
        raise RuntimeError(
            "auto stage construction found no feasible partition")
    fwd_ids = [list(range(a, b)) for a, b, _ in part]
    submeshes = get_sliced_virtual_submeshes(
        virtual_mesh, [list(choices[m]) for _, _, m in part])
    info = {"partition": [(a, b, choices[m]) for a, b, m in part],
            "choices": choices, "layer_flops": flops, "costs": costs,
            "objective": objective, "ilp_solves": cost_info["ilp_solves"],
            "ilp_seconds": cost_info["ilp_seconds"],
            "calibrated": cal is not None, "measured": refined,
            "cost_cache_hit": loaded is not None,
            "solver": "native stage_dp.cc", "solve_seconds": solve_seconds,
            "seconds": time.perf_counter() - tic}
    return fwd_ids, submeshes, info
