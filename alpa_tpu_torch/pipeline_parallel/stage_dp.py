"""Auto stage construction: the cost tensor and the OSDI'22 stage DP.

Counterpart of ``alpa_tpu/pipeline_parallel/stage_dp.py``.  The cost
tensor ``C[i, j, m]`` (layers i..j on submesh choice m) holds the compute
term of the JAX package's static cost model (``estimate_stage_cost``):
the layers' forward flops (``node_flops``) x seconds per flop / the
submesh's devices, at the card's bf16 peak.  The DP minimizing
``sum(stage costs) + (B - 1) * max(stage cost)`` runs in the port's own
native copy, ``csrc/stage_dp.cc``, built with ``g++`` at first use
(``ops/_build.py``); ``_stage_dp_python`` is the same algorithm in Python,
which the tests hold the native solver to.

The communication term of a stage of more than one device is the intra-op
ILP's objective, which is not ported (ROADMAP A.3).  Without it the port's
costs equal JAX's on one-device submeshes and are no higher on the others;
the DP is monotone in the costs, so a partition that is optimal here and
uses only one-device submeshes is optimal for JAX too.  A partition with a
stage of more than one device raises ``NotImplementedError`` instead of
returning a plan JAX would not choose.  The options of the communication
term, of measured profiling and of the cost-tensor disk cache raise as well
(ROADMAP A.3, A.6).  A forward-only function takes the inference
objective (JAX's ``objective="inference"``): B -> 4096, so the slowest
stage dominates, with one microbatch in flight per stage for the memory
check and no optimizer state in it.
"""
import ctypes
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.telemetry.perf import GPU_SPECS
from alpa_tpu_torch.util import node_flops

# Must match csrc/stage_dp.cc kAbiVersion.
_ABI_VERSION = 2

# inflight_mode codes (csrc/stage_dp.cc inflight_count)
_INFLIGHT_MODES = {"1f1b": 0, "pipedream_flush": 0, "gpipe": 1,
                   "1f1b_overlap_friendly": 2, "inference": 3}

# seconds per flop of the cost model: the H100 SXM's dense bf16 peak (the
# divisor of the port's MFU)
SEC_PER_FLOP = 1.0 / (GPU_SPECS["h100-sxm"]["peak_bf16_tflops"] * 1e12)

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


def _check_unported_fields(stage_option):
    """Raise on an ``AutoStageOption`` field of the communication term, of
    measured profiling or of the cost cache set to other than its
    default."""
    defaults = {f.name: f.default for f in dataclasses.fields(stage_option)}
    unported = {
        "use_hlo_cost_model": "it chooses how the communication term is "
                              "computed, which needs the intra-op ILP "
                              "(ROADMAP A.3)",
        "profiling_database_filename": "a profiling database calibrates the "
                                       "communication term, which needs the "
                                       "intra-op ILP (ROADMAP A.3)",
        "profiling_mode": "measured profiling compiles and times candidate "
                          "stages, which needs intra-op sharding (ROADMAP "
                          "A.3) and the compile cache (ROADMAP A.6)",
        "measured_candidates_limit": "it bounds measured profiling, which "
                                     "needs intra-op sharding (ROADMAP A.3)",
        "measured_compile_workers": "it bounds measured profiling, which "
                                    "needs intra-op sharding (ROADMAP A.3)",
        "cached_compute_cost": "the cost-tensor disk cache is not ported "
                               "yet (ROADMAP A.6)",
    }
    for name, why in unported.items():
        value = getattr(stage_option, name)
        if value != defaults[name]:
            raise NotImplementedError(
                f"AutoStageOption({name}={value!r}): {why}")


def auto_stage_dp(num_layers, virtual_mesh, stage_option, layer_comps,
                  num_micro_batches, schedule: str = "1f1b",
                  objective: str = "training"):
    """Fill the cost tensor's compute term and run the DP: the auto branch
    of ``cluster_layers_and_slice_mesh``.  Returns ``(forward stage layer
    ids, submeshes, info)``; ``info`` has the partition, the submesh
    choices, the per-layer flops, the solver and its seconds.
    ``objective="inference"`` solves with B = 4096 and the "inference"
    inflight mode (JAX's ``inference_dp`` objective)."""
    from alpa_tpu_torch.pipeline_parallel.stage_construction import (
        get_sliced_virtual_submeshes, get_submesh_choices)
    from alpa_tpu_torch.mesh_profiling import estimate_stage_memory_split

    _check_unported_fields(stage_option)
    tic = time.perf_counter()
    choices = get_submesh_choices(virtual_mesh.num_hosts,
                                  virtual_mesh.num_devices_per_host,
                                  stage_option.submesh_physical_shape_space)
    sizes = [h * d for h, d in choices]
    L, M = num_layers, len(choices)
    flops = layer_flops(layer_comps)
    mem_budget = float(stage_option.memory_budget_per_device or 0.0)
    costs = np.full((L, L, M), np.inf)
    mem_param = np.zeros((L, L, M))
    mem_act = np.zeros((L, L, M))
    for m, n_dev in enumerate(sizes):
        for i in range(L):
            for j in range(i, L):
                costs[i, j, m] = sum(flops[i:j + 1]) * SEC_PER_FLOP / n_dev
                if mem_budget > 0:
                    mem_param[i, j, m], mem_act[i, j, m] = \
                        estimate_stage_memory_split(layer_comps[i:j + 1],
                                                    n_dev, objective)

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
    wide = [(a, b, choices[m]) for a, b, m in part if sizes[m] > 1]
    if wide:
        raise NotImplementedError(
            f"the stage DP's optimum {[(a, b, choices[m]) for a, b, m in part]}"
            f" puts layers on submeshes of more than one device {wide}: their "
            "cost lacks the intra-op ILP's communication term and such a "
            "stage needs intra-op sharding (ROADMAP A.3); give the pipeline "
            "one device per stage with ManualStageOption or "
            "UniformStageOption")
    fwd_ids = [list(range(a, b)) for a, b, _ in part]
    submeshes = get_sliced_virtual_submeshes(
        virtual_mesh, [list(choices[m]) for _, _, m in part])
    info = {"partition": [(a, b, choices[m]) for a, b, m in part],
            "choices": choices, "layer_flops": flops, "costs": costs,
            "objective": objective,
            "solver": "native stage_dp.cc", "solve_seconds": solve_seconds,
            "seconds": time.perf_counter() - tic}
    return fwd_ids, submeshes, info
