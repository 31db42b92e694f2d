"""The static stage cost model and stage memory model of the stage DP.

Counterpart of ``estimate_stage_cost`` and ``estimate_stage_memory_split``
in ``alpa_tpu/mesh_profiling.py``, on the JAX package's uncalibrated path:
a stage's compute term is its flops x ``DEFAULT_SEC_PER_FLOP`` / its
devices, its communication term the objective of the intra-op ILP solved
on its merged graph and the candidate logical mesh, in the ILP's abstract
units x 1e-7.  The profiling of collectives and devices, the profiling
database and the calibrated cost model that would turn both terms into
measured seconds are ROADMAP A.6.
"""
import time
from typing import Optional, Tuple

import torch

from alpa_tpu_torch.util import node_flops

#: seconds per flop of the uncalibrated cost model (the JAX package's)
DEFAULT_SEC_PER_FLOP = 1.0 / 100e12
#: the exchange rate of the ILP's abstract units into the cost's seconds
ILP_UNIT_SECONDS = 1e-7
#: seconds the ILP of one candidate stage may take (the JAX package's)
STAGE_ILP_TIME_LIMIT = 10

#: optimizer-state bytes per parameter byte (Adam-family: mu + nu)
OPT_STATE_MULT = 2.0


def estimate_stage_cost(stage_comps, logical_mesh, as_option,
                        use_ilp: bool = True,
                        info: Optional[dict] = None) -> float:
    """The cost of the layer computations ``stage_comps`` merged into one
    stage on ``logical_mesh``: flops x ``DEFAULT_SEC_PER_FLOP`` / devices,
    plus, on more than one device (and with ``use_ilp``), the objective of
    the ILP of the merged stage's strategy graph (no input taken as batch,
    as the JAX package plans a stage) x ``ILP_UNIT_SECONDS``.  ``info``,
    when given, accumulates the ILP solves and their seconds."""
    from alpa_tpu_torch.pipeline_parallel.computation import \
        merge_computations
    from alpa_tpu_torch.shard_parallel.ilp import (solution_cost,
                                                   solve_strategy_graph)
    from alpa_tpu_torch.shard_parallel.sharding_spec import Aval
    from alpa_tpu_torch.shard_parallel.strategy import build_strategy_graph
    comp = (merge_computations(stage_comps, "cost_probe")
            if len(stage_comps) > 1 else stage_comps[0])
    flops = sum(node_flops(n) for n in comp.nodes)
    n_dev = logical_mesh.num_devices
    compute = flops * DEFAULT_SEC_PER_FLOP / max(n_dev, 1)
    if not use_ilp or n_dev <= 1:
        return compute
    tic = time.perf_counter()
    avals = [Aval(tuple(v.meta["val"].shape), v.meta["val"].dtype)
             for v in comp.invars]
    graph = build_strategy_graph(comp.to_graph(), avals, logical_mesh, [],
                                 as_option)
    choice = solve_strategy_graph(graph, STAGE_ILP_TIME_LIMIT)
    units = solution_cost(graph, choice)
    if info is not None:
        info["ilp_solves"] = info.get("ilp_solves", 0) + 1
        info["ilp_seconds"] = (info.get("ilp_seconds", 0.0) +
                               time.perf_counter() - tic)
    return compute + units * ILP_UNIT_SECONDS


def _bytes(v) -> float:
    val = v.meta.get("val")
    if not isinstance(val, torch.Tensor):
        return 0.0
    return float(max(val.numel(), 1)) * val.element_size()


def estimate_stage_memory_split(stage_comps, num_devices: int,
                                objective: str = "training"
                                ) -> Tuple[float, float]:
    """(per-device parameter bytes, per-device bytes of one microbatch's
    activations) of the layer computations ``stage_comps`` on a submesh of
    ``num_devices``, which the stage DP combines as ``param + inflight(s) *
    act``.

    Parameters are the stage's inputs that none of its computations
    produce, each counted once; activations are the values its
    computations produce, each counted once, except those that merely pass
    through (an input of the stage).  For ``objective="training"`` the
    parameter term carries the optimizer state (``OPT_STATE_MULT`` x the
    parameter bytes), divided over the submesh as the JAX package's
    default, ZeRO "auto", divides it; a forward-only pipeline
    (``"inference"``) holds none.  Both terms divide by the submesh's
    devices."""
    produced = {v for c in stage_comps for v in c.outvars}
    stage_inputs = set()
    param_bytes = 0.0
    for c in stage_comps:
        for v in c.invars:
            if v in produced or v in stage_inputs:
                continue
            stage_inputs.add(v)
            param_bytes += _bytes(v)
    act_bytes, counted = 0.0, set()
    for c in stage_comps:
        for v in c.outvars:
            if v in counted or v in stage_inputs:
                continue
            counted.add(v)
            act_bytes += _bytes(v)
    n = max(num_devices, 1)
    opt_bytes = (OPT_STATE_MULT * param_bytes / n if objective == "training"
                 else 0.0)
    return param_bytes / n + opt_bytes, act_bytes / n
