"""The auto-sharding planner: trace, mesh-shape search, strategy graph, ILP.

Counterpart of ``alpa_tpu/shard_parallel/solver.py``: the flat function is
traced (``trace_flat``, ``make_fx`` on fake tensors: the counterpart of
``jax.make_jaxpr``), its strategy graph built (``strategy.py``) and solved
(``ilp.py``) for every candidate logical mesh shape, and the cheapest
solution's input specs returned, with the forced ZeRO-2/3 specs on top.

``solve_pinned`` is the plan that executes an ILP plan: the strategy
graph solved again with every input restricted to its final Spec (after
the ZeRO forcing and the user's manual specs), over the strategies the
partitioner executes as they are.  When nothing was forced, its inputs
take the ILP's specs.  ``spmd_partition.py`` realises it.

The rule-based plans of ``DataParallel``, the ZeRO methods,
``get_3d_parallel_method`` and a pipeline stage planned without the ILP
fix only the inputs' specs (``auto_sharding.plan_rule_based``).  The JAX
package hands them to GSPMD, which propagates them from the inputs and
re-plans nothing.  ``propagate_pinned`` is that propagation: the same
pinned graph, each value taking in program order the strategy that
costs least against the values already decided, so that products follow
the batch-sharded inputs, gradients are reduced where the update reads
them (reduce-scattered into sharded ZeRO state) and ZeRO-3 parameters
are gathered at their use; no ILP runs.

With ``global_config.grad_quantize`` on, a ZeRO leaf's sharded strategy
has a twin whose gradient reduce-scatter runs through the gradient codec
(``strategy.py``, priced by ``reduce_scatter_cost_quantized``), so the
ILP flips a tensor to it where the wire saving beats the encode and
decode; ``_note_grad_quantized_choices`` counts the flipped tensors
(``reshard_codec.STATS``) and ``quantized_choices`` lists them.  At
"off" no twin exists and the plans are unchanged.

``plan_auto_sharding`` writes its winning (shape, choice) through the
compile cache (namespace ``ilp``), keyed by the traced graph's content
(``compile_cache.graph_fingerprint``), the avals, paths and batch
arguments, the mesh's shape, device kind and backend, the option, and the
calibration and ``grad_quantize`` tokens where those are on; a hit
rebuilds the strategy graph of the cached shape and replays the choice,
so the plan is the one solved.  The search runs in ``ilp-solve`` and
``ilp-solve-shape`` spans, a hit in ``ilp-cache-replay``.
"""
import logging
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import make_fx

from alpa_tpu_torch.shard_parallel.auto_sharding import (
    AutoShardingOption, _largest_divisible_dim, is_opt_state_path,
    is_param_path, resolved_zero_stage)
from alpa_tpu_torch.shard_parallel.ilp import (InfeasibleMemoryBudget,
                                               solution_cost,
                                               solve_strategy_graph)
from alpa_tpu_torch.shard_parallel.sharding_spec import (Aval, make_spec,
                                                         replicated_spec)
from alpa_tpu_torch.shard_parallel.strategy import build_strategy_graph
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)


def trace_flat(fun: Callable, avals: Sequence[Tuple], device
               ) -> fx.GraphModule:
    """The joint aten graph of the flat function ``fun`` at ``avals``
    ((shape, dtype) per flat argument), traced on fake tensors on
    ``device`` with the gradient marker on: functionalized if autograd
    left an in-place op in it, ``detach`` (an identity once no autograd
    runs) dropped."""
    from alpa_tpu_torch.pipeline_parallel.compile_executable import \
        _fake_inputs
    from alpa_tpu_torch.pipeline_parallel.primitive_def import \
        gradient_marker_tracing
    fake = _fake_inputs(avals, [False] * len(avals), 1, device)
    with gradient_marker_tracing():
        gm = make_fx(fun, tracing_mode="fake")(*fake)
        if any(getattr(n.target, "_schema", None) is not None and
               n.target._schema.is_mutable for n in gm.graph.nodes):
            gm = make_fx(torch.func.functionalize(gm, remove="mutations"),
                         tracing_mode="fake")(*fake)
    for node in list(gm.graph.nodes):
        if node.target is torch.ops.aten.detach.default:
            node.replace_all_uses_with(node.args[0])
            gm.graph.erase_node(node)
    gm.recompile()
    return gm


def candidate_mesh_shapes(num_devices: int, option: AutoShardingOption,
                          symmetric_axes: bool = False
                          ) -> List[Tuple[int, int]]:
    """2-D logical shapes to search (``alpa_tpu/shard_parallel/
    solver.py:40``): (d, n/d) for d a power of two dividing n; on one host
    the two axes cost the same, so only d <= n/d."""
    if option.logical_mesh_shape is not None:
        return [tuple(option.logical_mesh_shape)]
    shapes = []
    d = 1
    while d <= num_devices:
        if num_devices % d == 0:
            shapes.append((d, num_devices // d))
        d *= 2
    if symmetric_axes:
        shapes = [s for s in shapes if s[0] <= s[1]] or shapes[:1]
    return shapes


def plan_auto_sharding(fun: Callable, in_avals: Sequence[Any],
                       in_paths: Sequence[str],
                       batch_flat_idx: Sequence[int], physical_mesh,
                       option: AutoShardingOption,
                       return_graph: bool = False,
                       traced: Optional[fx.GraphModule] = None):
    """Search the logical mesh shapes (``alpa_tpu/shard_parallel/
    solver.py:84``).  ``in_avals``: (shape, dtype) per flat argument;
    ``traced``: ``fun`` already traced at them (``trace_flat``).  Returns
    ``(logical_mesh, flat input specs, (graph, choice), shape)`` and, with
    ``return_graph``, ``(graph, choice)`` once more, as JAX's fifth item.
    ``graph.search`` lists, per shape searched, its size, the seconds of
    its build and solve, the solver and the objective."""
    from alpa_tpu_torch.compile_cache import cache_enabled, get_compile_cache
    avals = [Aval(tuple(shape), dtype) for shape, dtype in in_avals]
    device = physical_mesh.devices.flat[0]
    if traced is None:
        traced = trace_flat(fun, in_avals, device)
    cache = key = None
    if not return_graph and cache_enabled():
        cache = get_compile_cache()
        key = _ilp_cache_key(cache, traced, avals, in_paths, batch_flat_idx,
                             physical_mesh, option)
        entry = cache.get("ilp", key)
        if entry is not None:
            with _ttrace.span("ilp-cache-replay", "compile",
                              {"cache": "hit"} if _ttrace.enabled()
                              else None):
                replayed = _replay_cached_solution(
                    traced, avals, in_paths, batch_flat_idx, physical_mesh,
                    option, entry)
            if replayed is not None:
                cache.record_saved_seconds("ilp", entry["solve_seconds"])
                shape, logical_mesh, graph, choice = replayed
                _note_grad_quantized_choices(graph, choice)
                return _assemble_plan(avals, in_paths, batch_flat_idx,
                                      option, shape, logical_mesh, graph,
                                      choice, return_graph)
    solve_span = _ttrace.begin(
        "ilp-solve", "compile",
        {"cache": "miss" if cache is not None else "off"}
        if _ttrace.enabled() else None)
    best, infeasible, search = None, None, []
    search_tic = time.perf_counter()
    for shape in candidate_mesh_shapes(physical_mesh.num_devices, option,
                                       physical_mesh.num_hosts == 1):
        logical_mesh = physical_mesh.get_logical_mesh(shape)
        tic = time.perf_counter()
        graph = build_strategy_graph(traced.graph, avals, logical_mesh,
                                     batch_flat_idx, option, in_paths)
        build_s = time.perf_counter() - tic
        info = {}
        row = {"shape": shape, "nodes": len(graph.nodes),
               "edges": len(graph.edges),
               "strategies": sum(len(n.strategies) for n in graph.nodes),
               "build_seconds": build_s}
        search.append(row)
        try:
            with _ttrace.span("ilp-solve-shape", "compile",
                              {"shape": str(shape)} if _ttrace.enabled()
                              else None):
                choice = solve_strategy_graph(
                    graph, option.solver_timeout,
                    option.memory_budget_per_device, info)
        except InfeasibleMemoryBudget as e:
            # another shape may still fit the budget
            row["infeasible"] = str(e)
            infeasible = e
            continue
        cost = solution_cost(graph, choice)
        row.update(solver=info["solver"], solve_seconds=info["seconds"],
                   objective=cost)
        logger.debug("mesh shape %s: cost %.4f (%s)", shape, cost,
                     graph.stats())
        if best is None or cost < best[0]:
            best = (cost, shape, logical_mesh, graph, choice)
    _ttrace.end(solve_span)
    if best is None:
        raise infeasible
    cost, shape, logical_mesh, graph, choice = best
    graph.search = search
    if cache is not None:
        solve_seconds = time.perf_counter() - search_tic
        cache.record_solve_seconds("ilp", solve_seconds)
        cache.put("ilp", key, {"shape": tuple(shape),
                               "choice": [int(c) for c in choice],
                               "cost": float(cost),
                               "solve_seconds": solve_seconds,
                               "search": search})
    _note_grad_quantized_choices(graph, choice)
    return _assemble_plan(avals, in_paths, batch_flat_idx, option, shape,
                          logical_mesh, graph, choice, return_graph)


def _grad_quantize_cache_token() -> Optional[str]:
    """The ``grad_quantize`` knobs as a key part; None at "off", so the
    default keys carry none."""
    from alpa_tpu_torch.global_env import global_config
    if global_config.grad_quantize == "off":
        return None
    return "gq:{}:{}:{}".format(global_config.grad_quantize,
                                global_config.grad_quantize_min_bytes,
                                int(global_config.grad_error_feedback))


def _ilp_cache_key(cache, traced, avals, in_paths, batch_flat_idx,
                   physical_mesh, option) -> str:
    from alpa_tpu_torch.compile_cache import graph_fingerprint
    from alpa_tpu_torch.mesh_profiling import device_kind
    from alpa_tpu_torch.shard_parallel.collectives import backend_of
    from alpa_tpu_torch.telemetry.calibration import calibration_cache_token
    devices = list(physical_mesh.devices.flat)
    cal = physical_mesh.get_logical_mesh().calibration
    toks = [t for t in (calibration_cache_token(),
                        _grad_quantize_cache_token()) if t]
    return cache.make_key("ilp", [
        "plan_auto_sharding", graph_fingerprint(traced),
        repr([(tuple(a.shape), str(a.dtype)) for a in avals]),
        repr(tuple(in_paths)), repr(tuple(batch_flat_idx)),
        repr((physical_mesh.num_hosts, physical_mesh.num_devices)),
        device_kind(devices[0]), backend_of(devices), option,
        repr(None if cal is None else (sorted(cal.dot_points),
                                       sorted(cal.collective_ab.items()))),
    ] + toks)


def _replay_cached_solution(traced, avals, in_paths, batch_flat_idx,
                            physical_mesh, option, entry):
    """``(shape, logical_mesh, graph, choice)`` rebuilt from a cached
    solution, or None where it no longer fits the strategy graph."""
    try:
        shape = tuple(entry["shape"])
        choice = list(entry["choice"])
        if shape not in candidate_mesh_shapes(physical_mesh.num_devices,
                                              option,
                                              physical_mesh.num_hosts == 1):
            return None
        logical_mesh = physical_mesh.get_logical_mesh(shape)
        graph = build_strategy_graph(traced.graph, avals, logical_mesh,
                                     batch_flat_idx, option, in_paths)
        if len(choice) != len(graph.nodes) or not all(
                0 <= c < len(n.strategies)
                for n, c in zip(graph.nodes, choice)):
            return None
    except Exception:  # pylint: disable=broad-except
        logger.warning("cached ILP solution failed to replay; re-solving",
                       exc_info=True)
        return None
    graph.search = [dict(r, cached=True) for r in entry["search"]]
    return shape, logical_mesh, graph, choice


def quantized_choices(graph, choice) -> List[Tuple[int, str, str]]:
    """``(input index, its strategy, codec)`` of each input the solution
    routes through the gradient codec."""
    out = []
    for node, s in zip(graph.nodes, choice):
        st = node.strategies[s]
        if node.kind == "invar" and st.codec:
            out.append((node.invar_idx, st.name, st.codec))
    return out


def _note_grad_quantized_choices(graph, choice) -> None:
    """Count each gradient tensor the solution routes through the codec,
    with the wire bytes it saves."""
    from alpa_tpu_torch.pipeline_parallel import reshard_codec
    for node, s in zip(graph.nodes, choice):
        codec = node.strategies[s].codec
        if node.kind != "invar" or not codec:
            continue
        shape = tuple(node.aval.shape)
        itemsize = torch.empty((), dtype=node.aval.dtype).element_size()
        full = int(np.prod(shape, dtype=np.int64)) * itemsize
        reshard_codec.note_grad_quantized(
            codec, full, reshard_codec.grad_wire_bytes(shape, itemsize,
                                                       codec))


def _assemble_plan(avals, in_paths, batch_flat_idx, option, shape,
                   logical_mesh, graph, choice, return_graph):
    """The result of ``plan_auto_sharding`` from a solved (graph, choice)
    (``alpa_tpu/shard_parallel/solver.py:221``)."""
    in_specs: List[Any] = [replicated_spec(len(a.shape)) for a in avals]
    for node, s in zip(graph.nodes, choice):
        if node.kind == "invar" and node.invar_idx is not None:
            in_specs[node.invar_idx] = node.strategies[s].out_spec

    # forced ZeRO stages shard each weight-update leaf the ILP left
    # replicated, over the axis the ILP put the batch dim on (else the
    # largest axis)
    zero = resolved_zero_stage(option)
    if zero in (2, 3):
        dp_axis = None
        for node, s in zip(graph.nodes, choice):
            spec = node.strategies[s].out_spec
            if (node.kind == "invar" and node.invar_idx in batch_flat_idx
                    and spec and spec[0]):
                dp_axis = spec[0][0]
                break
        if dp_axis is None:
            dp_axis = int(np.argmax(shape))
        dp = shape[dp_axis]
        if dp > 1:
            for i, path in enumerate(in_paths):
                if not (is_opt_state_path(path) or
                        (zero == 3 and is_param_path(path))):
                    continue
                d = _largest_divisible_dim(avals[i].shape, dp)
                if d is not None and not any(in_specs[i]):
                    in_specs[i] = make_spec(len(avals[i].shape), {d: dp_axis})

    out = (logical_mesh, in_specs, (graph, choice), shape)
    if return_graph:
        return out + ((graph, choice),)
    return out


def solve_pinned(traced: fx.GraphModule, in_avals: Sequence[Any],
                 in_paths: Sequence[str], batch_flat_idx: Sequence[int],
                 logical_mesh, option: AutoShardingOption, in_specs):
    """``(graph, choice)`` of ``traced`` (the flat function at
    ``in_avals``) on ``logical_mesh`` with every input's node restricted
    to its spec in ``in_specs``, over the strategies the partitioner
    executes as they are (``build_strategy_graph(realizable=True)``): the
    graph is built again with the pins (a forced spec that is not among a
    node's strategies becomes its one strategy) and solved."""
    avals = [Aval(tuple(shape), dtype) for shape, dtype in in_avals]
    graph = build_strategy_graph(traced.graph, avals, logical_mesh,
                                 batch_flat_idx, option, in_paths,
                                 pins=dict(enumerate(in_specs)),
                                 realizable=True)
    info = {}
    choice = solve_strategy_graph(graph, option.solver_timeout, None, info)
    graph.search = [{"shape": tuple(logical_mesh.shape), "pinned": True,
                     "nodes": len(graph.nodes), "edges": len(graph.edges),
                     "solver": info["solver"],
                     "solve_seconds": info["seconds"],
                     "objective": solution_cost(graph, choice)}]
    return graph, choice


def propagate_strategies(graph) -> List[int]:
    """A choice per node of ``graph``, GSPMD's way: every node of one
    strategy keeps it; every other node, in the order the graph was built
    (the program's order), takes the strategy that reshards least of its
    operands already decided, then (on ties) communicates least itself,
    then reshards least against the other values already decided (its
    consumers, and the side operands of elementwise ops that follow it),
    then the first."""
    n = len(graph.nodes)
    incident: List[List[Tuple[Any, bool]]] = [[] for _ in range(n)]
    for e in graph.edges:
        incident[e.dst].append((e, True))
        incident[e.src].append((e, False))
    choice: List[Optional[int]] = [0 if len(node.strategies) == 1 else None
                                   for node in graph.nodes]
    for node in graph.nodes:
        if choice[node.idx] is not None:
            continue
        k = len(node.strategies)
        operands, consumers = np.zeros(k), np.zeros(k)
        own = np.array([st.comm_cost + st.tie_bias
                        for st in node.strategies])
        for e, inbound in incident[node.idx]:
            other = e.src if inbound else e.dst
            if choice[other] is None:
                continue
            if inbound and not e.consistency:
                operands = operands + e.cost[choice[other], :]
            elif inbound:
                consumers = consumers + e.cost[choice[other], :]
            else:
                consumers = consumers + e.cost[:, choice[other]]
        choice[node.idx] = int(np.lexsort((consumers, own, operands))[0])
    return choice


def propagate_pinned(traced: fx.GraphModule, in_avals: Sequence[Any],
                     in_paths: Sequence[str], batch_flat_idx: Sequence[int],
                     logical_mesh, option: AutoShardingOption, in_specs):
    """``(graph, choice)`` of ``traced`` with every input pinned to its
    spec in ``in_specs`` (the graph ``solve_pinned`` builds, a select
    following its data as GSPMD propagates it), the other nodes decided
    by ``propagate_strategies``: GSPMD's propagation of a rule-based plan,
    with no ILP."""
    avals = [Aval(tuple(shape), dtype) for shape, dtype in in_avals]
    tic = time.perf_counter()
    graph = build_strategy_graph(traced.graph, avals, logical_mesh,
                                 batch_flat_idx, option, in_paths,
                                 pins=dict(enumerate(in_specs)),
                                 realizable=True, propagation=True)
    choice = propagate_strategies(graph)
    graph.search = [{"shape": tuple(logical_mesh.shape), "pinned": True,
                     "nodes": len(graph.nodes), "edges": len(graph.edges),
                     "solver": "propagation",
                     "solve_seconds": time.perf_counter() - tic,
                     "objective": solution_cost(graph, choice)}]
    return graph, choice
