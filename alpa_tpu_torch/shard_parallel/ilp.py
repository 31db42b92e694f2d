"""The ILP over the strategy graph.

Counterpart of ``alpa_tpu/shard_parallel/ilp.py``: one-hot node variables
s_i and edge variables e_ij with row and column consistency, the objective
the nodes' communication costs plus the edges' resharding costs, solved by
scipy's ``milp`` (HiGHS), with an optional per-device memory budget over
the resident inputs.  A greedy pass in program order is the fallback when
the MILP fails; it enforces the budget as hard as the MILP does.
"""
import logging
import time
from typing import Dict, List

import numpy as np

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.shard_parallel.strategy import StrategyGraph

logger = logging.getLogger(__name__)


class InfeasibleMemoryBudget(RuntimeError):
    """No assignment fits ``memory_budget_per_device``: even the smallest
    (most sharded) layout exceeds it."""


def solve_strategy_graph(graph: StrategyGraph, time_limit: float = None,
                         memory_budget: float = None,
                         info: dict = None) -> List[int]:
    """One strategy per node at least total cost.  ``memory_budget``: a
    per-device byte cap on the resident inputs' bytes.  ``info``, when
    given, receives the solver used ("milp" or "greedy") and its
    seconds."""
    time_limit = time_limit or global_config.ilp_time_limit
    sizes = [len(n.strategies) for n in graph.nodes]
    info = {} if info is None else info
    tic = time.perf_counter()
    if all(s == 1 for s in sizes) and not memory_budget:
        info.update(solver="trivial", seconds=0.0)
        return [0] * len(graph.nodes)
    try:
        choice = _solve_milp(graph, sizes, time_limit, memory_budget)
        info.update(solver="milp")
    except InfeasibleMemoryBudget:
        raise
    except Exception as e:  # pylint: disable=broad-except
        logger.warning("MILP solve failed (%s); using greedy fallback", e)
        choice = _solve_greedy(graph, sizes, memory_budget)
        info.update(solver="greedy", error=str(e))
    info["seconds"] = time.perf_counter() - tic
    return choice


def _solve_milp(graph: StrategyGraph, sizes: List[int], time_limit: float,
                memory_budget: float = None) -> List[int]:
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    # variables: [node strategy vars..., edge vars...]
    node_off, off = [], 0
    for s in sizes:
        node_off.append(off)
        off += s
    n_node_vars = off
    edge_off = []
    for e in graph.edges:
        edge_off.append(off)
        off += e.cost.size
    n_vars = off

    c = np.zeros(n_vars)
    biased = []
    for n, o in zip(graph.nodes, node_off):
        for s, st in enumerate(n.strategies):
            c[o + s] = st.comm_cost
            if st.tie_bias > 0:
                biased.append((o + s, st.tie_bias))
    for e, o in zip(graph.edges, edge_off):
        c[o:o + e.cost.size] = e.cost.reshape(-1)
    # normalized for the solver's conditioning
    scale = max(1.0, np.abs(c).max() / 1e4)
    c = c / scale
    # tie_bias steers genuinely tied choices without entering the costs:
    # sized from the smallest real normalized cost, so that the summed
    # bias never flips a real difference; a bias above the usual 1e-6
    # weighs that much more (at most twice)
    if biased:
        pos = c[c > 1e-12]
        eps = ((pos.min() if pos.size else 1.0) * 1e-3 /
               max(1, len(biased)))
        for i, bias in biased:
            c[i] += eps * min(2.0, bias / 1e-6)

    has_mem = bool(memory_budget)
    n_cons = len(graph.nodes) + sum(
        sizes[e.src] + sizes[e.dst] for e in graph.edges) + (
            1 if has_mem else 0)
    A = lil_matrix((n_cons, n_vars))
    lb = np.zeros(n_cons)
    ub = np.zeros(n_cons)
    row = 0
    if has_mem:
        # the resident bytes: every invar node, and op nodes with bytes
        for n, o in zip(graph.nodes, node_off):
            if n.kind != "invar" and not any(
                    st.mem_bytes for st in n.strategies):
                continue
            for s, st in enumerate(n.strategies):
                A[row, o + s] = st.mem_bytes
        lb[row] = -np.inf
        ub[row] = float(memory_budget)
        row += 1
    for i, o in enumerate(node_off):       # sum_s x[i, s] = 1
        A[row, o:o + sizes[i]] = 1.0
        lb[row] = ub[row] = 1.0
        row += 1
    # sum_j e[si, :] = x_src[si]; sum_i e[:, sj] = x_dst[sj]
    for e, o in zip(graph.edges, edge_off):
        ns, nd = sizes[e.src], sizes[e.dst]
        for si in range(ns):
            A[row, o + si * nd:o + (si + 1) * nd] = 1.0
            A[row, node_off[e.src] + si] = -1.0
            row += 1
        for sj in range(nd):
            for si in range(ns):
                A[row, o + si * nd + sj] = 1.0
            A[row, node_off[e.dst] + sj] = -1.0
            row += 1

    integrality = np.zeros(n_vars)
    integrality[:n_node_vars] = 1   # node vars binary; edge vars relax
    res = milp(c=c, constraints=LinearConstraint(A.tocsr(), lb, ub),
               integrality=integrality,
               bounds=Bounds(np.zeros(n_vars), np.ones(n_vars)),
               options={"time_limit": time_limit, "presolve": True,
                        "mip_rel_gap": 1e-9})
    # status 1: the time limit, with the best incumbent in res.x
    if res.x is None or res.status not in (0, 1):
        raise RuntimeError(f"milp status={res.status} {res.message}")
    return [int(np.argmax(res.x[o:o + sizes[i]]))
            for i, o in enumerate(node_off)]


def _solve_greedy(graph: StrategyGraph, sizes: List[int],
                  memory_budget: float = None) -> List[int]:
    """Ops in program order, then invars, each at least marginal cost
    against its decided neighbours, then two refinement sweeps.  The
    budget is hard: a strategy is eligible only if the resident total plus
    the least footprint of the undecided invars fits; raises
    ``InfeasibleMemoryBudget`` when even the least footprint does not."""
    nodes = graph.nodes
    choice = [0] * len(nodes)
    decided = [False] * len(nodes)
    in_edges: Dict[int, List] = {}
    out_edges: Dict[int, List] = {}
    for e in graph.edges:
        in_edges.setdefault(e.dst, []).append(e)
        out_edges.setdefault(e.src, []).append(e)

    invar_idx = [i for i, n in enumerate(nodes) if n.kind == "invar"]
    min_mem = {i: min(st.mem_bytes for st in nodes[i].strategies)
               for i in invar_idx}
    if memory_budget and sum(min_mem.values()) > memory_budget:
        raise InfeasibleMemoryBudget(
            f"minimum resident footprint {sum(min_mem.values()):.3e} B "
            f"exceeds memory_budget_per_device {memory_budget:.3e} B")
    mem_used = [0.0]
    remaining_min = [sum(min_mem.values())]

    def marginal(i, s):
        st = nodes[i].strategies[s]
        cost = st.comm_cost + st.tie_bias
        for e in in_edges.get(i, ()):
            if decided[e.src]:
                cost += e.cost[choice[e.src], s]
        for e in out_edges.get(i, ()):
            if decided[e.dst]:
                cost += e.cost[s, choice[e.dst]]
        return cost

    def feasible_set(i):
        if not memory_budget or nodes[i].kind != "invar":
            return range(sizes[i])
        headroom = memory_budget - mem_used[0] - (remaining_min[0] -
                                                  min_mem[i])
        ok = [s for s in range(sizes[i])
              if nodes[i].strategies[s].mem_bytes <= headroom]
        return ok or [int(np.argmin(
            [st.mem_bytes for st in nodes[i].strategies]))]

    order = sorted(range(len(nodes)),
                   key=lambda i: (nodes[i].kind == "invar", i))
    for i in order:
        choice[i] = min(feasible_set(i), key=lambda s: marginal(i, s))
        decided[i] = True
        if memory_budget and nodes[i].kind == "invar":
            mem_used[0] += nodes[i].strategies[choice[i]].mem_bytes
            remaining_min[0] -= min_mem[i]
    for _ in range(2):
        for i in range(len(nodes)):
            if memory_budget and nodes[i].kind == "invar":
                cur = nodes[i].strategies[choice[i]].mem_bytes
                headroom = memory_budget - (mem_used[0] - cur)
                cand = [s for s in range(sizes[i])
                        if nodes[i].strategies[s].mem_bytes <= headroom]
            else:
                cand = range(sizes[i])
            new = min(cand, key=lambda s: marginal(i, s))
            if memory_budget and nodes[i].kind == "invar":
                mem_used[0] += (nodes[i].strategies[new].mem_bytes -
                                nodes[i].strategies[choice[i]].mem_bytes)
            choice[i] = new
    return choice


def solution_cost(graph: StrategyGraph, choice: List[int]) -> float:
    cost = 0.0
    for n, s in zip(graph.nodes, choice):
        cost += n.strategies[s].comm_cost
    for e in graph.edges:
        cost += e.cost[choice[e.src], choice[e.dst]]
    return cost
