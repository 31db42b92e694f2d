"""Gradient split, accumulation and apply-grad partitioning.

Counterpart of ``alpa_tpu/pipeline_parallel/apply_grad.py`` over a traced
``torch.fx`` graph: split the train step at the gradient marker, rewrite
the computations that produce gradients so that each microbatch adds into
an accumulator, divide the accumulated values by the number of
microbatches at the head of apply-grad (the returned loss too: it passes
the marker beside the gradients), and partition apply-grad across meshes
by where its inputs live.
"""
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.computation import (PipelineComputation,
                                                          is_marker_output,
                                                          marker_outputs)
from alpa_tpu_torch.pipeline_parallel.primitive_def import is_marker
from alpa_tpu_torch.shard_parallel.strategy import ACCUMULATES

aten = torch.ops.aten


def split_compute_grad_and_apply_grad(graph: fx.Graph):
    """``(grad_marker, compute_nodes, grad_pairs, apply_nodes)``: the nodes
    before the last gradient marker, the ``(pre, post)`` pairs of the
    marked values apply-grad or the output reads (the marker's operand and
    its output node), and the nodes after it."""
    nodes = list(graph.nodes)
    marks = [i for i, n in enumerate(nodes) if is_marker(n, "grad")]
    if not marks:
        raise ValueError(
            "PipeshardParallel requires alpa_tpu_torch.grad / value_and_grad "
            "inside the parallelized function (gradient marker not found)")
    i = marks[-1]
    marker = nodes[i]
    grad_pairs = [(marker.args[0][j], post)
                  for j, post in sorted(marker_outputs(marker).items())
                  if post.users]
    apply_nodes = [n for n in nodes[i + 1:]
                   if n.op == "call_function" and not is_marker_output(n)]
    return marker, nodes[:i], grad_pairs, apply_nodes


def compute_grad_to_accumulate_grad(
        graph: fx.Graph, computations: List[PipelineComputation],
        grad_vars: Sequence[fx.Node]
) -> Dict[fx.Node, Tuple[fx.Node, fx.Node, int]]:
    """Make each computation that produces a gradient add it into an
    accumulator: an extra invar ``acc`` and the outvar ``acc += g`` in
    place of ``g`` (the runtime feeds zeros for the first microbatch and
    the running sum after, and the sum is its own buffer, as the JAX
    runtime donates it).  Returns ``{g: (acc, summed, computation
    index)}``.  A marked value another computation also reads (the loss,
    whose seed gradient the backward takes its shape from) stays an
    outvar."""
    grad_set = set(grad_vars)
    acc_info = {}
    for ci, comp in enumerate(computations):
        for g in [v for v in comp.outvars if v in grad_set]:
            with graph.inserting_before(g.next):
                acc = graph.create_node("placeholder", f"acc_{g.name}")
                summed = graph.call_function(aten.add_.Tensor, (acc, g))
            acc.meta["val"] = summed.meta["val"] = g.meta.get("val")
            summed.meta[ACCUMULATES] = True
            comp.nodes.append(summed)
            comp.invars.append(acc)
            read = any(g in c.invars for c in computations if c is not comp)
            comp.outvars = [summed if v is g else v for v in comp.outvars] + (
                [g] if read else [])
            acc_info[g] = (acc, summed, ci)
    return acc_info


def apply_grad_get_mean(graph: fx.Graph, grad_marker: fx.Node,
                        apply_nodes: List[fx.Node], grad_pairs,
                        num_micro_batches: int) -> List[fx.Node]:
    """Divide every marked value by the number of microbatches where
    apply-grad (and the output) reads it.  Returns the apply nodes with the
    divisions first (none for one microbatch)."""
    if num_micro_batches == 1:
        return apply_nodes
    divs = []
    for _, post in grad_pairs:
        with graph.inserting_after(grad_marker):
            scaled = graph.call_function(aten.div.Tensor,
                                         (post, num_micro_batches))
        scaled.meta["val"] = post.meta.get("val")
        post.replace_all_uses_with(
            scaled, delete_user_cb=lambda u, s=scaled: u is not s)
        divs.append(scaled)
    return divs + apply_nodes


def _size(v: fx.Node) -> float:
    val = v.meta.get("val")
    return float(val.numel()) if isinstance(val, torch.Tensor) else 1.0


def apply_partition_is_acyclic(comps: List[PipelineComputation]) -> bool:
    """Whether the mesh-level dependency graph of the apply computations
    has no cycle (a mutual cross-mesh exchange, as global-norm clipping
    makes, has one)."""
    outs_of = {v: m for m, c in enumerate(comps) for v in c.outvars}
    deps = {m: {outs_of[v] for v in c.invars
                if v in outs_of and outs_of[v] != m}
            for m, c in enumerate(comps)}
    state = {}

    def visit(m):
        if state.get(m) == 2:
            return True
        if state.get(m) == 1:
            return False
        state[m] = 1
        if not all(visit(d) for d in deps[m]):
            return False
        state[m] = 2
        return True

    return all(visit(m) for m in range(len(comps)))


def partition_apply_grad(apply_nodes: List[fx.Node],
                         var_mesh: Dict[fx.Node, int],
                         num_meshes: int,
                         global_outvars: Sequence,
                         force_mesh: Optional[int] = None
                         ) -> List[PipelineComputation]:
    """Assign each apply-grad node to a mesh by the placement of its
    inputs: the mesh of its largest placed input (gradient-sized values
    stay put, scalars travel), mesh 0 when none is placed, or
    ``force_mesh``.  Returns one computation per mesh (maybe empty)."""
    node_mesh: List[int] = []
    where = dict(var_mesh)
    for node in apply_nodes:
        if force_mesh is not None:
            m = force_mesh
        else:
            placed = [v for v in node.all_input_nodes if v in where]
            m = where[max(placed, key=_size)] if placed else 0
        node_mesh.append(m)
        where[node] = m

    global_set = {v for v in global_outvars if isinstance(v, fx.Node)}
    comps = []
    for mesh_id in range(num_meshes):
        mine = [n for n, m in zip(apply_nodes, node_mesh) if m == mesh_id]
        defined = set(mine)
        invars = dict.fromkeys(v for n in mine for v in n.all_input_nodes
                               if v not in defined and v.op != "get_attr")
        outvars = dict.fromkeys(n for n in mine if n in global_set)
        outvars.update(dict.fromkeys(
            v for n, m in zip(apply_nodes, node_mesh) if m != mesh_id
            for v in n.all_input_nodes if v in defined))
        comps.append(PipelineComputation(f"apply_grad_{mesh_id}",
                                         list(invars), list(outvars), mine))
    return comps
