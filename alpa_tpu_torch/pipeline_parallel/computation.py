"""Pipeline computations and graph slicing.

Counterpart of ``alpa_tpu/pipeline_parallel/computation.py`` over a traced
``torch.fx`` graph instead of a jaxpr.  A ``PipelineComputation`` is a
named run of nodes of the traced graph with explicit ``invars`` and
``outvars`` (nodes of that graph); ``get_runnable()`` copies it into a
``GraphModule`` of its own.

The JAX package resolves a marker's output variable to the variable
outside the layer.  Here ``collapse_pipeline_marks`` rewrites the traced
graph so that every use of a marker's output uses the marker's operand
(the value's producer); marker nodes then stand only for positions in the
node order, and slicing cuts at them.  They are never executed.
"""
import dataclasses
import operator
from typing import Dict, List, Sequence

import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.primitive_def import (is_boundary,
                                                            is_marker,
                                                            marker_name)


@dataclasses.dataclass
class PipelineComputation:
    """One pipeline layer or stage: ``nodes`` of the traced graph, run in
    order, from ``invars`` to ``outvars``."""
    name: str
    invars: List[fx.Node]
    outvars: List[fx.Node]
    nodes: List[fx.Node]

    def get_runnable(self, root: torch.nn.Module,
                     device: torch.device) -> fx.GraphModule:
        """The computation as a ``GraphModule`` on ``device``, taking
        ``invars`` and returning the list of ``outvars``.  Constants
        (``get_attr``) are copied in; every device an op names (factory
        functions and casts traced on another device) and every constant
        move to ``device``."""
        graph = fx.Graph()
        env: Dict[fx.Node, fx.Node] = {}
        for v in self.invars:
            env[v] = graph.placeholder(v.name)

        def arg(v):
            if v not in env and v.op == "get_attr":
                env[v] = graph.node_copy(v)
            return env[v]

        for node in self.nodes:
            env[node] = graph.node_copy(node, arg)
        graph.output([arg(v) for v in self.outvars])
        _retarget(graph, torch.device(device))
        gm = fx.GraphModule(root, graph)
        for node in graph.nodes:
            if node.op == "get_attr":
                setattr(gm, node.target, getattr(gm, node.target).to(device))
        return gm


def _retarget(graph: fx.Graph, device: torch.device):
    def move(x):
        return device if isinstance(x, torch.device) else x

    for node in graph.nodes:
        if node.op == "call_function":
            node.args = fx.node.map_aggregate(node.args, move)
            node.kwargs = fx.node.map_aggregate(node.kwargs, move)


def is_marker_output(node: fx.Node) -> bool:
    return (node.op == "call_function" and node.target is operator.getitem
            and isinstance(node.args[0], fx.Node) and is_marker(node.args[0]))


def marker_outputs(marker: fx.Node) -> Dict[int, fx.Node]:
    """The ``getitem`` node of each used output of a marker, by index."""
    return {u.args[1]: u for u in marker.users if is_marker_output(u)}


def collapse_pipeline_marks(graph: fx.Graph, keep: Sequence[fx.Node] = ()):
    """Point every use of a marker's output at the marker's operand, for
    every marker except those in ``keep`` (the gradient marker, whose
    outputs the apply-grad computations read)."""
    keep = set(keep)
    for node in graph.nodes:
        if is_marker(node) and node not in keep:
            for i, out in marker_outputs(node).items():
                out.replace_all_uses_with(node.args[0][i])


def slice_graph_by_full_pipeline_marks(nodes: Sequence[fx.Node]
                                       ) -> List[PipelineComputation]:
    """Slice a collapsed run of nodes at start/end markers.  Nodes outside
    any marker pair (the glue between backward layers, the loss's seed
    gradient) join the following computation; those after the last one
    join the last."""
    computations: List[PipelineComputation] = []
    current = None
    floating: List[fx.Node] = []
    for node in nodes:
        if node.op != "call_function" or is_marker_output(node) or \
                is_boundary(node):
            continue
        if is_marker(node, "start"):
            if current is not None:
                raise ValueError(f"nested pipeline markers at {node}")
            # constants are copied into each computation, and glue before
            # the marker is computed in it
            glue = set(floating)
            current = PipelineComputation(
                marker_name(node),
                [v for v in dict.fromkeys(node.args[0])
                 if v not in glue and v.op != "get_attr"], [], floating)
            floating = []
        elif is_marker(node, "end"):
            if current is None:
                raise ValueError(f"end marker without start at {node}")
            current.outvars = list(dict.fromkeys(node.args[0]))
            computations.append(current)
            current = None
        elif is_marker(node):
            raise ValueError(f"unexpected pipeline marker {node} "
                             f"({node.args[1:]}) inside compute-grad")
        else:
            (current.nodes if current is not None else floating).append(node)
    if current is not None:
        raise ValueError(f"start marker of {current.name} without end")
    if floating and computations:
        computations[-1].nodes.extend(floating)
    return computations


def mark_missing_vars_in_backward_computation_pipeline_marks(
        computations: List[PipelineComputation]
) -> List[PipelineComputation]:
    """A backward computation reads forward values that never passed a
    marker (autograd's saved tensors) and global inputs: add them to its
    invars.  Every invar another computation makes (those, and glue that
    joined an earlier computation) is exported from there."""
    defined_by = {n: ci for ci, comp in enumerate(computations)
                  for n in comp.nodes}
    for ci, comp in enumerate(computations):
        known = set(comp.invars) | set(comp.nodes)
        for node in comp.nodes:
            for v in node.all_input_nodes:
                if v not in known and v.op != "get_attr":
                    comp.invars.append(v)
                    known.add(v)
        for v in comp.invars:
            src = defined_by.get(v)
            if src is not None and src != ci and \
                    v not in computations[src].outvars:
                computations[src].outvars.append(v)
    return computations


def pipeline_dce(computations: List[PipelineComputation],
                 global_outvars: Sequence[fx.Node]
                 ) -> List[PipelineComputation]:
    """Remove dead nodes and outvars across computations, walking them in
    reverse: a computation's live outvars are those later computations or
    the global outputs use; its live invars feed the liveness of earlier
    ones.  Values defined in a computation that are globally live but
    never passed a marker (a tied weight's summed gradient) are
    exported."""
    live = dict.fromkeys(v for v in global_outvars
                         if isinstance(v, fx.Node))
    for comp in reversed(computations):
        defined = set(comp.nodes)
        comp.outvars = [v for v in comp.outvars if v in live]
        comp.outvars += [v for v in live
                         if v in defined and v not in comp.outvars]
        live_local = set(comp.outvars)
        kept = []
        for node in reversed(comp.nodes):
            if node in live_local:
                kept.append(node)
                live_local.update(node.all_input_nodes)
        comp.nodes = kept[::-1]
        comp.invars = [v for v in comp.invars if v in live_local]
        live.update(dict.fromkeys(comp.invars))
    return [c for c in computations if c.nodes or c.outvars]


def merge_computations(computations: List[PipelineComputation],
                       name: str) -> PipelineComputation:
    """Concatenate computations into one."""
    invars, defined, nodes = {}, set(), []
    for comp in computations:
        invars.update(dict.fromkeys(v for v in comp.invars
                                    if v not in defined))
        nodes.extend(comp.nodes)
        defined.update(comp.nodes)
    outvars = dict.fromkeys(v for comp in computations for v in comp.outvars)
    return PipelineComputation(name, list(invars), list(outvars), nodes)
