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

aten = torch.ops.aten


@dataclasses.dataclass
class PipelineComputation:
    """One pipeline layer or stage: ``nodes`` of the traced graph, run in
    order, from ``invars`` to ``outvars``."""
    name: str
    invars: List[fx.Node]
    outvars: List[fx.Node]
    nodes: List[fx.Node]

    def to_graph(self) -> fx.Graph:
        """The computation as an ``fx.Graph`` of its own, taking ``invars``
        (placeholders carrying their traced values) and returning the list
        of ``outvars``; constants stay ``get_attr`` nodes."""
        graph = fx.Graph()
        env: Dict[fx.Node, fx.Node] = {}
        for v in self.invars:
            env[v] = graph.placeholder(v.name)
            env[v].meta = dict(v.meta)

        def arg(v):
            if v not in env and v.op == "get_attr":
                env[v] = graph.node_copy(v)
            return env[v]

        for node in self.nodes:
            env[node] = graph.node_copy(node, arg)
        graph.output([arg(v) for v in self.outvars])
        return graph

    def get_runnable(self, root: torch.nn.Module,
                     device: torch.device) -> fx.GraphModule:
        """The computation as a ``GraphModule`` on ``device``, taking
        ``invars`` and returning the list of ``outvars``.  Constants
        (``get_attr``) are copied in; every device an op names (factory
        functions and casts traced on another device) and every constant
        move to ``device``."""
        graph = self.to_graph()
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


#: ops that only view their first operand: a saved tensor made by a chain
#: of them from a computation's input is remade where it is read
_VIEW_OPS = frozenset({
    aten.t.default, aten.transpose.int, aten.permute.default,
    aten.view.default, aten._unsafe_view.default, aten.reshape.default,
    aten.unsqueeze.default, aten.squeeze.dim, aten.expand.default,
    aten.alias.default})


def _view_chain(v: fx.Node, comp: PipelineComputation):
    """``(chain, root)`` when ``v`` is made from ``root``, a global input
    or an input of ``comp`` (the computation that made ``v``), by view ops
    only (``chain`` in program order); else None."""
    chain = []
    while v.op == "call_function" and v.target in _VIEW_OPS and \
            len(v.all_input_nodes) == 1:
        chain.append(v)
        v = v.args[0]
    if chain and (v.op == "placeholder" or v in comp.invars):
        return chain[::-1], v
    return None


def _remake_views(graph: fx.Graph, comp: PipelineComputation,
                  defined_by: Dict[fx.Node, int],
                  computations: List[PipelineComputation]):
    """Where ``comp`` reads a view another computation made of its input
    (autograd saves ``t(W)`` of a forward layer's weight ``W``), read the
    input and remake the view in ``comp``, as JAX's backward reads the
    weight itself: the view's spec is then the weight's."""
    remade: Dict[fx.Node, fx.Node] = {}
    known = set(comp.nodes)
    for node in list(comp.nodes):
        for v in list(node.all_input_nodes):
            src = defined_by.get(v)
            if v in known or src is None or src == defined_by.get(node):
                continue
            if v not in remade:
                found = _view_chain(v, computations[src])
                if found is None:
                    continue
                chain, cur = found
                copies = []
                with graph.inserting_before(comp.nodes[0]):
                    for n in chain:
                        cur = graph.node_copy(
                            n, lambda a, c=cur, o=n.args[0]: c if a is o
                            else a)
                        copies.append(cur)
                comp.nodes[:0] = copies
                for c in copies:
                    defined_by[c] = defined_by[node]
                remade[v] = cur
            node.replace_input_with(v, remade[v])


def mark_missing_vars_in_backward_computation_pipeline_marks(
        computations: List[PipelineComputation]
) -> List[PipelineComputation]:
    """A backward computation reads forward values that never passed a
    marker (autograd's saved tensors) and global inputs: add them to its
    invars; a saved view of another computation's input is remade from
    that input (``_remake_views``).  Every invar another computation makes
    (those, and glue that joined an earlier computation) is exported from
    there."""
    defined_by = {n: ci for ci, comp in enumerate(computations)
                  for n in comp.nodes}
    for comp in computations:
        if comp.nodes:
            _remake_views(comp.nodes[0].graph, comp, defined_by,
                          computations)
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
