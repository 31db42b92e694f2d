"""The sliced layer graphs run in order on one device, for debugging.

Counterpart of ``alpa_tpu/pipeline_parallel/local_pipeline.py``: the step
is traced as the pipeshard compiler traces it (with the layer option
installed, so ``value_and_grad`` marks the layers and their backward
layers), cut at the layer markers into forward and backward layer
computations and the runs of nodes between them (the gradient marker's
glue, apply-grad), and each piece runs as a ``GraphModule`` of its own, in
the traced order, on one device.  A fault that shows here and not in the
plain step lies in the slicing; one that shows only under
``PipeshardParallel`` lies in the runtime.
"""
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.computation import (
    PipelineComputation, collapse_pipeline_marks, is_marker_output)
from alpa_tpu_torch.pipeline_parallel.compile_executable import (
    _fake_inputs, trace_train_step)
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    AutoLayerOption, LayerOption)
from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import _to_tensor
from alpa_tpu_torch.pipeline_parallel.primitive_def import (is_boundary,
                                                            is_marker,
                                                            marker_name)


def slice_in_order(graph: fx.Graph) -> List[PipelineComputation]:
    """The collapsed graph's compute nodes as consecutive computations:
    each start/end marker pair one layer, each run of nodes between pairs
    one computation of its own (named ``glue_<i>``)."""
    pieces: List[PipelineComputation] = []
    current = PipelineComputation("", [], [], [])
    for node in graph.nodes:
        if node.op != "call_function" or is_marker_output(node) or \
                is_boundary(node):
            continue
        if is_marker(node, "start") or is_marker(node, "end"):
            if current.nodes:
                pieces.append(current)
            current = PipelineComputation(
                marker_name(node) if is_marker(node, "start") else "", [],
                [], [])
        elif not is_marker(node):
            current.nodes.append(node)
    if current.nodes:
        pieces.append(current)
    for i, comp in enumerate(c for c in pieces if not c.name):
        comp.name = f"glue_{i}"
    output = next(n for n in graph.nodes if n.op == "output")
    later = set(output.all_input_nodes)
    for comp in reversed(pieces):
        mine = set(comp.nodes)
        comp.outvars = [n for n in comp.nodes if n in later]
        comp.invars = list(dict.fromkeys(
            v for n in comp.nodes for v in n.all_input_nodes
            if v not in mine and v.op != "get_attr"))
        later.update(comp.invars)
    return pieces


class LocalPipelineExecutable:
    """The layer computations of one traced step, run in order on one
    device."""

    def __init__(self, fun, avals: Sequence, device: torch.device,
                 layer_option: Optional[LayerOption] = None):
        self.device = torch.device(device)
        fake = _fake_inputs(avals, [False] * len(avals), 1, self.device)
        gm = trace_train_step(fun, fake,
                              layer_option or AutoLayerOption(layer_num=2))
        collapse_pipeline_marks(gm.graph)
        self.in_dtypes = [dtype for _, dtype in avals]
        self.global_invars = [n for n in gm.graph.nodes
                              if n.op == "placeholder"]
        self.global_outvars = list(
            next(n for n in gm.graph.nodes if n.op == "output").args[0])
        self.computations = slice_in_order(gm.graph)
        self.modules = [c.get_runnable(gm, self.device)
                        for c in self.computations]

    def launch_on_driver(self, *flat_args):
        env: Dict[fx.Node, Any] = {
            v: _to_tensor(x, dtype, self.device)
            for v, x, dtype in zip(self.global_invars, flat_args,
                                   self.in_dtypes)}
        with torch.no_grad():
            for comp, module in zip(self.computations, self.modules):
                env.update(zip(comp.outvars,
                               module(*[env[v] for v in comp.invars])))
        return [env[v] if isinstance(v, fx.Node) else v
                for v in self.global_outvars]

    def __call__(self, *args):
        return self.launch_on_driver(*args)
