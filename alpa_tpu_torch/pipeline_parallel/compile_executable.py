"""Pipeshard compilation: trace, slice, stage, accumulate, emit.

Counterpart of the training path of ``compile_pipeshard_executable``
(``alpa_tpu/pipeline_parallel/compile_executable.py``):

  trace the flat train step with ``make_fx`` at microbatch shapes, on fake
  tensors, with the layer option installed (one joint aten graph: forward
  layers between start/end markers, the backward layers autograd traced
  between the flipped markers, the gradient marker, apply-grad)
  -> split at the gradient marker (apply_grad.py)
  -> slice into layer computations (computation.py)
  -> group layers into stages, slice the mesh (stage_construction.py):
     per stage a submesh of one or more devices, a logical shape and its
     AutoShardingOption overrides
  -> merge, prune stage outputs, rewrite gradients into accumulators
  -> divide by the number of microbatches, partition apply-grad by mesh
  -> PipeshardDriverExecutable (pipeshard_executable.py), which plans
     each stage of several devices as the JAX package does and
     partitions it for its devices

A function with no gradient marker takes the inference path, the JAX
package's ``_compile_inference``: its trace is cut into layers by the
layer option when it has no layer markers (``mark_traced_graph``: the
graph already traced is marked and retraced, the function is not run
again), sliced into forward stages only,
staged with the stage DP's inference objective, run under the
``"inference"`` schedule with no apply-grad, donating nothing; its batch
outputs are joined over microbatches.  Where such a function writes an
input in place and nothing else reads that input (a KV cache written by
``index_put_``, ``_input_writes``), the trace is not functionalized: the
stage graph writes the input where it lies and hands it back as the
output, as the function does eagerly, so a decode step neither copies a
cache nor moves it between meshes (JAX's cache outputs keep their stage
placement; here they keep their address too).
"""
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import fx
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

from alpa_tpu_torch.device_mesh import VirtualPhysicalMesh
from alpa_tpu_torch.pipeline_parallel.apply_grad import (
    apply_grad_get_mean, apply_partition_is_acyclic,
    compute_grad_to_accumulate_grad, partition_apply_grad,
    split_compute_grad_and_apply_grad)
from alpa_tpu_torch.pipeline_parallel.computation import (
    PipelineComputation, collapse_pipeline_marks, is_marker_output,
    mark_missing_vars_in_backward_computation_pipeline_marks,
    merge_computations, pipeline_dce, slice_graph_by_full_pipeline_marks)
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    AutoLayerOption, LayerOption, collapse_remat_markers, mark_traced_graph,
    set_current_layer_option)
from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
    PipeshardDriverExecutable
from alpa_tpu_torch.pipeline_parallel.primitive_def import (is_marker,
                                                            pipeshard_tracing)
from alpa_tpu_torch.pipeline_parallel.stage_construction import (
    StageOption, cluster_layers_and_slice_mesh)


def _layer_index_of(name: str) -> int:
    return int(re.match(r"layer_(\d+)", name).group(1))


def _is_backward_name(name: str) -> bool:
    return "backward" in name


def _fake_inputs(avals, batch_invars, num_micro_batches, device):
    """Fake tensors of the flat arguments at microbatch shapes."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    out = []
    for (shape, dtype), is_batch in zip(avals, batch_invars):
        if not isinstance(dtype, torch.dtype):
            raise TypeError(f"pipeshard takes tensors, arrays and numbers; "
                            f"got a leaf of type {dtype.__name__}")
        shape = list(shape)
        if is_batch:
            if not shape or shape[0] % num_micro_batches:
                raise ValueError(
                    f"batch argument of shape {tuple(shape)} does not split "
                    f"into num_micro_batches={num_micro_batches}")
            shape[0] //= num_micro_batches
        with mode:
            out.append(torch.empty(shape, dtype=dtype, device=device))
    return out


def _marker_root(v: fx.Node) -> fx.Node:
    """The value a chain of marker outputs forwards (a marker's output is
    its operand, as ``collapse_pipeline_marks`` makes it)."""
    while is_marker_output(v):
        v = v.args[0].args[0][v.args[1]]
    return v


def _input_writes(graph: fx.Graph) -> Optional[List[fx.Node]]:
    """The in-place ops of a forward-only ``graph`` if every one writes a
    graph input (through marker outputs) that nothing else reads and no
    other op writes (``detach_`` aside); None otherwise (the graph is then
    functionalized)."""
    writes, readers = [], {}
    for node in graph.nodes:
        if node.op != "call_function" or is_marker(node):
            continue
        for v in node.all_input_nodes:
            readers.setdefault(_marker_root(v), []).append(node)
        schema = getattr(node.target, "_schema", None)
        # ``detach_`` (of a constant made in the trace) changes no value
        if schema is not None and schema.is_mutable and \
                node.target is not torch.ops.aten.detach_.default:
            writes.append(node)
    if any(is_marker(n, "grad") for n in graph.nodes):
        return None
    written = set()
    for node in writes:
        schema = node.target._schema
        targets = [a for a, arg in zip(node.args, schema.arguments)
                   if arg.alias_info is not None and arg.alias_info.is_write]
        if len(targets) != 1 or not isinstance(targets[0], fx.Node):
            return None
        root = _marker_root(targets[0])
        if root.op != "placeholder" or root in written or \
                readers.get(root) != [node]:
            return None
        written.add(root)
    return writes


def trace_train_step(fun: Callable, fake_args, layer_option: LayerOption
                     ) -> fx.GraphModule:
    """The joint graph of the flat train step: traced with the layer
    option installed and the markers on, functionalized if autograd left
    an in-place op in it (a forward-only graph whose only in-place ops
    write inputs, ``_input_writes``, keeps them), and with ``detach`` (an
    identity once no autograd runs) dropped."""
    set_current_layer_option(layer_option)
    try:
        with pipeshard_tracing():
            gm = make_fx(fun, tracing_mode="fake")(*fake_args)
    finally:
        set_current_layer_option(None)
    # a model traced outside the layer transform leaves its remat markers
    collapse_remat_markers(gm.graph)
    if any(getattr(n.target, "_schema", None) is not None and
           n.target._schema.is_mutable for n in gm.graph.nodes) and \
            _input_writes(gm.graph) is None:
        gm = make_fx(torch.func.functionalize(gm, remove="mutations"),
                     tracing_mode="fake")(*fake_args)
    for node in list(gm.graph.nodes):
        if node.target is torch.ops.aten.detach.default:
            node.replace_all_uses_with(node.args[0])
            gm.graph.erase_node(node)
    return gm


def compile_pipeshard_executable(fun: Callable,
                                 virtual_mesh: VirtualPhysicalMesh,
                                 avals: Sequence,
                                 batch_invars: Sequence[bool],
                                 donated_invars: Sequence[bool],
                                 num_micro_batches: int,
                                 pipeline_schedule: str,
                                 layer_option: Optional[LayerOption],
                                 stage_option: Optional[StageOption],
                                 as_option=None,
                                 in_paths: Optional[Sequence[str]] = None
                                 ) -> PipeshardDriverExecutable:
    tic = time.perf_counter()
    num_micro_batches = num_micro_batches or 1
    layer_option = layer_option or AutoLayerOption(
        layer_num=min(8, virtual_mesh.num_hosts if virtual_mesh.num_hosts > 1
                      else virtual_mesh.num_devices))
    trace_device = virtual_mesh.devices.flat[0]
    fake_args = _fake_inputs(avals, batch_invars, num_micro_batches,
                             trace_device)
    gm = trace_train_step(fun, fake_args, layer_option)
    if not any(is_marker(n, "grad") for n in gm.graph.nodes):
        if not any(is_marker(n, "start") for n in gm.graph.nodes):
            # a forward-only function never passes through value_and_grad,
            # so the layer transform is applied here, to the graph just
            # traced (JAX's one trace of such a function)
            gm = trace_train_step(mark_traced_graph(gm, layer_option),
                                  fake_args, layer_option)
        return _compile_inference(
            gm, virtual_mesh, avals, batch_invars, num_micro_batches,
            stage_option, tic, time.perf_counter() - tic, as_option,
            in_paths)
    if pipeline_schedule == "inference":
        raise ValueError(
            "pipeline_schedule='inference' runs forward-only functions; "
            "this one computes gradients (alpa_tpu_torch.grad / "
            "value_and_grad): use a training schedule")
    trace_seconds = time.perf_counter() - tic
    graph = gm.graph
    global_invars = [n for n in graph.nodes if n.op == "placeholder"]
    output = next(n for n in graph.nodes if n.op == "output")

    grad_marker = next(n for n in reversed(graph.nodes)
                       if is_marker(n, "grad"))
    collapse_pipeline_marks(graph, keep=[grad_marker])
    grad_marker, compute_nodes, grad_pairs, apply_nodes = \
        split_compute_grad_and_apply_grad(graph)
    grad_vars = [pre for pre, _ in grad_pairs]

    # ---- slice into layer computations ----
    computations = slice_graph_by_full_pipeline_marks(compute_nodes)
    if not computations:
        raise ValueError(
            "no pipeline layers found: use AutoLayerOption, or "
            "ManualLayerOption with mark_pipeline_boundary()")
    computations = \
        mark_missing_vars_in_backward_computation_pipeline_marks(
            computations)
    computations = pipeline_dce(computations, grad_vars)
    fwd_comps = [c for c in computations if not _is_backward_name(c.name)]
    num_layers = len(fwd_comps)
    bwd_by_layer: Dict[int, List[PipelineComputation]] = {}
    for comp in computations:
        if _is_backward_name(comp.name):
            bwd_by_layer.setdefault(_layer_index_of(comp.name),
                                    []).append(comp)

    # ---- stages ----
    fwd_stage_layer_ids, submeshes, logical_shapes, as_dicts, \
        stage_dp_info = cluster_layers_and_slice_mesh(
            num_layers, virtual_mesh, stage_option, layer_comps=fwd_comps,
            num_micro_batches=num_micro_batches, schedule=pipeline_schedule,
            auto_sharding_option=as_option, root=gm)
    num_stages = len(fwd_stage_layer_ids)
    fwd_stages = [merge_computations([fwd_comps[i] for i in ids],
                                     f"stage_{s}_fwd")
                  for s, ids in enumerate(fwd_stage_layer_ids)]
    bwd_stages = [merge_computations(
        [c for i in reversed(ids) for c in bwd_by_layer.get(i, [])],
        f"stage_{s}_bwd") for s, ids in enumerate(fwd_stage_layer_ids)]

    # ---- gradient accumulation ----
    all_stages = fwd_stages + bwd_stages
    global_outvars = list(output.args[0])
    _prune_stage_outvars(all_stages, grad_vars, global_outvars)
    _export_vars(all_stages, grad_vars)
    acc_info = compute_grad_to_accumulate_grad(graph, all_stages, grad_vars)

    # ---- apply-grad ----
    compute_set = set(compute_nodes)
    for node in apply_nodes:
        stray = [v for v in node.all_input_nodes
                 if v in compute_set and v.op != "placeholder"
                 and v.op != "get_attr"]
        if stray:
            raise ValueError(
                f"apply-grad node {node} reads {stray}, computed before the "
                "gradient marker but not passed through it: return such "
                "values from the function given to value_and_grad")
    apply_nodes = apply_grad_get_mean(graph, grad_marker, apply_nodes,
                                      grad_pairs, num_micro_batches)
    global_outvars = list(output.args[0])
    var_mesh = {}
    for pre, post in grad_pairs:
        if pre in acc_info:
            ci = acc_info[pre][2]
            var_mesh[post] = ci if ci < num_stages else ci - num_stages
    ginvars = set(global_invars)
    for stages in (fwd_stages, bwd_stages):
        for s, comp in enumerate(stages):
            for v in comp.invars:
                if v in ginvars:
                    var_mesh.setdefault(v, s)
    apply_comps = partition_apply_grad(apply_nodes, var_mesh, num_stages,
                                       global_outvars)
    if not apply_partition_is_acyclic(apply_comps):
        # a mutual cross-mesh exchange (global-norm clipping reads every
        # gradient and scales every one): run all of apply-grad on mesh 0
        apply_comps = partition_apply_grad(
            apply_nodes, var_mesh, num_stages, global_outvars, force_mesh=0)

    executable = PipeshardDriverExecutable(
        meshes=submeshes, logical_shapes=logical_shapes,
        as_dicts=as_dicts, as_option=as_option, in_paths=in_paths,
        fwd_stages=fwd_stages, bwd_stages=bwd_stages,
        apply_comps=apply_comps, root=gm, schedule_name=pipeline_schedule,
        num_micro_batches=num_micro_batches, global_invars=global_invars,
        global_outvars=global_outvars,
        in_dtypes=[dtype for _, dtype in avals], batch_invars=batch_invars,
        donated_invars=donated_invars, grad_pairs=grad_pairs,
        acc_info=acc_info)
    executable.stage_dp_info = stage_dp_info
    executable.fwd_layer_comps = fwd_comps
    executable.trace_seconds = trace_seconds
    executable.compile_seconds = time.perf_counter() - tic - trace_seconds
    return executable


def _compile_inference(gm: fx.GraphModule, virtual_mesh, avals,
                       batch_invars, num_micro_batches, stage_option, tic,
                       trace_seconds, as_option=None, in_paths=None
                       ) -> PipeshardDriverExecutable:
    """Forward-only pipeshard compile (``_compile_inference`` of the JAX
    package): forward stages only, the stage DP's inference objective, the
    ``"inference"`` schedule, no apply-grad, nothing donated."""
    graph = gm.graph
    global_invars = [n for n in graph.nodes if n.op == "placeholder"]
    output = next(n for n in graph.nodes if n.op == "output")
    collapse_pipeline_marks(graph)
    global_outvars = list(output.args[0])
    computations = slice_graph_by_full_pipeline_marks(list(graph.nodes))
    if not computations:
        raise ValueError(
            "no pipeline layers found: mark layers with "
            "mark_pipeline_boundary() (ManualLayerOption) or use "
            "AutoLayerOption")
    computations = \
        mark_missing_vars_in_backward_computation_pipeline_marks(
            computations)
    computations = pipeline_dce(computations, global_outvars)
    fwd_stage_layer_ids, submeshes, logical_shapes, as_dicts, \
        stage_dp_info = cluster_layers_and_slice_mesh(
            len(computations), virtual_mesh, stage_option,
            layer_comps=computations, num_micro_batches=num_micro_batches,
            objective="inference", auto_sharding_option=as_option, root=gm)
    fwd_stages = [merge_computations([computations[i] for i in ids],
                                     f"stage_{s}_fwd")
                  for s, ids in enumerate(fwd_stage_layer_ids)]
    _prune_stage_outvars(fwd_stages, [], global_outvars)
    executable = PipeshardDriverExecutable(
        meshes=submeshes, logical_shapes=logical_shapes,
        as_dicts=as_dicts, as_option=as_option, in_paths=in_paths,
        fwd_stages=fwd_stages, bwd_stages=[], apply_comps=[], root=gm,
        schedule_name="inference",
        num_micro_batches=num_micro_batches, global_invars=global_invars,
        global_outvars=global_outvars,
        in_dtypes=[dtype for _, dtype in avals], batch_invars=batch_invars,
        donated_invars=(False,) * len(avals), grad_pairs=[], acc_info={})
    executable.stage_dp_info = stage_dp_info
    executable.fwd_layer_comps = computations
    executable.trace_seconds = trace_seconds
    executable.compile_seconds = time.perf_counter() - tic - trace_seconds
    return executable


def _prune_stage_outvars(stages: List[PipelineComputation], grad_vars,
                         global_outvars):
    """Merged stages export the union of their layers' outvars, including
    activations used only inside the stage; keep only what another stage,
    a gradient or the output reads, so the rest is never held across
    microbatches."""
    external = set(grad_vars) | {v for v in global_outvars
                                 if isinstance(v, fx.Node)}
    invars_of = [set(s.invars) for s in stages]
    for i, comp in enumerate(stages):
        elsewhere = set().union(*(inv for j, inv in enumerate(invars_of)
                                  if j != i))
        comp.outvars = [v for v in comp.outvars
                        if v in external or v in elsewhere]


def _export_vars(stages: List[PipelineComputation], needed):
    """Make each needed value an outvar of the stage that computes it."""
    for v in needed:
        if any(v in s.outvars for s in stages):
            continue
        for s in stages:
            if v in s.nodes:
                s.outvars.append(v)
                break
