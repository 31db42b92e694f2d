"""Pipeshard compilation: trace, slice, stage, accumulate, emit.

Counterpart of the training path of ``compile_pipeshard_executable``
(``alpa_tpu/pipeline_parallel/compile_executable.py``):

  trace the flat train step with ``make_fx`` at microbatch shapes, on fake
  tensors, with the layer option installed (one joint aten graph: forward
  layers between start/end markers, the backward layers autograd traced
  between the flipped markers, the gradient marker, apply-grad)
  -> split at the gradient marker (apply_grad.py)
  -> slice into layer computations (computation.py)
  -> group layers into stages, slice the mesh (stage_construction.py)
  -> merge, prune stage outputs, rewrite gradients into accumulators
  -> divide by the number of microbatches, partition apply-grad by mesh
  -> PipeshardDriverExecutable (pipeshard_executable.py)

A function with no gradient marker takes the inference path, the JAX
package's ``_compile_inference``: traced again under the layer transform
when its trace has no layer markers, sliced into forward stages only,
staged with the stage DP's inference objective, run under the
``"inference"`` schedule with no apply-grad, donating nothing; its batch
outputs are joined over microbatches.
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
    PipelineComputation, collapse_pipeline_marks,
    mark_missing_vars_in_backward_computation_pipeline_marks,
    merge_computations, pipeline_dce, slice_graph_by_full_pipeline_marks)
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    AutoLayerOption, LayerOption, collapse_remat_markers,
    layer_level_transform, set_current_layer_option)
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


def trace_train_step(fun: Callable, fake_args, layer_option: LayerOption
                     ) -> fx.GraphModule:
    """The joint graph of the flat train step: traced with the layer
    option installed and the markers on, functionalized if autograd left
    an in-place op in it, and with ``detach`` (an identity once no
    autograd runs) dropped."""
    set_current_layer_option(layer_option)
    try:
        with pipeshard_tracing():
            gm = make_fx(fun, tracing_mode="fake")(*fake_args)
    finally:
        set_current_layer_option(None)
    # a model traced outside the layer transform leaves its remat markers
    collapse_remat_markers(gm.graph)
    if any(getattr(n.target, "_schema", None) is not None and
           n.target._schema.is_mutable for n in gm.graph.nodes):
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
                                 stage_option: Optional[StageOption]
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
            # so the layer transform is applied here
            gm = trace_train_step(layer_level_transform(fun, layer_option),
                                  fake_args, layer_option)
        return _compile_inference(
            gm, virtual_mesh, avals, batch_invars, num_micro_batches,
            stage_option, tic, time.perf_counter() - tic)
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
    fwd_stage_layer_ids, submeshes, stage_dp_info = \
        cluster_layers_and_slice_mesh(
            num_layers, virtual_mesh, stage_option, layer_comps=fwd_comps,
            num_micro_batches=num_micro_batches, schedule=pipeline_schedule)
    mesh_devices = _stage_devices(submeshes)
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
        mesh_devices=mesh_devices, fwd_stages=fwd_stages,
        bwd_stages=bwd_stages, apply_comps=apply_comps, root=gm,
        schedule_name=pipeline_schedule,
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


def _stage_devices(submeshes) -> List[torch.device]:
    """The one device of each stage mesh; a wider mesh raises."""
    devices = []
    for s, sub in enumerate(submeshes):
        if sub.num_devices != 1:
            raise NotImplementedError(
                f"stage {s} has a mesh of {sub.num_devices} devices; "
                "intra-op sharding inside a stage is not ported yet "
                "(ROADMAP A.3): give each stage one device")
        devices.append(sub.devices.flat[0])
    return devices


def _compile_inference(gm: fx.GraphModule, virtual_mesh, avals,
                       batch_invars, num_micro_batches, stage_option, tic,
                       trace_seconds) -> PipeshardDriverExecutable:
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
    fwd_stage_layer_ids, submeshes, stage_dp_info = \
        cluster_layers_and_slice_mesh(
            len(computations), virtual_mesh, stage_option,
            layer_comps=computations, num_micro_batches=num_micro_batches,
            objective="inference")
    fwd_stages = [merge_computations([computations[i] for i in ids],
                                     f"stage_{s}_fwd")
                  for s, ids in enumerate(fwd_stage_layer_ids)]
    _prune_stage_outvars(fwd_stages, [], global_outvars)
    executable = PipeshardDriverExecutable(
        mesh_devices=_stage_devices(submeshes), fwd_stages=fwd_stages,
        bwd_stages=[], apply_comps=[], root=gm, schedule_name="inference",
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
