"""Gradient accumulation by rewriting the traced step.

Counterpart of ``alpa_tpu/shard_parallel/grad_acc.py``, over the joint
aten graph of ``trace_flat`` in place of a jaxpr.  The step is traced at
microbatch shapes and split at the gradient marker (inserted by
``alpa_tpu_torch.grad``/``value_and_grad``) into a compute-grad graph and
an apply-grad graph.  The compute-grad graph runs once per microbatch and
adds every gradient-marked value (the loss beside the gradients) into an
accumulator of its own, in place (``compute_grad_to_accumulate_grad``);
the apply-grad graph divides the sums by the number of microbatches (the
mean, ``apply_grad_get_mean``) and runs once.  The JAX package runs the
microbatch loop as a ``lax.scan`` inside one program; here the executable
runs it (``mesh_executable.GradAccMeshExecutable``).  Over more than one
device the step traced at microbatch shapes (``trace_for_grad_accumulation``)
is partitioned whole (``spmd_partition.py``), and the executable keeps
each device's partial gradients in its accumulators until one reduction
before apply-grad.

Quantized gradient sync (``global_config.grad_quantize``, JAX's
``grad_acc.py:150-215``): each microbatch's contribution to an eligible
accumulator (``quantized_accumulators``: fp32 or bf16, at least
``grad_quantize_min_bytes``) goes through the gradient codec before it is
added, with stochastic rounding and an error-feedback residual carried
from microbatch to microbatch within the step (``new_grad_codec``: the
uniforms from a generator seeded 0 each step, as JAX splits
``PRNGKey(0)``).  Over N devices the codec takes the microbatch's whole
gradient, as JAX's does: partial sums are reduced first and the sum is
kept by the first device of each reduction group only
(``compress_spmd``).  At "off" nothing changes.
"""
import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.apply_grad import (
    apply_grad_get_mean, compute_grad_to_accumulate_grad,
    split_compute_grad_and_apply_grad)
from alpa_tpu_torch.pipeline_parallel.computation import PipelineComputation
from alpa_tpu_torch.pipeline_parallel.primitive_def import is_marker
from alpa_tpu_torch.shard_parallel.solver import trace_flat


@dataclasses.dataclass
class GradAccProgram:
    """The rewritten step: ``compute`` takes its ``invars`` (placeholders of
    the traced graph) and then one accumulator per ``acc_vals`` entry, and
    returns the accumulators; ``apply`` takes its invars (placeholders, and
    the marked values, which the executable feeds with the accumulators
    ``post_acc`` names) and returns ``outvars``.  ``outputs``: per flat
    output, ("apply", index into ``apply.outvars``), ("input", flat
    argument index) or ("literal", value)."""
    root: fx.GraphModule
    placeholders: List[fx.Node]
    compute: PipelineComputation
    apply: PipelineComputation
    acc_vals: List[torch.Tensor]
    post_acc: Dict[fx.Node, int]
    outputs: List[Tuple[str, Any]]


def split_graph_at_grad_marker(graph: fx.Graph):
    """``split_compute_grad_and_apply_grad``'s split at the one gradient
    marker, or None without one."""
    markers = [n for n in graph.nodes if is_marker(n, "grad")]
    if not markers:
        return None
    if len(markers) > 1:
        raise ValueError(
            "Gradient accumulation requires exactly one alpa_tpu_torch.grad "
            f"/ value_and_grad call; found {len(markers)} gradient markers.")
    return split_compute_grad_and_apply_grad(graph)


def microbatch_avals(in_avals: Sequence[Tuple], batch_flat_idx,
                     num_micro_batches: int) -> List[Tuple]:
    """The flat arguments' (shape, dtype) at microbatch shapes."""
    batch_set = set(batch_flat_idx)
    out = []
    for i, (shape, dtype) in enumerate(in_avals):
        if i in batch_set:
            b = shape[0]
            if b % num_micro_batches != 0:
                raise ValueError(
                    f"Batch size {b} of arg {i} is not divisible by "
                    f"num_micro_batches={num_micro_batches}")
            shape = (b // num_micro_batches,) + tuple(shape[1:])
        out.append((tuple(shape), dtype))
    return out


def trace_for_grad_accumulation(fun: Callable, in_avals: Sequence[Tuple],
                                batch_flat_idx: Sequence[int],
                                num_micro_batches: int, device):
    """``fun`` (flat signature, full-batch ``in_avals``) traced at
    microbatch shapes, and its split at the gradient marker
    (``split_compute_grad_and_apply_grad``), checked: nothing but inputs
    and marked values crosses the marker, and no batch argument is read
    after it."""
    gm = trace_flat(fun, microbatch_avals(in_avals, batch_flat_idx,
                                          num_micro_batches), device)
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    output = next(n for n in graph.nodes if n.op == "output")
    split = split_graph_at_grad_marker(graph)
    if split is None:
        raise ValueError(
            "num_micro_batches > 1 requires using alpa_tpu_torch.grad or "
            "alpa_tpu_torch.value_and_grad inside the parallelized function "
            "so the gradient boundary can be found.")
    marker, compute_nodes, grad_pairs, apply_nodes = split

    # nothing but inputs and marked values crosses the marker
    computed = {n for n in compute_nodes if n.op == "call_function"}
    for node in apply_nodes:
        for v in node.all_input_nodes:
            if v in computed:
                raise ValueError(
                    "A value computed before alpa_tpu_torch.grad is used "
                    f"after it without passing through the gradient marker: "
                    f"{v}. Return it through the loss/aux outputs instead.")
    outs = list(output.args[0])
    for v in outs:
        if isinstance(v, fx.Node) and v in computed:
            raise ValueError(
                "A function output bypasses the gradient marker; with "
                "num_micro_batches > 1 every output must be derived from "
                "marked values or inputs.")
    batch_vars = {placeholders[i] for i in batch_flat_idx}
    for node in apply_nodes:
        if any(v in batch_vars for v in node.all_input_nodes):
            raise ValueError(
                "A batch argument is used after alpa_tpu_torch.grad; with "
                "num_micro_batches > 1 the apply-gradient section may only "
                "consume state and gradient-marked values.")
    return gm, split


def rewrite_for_grad_accumulation(fun: Callable, in_avals: Sequence[Tuple],
                                  batch_flat_idx: Sequence[int],
                                  num_micro_batches: int,
                                  device) -> GradAccProgram:
    """Trace ``fun`` (flat signature, full-batch ``in_avals``) at
    microbatch shapes and split it into the accumulating compute-grad
    graph and the mean-taking apply-grad graph
    (``alpa_tpu/shard_parallel/grad_acc.py:56``)."""
    gm, split = trace_for_grad_accumulation(fun, in_avals, batch_flat_idx,
                                            num_micro_batches, device)
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    output = next(n for n in graph.nodes if n.op == "output")
    marker, compute_nodes, grad_pairs, apply_nodes = split

    # compute-grad: every marked value added into its accumulator
    nodes = [n for n in compute_nodes if n.op == "call_function"]
    pres = list(dict.fromkeys(pre for pre, _ in grad_pairs))
    invars = list(dict.fromkeys(
        v for n in nodes for v in n.all_input_nodes
        if v.op == "placeholder"))
    compute = PipelineComputation("compute_grad", invars, pres, nodes)
    # appends the accumulators to the invars, their sums as the outvars
    acc_info = compute_grad_to_accumulate_grad(graph, [compute], pres)
    acc_index = {g: k for k, g in enumerate(pres)}
    post_acc = {post: acc_index[pre] for pre, post in grad_pairs}

    # apply-grad: the means first, then the update
    apply_nodes = apply_grad_get_mean(graph, marker, apply_nodes,
                                      grad_pairs, num_micro_batches)
    defined = set(apply_nodes)
    apply_in = list(dict.fromkeys(
        v for n in apply_nodes for v in n.all_input_nodes
        if v not in defined and v.op != "get_attr"))
    index = {v: i for i, v in enumerate(placeholders)}
    apply_out, outputs = [], []
    for v in list(output.args[0]):
        if isinstance(v, fx.Node) and v in defined:
            outputs.append(("apply", len(apply_out)))
            apply_out.append(v)
        elif isinstance(v, fx.Node) and v.op == "placeholder":
            outputs.append(("input", index[v]))
        else:
            outputs.append(("literal", v))
    apply = PipelineComputation("apply_grad", apply_in, apply_out,
                                apply_nodes)
    return GradAccProgram(
        root=gm, placeholders=placeholders, compute=compute, apply=apply,
        acc_vals=[g.meta["val"] for g in pres], post_acc=post_acc,
        outputs=outputs)


def quantized_accumulators(acc_vals: Sequence[torch.Tensor]
                           ) -> Dict[int, str]:
    """Accumulator index -> the gradient codec's mode, of each marked
    value the codec takes under ``global_config.grad_quantize`` (JAX's
    ``q_set``); empty at "off"."""
    from alpa_tpu_torch.global_env import global_config
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import grad_eligible
    mode = global_config.grad_quantize
    if mode == "off":
        return {}
    return {j: mode for j, v in enumerate(acc_vals)
            if v is not None and grad_eligible(tuple(v.shape), v.dtype, mode)}


def new_grad_codec(quantized: Dict[int, str], device: torch.device):
    """The codec state of one step (a generator seeded 0, no residuals),
    or None without quantized accumulators."""
    if not quantized:
        return None
    from alpa_tpu_torch.global_env import global_config
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import GradCodecState
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    return GradCodecState(next(iter(quantized.values())), generator,
                          global_config.grad_error_feedback)


def compress_spmd(pre: List[List[Any]], quantized: Dict[int, str], codecs,
                  layouts, logical_mesh) -> List[List[Any]]:
    """One microbatch's marked values per device (``pre``), those of the
    ``quantized`` accumulators through the codec of each device
    (``codecs``, all seeded alike): a value left as a partial sum over
    some mesh axes is all-reduced over them first, each device compresses
    its block of the whole value, and only the first device of each
    reduction group keeps it (the others add zeros), so that the apply
    part's reduction returns the compressed sum exactly."""
    from alpa_tpu_torch.shard_parallel.collectives import (CollectiveRecord,
                                                           run_collective)
    out = [list(vals) for vals in pre]
    for j in quantized:
        vals = [vals[j] for vals in pre]
        partial = layouts[j].partial if layouts[j] is not None else ()
        for ax in partial:
            record = CollectiveRecord("all_reduce", ax,
                                      tuple(vals[0].shape), vals[0].dtype,
                                      0, "")
            vals = run_collective(record, vals, logical_mesh)
        for p, v in enumerate(vals):
            g_hat = codecs[p].compress((p, j), v)
            keep = all(logical_mesh.coords(p)[ax] == 0 for ax in partial)
            out[p][j] = g_hat if keep else torch.zeros_like(g_hat)
    return out
