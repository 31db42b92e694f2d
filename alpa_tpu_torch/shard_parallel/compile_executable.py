"""Compile a function into a single-mesh executable.

Counterpart of ``alpa_tpu/shard_parallel/compile_executable.py``
(``compile_shard_executable``), in JAX's order:

1. plan the input specs on the full-batch program: the ILP
   (``solver.plan_auto_sharding``, on the step traced once here and
   reused) or, for ``DataParallel`` and the ZeRO methods, the rules
   (``auto_sharding.plan_rule_based``);
2. apply the user's manual specs;
3. rewrite the step for gradient accumulation (``grad_acc.py``);
4. pin each state output to its input's spec.

On a one-device mesh every spec is replicated and the ILP has one
answer, so nothing is traced for the plan.  Over more than one device
the program that runs (the full-batch trace, or the trace at microbatch
shapes with accumulation) is planned again with its inputs pinned to the
final specs and partitioned (``spmd_partition.SpmdProgram``): solved by
the ILP after an ILP plan (``solver.solve_pinned``), and after a
rule-based plan propagated from the inputs as GSPMD propagates JAX's
(``solver.propagate_pinned``), the program's interior not re-planned.
"""
import time
from typing import Callable, Optional, Sequence

import torch

from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
from alpa_tpu_torch.mesh_executable import (GradAccMeshExecutable,
                                            NormalMeshExecutable)
from alpa_tpu_torch.shard_parallel.auto_sharding import (AutoShardingOption,
                                                         plan_rule_based)
from alpa_tpu_torch.shard_parallel.manual_sharding import (
    ManualShardingOption, apply_manual_shardings, flat_specs_from_tree)
from alpa_tpu_torch.shard_parallel.sharding_spec import (Aval,
                                                         replicated_spec,
                                                         spec_valid)


def _pin_state_out_specs(avals, in_specs, batch_invars, out_avals):
    """In order, each output leaf takes the spec of the first unclaimed
    non-batch input of its shape and dtype (state -> new state); others
    get None (the executor decides)."""
    unclaimed = {}
    for i, ((shape, dtype), is_batch) in enumerate(zip(avals, batch_invars)):
        if not is_batch:
            unclaimed.setdefault((tuple(shape), dtype), []).append(i)
    out = []
    for shape, dtype in out_avals:
        key = (tuple(shape), dtype)
        out.append(in_specs[unclaimed[key].pop(0)] if unclaimed.get(key)
                   else None)
    return out


def compile_shard_executable(fun: Callable,
                             physical_mesh: PhysicalDeviceMesh,
                             avals: Sequence,
                             in_tree,
                             in_paths: Sequence[str],
                             donated_invars: Sequence[bool],
                             batch_invars: Sequence[bool],
                             num_micro_batches: Optional[int],
                             as_option: AutoShardingOption,
                             manual_sharding_option: Optional[
                                 ManualShardingOption] = None):
    """The executable of ``fun`` (flat args in, flat outs) on
    ``physical_mesh``; ``avals`` are the flat arguments' (shape, dtype)."""
    from alpa_tpu_torch.shard_parallel.solver import (plan_auto_sharding,
                                                      trace_flat)
    tic = time.perf_counter()
    batch_flat_idx = [i for i, b in enumerate(batch_invars) if b]
    plan_info = {"shape": (1, 1), "graph": None, "logical_mesh": None,
                 "rule_based": False}
    device = physical_mesh.devices.flat[0]
    multi = physical_mesh.num_devices > 1
    grad_acc = num_micro_batches is not None and num_micro_batches > 1
    trace_seconds, traced = 0.0, None

    # ---- 1. plan the input specs on the full-batch program ----
    if not multi:
        in_specs = [replicated_spec(len(shape)) for shape, _ in avals]
    elif as_option.enable_auto_sharding and \
            not as_option.force_data_parallel:
        trace_tic = time.perf_counter()
        traced = trace_flat(fun, avals, device)
        trace_seconds += time.perf_counter() - trace_tic
        logical_mesh, in_specs, solved, shape = plan_auto_sharding(
            fun, avals, in_paths, batch_flat_idx, physical_mesh, as_option,
            traced=traced)
        plan_info.update(shape=shape, graph=solved,
                         logical_mesh=logical_mesh)
    else:
        shape = tuple(as_option.logical_mesh_shape or
                      (physical_mesh.num_devices, 1))
        in_specs = list(plan_rule_based(
            shape, [Aval(tuple(s), d) for s, d in avals], in_paths,
            batch_flat_idx, as_option))
        plan_info.update(shape=shape, rule_based=True,
                         logical_mesh=physical_mesh.get_logical_mesh(shape))
    plan_seconds = time.perf_counter() - tic - trace_seconds

    # ---- 2. the user's specs ----
    if manual_sharding_option is not None:
        manual = flat_specs_from_tree(
            manual_sharding_option.in_axis_resources, in_tree, len(avals))
        if manual is not None:
            in_specs = apply_manual_shardings(in_specs, manual)

    if multi:
        return _compile_spmd(
            fun, physical_mesh, avals, in_paths, donated_invars,
            batch_invars, num_micro_batches if grad_acc else None,
            as_option, in_specs, plan_info, traced, tic, trace_seconds,
            plan_seconds)

    # ---- 3. gradient accumulation ----
    trace_tic = time.perf_counter()
    if grad_acc:
        from alpa_tpu_torch.shard_parallel.grad_acc import \
            rewrite_for_grad_accumulation
        program = rewrite_for_grad_accumulation(
            fun, avals, batch_flat_idx, num_micro_batches, device)
        trace_seconds = time.perf_counter() - trace_tic
        executable = GradAccMeshExecutable(
            physical_mesh, program, avals, batch_invars, donated_invars,
            num_micro_batches)
        out_vals = [v.meta["val"] for v in program.apply.outvars]
        out_avals = []
        for kind, i in program.outputs:
            if kind == "apply":
                out_avals.append((tuple(out_vals[i].shape),
                                  out_vals[i].dtype))
            elif kind == "input":
                out_avals.append(tuple(avals[i]))
            else:
                out_avals.append(((), type(i)))
    else:
        executable = NormalMeshExecutable(physical_mesh, fun)
        out_avals = None

    # ---- 4. state outputs keep their inputs' specs ----
    executable.in_specs = list(in_specs)
    executable.out_specs = (None if out_avals is None else
                            _pin_state_out_specs(avals, in_specs,
                                                 batch_invars, out_avals))
    executable.plan = plan_info
    executable.plan_seconds = plan_seconds
    executable.trace_seconds = trace_seconds
    executable.compile_seconds = (time.perf_counter() - tic - trace_seconds
                                  - plan_seconds)
    return executable


def _compile_spmd(fun, physical_mesh, avals, in_paths, donated_invars,
                  batch_invars, num_micro_batches, as_option, in_specs,
                  plan_info, traced, tic, trace_seconds, plan_seconds):
    """Steps 3-4 over more than one device: the program that runs
    (traced at microbatch shapes with accumulation), its pinned solve, its
    partition, and the executable."""
    from alpa_tpu_torch.shard_parallel.solver import (propagate_pinned,
                                                      solve_pinned,
                                                      trace_flat)
    from alpa_tpu_torch.shard_parallel.spmd_partition import SpmdProgram
    batch_flat_idx = [i for i, b in enumerate(batch_invars) if b]
    device = physical_mesh.devices.flat[0]
    logical_mesh = plan_info["logical_mesh"]
    trace_tic = time.perf_counter()
    if num_micro_batches:
        from alpa_tpu_torch.shard_parallel.grad_acc import (
            microbatch_avals, trace_for_grad_accumulation)
        traced, _ = trace_for_grad_accumulation(
            fun, avals, batch_flat_idx, num_micro_batches, device)
        prog_avals = microbatch_avals(avals, batch_flat_idx,
                                      num_micro_batches)
    else:
        if traced is None:
            traced = trace_flat(fun, avals, device)
        prog_avals = list(avals)
    trace_seconds += time.perf_counter() - trace_tic
    # a spec the program's shapes cannot take (a batch dim the mesh does
    # not divide at microbatch size) is replicated, as JAX's rules do
    shape = tuple(logical_mesh.shape)
    in_specs = [tuple(spec) if spec_valid(Aval(tuple(s), d), spec, shape)
                else replicated_spec(len(s))
                for spec, (s, d) in zip(in_specs, prog_avals)]
    solve_tic = time.perf_counter()
    plan = propagate_pinned if plan_info["rule_based"] else solve_pinned
    graph, choice = plan(traced, prog_avals, in_paths, batch_flat_idx,
                         logical_mesh, as_option, in_specs)
    plan_seconds += time.perf_counter() - solve_tic
    out_node = next(n for n in traced.graph.nodes if n.op == "output")
    out_avals = []
    for v in out_node.args[0]:
        val = v.meta.get("val") if hasattr(v, "meta") else None
        out_avals.append((tuple(val.shape), val.dtype)
                         if isinstance(val, torch.Tensor) else
                         ((), type(v)))
    out_specs = _pin_state_out_specs(avals, in_specs, batch_invars,
                                     out_avals)
    program = SpmdProgram(traced, graph, choice, logical_mesh, in_specs,
                          out_specs, donated_invars)
    if num_micro_batches:
        executable = GradAccMeshExecutable(
            physical_mesh, None, avals, batch_invars, donated_invars,
            num_micro_batches, spmd=program, out_specs=out_specs)
    else:
        executable = NormalMeshExecutable(
            physical_mesh, fun, program, avals, donated_invars, out_specs)
    executable.out_avals = out_avals
    executable.in_specs = list(in_specs)
    executable.out_specs = out_specs
    plan_info.update(graph=(graph, choice), logical_mesh=logical_mesh)
    executable.plan = plan_info
    executable.plan_seconds = plan_seconds
    executable.trace_seconds = trace_seconds
    executable.compile_seconds = (time.perf_counter() - tic - trace_seconds
                                  - plan_seconds)
    return executable
