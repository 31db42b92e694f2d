"""Compile a function into a single-mesh executable.

Counterpart of ``alpa_tpu/shard_parallel/compile_executable.py``
(``compile_shard_executable``), in JAX's order:

1. plan the input specs on the full-batch program: the ILP
   (``solver.plan_auto_sharding``) or, for ``DataParallel`` and the ZeRO
   methods, the rules (``auto_sharding.plan_rule_based``);
2. apply the user's manual specs;
3. rewrite the step for gradient accumulation (``grad_acc.py``);
4. pin each state output to its input's spec.

On a one-device mesh every spec is replicated and the ILP has one
answer, so nothing is traced for the plan.  A plan over more than one
device is made and then refused: executing it needs the multi-device
executor (ROADMAP A.3.2).
"""
import time
from typing import Callable, Optional, Sequence

from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
from alpa_tpu_torch.mesh_executable import (GradAccMeshExecutable,
                                            NormalMeshExecutable)
from alpa_tpu_torch.shard_parallel.auto_sharding import (AutoShardingOption,
                                                         plan_rule_based)
from alpa_tpu_torch.shard_parallel.manual_sharding import (
    ManualShardingOption, apply_manual_shardings, flat_specs_from_tree)
from alpa_tpu_torch.shard_parallel.sharding_spec import (Aval,
                                                         replicated_spec)


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
    tic = time.perf_counter()
    batch_flat_idx = [i for i, b in enumerate(batch_invars) if b]
    plan_info = {"shape": (1, 1), "graph": None, "logical_mesh": None}

    # ---- 1. plan the input specs on the full-batch program ----
    if physical_mesh.num_devices == 1:
        in_specs = [replicated_spec(len(shape)) for shape, _ in avals]
    elif as_option.enable_auto_sharding and \
            not as_option.force_data_parallel:
        from alpa_tpu_torch.shard_parallel.solver import plan_auto_sharding
        logical_mesh, in_specs, solved, shape = plan_auto_sharding(
            fun, avals, in_paths, batch_flat_idx, physical_mesh, as_option)
        plan_info.update(shape=shape, graph=solved,
                         logical_mesh=logical_mesh)
    else:
        shape = tuple(as_option.logical_mesh_shape or
                      (physical_mesh.num_devices, 1))
        in_specs = list(plan_rule_based(
            shape, [Aval(tuple(s), d) for s, d in avals], in_paths,
            batch_flat_idx, as_option))
        plan_info.update(shape=shape)
    plan_seconds = time.perf_counter() - tic

    # ---- 2. the user's specs ----
    if manual_sharding_option is not None:
        manual = flat_specs_from_tree(
            manual_sharding_option.in_axis_resources, in_tree, len(avals))
        if manual is not None:
            in_specs = apply_manual_shardings(in_specs, manual)

    if physical_mesh.num_devices != 1:
        raise NotImplementedError(
            f"ShardParallel over {physical_mesh.num_devices} devices: the "
            f"plan is made (logical mesh {tuple(plan_info['shape'])}), but "
            "executing it needs the multi-device executor, which is not "
            "ported yet (ROADMAP A.3.2)")

    # ---- 3. gradient accumulation ----
    device = physical_mesh.devices.flat[0]
    trace_tic = time.perf_counter()
    if num_micro_batches is not None and num_micro_batches > 1:
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
        trace_seconds = 0.0
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

