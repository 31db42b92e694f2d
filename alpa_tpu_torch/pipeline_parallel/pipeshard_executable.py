"""The pipeshard driver executable: stage graphs on their meshes and the
static instruction program that runs them.

Counterpart of ``alpa_tpu/pipeline_parallel/pipeshard_executable.py``.
Every stage is a ``GraphModule`` copied out of the traced train step and
bound to its mesh's one device; no autograd runs at run time, since the
backward stages are graphs of their own.  ``_emit`` walks the schedule and
emits RUN, RESHARD and FREE instructions; ``launch_on_driver`` places the
inputs (microbatch slices of the batch arguments, each other input on
every mesh that reads it), allocates the zero gradient accumulators and
interprets the program in one Python loop.  FREE drops the program's
reference to a value, so a value no instruction reads any more is freed;
donated inputs have their storage released after the step.

The register-file replay, threaded per-mesh dispatch and the overlap,
fault and telemetry hooks of the JAX driver are not ported yet (ROADMAP
A.5).
"""
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.computation import PipelineComputation
from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import reshard
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
    PipelineInstruction, PipelineInstType, emit_free_instructions,
    partition_streams)
from alpa_tpu_torch.pipeline_parallel.schedules import \
    create_pipeline_schedule


class StageExecutable:
    """One computation as a ``GraphModule`` on one mesh's device, run
    without autograd."""

    def __init__(self, comp: PipelineComputation, mesh_id: int,
                 device: torch.device, root: torch.nn.Module):
        self.name = comp.name
        self.mesh_id = mesh_id
        self.invars = list(comp.invars)
        self.outvars = list(comp.outvars)
        self.num_nodes = len(comp.nodes)
        self.module = comp.get_runnable(root, device)

    def __call__(self, args):
        with torch.no_grad():
            return self.module(*args)


def _to_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray) else x,
                           dtype=dtype, device=device)


class PipeshardDriverExecutable:
    """Stages, schedule and instruction program of one pipeshard train
    step."""

    def __init__(self, *, mesh_devices: Sequence[torch.device],
                 fwd_stages: List[PipelineComputation],
                 bwd_stages: List[PipelineComputation],
                 apply_comps: List[PipelineComputation],
                 root: torch.nn.Module, schedule_name: str,
                 num_micro_batches: int, global_invars: List[fx.Node],
                 global_outvars: List[Any], in_dtypes: Sequence[torch.dtype],
                 batch_invars: Sequence[bool],
                 donated_invars: Sequence[bool], grad_pairs,
                 acc_info: Dict[fx.Node, Tuple[fx.Node, fx.Node, int]]):
        self.mesh_devices = list(mesh_devices)
        self.num_meshes = len(fwd_stages)
        self.num_micro_batches = num_micro_batches
        self.global_invars = global_invars
        self.global_outvars = global_outvars
        self.in_dtypes = list(in_dtypes)
        self.batch_invars = list(batch_invars)
        self.donated_invars = list(donated_invars)
        self.grad_pairs = grad_pairs
        self.acc_info = acc_info
        self.acc_pairs = {acc: summed for acc, summed, _ in acc_info.values()}
        self._summed = set(self.acc_pairs.values())
        self.stage_execs = [
            StageExecutable(c, s, self.mesh_devices[s], root)
            for s, c in enumerate(fwd_stages)] + [
            StageExecutable(c, s, self.mesh_devices[s], root)
            for s, c in enumerate(bwd_stages)]
        self.num_fwd_stages = len(fwd_stages)
        self.apply_execs = [
            StageExecutable(c, m, self.mesh_devices[m], root)
            if c.nodes or c.outvars else None
            for m, c in enumerate(apply_comps)]
        self.schedule = create_pipeline_schedule(
            schedule_name, num_stages=2 * self.num_meshes,
            num_meshes=self.num_meshes, num_batch=num_micro_batches)
        self._emit()
        # set by the compiler: the seconds of the trace and of the rest
        self.trace_seconds = self.compile_seconds = 0.0
        self.executed_resharding_bytes = 0
        self._peak_bytes = -1

    # ---- emission ----
    def _stage_exec_for(self, stage_idx: int) -> StageExecutable:
        s = self.num_fwd_stages
        if stage_idx < s:
            return self.stage_execs[stage_idx]
        return self.stage_execs[s + 2 * s - 1 - stage_idx]

    def _apply_topo_order(self) -> List[int]:
        """Apply computations in the order of their cross-mesh data
        dependencies (the compiler made them acyclic)."""
        outs_of = {v: m for m, e in enumerate(self.apply_execs)
                   if e is not None for v in e.outvars}
        order, done = [], set()

        def visit(m):
            if m in done:
                return
            done.add(m)
            for v in self.apply_execs[m].invars:
                if v in outs_of and outs_of[v] != m:
                    visit(outs_of[v])
            order.append(m)

        for m, e in enumerate(self.apply_execs):
            if e is not None:
                visit(m)
        return order

    def _emit(self):
        ginvar_idx = self._input_index = {
            v: i for i, v in enumerate(self.global_invars)}
        batch_var = {v for v, b in zip(self.global_invars, self.batch_invars)
                     if b}
        post_alias = {post: self.acc_info[pre][1]
                      for pre, post in self.grad_pairs if pre in self.acc_info}
        instructions: List[PipelineInstruction] = []
        location: Dict[Tuple[Any, int], Dict[int, None]] = {}
        # global input -> meshes it is placed on at launch
        self.input_place: Dict[fx.Node, List[int]] = {}
        self.acc_allocs: List[Tuple[fx.Node, int]] = []
        first_mb_of: Dict[int, int] = {}

        def key_of(v, mb, first_mb):
            if v in self.acc_pairs:
                return (v, -1) if mb == first_mb else (self.acc_pairs[v], -1)
            if v in post_alias:
                return (post_alias[v], -1)
            if v in ginvar_idx:
                return (v, mb) if v in batch_var else (v, -1)
            return (v, mb)

        def ensure_on_mesh(key, mesh_id, info):
            v = key[0]
            if key not in location:
                if v not in ginvar_idx:
                    raise ValueError(f"{info} reads {v}, which no earlier "
                                     "instruction produces")
                place = self.input_place.setdefault(v, [])
                if mesh_id not in place:
                    place.append(mesh_id)
                location[key] = dict.fromkeys(place)
            if mesh_id in location[key]:
                return
            if v in ginvar_idx and v not in batch_var:
                # a non-batch global input read on several meshes (the
                # tied embedding) is placed on each of them at launch
                self.input_place[v].append(mesh_id)
                location[key][mesh_id] = None
                return
            instructions.append(PipelineInstruction(
                PipelineInstType.RESHARD, var_key=key,
                src_mesh=next(iter(location[key])), dst_mesh=mesh_id,
                info=info))
            location[key][mesh_id] = None

        def emit_run(exec_: StageExecutable, stage_id: int, mb: int,
                     mesh_id: int):
            first_mb = first_mb_of.setdefault(id(exec_), mb)
            in_keys = []
            for v in exec_.invars:
                k = key_of(v, mb, first_mb)
                if v in self.acc_pairs and k == (v, -1):
                    self.acc_allocs.append((v, mesh_id))
                    location[k] = {mesh_id: None}
                ensure_on_mesh(k, mesh_id, exec_.name)
                in_keys.append(k)
            out_keys = [(v, -1) if v in self._summed else (v, mb)
                        for v in exec_.outvars]
            for k in out_keys:
                location[k] = {mesh_id: None}
            instructions.append(PipelineInstruction(
                PipelineInstType.RUN, stage_id=stage_id, micro_batch=mb,
                input_keys=in_keys, output_keys=out_keys, dst_mesh=mesh_id,
                info=exec_.name, executable=exec_))

        for tick in self.schedule.schedules:
            for mesh_id, task in enumerate(tick):
                if task is None:
                    continue
                mb, stage_idx = task
                exec_ = self._stage_exec_for(stage_idx)
                if exec_.invars or exec_.outvars:
                    emit_run(exec_, self.stage_execs.index(exec_), mb,
                             mesh_id)
        for m in self._apply_topo_order():
            emit_run(self.apply_execs[m], -1, -1, m)

        self.output_specs = []
        for v in self.global_outvars:
            if not isinstance(v, fx.Node):
                self.output_specs.append(("literal", v))
                continue
            k = (post_alias.get(v, v), -1)
            if k in location:
                self.output_specs.append(("env", (k, next(iter(location[k])))))
            elif v in ginvar_idx:
                self.output_specs.append(("input", ginvar_idx[v]))
            else:
                raise ValueError(f"cannot trace global output {v} to a "
                                 "stage output")
        protected = {(k[0], k[1], m) for kind, p in self.output_specs
                     if kind == "env" for k, m in [p]}
        self.instructions = emit_free_instructions(instructions, protected)

    # ---- execution ----
    def launch_on_driver(self, *flat_args):
        devices = list(dict.fromkeys(d for d in self.mesh_devices
                                     if d.type == "cuda"))
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
        env: Dict[Tuple[Any, int], Dict[int, torch.Tensor]] = {}
        n_mb = self.num_micro_batches
        for v, meshes in self.input_place.items():
            i = self._input_index[v]
            for m in meshes:
                x = _to_tensor(flat_args[i], self.in_dtypes[i],
                               self.mesh_devices[m])
                if self.batch_invars[i]:
                    for mb, part in enumerate(x.chunk(n_mb)):
                        env.setdefault((v, mb), {})[m] = part
                else:
                    env.setdefault((v, -1), {})[m] = x
        for acc, m in self.acc_allocs:
            val = acc.meta["val"]
            env[(acc, -1)] = {m: torch.zeros(val.shape, dtype=val.dtype,
                                             device=self.mesh_devices[m])}
        moved = 0
        for inst in self.instructions:
            if inst.opcode == PipelineInstType.RUN:
                m = inst.dst_mesh
                outs = inst.executable([env[k][m] for k in inst.input_keys])
                for k, o in zip(inst.output_keys, outs):
                    env.setdefault(k, {})[m] = o
            elif inst.opcode == PipelineInstType.RESHARD:
                x, n = reshard(env[inst.var_key][inst.src_mesh],
                               self.mesh_devices[inst.dst_mesh])
                env[inst.var_key][inst.dst_mesh] = x
                moved += n
            else:
                for v, i, m in inst.free_keys:
                    env[(v, i)].pop(m, None)
        self.executed_resharding_bytes = moved
        outs = []
        for kind, payload in self.output_specs:
            if kind == "literal":
                outs.append(payload)
            elif kind == "env":
                k, m = payload
                outs.append(env[k][m])
            else:
                outs.append(flat_args[payload])
        del env
        self._free_donated(flat_args, outs)
        if devices:
            self._peak_bytes = max(torch.cuda.max_memory_allocated(d)
                                   for d in devices)
        return outs

    def _free_donated(self, flat_args, outs):
        """Release the storage of donated input tensors that no output and
        no undonated input shares (the counterpart of JAX deleting a
        donated buffer)."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(x) for x in outs if isinstance(x, torch.Tensor)}
        keep.update(ptr(x) for x, d in zip(flat_args, self.donated_invars)
                    if isinstance(x, torch.Tensor) and not d)
        for x, d in zip(flat_args, self.donated_invars):
            if d and isinstance(x, torch.Tensor) and ptr(x) not in keep:
                storage = x.untyped_storage()
                if storage.resizable():
                    storage.resize_(0)

    def __call__(self, *args):
        return self.launch_on_driver(*args)

    # ---- introspection ----
    def get_schedule_text(self) -> str:
        return self.schedule.pprint_schedule()

    def get_instruction_text(self) -> str:
        return "\n".join(repr(i) for i in self.instructions)

    def get_instruction_counts(self) -> Dict[str, int]:
        counts = {t.name: 0 for t in PipelineInstType}
        for inst in self.instructions:
            counts[inst.opcode.name] += 1
        return counts

    def get_instruction_streams(self):
        return partition_streams(self.instructions, self.num_meshes)

    def get_total_allocation_size(self) -> int:
        """Peak bytes the CUDA allocator held over the last launch, the
        largest over the meshes' devices (-1 before a launch on CUDA)."""
        return self._peak_bytes
