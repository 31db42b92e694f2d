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
reference to a value, so a value no instruction reads any more is freed.
A donated input that exactly one apply-grad graph reads (JAX's rule) is
overwritten by that graph with an output of its shape and dtype, or freed
right after it, so old and new state do not coexist; the other donated
inputs have their storage released after the step.

The register-file replay, threaded per-mesh dispatch and the overlap,
fault and telemetry hooks of the JAX driver are not ported yet (ROADMAP
A.5).
"""
import operator
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

aten = torch.ops.aten


def _aliases_its_input(node: fx.Node) -> bool:
    """Whether a node's result may share storage with a tensor it reads: a
    view, an in-place op, ``_unsafe_view`` or an item of such a result."""
    if node.target is operator.getitem:
        return True
    if node.target is aten._unsafe_view.default:
        return True
    schema = getattr(node.target, "_schema", None)
    return schema is not None and any(r.alias_info is not None
                                      for r in schema.returns)


def alias_donated_inputs(gm: fx.GraphModule, donate: Sequence[int],
                         invals: Sequence[Any]) -> Dict[int, int]:
    """Write outputs of ``gm`` into the storage of its donated inputs, the
    counterpart of XLA's input-output aliasing of donated buffers.

    ``donate`` are placeholder indices, ``invals`` the fake values of all
    placeholders.  Outputs are taken in the order the graph computes them;
    each computed (not viewed) output takes a donated input of its shape
    and dtype that nothing reads after it (through a view either), the one
    read last.  A ``copy_`` into that input follows the output's node, and
    every later use of the output reads the input instead, so the output's
    own tensor is freed at once.  Returns ``{output index: placeholder
    index}``; values are bit-identical."""
    graph = gm.graph
    nodes = list(graph.nodes)
    order = {n: i for i, n in enumerate(nodes)}
    placeholders = [n for n in nodes if n.op == "placeholder"]
    output = nodes[-1]
    outs = list(output.args[0])

    def last_read(p):
        seen, todo, last = {p}, [p], order[p]
        while todo:
            for user in todo.pop().users:
                last = max(last, order[user])
                if user not in seen and _aliases_its_input(user):
                    seen.add(user)
                    todo.append(user)
        return last

    def key(val):
        return (tuple(val.shape), val.dtype)

    free = {i: (key(invals[i]), last_read(placeholders[i])) for i in donate
            if isinstance(invals[i], torch.Tensor)}
    pairs, done = {}, set()
    computed = sorted((order[o], j, o) for j, o in enumerate(outs)
                      if isinstance(o, fx.Node) and o.op == "call_function"
                      and not _aliases_its_input(o))
    for pos, j, o in computed:
        val = o.meta.get("val")
        if o in done or not isinstance(val, torch.Tensor):
            continue
        fits = [(last, i) for i, (k, last) in free.items()
                if k == key(val) and last <= pos]
        if not fits:
            continue
        _, i = max(fits)
        del free[i]
        done.add(o)
        with graph.inserting_after(o):
            copied = graph.call_function(aten.copy_.default,
                                         (placeholders[i], o))
        copied.meta = dict(o.meta)
        o.replace_all_uses_with(copied,
                                delete_user_cb=lambda u, c=copied: u is not c)
        pairs[j] = i
    gm.recompile()
    return pairs


class StageExecutable:
    """One computation as a ``GraphModule`` on one mesh's device, run
    without autograd.  ``donate``: indices of invars the graph may write
    its outputs into (``alias_donated_inputs``); those it does not write
    are listed in ``free_after``."""

    def __init__(self, comp: PipelineComputation, mesh_id: int,
                 device: torch.device, root: torch.nn.Module,
                 donate: Sequence[int] = ()):
        self.name = comp.name
        self.mesh_id = mesh_id
        self.invars = list(comp.invars)
        self.outvars = list(comp.outvars)
        self.num_nodes = len(comp.nodes)
        self.module = comp.get_runnable(root, device)
        self.aliased = alias_donated_inputs(
            self.module, donate, [v.meta.get("val") for v in self.invars])
        written = set(self.aliased.values())
        self.free_after = [i for i in donate if i not in written]

    def __call__(self, args):
        with torch.no_grad():
            return self.module(*args)


def _to_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x) if isinstance(x, np.ndarray) else x,
                           dtype=dtype, device=device)


def _release(x: torch.Tensor, keep_ptrs):
    """Free the storage of a donated input right after its one reader,
    unless an undonated argument shares it."""
    storage = x.untyped_storage()
    if storage.data_ptr() not in keep_ptrs and storage.resizable():
        storage.resize_(0)


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
        # JAX's rule: a donated state input that exactly one apply
        # computation reads is donated to it, so old and new state never
        # coexist (an input the step returns as it is stays)
        returned = set(v for v in global_outvars if isinstance(v, fx.Node))
        donated_global = {v for v, d in zip(global_invars, donated_invars)
                          if d and v not in returned}
        use_count: Dict[fx.Node, int] = {}
        for comp in apply_comps:
            for v in comp.invars:
                use_count[v] = use_count.get(v, 0) + 1
        self.apply_execs = [
            StageExecutable(c, m, self.mesh_devices[m], root, donate=[
                i for i, v in enumerate(c.invars)
                if v in donated_global and use_count[v] == 1])
            if c.nodes or c.outvars else None
            for m, c in enumerate(apply_comps)]
        index = {v: i for i, v in enumerate(global_invars)}
        self._written_inputs = sorted(
            index[e.invars[i]] for e in self.apply_execs if e is not None
            for i in e.aliased.values())
        self.schedule = create_pipeline_schedule(
            schedule_name, num_stages=2 * self.num_meshes,
            num_meshes=self.num_meshes, num_batch=num_micro_batches)
        self._emit()
        # set by the compiler: the seconds of the trace and of the rest
        self.trace_seconds = self.compile_seconds = 0.0
        # set by parallelize: the seconds of auto donation's fake pass
        self.donation_seconds = 0.0
        # set by the compiler: the forward layer computations, and what
        # the stage DP decided when it chose the stages
        self.fwd_layer_comps: List[PipelineComputation] = []
        self.stage_dp_info = None
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
        inputs = self._unshare_written_inputs(flat_args)
        undonated = {x.untyped_storage().data_ptr()
                     for x, d in zip(flat_args, self.donated_invars)
                     if isinstance(x, torch.Tensor) and not d}
        for v, meshes in self.input_place.items():
            i = self._input_index[v]
            for m in meshes:
                x = _to_tensor(inputs[i], self.in_dtypes[i],
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
                for i in inst.executable.free_after:
                    _release(env[inst.input_keys[i]].pop(m), undonated)
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

    def _unshare_written_inputs(self, flat_args):
        """The arguments, with a copy of each one an apply graph writes in
        place whose storage another argument shares."""
        ptrs = [x.untyped_storage().data_ptr()
                if isinstance(x, torch.Tensor) else None for x in flat_args]
        shared = [i for i in self._written_inputs
                  if ptrs[i] is not None and ptrs.count(ptrs[i]) > 1]
        if not shared:
            return flat_args
        args = list(flat_args)
        for i in shared:
            args[i] = args[i].clone()
        return args

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
