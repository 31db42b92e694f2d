"""The pipeshard driver executable: stage graphs on their meshes and the
static instruction program that runs them.

Counterpart of ``alpa_tpu/pipeline_parallel/pipeshard_executable.py``.
Every stage is a ``GraphModule`` copied out of the traced train step and
bound to its mesh's one device; no autograd runs at run time, since the
backward stages are graphs of their own.  ``_emit`` walks the schedule and
emits RUN, RESHARD and FREE instructions; a launch places the inputs
(microbatch slices of the batch arguments, each other input on every mesh
that reads it), allocates the zero gradient accumulators and runs the
program.  FREE drops the program's reference to a value.  A donated input
that exactly one apply-grad graph reads (JAX's rule) is overwritten by that
graph with an output of its shape and dtype, or freed right after it, so
old and new state do not coexist; the other donated inputs have their
storage released after the step.  A forward-only executable (the inference
path) has no backward stages and no apply-grad, and joins its batch
outputs over microbatches.

Dispatch makes the JAX driver's "auto" choice in ``_launch``: "overlap"
(the register-file lowering's dataflow graph, cross-mesh RESHARDs launched
early) where there are cross-mesh RESHARDs to overlap and
``overlap_resharding`` is on, else "registers" (the register-file lowering
in program order).  The JAX package's other modes stay as a private
switch for the tests and ``chip_smoke.py``
(``global_config._pipeline_dispatch_mode``): "threaded" runs the
per-mesh streams of ``partition_streams`` on worker threads, "sequential"
interprets the list in one loop; a requested mode that is not eligible
warns once and takes the "auto" choice.

On CUDA each stage run is a CUDA graph, the counterpart of the JAX
driver's compiled stage executable.  The first call runs the stage graphs
as they are (kernel builds, cuBLAS handles and workspaces); the second
captures every RUN of the step, in program order, as a graph of its own
(``CapturedRun``: one graph per stage and microbatch, so that a forward
replayed for microbatch 1 does not overwrite what microbatch 0's backward
reads), on one capture stream and into one memory pool per device, and
replays it; later calls replay.  Meshes of one device lend each other the
pool's freed memory, as eagerly; a graph waits for the last work on every
other stream that touched the pool before it.  Every tensor a graph reads
keeps its capture-time address: batch slices, inputs that arrive
converted or donated without being written in place, accumulators and
RESHARD destinations on another device are the executable's own buffers,
refilled each step; an input read where it is (an undonated tensor, or a
donated one the apply-grad writes in place) must come back at its
address.  If it does not, the step is captured again once, with that
input read from a buffer from then on (``last_dispatch_stats`` counts the
recaptures; the first warns).  Graph outputs keep their memory, so no
replay overwrites a value another mesh has still to read, and the outputs
a step returns are copied out of it.  In every mode but "sequential" each mesh's work goes on a CUDA stream of
its own; a cross-stream dependency becomes a CUDA event, and an overlapped
RESHARD a copy on a side stream that waits for its source's event.  The
flash kernels' launch counters advance by each graph's captured launches
at every replay.  ``_capture = False`` (a private switch for the tests and
``chip_smoke.py``) runs the stage graphs uncaptured, all on the current
stream.  The fault, flight-recorder and trace hooks of the JAX driver are
not ported (ROADMAP A.6).
"""
import functools
import logging
from contextlib import nullcontext
import operator
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import fx

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.ops import flash_attention as _flash
from alpa_tpu_torch.pipeline_parallel.computation import PipelineComputation
from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import reshard
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
    DispatchRaceChecker, PipelineInstruction, PipelineInstType,
    emit_free_instructions, lower_to_register_file, partition_streams)
from alpa_tpu_torch.pipeline_parallel.schedules import \
    create_pipeline_schedule

logger = logging.getLogger(__name__)
aten = torch.ops.aten

# "auto" and the JAX package's other modes, a private switch
DISPATCH_MODES = ("auto", "registers", "overlap", "sequential", "threaded")


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
    are listed in ``free_after``.  ``donate_idx``: every invar the graph
    writes in place or releases (for a backward stage the driver sets its
    accumulators), which the stream partition treats as a kill, as JAX
    treats a donated input."""

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
        self.donate_idx: Tuple[int, ...] = tuple(sorted(
            written | set(self.free_after)))

    def __call__(self, args):
        with torch.no_grad():
            return self.module(*args)


def launch_counts() -> Tuple[int, int, int]:
    """The flash kernels' launch counters (forward, dq, dk/dv)."""
    return (_flash.FLASH_FWD_LAUNCHES, _flash.FLASH_BWD_DQ_LAUNCHES,
            _flash.FLASH_BWD_DKV_LAUNCHES)


_COUNT_LOCK = threading.Lock()


def _set_launch_counts(counts):
    (_flash.FLASH_FWD_LAUNCHES, _flash.FLASH_BWD_DQ_LAUNCHES,
     _flash.FLASH_BWD_DKV_LAUNCHES) = counts


def _add_launch_counts(delta):
    if any(delta):
        with _COUNT_LOCK:
            _set_launch_counts(tuple(
                c + d for c, d in zip(launch_counts(), delta)))


def _view_of(t: torch.Tensor):
    """A tensor over ``t``'s memory that does not own it: what a replay
    hands on, so that the pool's memory goes on being reused between
    graphs as it was at capture."""
    storage = t.untyped_storage()
    raw = torch._C._construct_storage_from_data_pointer(
        storage.data_ptr(), t.device, storage.nbytes())
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        raw, t.storage_offset(), t.shape, t.stride())


class CapturedRun:
    """One RUN instruction's stage graph captured as a CUDA graph on
    ``stream`` into ``pool``.  A replay writes its outputs where the
    capture put them.  An output in an input's memory (an accumulator
    added into, a donated input written) is handed on as that input; any
    other is handed on as a view that owns no memory, so that a value the
    program has freed gives its memory back to the pool for the graphs
    captured after it, as eagerly.  Capture failing raises; nothing runs
    the graph eagerly in its place.  ``launches``: the flash kernel
    launches the capture recorded, which every replay adds to the counters
    (the wrappers, which count, run only at capture)."""

    def __init__(self, stage: StageExecutable, args: List[Any], pool,
                 stream):
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=pool,
                                                   stream=stream):
                outs = stage.module(*args)
        except Exception as e:
            raise RuntimeError(
                f"capturing stage graph {stage.name} as a CUDA graph failed; "
                "the stage is not run eagerly in its place") from e
        finally:
            self.launches = tuple(a - b for a, b in
                                  zip(launch_counts(), before))
            _set_launch_counts(before)
        self.graph = graph
        arg_of = {a.untyped_storage().data_ptr(): p
                  for p, a in enumerate(args) if isinstance(a, torch.Tensor)}
        # per output: ("arg", position, geometry or None) or ("pool", view)
        self._out_specs = []
        for o in outs:
            p = (arg_of.get(o.untyped_storage().data_ptr())
                 if isinstance(o, torch.Tensor) else None)
            if p is None:
                self._out_specs.append(("pool", _view_of(o) if isinstance(
                    o, torch.Tensor) else o))
                continue
            geometry = (tuple(o.shape), o.stride(), o.storage_offset())
            a = args[p]
            same = geometry == (tuple(a.shape), a.stride(),
                                a.storage_offset())
            self._out_specs.append(("arg", p, None if same else geometry))
        self._captured_outputs = list(outs)

    def first_outputs(self) -> List[Any]:
        """The capture's own outputs (owning their memory), for the step
        that captured the graph; replays return views."""
        outs, self._captured_outputs = self._captured_outputs, None
        return outs

    def __call__(self, args):
        # the inputs sit at the addresses the graph was captured on
        self.graph.replay()
        _add_launch_counts(self.launches)
        outs = []
        for spec in self._out_specs:
            if spec[0] == "pool":
                outs.append(spec[1])
            elif spec[2] is None:
                outs.append(args[spec[1]])
            else:
                outs.append(args[spec[1]].as_strided(*spec[2]))
        return outs


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


def _signature(x: torch.Tensor):
    return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)


def _on_stream(op, stream, waits, records):
    """``op`` enqueued on ``stream`` after the events ``waits``, recording
    the events ``records`` after it."""
    if not waits and not records:
        def run(regs, _op=op, _s=stream):
            with torch.cuda.stream(_s):
                _op(regs)
        return run

    def run(regs, _op=op, _s=stream, _w=waits, _r=records):
        with torch.cuda.stream(_s):
            for e in _w:
                _s.wait_event(e)
            _op(regs)
            for e in _r:
                e.record(_s)
    return run


class _CapturedStep:
    """The CUDA graphs of one executable's step and the buffers they read:
    ``runs[i]`` of each RUN, ``static[key]`` the executable's own input
    buffers (batch slices, converted or donated inputs, accumulators),
    ``reshard_bufs[i]`` the destination of each RESHARD to another device,
    ``direct[(arg, mesh)]`` the signature of each input a graph reads where
    it is; one memory pool and one capture stream per device (the allocator
    lends a pool's freed memory only to captures on the stream that freed
    it), one replay stream per mesh."""

    def __init__(self, devices, num_instructions: int):
        cards = list(dict.fromkeys(devices))
        self.pools = {d: torch.cuda.graph_pool_handle() for d in cards}
        self.capture_streams = {d: torch.cuda.Stream(d) for d in cards}
        self.mesh_streams = [torch.cuda.Stream(d) for d in devices]
        self.side_streams = {d: torch.cuda.Stream(d) for d in cards}
        self.runs: Dict[int, CapturedRun] = {}
        self.static: Dict[Tuple[Any, int, int], torch.Tensor] = {}
        self.batch_loads: List[Tuple[int, int, int, torch.Tensor]] = []
        self.copy_loads: List[Tuple[int, int, torch.Tensor]] = []
        self.acc_bufs: List[Tuple[int, torch.Tensor]] = []
        self.reshard_bufs: Dict[int, torch.Tensor] = {}
        self.direct: Dict[Tuple[int, int], Tuple] = {}
        # RUN index -> the last instruction on each other stream that touched
        # memory of the RUN's pool before it (a graph run in the pool, or a
        # value of the pool read): the pool may lend the RUN that memory
        self.reuse_deps: Dict[int, set] = {}
        self.events = [torch.cuda.Event() for _ in range(num_instructions)]
        # (output position, input, the input's buffer): a donated input
        # copied in each step gets its new value back in its buffer, which
        # the step returns (a view of it, ``handed``) and the next step
        # reads without a copy
        self.feedback: List[Tuple[int, int, torch.Tensor]] = []
        self.handed: Dict[int, Any] = {}
        self.transfers: Dict[int, Callable] = {}
        self.programs: Dict[str, Any] = {}
        self.pool_bytes: Optional[int] = None

    def mismatches(self, inputs) -> Tuple[set, set]:
        """The inputs the graphs cannot run on, as two sets of indices: the
        inputs read where they are that did not come back at their address;
        the inputs whose buffer the last step handed back as an output that
        came back as another tensor while the caller still holds that
        output (refilling the buffer would overwrite it).  Both empty: the
        step can be replayed."""
        moved = {i for (i, _), sig in self.direct.items()
                 if not (isinstance(inputs[i], torch.Tensor) and
                         _signature(inputs[i]) == sig)}
        held_back = set()
        for _, i, buf in self.feedback:
            held = self.handed.get(i)
            if held is not None and held() is not None and not (
                    isinstance(inputs[i], torch.Tensor) and
                    inputs[i].data_ptr() == buf.data_ptr()):
                held_back.add(i)
        return moved, held_back


class PipeshardDriverExecutable:
    """Stages, schedule and instruction program of one pipeshard step."""

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
        self.mesh_devices = [torch.device(d) for d in mesh_devices]
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
        self.has_bwd = bool(bwd_stages)
        self.stage_execs = [
            StageExecutable(c, s, self.mesh_devices[s], root)
            for s, c in enumerate(fwd_stages)] + [
            StageExecutable(c, s, self.mesh_devices[s], root)
            for s, c in enumerate(bwd_stages)]
        for e in self.stage_execs:
            # a backward stage adds into its accumulators in place
            e.donate_idx = tuple(i for i, v in enumerate(e.invars)
                                 if v in self.acc_pairs)
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
            schedule_name,
            num_stages=(2 if self.has_bwd else 1) * self.num_meshes,
            num_meshes=self.num_meshes, num_batch=num_micro_batches)
        self._emit()
        self._key_alias = self._shared_input_keys()
        self._instruction_streams = partition_streams(
            self.instructions, self.num_meshes, self._key_alias)
        self._has_cross_mesh = any(
            i.opcode == PipelineInstType.RESHARD and i.src_mesh != i.dst_mesh
            for i in self.instructions)
        self._register_programs: Dict[str, Any] = {}
        self._register_program = None
        self._eager = None
        self._warned_fallback = False
        self._race_checker = None
        self._acct_lock = threading.Lock()
        self._moved = 0
        self._keep_ptrs: set = set()
        self.last_dispatch_stats: Dict[str, Any] = {}
        # CUDA graphs: the first call warms up, the second captures
        self._use_graphs = all(d.type == "cuda" for d in self.mesh_devices)
        self._capture = True
        self._warm = False
        self._captured: Optional[_CapturedStep] = None
        self._returned_inputs: set = set()
        # inputs read from a buffer, and inputs whose buffer is handed back
        # to no output, after a recapture that they caused
        self._copy_in: set = set()
        self._no_feedback: set = set()
        self.capture_count = self.recapture_count = 0
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
            elif (v, 0) in location:
                # a per-microbatch output (inference): joined over them
                self.output_specs.append(("concat", (v, [
                    (mb, next(iter(location[(v, mb)])))
                    for mb in range(self.num_micro_batches)])))
            elif v in ginvar_idx:
                self.output_specs.append(("input", ginvar_idx[v]))
            else:
                raise ValueError(f"cannot trace global output {v} to a "
                                 "stage output")
        protected = set()
        for kind, payload in self.output_specs:
            if kind == "env":
                (k, m) = payload
                protected.add((k[0], k[1], m))
            elif kind == "concat":
                v, meshes = payload
                protected.update((v, mb, m) for mb, m in meshes)
        self.instructions = emit_free_instructions(instructions, protected)

    def _shared_input_keys(self) -> Dict[Tuple[Any, int, int],
                                         Tuple[Any, int, int]]:
        """A non-batch input placed on several meshes of one device is one
        tensor: map each of its keys to the first, so a write in place
        waits for every mesh's readers."""
        alias = {}
        for v, meshes in self.input_place.items():
            if self.batch_invars[self._input_index[v]]:
                continue
            first: Dict[torch.device, int] = {}
            for m in meshes:
                f = first.setdefault(self.mesh_devices[m], m)
                if f != m:
                    alias[(v, -1, m)] = (v, -1, f)
        return alias

    # ---- dispatch mode ----
    def _dispatch_mode(self) -> str:
        """JAX's choice in ``_launch``: a requested mode runs where it is
        eligible; "overlap" needs cross-mesh RESHARDs on more than one mesh
        and ``overlap_resharding``, and "auto" takes it then, registers
        otherwise."""
        mode = global_config._pipeline_dispatch_mode
        if mode not in DISPATCH_MODES:
            raise ValueError(f"_pipeline_dispatch_mode must be one of "
                             f"{DISPATCH_MODES}, got {mode!r}")
        overlap_ok = (self.num_meshes > 1 and self._has_cross_mesh and
                      global_config.overlap_resharding)
        if mode == "overlap" and not overlap_ok:
            if not self._warned_fallback:
                self._warned_fallback = True
                logger.warning(
                    "dispatch mode 'overlap' requested but there is "
                    "nothing to overlap (single mesh, no cross-mesh "
                    "RESHARDs, or overlap_resharding disabled); using "
                    "register dispatch")
            return "registers"
        if mode == "auto":
            return "overlap" if overlap_ok else "registers"
        return mode

    # ---- execution ----
    def launch_on_driver(self, *flat_args):
        mode = self._dispatch_mode()
        inputs = self._unshare_written_inputs(flat_args)
        self._moved = 0
        if self._use_graphs and self._capture and self._warm:
            outs = self._launch_graphs(flat_args, inputs, mode)
        else:
            # on CUDA the first call runs the stage graphs as they are, in
            # order: it builds the kernels and the cuBLAS state the capture
            # of the second call needs
            warm_up = self._use_graphs and self._capture
            outs = self._launch_eager(flat_args, inputs,
                                      "sequential" if warm_up else mode)
            self._warm = True
        self.executed_resharding_bytes = self._moved
        devices = list(dict.fromkeys(d for d in self.mesh_devices
                                     if d.type == "cuda"))
        if devices:
            self._peak_bytes = max(torch.cuda.max_memory_allocated(d)
                                   for d in devices)
        return outs

    def _placements(self, inputs):
        """``(key, value)`` of every input placement: each batch slice and
        each other input on every mesh that reads it."""
        n_mb = self.num_micro_batches
        for v, meshes in self.input_place.items():
            i = self._input_index[v]
            for m in meshes:
                x = _to_tensor(inputs[i], self.in_dtypes[i],
                               self.mesh_devices[m])
                if self.batch_invars[i]:
                    for mb, part in enumerate(x.chunk(n_mb)):
                        yield (v, mb, m), part, i
                else:
                    yield (v, -1, m), x, i

    def _run_eager(self, exec_: StageExecutable, args):
        outs = exec_(args)
        for i in exec_.free_after:
            _release(args[i], self._keep_ptrs)
        return outs

    def _transfer_eager(self, inst: PipelineInstruction):
        dst = self.mesh_devices[inst.dst_mesh]

        def transfer(x):
            y, n = reshard(x, dst)
            if n:
                with self._acct_lock:
                    self._moved += n
            return y
        return transfer

    def _launch_eager(self, flat_args, inputs, mode):
        """The stage graphs run as they are, on the current stream."""
        self._keep_ptrs = self._owned_ptrs() | {
            x.untyped_storage().data_ptr()
            for x, d in zip(flat_args, self.donated_invars)
            if isinstance(x, torch.Tensor) and not d}
        env: Dict[Tuple[Any, int, int], Any] = {}
        for key, x, _ in self._placements(inputs):
            env[key] = x
        for acc, m in self.acc_allocs:
            val = acc.meta["val"]
            env[(acc, -1, m)] = torch.zeros(val.shape, dtype=val.dtype,
                                            device=self.mesh_devices[m])
        runs, transfers = self._eager_tables()
        get = self._dispatch(mode, env, runs, transfers, None, graphs=False)
        outs = self._collect_outputs(flat_args, get, copy_out=False)
        returned = {x.untyped_storage().data_ptr() for x in outs
                    if isinstance(x, torch.Tensor)}
        self._returned_inputs = {
            i for i, x in enumerate(flat_args) if isinstance(x, torch.Tensor)
            and x.untyped_storage().data_ptr() in returned}
        self._free_donated(flat_args, outs)
        return outs

    # ---- the four dispatch loops over one value store ----
    def _dispatch(self, mode, env, runs, transfers, step, graphs):
        """Run the program in ``mode``; ``env`` holds the placed inputs by
        key.  Returns a getter of the values by key.  ``step`` (CUDA graphs)
        puts each mesh's work on its stream."""
        loop_tic = time.perf_counter()
        stats: Dict[str, Any] = {"mode": mode, "graphs": graphs,
                                 "n_instructions": len(self.instructions),
                                 "captures": self.capture_count,
                                 "recaptures": self.recapture_count}
        if mode in ("registers", "overlap"):
            prog = self._program(mode, runs, transfers, step)
            regs: List[Any] = [None] * prog.num_slots
            slot_of = prog.slot_of
            for key, x in env.items():
                regs[slot_of[key]] = x
            prog.execute(regs, step.programs[mode][1]
                         if step is not None else None)
            if step is None:
                self._register_program = prog
            stats["n_ops"] = len(prog.ops)
            if mode == "overlap":
                busy = prog.run_stats["transfer_busy_s"]
                blocked = prog.run_stats["wait_blocked_s"]
                stats.update(
                    n_cross_mesh=prog.n_cross_mesh,
                    n_hoisted=prog.n_hoisted, n_launches=prog.n_launches,
                    overlap_window=prog.overlap_window,
                    transfer_busy_s=busy, wait_blocked_s=blocked,
                    overlap_fraction=(max(0.0, min(1.0, 1 - blocked / busy))
                                      if busy > 0 else 1.0))
            get = lambda key: regs[slot_of[key]]  # noqa: E731
        elif mode == "threaded":
            self._run_streams_threaded(env, runs, transfers, step)
            get = env.__getitem__
        else:
            for i, inst in enumerate(self.instructions):
                self._exec_inst(i, inst, env, runs, transfers)
            get = env.__getitem__
        stats["loop_s"] = loop = time.perf_counter() - loop_tic
        stats["per_inst_us"] = loop / max(1, len(self.instructions)) * 1e6
        self.last_dispatch_stats = stats
        return get

    def _exec_inst(self, idx, inst, env, runs, transfers):
        if inst.opcode == PipelineInstType.RUN:
            m = inst.dst_mesh
            outs = runs[idx]([env[(k[0], k[1], m)]
                              for k in inst.input_keys])
            for k, o in zip(inst.output_keys, outs):
                env[(k[0], k[1], m)] = o
        elif inst.opcode == PipelineInstType.RESHARD:
            v, i = inst.var_key
            env[(v, i, inst.dst_mesh)] = transfers[idx](
                env[(v, i, inst.src_mesh)])
        else:
            for key in inst.free_keys:
                env.pop(tuple(key), None)

    def _run_streams_threaded(self, env, runs, transfers, step):
        """Per-mesh worker threads over ``partition_streams``' streams, each
        instruction after its cross-stream dependencies (per-instruction
        events; on CUDA also a CUDA event on the mesh's stream).  Every edge
        points to an earlier index, so the workers cannot deadlock; one
        failing instruction stops all streams."""
        streams = self._instruction_streams
        n = len(self.instructions)
        done = [threading.Event() for _ in range(n)]
        abort = threading.Event()
        errors: List[BaseException] = []
        checker = None
        if global_config.debug_dispatch_races:
            if self._race_checker is None:
                self._race_checker = DispatchRaceChecker(
                    self.instructions, streams.stream_of, self._key_alias)
            checker = self._race_checker
            checker.reset()
        deps_of = dict(streams.deps)
        if step is not None:
            for i, reuse in step.reuse_deps.items():
                deps_of[i] = set(deps_of.get(i, ())) | reuse
        needed = {d for ds in deps_of.values() for d in ds}

        def worker(m, stream_idxs):
            cuda_stream = step.mesh_streams[m] if step is not None else None
            try:
                device = (torch.cuda.device(cuda_stream.device)
                          if cuda_stream is not None else nullcontext())
                ctx = (torch.cuda.stream(cuda_stream) if cuda_stream
                       is not None else nullcontext())
                with device, ctx:
                    for idx in stream_idxs:
                        deps = deps_of.get(idx, ())
                        for dep in sorted(deps):
                            while not done[dep].wait(0.05):
                                if abort.is_set():
                                    return
                        if abort.is_set():
                            return
                        if cuda_stream is not None:
                            for dep in deps:
                                cuda_stream.wait_event(step.events[dep])
                        accs = checker.begin(idx) if checker else None
                        try:
                            self._exec_inst(idx, self.instructions[idx], env,
                                            runs, transfers)
                        finally:
                            if checker:
                                checker.end(idx, accs)
                        if cuda_stream is not None and idx in needed:
                            step.events[idx].record(cuda_stream)
                        done[idx].set()
            except BaseException as e:  # noqa: B036 - re-raised below
                errors.append(e)
                abort.set()

        threads = [threading.Thread(target=worker, args=(m, s), daemon=True)
                   for m, s in enumerate(streams.streams) if s]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if checker is not None:
            checker.check()

    def _program(self, mode, runs, transfers, step):
        """The register-file program of ``mode``: lowered once per mode over
        the eager run and transfer tables, and once per capture over the
        graphs (whose ops are also put on the CUDA streams)."""
        preplaced = ([(v, mb, m) for v, meshes in self.input_place.items()
                      for m in meshes
                      for mb in (range(self.num_micro_batches)
                                 if self.batch_invars[self._input_index[v]]
                                 else (-1,))] +
                     [(acc, -1, m) for acc, m in self.acc_allocs])
        cache = self._register_programs if step is None else step.programs
        if mode not in cache:
            prog = lower_to_register_file(
                self.instructions, preplaced, runs.__getitem__,
                transfers.__getitem__, mode=mode,
                overlap_window=self.schedule.overlap_window_hint())
            cache[mode] = (prog, None if step is None else
                           self._stream_ops(prog, step, transfers))
        return cache[mode][0]

    def _eager_tables(self):
        """The run and transfer callables of the uncaptured stage graphs,
        by instruction index."""
        if self._eager is None:
            runs = {i: functools.partial(self._run_eager, inst.executable)
                    for i, inst in enumerate(self.instructions)
                    if inst.opcode == PipelineInstType.RUN}
            transfers = {i: self._transfer_eager(inst)
                         for i, inst in enumerate(self.instructions)
                         if inst.opcode == PipelineInstType.RESHARD}
            self._eager = (runs, transfers)
        return self._eager

    def _stream_ops(self, prog, step, transfers):
        """The program's ops on CUDA streams: each instruction's op on its
        mesh's stream after the events of its cross-stream dependencies; a
        launched transfer on its device's side stream after the events of
        all its predecessors in the dataflow graph; a wait makes the
        destination's stream wait for the transfer's event."""
        deps = self._instruction_streams.deps
        stream_of = self._instruction_streams.stream_of
        preds = prog.graph.preds
        waits_of = []
        for kind, members, _, _ in prog.op_info:
            if kind == "exec":
                waits_of.append({d for i in members
                                 for d in (*deps.get(i, ()),
                                           *step.reuse_deps.get(i, ()))})
            elif kind == "launch":
                waits_of.append({p for i in members for p in preds[i]})
            else:
                waits_of.append(set(members[:1]))
        needed = set().union(*waits_of) if waits_of else set()
        ops = []
        for op, (kind, members, srcs, dsts), waits in zip(
                prog.ops, prog.op_info, waits_of):
            wait_evs = [step.events[d] for d in sorted(waits)]
            if kind == "exec":
                stream = step.mesh_streams[stream_of[members[0]]]
                records = [step.events[i] for i in members if i in needed]
                ops.append(_on_stream(op, stream, wait_evs, records))
            elif kind == "launch":
                inst = self.instructions[members[0]]
                stream = step.side_streams[self.mesh_devices[inst.dst_mesh]]
                ts = [transfers[i] for i in members]

                def launch(regs, _t=ts, _s=srcs, _d=dsts):
                    for t, s, d in zip(_t, _s, _d):
                        regs[d] = t(regs[s])
                ops.append(_on_stream(launch, stream, wait_evs,
                                      [step.events[i] for i in members]))
            else:
                stream = step.mesh_streams[stream_of[members[0]]]
                ops.append(_on_stream(lambda regs: None, stream, wait_evs,
                                      []))
        return ops

    # ---- CUDA graphs ----
    def _launch_graphs(self, flat_args, inputs, mode):
        step = self._captured
        if step is None:
            return self._capture_step(flat_args, inputs)
        moved, held_back = step.mismatches(inputs)
        if not moved and not held_back:
            return self._replay(flat_args, inputs, mode, step)
        # capture once more, these inputs read from a buffer and their
        # buffers handed back to no output (a caller that does not pass
        # back what the step returned may hold it still), so that they
        # cannot cause another capture
        self._copy_in |= moved
        self._no_feedback |= moved | held_back
        self.recapture_count += 1
        if self.recapture_count == 1:
            logger.warning(
                "pipeshard step captured again: %d inputs did not come back "
                "at the address the CUDA graphs read them from, %d came "
                "back as new tensors while the caller holds the outputs "
                "handed back in their buffers (first: %s); from now on they "
                "are copied into buffers of the step (pass a state back as "
                "the step returned it to avoid the copies)",
                len(moved), len(held_back), sorted(moved | held_back)[:8])
        return self._capture_step(flat_args, inputs)

    def _is_direct(self, i, x, device) -> bool:
        """Whether a graph reads input ``i`` where it is: a tensor already on
        the mesh's device in its dtype that is undonated or that the step
        hands back (an apply-grad graph writes the new state into it)."""
        return (isinstance(x, torch.Tensor) and x.device == device and
                x.dtype == self.in_dtypes[i] and i not in self._copy_in and
                (not self.donated_invars[i] or i in self._returned_inputs))

    def _capture_step(self, flat_args, inputs):
        """Capture every RUN of the step in program order, each replayed at
        once, on the current stream; returns the step's outputs."""
        self._captured = None
        torch.cuda.synchronize()
        step = _CapturedStep(self.mesh_devices, len(self.instructions))
        self._keep_ptrs = set()
        env: Dict[Tuple[Any, int, int], Any] = {}
        for key, x, i in self._placements(inputs):
            m = key[2]
            if not self.batch_invars[i] and \
                    self._is_direct(i, inputs[i], self.mesh_devices[m]):
                env[key] = x
                step.direct[(i, m)] = _signature(inputs[i])
                continue
            buf = torch.empty_like(x, memory_format=torch.contiguous_format)
            buf.copy_(x)
            env[key] = step.static[key] = buf
            if self.batch_invars[i]:
                step.batch_loads.append((i, key[1], m, buf))
            else:
                step.copy_loads.append((i, m, buf))
        for acc, m in self.acc_allocs:
            val = acc.meta["val"]
            buf = torch.zeros(val.shape, dtype=val.dtype,
                              device=self.mesh_devices[m])
            env[(acc, -1, m)] = step.static[(acc, -1, m)] = buf
            step.acc_bufs.append((m, buf))
        outside = {x.untyped_storage().data_ptr() for x in env.values()}
        # which device's pool holds each value, and the last instruction on
        # each stream that touched each pool; a RESHARD's copy counts as a
        # stream of its own (overlap mode runs it on a side stream)
        pool_of: Dict[Tuple[Any, int, int], torch.device] = {}
        last_touch: Dict[torch.device, Dict[Any, int]] = {
            d: {} for d in step.pools}
        stream_of = self._instruction_streams.stream_of
        for idx, inst in enumerate(self.instructions):
            if inst.opcode == PipelineInstType.RUN:
                m = inst.dst_mesh
                device, s = self.mesh_devices[m], stream_of[idx]
                keys = [(k[0], k[1], m) for k in inst.input_keys]
                step.reuse_deps[idx] = {
                    j for t, j in last_touch[device].items() if t != s}
                for key in keys:
                    if key in pool_of:
                        last_touch[pool_of[key]][s] = idx
                # its temporaries and outputs
                last_touch[device][s] = idx
                run = step.runs[idx] = CapturedRun(
                    inst.executable, [env[k] for k in keys],
                    step.pools[device], step.capture_streams[device])
                run.graph.replay()
                _add_launch_counts(run.launches)
                for k, o in zip(inst.output_keys, run.first_outputs()):
                    key = (k[0], k[1], m)
                    env[key] = o
                    if isinstance(o, torch.Tensor) and \
                            o.untyped_storage().data_ptr() not in outside:
                        pool_of[key] = device
            elif inst.opcode == PipelineInstType.RESHARD:
                v, i = inst.var_key
                src = (v, i, inst.src_mesh)
                x = env[src]
                dst = self.mesh_devices[inst.dst_mesh]
                if x.device != dst:
                    if src in pool_of:
                        last_touch[pool_of[src]][("copy", idx)] = idx
                    buf = step.reshard_bufs[idx] = torch.empty_like(
                        x, device=dst)
                    buf.copy_(x, non_blocking=True)
                    self._moved += x.numel() * x.element_size()
                    x = buf
                elif src in pool_of:
                    pool_of[(v, i, inst.dst_mesh)] = pool_of[src]
                env[(v, i, inst.dst_mesh)] = x
            else:
                for key in inst.free_keys:
                    env.pop(tuple(key), None)
        self.capture_count += 1
        self.last_dispatch_stats = {
            "mode": "capture", "graphs": True,
            "n_instructions": len(self.instructions),
            "captures": self.capture_count,
            "recaptures": self.recapture_count}
        step.feedback = self._feedback_pairs(step, env, inputs)
        outs = self._collect_outputs(flat_args, env.__getitem__,
                                     copy_out=True, step=step)
        self._free_donated(flat_args, outs)
        step.pool_bytes = _pool_bytes(step.pools.values())
        self._captured = step
        return outs

    def _feedback_pairs(self, step, env, inputs):
        """Pair each output with the buffer of the input at its own flat
        position (a train step returns its state in the order it takes it)
        where that input is donated and copied in each step (one buffer, of
        the output's shape, dtype and device), and the output is made by a
        graph or is that buffer, written in place: the output's value goes
        back into the buffer at the end of the step, and the step hands
        back the buffer, which the next step reads without a copy."""
        loads = [i for i, _, _ in step.copy_loads]
        buf_of = {i: buf for i, _, buf in step.copy_loads
                  if self.donated_invars[i] and loads.count(i) == 1 and
                  i not in self._no_feedback}
        # not a graph-made output: one in an input's or a buffer's memory
        taken = {x.untyped_storage().data_ptr()
                 for x in list(step.static.values()) + list(inputs)
                 if isinstance(x, torch.Tensor)}
        pairs = []
        for j, (kind, payload) in enumerate(self.output_specs):
            buf = buf_of.get(j)
            if kind != "env" or buf is None:
                continue
            (v, inst), m = payload
            x = env[(v, inst, m)]
            if not isinstance(x, torch.Tensor) or (
                    x.shape, x.dtype, x.device) != (
                    buf.shape, buf.dtype, buf.device):
                continue
            in_place = (x.data_ptr() == buf.data_ptr() and
                        x.stride() == buf.stride())
            if in_place or x.untyped_storage().data_ptr() not in taken:
                pairs.append((j, j, buf))
        return pairs

    def _graph_transfer(self, idx, step):
        buf = step.reshard_bufs.get(idx)
        if buf is None:
            return lambda x: x

        def transfer(x, _b=buf):
            _b.copy_(x, non_blocking=True)
            with self._acct_lock:
                self._moved += x.numel() * x.element_size()
            return _b
        return transfer

    def _replay(self, flat_args, inputs, mode, step):
        """One step of graph replays in ``mode``: refill the executable's
        own input buffers, zero the accumulators, run the program, copy the
        outputs out."""
        current = {d: torch.cuda.current_stream(d)
                   for d in dict.fromkeys(self.mesh_devices)}
        # "sequential" runs on one stream: the first mesh's, where the meshes
        # share one device, else the caller's
        sequential = mode == "sequential"
        one = (step.mesh_streams[0] if len(current) == 1 else None)
        streams = ([one or current[d] for d in self.mesh_devices]
                   if sequential else list(step.mesh_streams))
        for d, s in zip(self.mesh_devices, streams):
            if s is not current[d]:
                s.wait_stream(current[d])
        for i, mb, m, buf in step.batch_loads:
            with torch.cuda.stream(streams[m]):
                x = _to_tensor(inputs[i], self.in_dtypes[i],
                               self.mesh_devices[m])
                buf.copy_(x.chunk(self.num_micro_batches)[mb],
                          non_blocking=True)
        for i, m, buf in step.copy_loads:
            x = inputs[i]
            if isinstance(x, torch.Tensor) and x.data_ptr() == buf.data_ptr():
                continue   # the buffer the last step handed back
            with torch.cuda.stream(streams[m]):
                if isinstance(x, torch.Tensor) and x.is_cuda:
                    x.record_stream(streams[m])
                buf.copy_(_to_tensor(x, self.in_dtypes[i],
                                     self.mesh_devices[m]),
                          non_blocking=True)
        for m, buf in step.acc_bufs:
            with torch.cuda.stream(streams[m]):
                buf.zero_()
        env: Dict[Tuple[Any, int, int], Any] = dict(step.static)
        for key, x, i in self._placements_direct(inputs, step):
            env[key] = x
        if not step.transfers:
            step.transfers = {i: self._graph_transfer(i, step)
                              for i, inst in enumerate(self.instructions)
                              if inst.opcode == PipelineInstType.RESHARD}
        transfers = step.transfers
        if sequential:
            with torch.cuda.stream(one) if one is not None else \
                    nullcontext():
                get = self._dispatch(mode, env, step.runs, transfers, None,
                                     graphs=True)
        else:
            get = self._dispatch(mode, env, step.runs, transfers, step,
                                 graphs=True)
        for d, s in list(zip(self.mesh_devices, streams)) + list(
                step.side_streams.items()):
            if s is not current[d]:
                current[d].wait_stream(s)
        outs = self._collect_outputs(flat_args, get, copy_out=True,
                                     step=step)
        self._free_donated(flat_args, outs)
        return outs

    def _placements_direct(self, inputs, step):
        """The placements of the inputs the graphs read where they are."""
        for v, meshes in self.input_place.items():
            i = self._input_index[v]
            for m in meshes:
                if (i, m) in step.direct:
                    yield (v, -1, m), inputs[i], i

    # ---- outputs and donation ----
    def _collect_outputs(self, flat_args, get, copy_out: bool, step=None):
        """The step's outputs; ``copy_out`` (CUDA graphs) copies each one a
        graph or the executable owns out of it, since the next replay
        overwrites it: into the buffer of its paired input
        (``step.feedback``), handed back as a view, or into a new
        tensor."""
        user = {x.untyped_storage().data_ptr() for x in flat_args
                if isinstance(x, torch.Tensor)}
        feedback = {j: (i, buf) for j, i, buf in
                    (step.feedback if step is not None else ())}
        n_mb = self.num_micro_batches
        outs = []
        for j, (kind, payload) in enumerate(self.output_specs):
            if kind == "literal":
                outs.append(payload)
            elif kind == "input":
                outs.append(flat_args[payload])
            elif kind == "env":
                (v, i), m = payload
                x = get((v, i, m))
                if j in feedback:
                    i, buf = feedback[j]
                    if x.data_ptr() != buf.data_ptr():
                        buf.copy_(x)
                    x = buf.detach()
                    step.handed[i] = weakref.ref(x)
                elif copy_out and isinstance(x, torch.Tensor) and \
                        x.untyped_storage().data_ptr() not in user:
                    x = x.clone()
                outs.append(x)
            else:
                v, meshes = payload
                vals = [get((v, mb, m)) for mb, m in meshes]
                if n_mb == 1:
                    outs.append(vals[0].clone() if copy_out else vals[0])
                elif vals[0].dim() >= 1:
                    dev = self.mesh_devices[meshes[0][1]]
                    outs.append(torch.cat([x.to(dev) for x in vals]))
                else:
                    raise ValueError(
                        "A scalar output of a pipelined forward-only "
                        "function is ambiguous with num_micro_batches > 1 "
                        "(per-microbatch reduction cannot be recombined); "
                        "return per-example values or use "
                        "num_micro_batches=1.")
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

    def _owned_ptrs(self) -> set:
        """The storages of the captured step's own buffers, which a donated
        argument may be a view of (one the last step handed back): never
        released."""
        if self._captured is None:
            return set()
        return {x.untyped_storage().data_ptr()
                for x in self._captured.static.values()}

    def _free_donated(self, flat_args, outs):
        """Release the storage of donated input tensors that no output and
        no undonated input shares (the counterpart of JAX deleting a
        donated buffer)."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(x) for x in outs if isinstance(x, torch.Tensor)}
        keep.update(ptr(x) for x, d in zip(flat_args, self.donated_invars)
                    if isinstance(x, torch.Tensor) and not d)
        keep.update(self._owned_ptrs())
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
        return self._instruction_streams

    def get_total_allocation_size(self) -> int:
        """``torch.cuda.max_memory_allocated`` after the last launch, the
        largest over the meshes' devices: the peak since the caller last
        reset the peak statistics, the graphs' capture included (-1 before a
        launch on CUDA)."""
        return self._peak_bytes

    def get_graph_pool_bytes(self) -> Optional[int]:
        """Bytes the CUDA graphs' memory pools reserve (their intermediates
        and outputs, measured after the capture); None before a capture."""
        return None if self._captured is None else self._captured.pool_bytes


def _pool_bytes(pools) -> Optional[int]:
    """The bytes of the allocator's segments that belong to ``pools``."""
    wanted = {tuple(p) for p in pools}
    total, found = 0, False
    for seg in torch.cuda.memory_snapshot():
        pool = seg.get("segment_pool_id")
        if pool is None:
            continue
        found = True
        if tuple(pool) in wanted:
            total += int(seg["total_size"])
    return total if found else None
