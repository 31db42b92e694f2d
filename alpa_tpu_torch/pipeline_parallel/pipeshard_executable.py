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
stream.

Measurement, as the JAX driver's (``telemetry/``): each launch is a
``pipeshard.step`` span, observed in ``alpa_pipeshard_dispatch_seconds``,
and a raising launch dumps the flight recorder (``flight.auto_dump``).
The register-file replay runs its per-op hooks (flight events on the host
clock, on by default; trace spans while tracing or ``collect_trace`` is
on; the slot hazard checker), as do the "sequential" and "threaded"
loops per instruction (tracks ``"mesh N"``).  On CUDA a traced step times
each op by a CUDA event pair on the op's stream (``_DeviceClock``; in a
captured step recorded after the op's cross-stream waits), syncs the
cards after the step and records the spans on the device clock, anchored
to the host clock at the step's start, with the host's dispatch time as
an argument: a replayed CUDA graph returns in microseconds, so a host
span would time its launch.  None of the hooks is captured into a graph.
``get_perf_report`` joins the last step's spans against the program's
dataflow graph (``telemetry.perf.StepPerfReport``) and feeds the
calibration store.

Faults (``fault.py``): the register-file replay compiles its fault hook
in while ``fault.instrumented()`` (``runtime_emitter``), and the
"sequential" and "threaded" loops fire ``stage_launch`` before each RUN
and ``cross_mesh_send`` before each RESHARD under ``call_with_retry``, as
the JAX package's interpreter does: a RUN that donates is retried only for
an injected fault, which fires before it runs.  A fire is a host call
before the op or its graph replays; it never causes a recapture.  The
launch gate: ``quiesce()`` closes it and waits for the launches in flight
(and the cards) to drain, ``resume()`` opens it again, as
``RecoveryManager`` and ``ElasticSupervisor`` drive them.

Plan analyses (``analysis/``), as the JAX driver runs them: before the
first launch the plan is verified once (``_ensure_verified``: the program
of the dispatched mode, lowered with ``_plan_context``'s shardings,
provenance, outputs and equivalence reference), and every later lowering,
of any mode or capture, carries that verdict (``get_plan_verdict``).
Under ``superopt_mode`` "suggest" or "auto" the superoptimizer runs first
(``_run_superopt``); an accepted "auto" rewrite replaces the instruction
list, and every table built from the old list is dropped
(``_set_instructions``), so the eager tables, the captures and the span
names are built from the rewritten list.
"""
import dataclasses
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

from alpa_tpu_torch import fault as _fault
from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.ops import flash_attention as _flash
from alpa_tpu_torch.pipeline_parallel.computation import PipelineComputation
from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
    MeshSharding, ReshardingTask, VirtualDistributedArray, as_shards,
    make_transfer, naive_transfer_bytes, plan_resharding)
from alpa_tpu_torch.pipeline_parallel.reshard_codec import QuantizedTransfer
from alpa_tpu_torch.shard_parallel.sharding_spec import (local_shape,
                                                         local_slices,
                                                         replicated_spec)
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
    DispatchRaceChecker, PipelineInstruction, PipelineInstType, PlanContext,
    emit_free_instructions, lower_to_register_file, partition_streams)
from alpa_tpu_torch.pipeline_parallel.schedules import \
    create_pipeline_schedule
from alpa_tpu_torch.telemetry import flight as _flight
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace
from alpa_tpu_torch.util import node_flops

logger = logging.getLogger(__name__)
aten = torch.ops.aten

# "auto" and the JAX package's other modes, a private switch
DISPATCH_MODES = ("auto", "registers", "overlap", "sequential", "threaded")

# the driver's host time of one pipeshard step (the whole launch, not the
# device's)
_DISPATCH_SECONDS = _tmetrics.get_registry().histogram(
    "alpa_pipeshard_dispatch_seconds",
    "launch_on_driver dispatch latency per pipeshard step")


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
                 donate: Sequence[int] = (), device_id: int = 0):
        self.name = comp.name
        self.mesh_id = mesh_id
        self.num_devices = 1
        self.invars = list(comp.invars)
        self.outvars = list(comp.outvars)
        self.num_nodes = len(comp.nodes)
        # one run's analytic flops (``telemetry.perf.stage_flops``)
        self.flops = float(sum(node_flops(n) for n in comp.nodes))
        self.module = comp.get_runnable(root, device)
        self.aliased = alias_donated_inputs(
            self.module, donate, [v.meta.get("val") for v in self.invars])
        written = set(self.aliased.values())
        self.free_after = [i for i in donate if i not in written]
        self.donate_idx: Tuple[int, ...] = tuple(sorted(
            written | set(self.free_after)))
        self.in_shardings = [_whole(v, device_id) for v in self.invars]
        self.out_shardings = [_whole(v, device_id) for v in self.outvars]

    def __call__(self, args):
        with torch.no_grad():
            return self.module(*args)


def _distribute_full(full: torch.Tensor, spec, mesh, used: set
                     ) -> DistributedArray:
    """``full`` as a ``DistributedArray`` under ``spec`` on ``mesh``: the
    first position whose block is all of ``full``, on its device, holds
    ``full`` itself unless ``used`` already names it; every other position
    a copy of its block (each device writes its own in place)."""
    shards = []
    for p, device in enumerate(mesh.flat_devices()):
        block = full
        for d, (off, size) in enumerate(local_slices(
                full.shape, spec, mesh.coords(p), mesh.shape)):
            if size != full.shape[d]:
                block = block.narrow(d, off, size)
        key = full.untyped_storage().data_ptr()
        if block is full and full.device == device and key not in used:
            used.add(key)
            shards.append(full)
        else:
            shards.append(block.to(device, copy=True).contiguous())
    return DistributedArray(shards, spec, mesh, tuple(full.shape),
                            full.dtype)


def _tensors(x) -> List[torch.Tensor]:
    """The tensors a value holds: a ``DistributedArray``'s shards, or the
    tensor itself."""
    if isinstance(x, DistributedArray):
        return list(x.shards)
    return [x] if isinstance(x, torch.Tensor) else []


def _same_tiles(v, a: MeshSharding, b: MeshSharding) -> bool:
    """Whether two shardings of ``v`` put the same block on each device."""
    if a == b:
        return True
    if a.device_ids != b.device_ids:
        return False
    shape = tuple(v.meta["val"].shape)
    return (VirtualDistributedArray.from_sharding(shape, a).device_tiles ==
            VirtualDistributedArray.from_sharding(shape, b).device_tiles)


def _ndim(v) -> int:
    val = v.meta.get("val")
    return val.dim() if isinstance(val, torch.Tensor) else 0


def _whole(v, device_id: int) -> MeshSharding:
    """A value on a mesh of one device: whole, on that device."""
    return MeshSharding(replicated_spec(_ndim(v)), (1, 1), (device_id,))


#: the spec of a stage output the plan leaves as the program computes it
NATURAL = None


class SpmdStageExecutable:
    """One computation on a stage mesh of several devices, planned as the
    JAX package's ``StageExecutable.plan`` plans a stage
    (``alpa_tpu/pipeline_parallel/pipeshard_executable.py:87``) and run by
    the SPMD partitioner over the mesh's devices, uncaptured.

    ``plan()`` decides the input specs: with ``enable_auto_sharding`` the
    ILP on the stage's graph (``solver.plan_auto_sharding``: no input
    taken as batch, the stage's logical shape and ``AutoShardingOption``
    overrides, the stage's input paths); otherwise the rule-based plan on
    an ``(n, 1)`` logical mesh under ZeRO stage 2 or 3, else every input
    replicated.  The driver may then unify the specs of values that stages
    of one mesh share (``unify_same_mesh_shardings``) before ``compile()``
    fixes them: the program is planned again with its inputs pinned (the
    ILP's pinned solve after an ILP plan, the propagation of a rule-based
    one), its accumulator outputs pinned to their donated inputs' specs
    (``donated_out_specs``), the outputs a consumer on the mesh pinned to
    its spec, new state (``state_out``: an output the step returns where
    it takes the old value) to its old value's spec, the others as
    computed, and partitioned
    (``spmd_partition.SpmdProgram``).  Values are ``DistributedArray``s
    over the stage's logical mesh; a donated input is written in place on
    every device."""

    def __init__(self, comp: PipelineComputation, mesh_id: int,
                 physical_mesh: PhysicalDeviceMesh, device_ids,
                 root: torch.nn.Module, as_option, logical_shape,
                 as_overrides, in_paths: Sequence[str],
                 donate: Sequence[int] = (), acc_out: Optional[Dict] = None,
                 state_out: Optional[Dict] = None):
        self.name = comp.name
        self.mesh_id = mesh_id
        self.invars = list(comp.invars)
        self.outvars = list(comp.outvars)
        self.num_nodes = len(comp.nodes)
        self.flops = float(sum(node_flops(n) for n in comp.nodes))
        self.physical_mesh = physical_mesh
        self.num_devices = physical_mesh.num_devices
        self.device_ids = tuple(int(i) for i in np.asarray(device_ids).flat)
        self.donate = list(donate)
        self.donate_idx: Tuple[int, ...] = tuple(sorted(donate))
        # summed output -> its accumulator input; new state -> old state
        self.acc_out = dict(acc_out or {})
        self.state_out = dict(state_out or {})
        # old state -> (its spec, the logical shape it is read under): set
        # by the driver from every stage that reads it
        self.state_specs: Dict[fx.Node, Tuple] = {}
        self.in_paths = list(in_paths)
        self.module = comp.get_runnable(root, physical_mesh.flat_devices[0])
        self.avals = [(tuple(v.meta["val"].shape), v.meta["val"].dtype)
                      for v in self.invars]
        self.pinned_out: Dict[fx.Node, Tuple] = {}
        self.plan_seconds = 0.0
        self.program = None
        self.plan(as_option, logical_shape, as_overrides)

    def plan(self, as_option, logical_shape, as_overrides):
        from alpa_tpu_torch.shard_parallel.auto_sharding import (
            plan_rule_based, resolved_zero_stage)
        from alpa_tpu_torch.shard_parallel.sharding_spec import Aval
        from alpa_tpu_torch.shard_parallel.solver import plan_auto_sharding
        tic = time.perf_counter()
        opt = as_option.copy()
        self.search = None
        if as_option.enable_auto_sharding:
            if logical_shape is not None:
                opt.logical_mesh_shape = tuple(logical_shape)
            for k, v in (as_overrides or {}).items():
                if not hasattr(opt, k):
                    raise ValueError(
                        f"unknown AutoShardingOption field {k!r} in "
                        "submesh_autosharding_option_dicts")
                setattr(opt, k, v)
            self.logical_mesh, in_specs, (graph, _), shape = \
                plan_auto_sharding(self.module, self.avals, self.in_paths,
                                   [], self.physical_mesh, opt,
                                   traced=self.module)
            self.search = graph.search
            self.rule_based = False
        else:
            shape = (self.num_devices, 1)
            self.logical_mesh = self.physical_mesh.get_logical_mesh(shape)
            if resolved_zero_stage(as_option) in (2, 3):
                in_specs = list(plan_rule_based(
                    shape, [Aval(*a) for a in self.avals], self.in_paths, [],
                    as_option))
            else:
                in_specs = [replicated_spec(len(a[0])) for a in self.avals]
            self.rule_based = True
        self.option = opt
        self.in_specs = [tuple(sp) for sp in in_specs]
        self.plan_seconds = time.perf_counter() - tic

    def sharding(self, spec) -> MeshSharding:
        return MeshSharding(tuple(spec), tuple(self.logical_mesh.shape),
                            self.device_ids)

    @property
    def in_shardings(self) -> List[MeshSharding]:
        return [self.sharding(sp) for sp in self.in_specs]

    def donated_out_specs(self) -> Dict[fx.Node, Tuple]:
        """Accumulator outputs (added into their input in place), locked to
        that input's spec."""
        pos = {v: i for i, v in enumerate(self.invars)}
        return {ov: self.in_specs[pos[acc]] for ov, acc in
                self.acc_out.items() if acc in pos}

    def compile(self):
        from alpa_tpu_torch.shard_parallel.solver import (propagate_pinned,
                                                          solve_pinned)
        from alpa_tpu_torch.shard_parallel.spmd_partition import SpmdProgram
        tic = time.perf_counter()
        locked = self.donated_out_specs()
        out_specs = [locked.get(ov, self.pinned_out.get(ov, NATURAL))
                     for ov in self.outvars]
        # new state keeps its old value's spec (as XLA keeps a donated
        # buffer's for the output it aliases), where the old value is read
        # under this logical shape
        shape = tuple(self.logical_mesh.shape)
        for j, ov in enumerate(self.outvars):
            got = self.state_specs.get(self.state_out.get(ov))
            if out_specs[j] is NATURAL and got is not None and \
                    got[1] == shape:
                out_specs[j] = got[0]
        plan = propagate_pinned if self.rule_based else solve_pinned
        graph, choice = plan(self.module, self.avals, self.in_paths, [],
                             self.logical_mesh, self.option, self.in_specs)
        donated = [i in self.donate for i in range(len(self.invars))]
        self.program = SpmdProgram(self.module, graph, choice,
                                   self.logical_mesh, self.in_specs,
                                   out_specs, donated, natural_outputs=True)
        self.pinned_search = graph.search
        self.out_specs = list(self.program.out_specs)
        self.aliased = self.program.aliased
        written = set(self.aliased.values())
        self.free_after = [i for i in self.donate if i not in written]
        self.out_shardings = [self.sharding(sp) for sp in self.out_specs]
        self._out_avals = [(tuple(v.meta["val"].shape), v.meta["val"].dtype)
                           for v in self.outvars]
        self.plan_seconds += time.perf_counter() - tic

    def distribute(self, shards, spec, shape, dtype) -> DistributedArray:
        return DistributedArray(shards, spec, self.logical_mesh, shape, dtype)

    def __call__(self, args):
        program = self.program
        per_pos = [[as_shards(a)[p] for a in args]
                   for p in range(self.num_devices)]
        stores = program.initial_store(per_pos)
        program.run_part("compute", stores)
        program.run_part("apply", stores)
        outs = program.output_values(stores)
        del stores
        return [self.distribute([o[j] for o in outs], spec, shape, dtype)
                for j, (spec, (shape, dtype)) in enumerate(zip(
                    self.out_specs, self._out_avals))]


def unify_same_mesh_shardings(execs, var_alias: Dict[fx.Node, fx.Node]):
    """Stages of one mesh agree on the specs of the values they share
    (``_unify_same_mesh_shardings``, ``alpa_tpu/pipeline_parallel/
    pipeshard_executable.py:176``): an accumulator's summed output keeps its
    donated input's spec, the later readers of a value adopt the first
    reader's spec, and its producer's output is pinned to it, so that no
    relayout runs between them.  A spec is adopted only between stages of
    one logical shape (the port's Specs name a logical mesh's axes); a
    value read under another shape is relaid out by the runtime.
    ``var_alias`` names one value by two nodes (the gradient marker's
    output and the accumulator's summed value)."""
    def canon(v):
        return var_alias.get(v, v)

    wide = [e for e in execs if isinstance(e, SpmdStageExecutable)]
    chosen: Dict[Tuple[int, fx.Node], Tuple[Tuple, Tuple]] = {}
    for ex in wide:
        shape = tuple(ex.logical_mesh.shape)
        for ov, spec in ex.donated_out_specs().items():
            chosen[(ex.mesh_id, canon(ov))] = (spec, shape)
    for ex in wide:
        shape = tuple(ex.logical_mesh.shape)
        for pos, v in enumerate(ex.invars):
            key = (ex.mesh_id, canon(v))
            if key in chosen:
                spec, at = chosen[key]
                if at == shape:
                    ex.in_specs[pos] = spec
            else:
                chosen[key] = (ex.in_specs[pos], shape)
    for ex in wide:
        shape = tuple(ex.logical_mesh.shape)
        locked = ex.donated_out_specs()
        for v in ex.outvars:
            got = chosen.get((ex.mesh_id, canon(v)))
            if got is not None and got[1] == shape and v not in locked:
                ex.pinned_out[v] = got[0]


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
        # asynchronous only into a card: the host reads a host copy at once
        return x.to(device, non_blocking=torch.device(device).type == "cuda")
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


def _on_stream(op, stream, waits, records, timing=None):
    """``op`` enqueued on ``stream`` after the events ``waits``, recording
    the events ``records`` after it; ``timing``, a pair of timing events
    recorded around the op after the waits."""
    if timing is not None:
        def run(regs, _op=op, _s=stream, _w=waits, _r=records, _t=timing):
            with torch.cuda.stream(_s):
                for e in _w:
                    _s.wait_event(e)
                _t[0].record(_s)
                _op(regs)
                _t[1].record(_s)
                for e in _r:
                    e.record(_s)
        return run
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


class _DeviceClock:
    """The ops of a traced step timed on the device: a CUDA event pair per
    op ``k``, recorded on the op's stream -- by ``_on_stream`` itself
    after the op's waits where ``baked``, else on the current stream of
    the op's device around the call.  ``spans`` reads them after the
    step's final sync, anchored to the host clock at the step's start
    (``anchor``, taken after a sync)."""

    def __init__(self, op_devices, baked: bool = False):
        self.op_devices = [torch.device("cuda", torch.device(d).index or 0)
                           for d in op_devices]
        self.pairs = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in self.op_devices]
        self.baked = baked
        self.pending: List[Tuple[int, str, str, str, float]] = []

    def wrap(self, op, k, name, cat, track):
        start, end = self.pairs[k]
        dev = self.op_devices[k]
        pend, now = self.pending, _ttrace.now_us
        if self.baked:
            def timed(regs, _op=op):
                t0 = now()
                _op(regs)
                pend.append((k, name, cat, track, now() - t0))
        else:
            def timed(regs, _op=op):
                s = torch.cuda.current_stream(dev)
                start.record(s)
                t0 = now()
                _op(regs)
                end.record(s)
                pend.append((k, name, cat, track, now() - t0))
        return timed

    @staticmethod
    def anchor(devices) -> Dict[torch.device, Tuple[Any, float]]:
        """Per device an event recorded on its idle current stream and the
        host time beside it."""
        out = {}
        for d in devices:
            torch.cuda.synchronize(d)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            out[d] = (ev, _ttrace.now_us())
        return out

    def spans(self, anchors) -> List[Tuple[int, str, str, str, float, float,
                                           float]]:
        """``(k, name, category, track, ts_us, dur_us, host_us)`` of the
        ops run since the last call, in op order, on the device clock."""
        out = []
        for k, name, cat, track, host_us in sorted(self.pending,
                                                   key=lambda r: r[0]):
            start, end = self.pairs[k]
            ev, host0 = anchors[self.op_devices[k]]
            ts = host0 + ev.elapsed_time(start) * 1e3
            out.append((k, name, cat, track, ts,
                        max(0.0, start.elapsed_time(end) * 1e3), host_us))
        self.pending.clear()
        return out


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
        # mode -> (the program's ops on their streams with timing events,
        # their ``_DeviceClock``), built when a step is first traced
        self.timed: Dict[str, Any] = {}
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

    def __init__(self, *, meshes: Sequence[Any],
                 fwd_stages: List[PipelineComputation],
                 bwd_stages: List[PipelineComputation],
                 apply_comps: List[PipelineComputation],
                 root: torch.nn.Module, schedule_name: str,
                 num_micro_batches: int, global_invars: List[fx.Node],
                 global_outvars: List[Any], in_dtypes: Sequence[torch.dtype],
                 batch_invars: Sequence[bool],
                 donated_invars: Sequence[bool], grad_pairs,
                 acc_info: Dict[fx.Node, Tuple[fx.Node, fx.Node, int]],
                 logical_shapes: Optional[Sequence[Any]] = None,
                 as_dicts: Optional[Sequence[Dict]] = None,
                 as_option: Any = None,
                 in_paths: Optional[Sequence[str]] = None):
        # each stage mesh (a ``VirtualPhysicalMesh``): its devices and their
        # ids in the virtual mesh it was sliced from
        self.mesh_device_lists = [[torch.device(d) for d in m.devices.flat]
                                  for m in meshes]
        self.mesh_device_ids = [tuple(int(i) for i in m.device_ids.flat)
                                for m in meshes]
        self.mesh_devices = [devs[0] for devs in self.mesh_device_lists]
        self.mesh_sizes = [len(devs) for devs in self.mesh_device_lists]
        # (hosts, devices per host) of each stage mesh, and the schedule's
        # name (``parallel_plan.executable_to_plan``)
        self.mesh_shapes = [tuple(int(x) for x in m.devices.shape)
                            for m in meshes]
        self.schedule_name = schedule_name
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
        summed_to_acc = {summed: acc for acc, summed in self.acc_pairs.items()}
        self.has_bwd = bool(bwd_stages)
        paths = self.invar_paths = dict(zip(global_invars, in_paths or ()))
        logical_shapes = list(logical_shapes or [None] * self.num_meshes)
        as_dicts = list(as_dicts or [{}] * self.num_meshes)
        if as_option is None:
            from alpa_tpu_torch.shard_parallel.auto_sharding import \
                AutoShardingOption
            as_option = AutoShardingOption()

        # new state -> old: the step returns its state where it takes it
        state_out = {
            o: i for o, i, d in zip(global_outvars, global_invars,
                                    donated_invars)
            if d and isinstance(o, fx.Node) and o is not i and
            isinstance(o.meta.get("val"), torch.Tensor) and
            (tuple(o.meta["val"].shape), o.meta["val"].dtype) ==
            (tuple(i.meta["val"].shape), i.meta["val"].dtype)}

        def make(comp, m, donate=()):
            if self.mesh_sizes[m] == 1:
                return StageExecutable(comp, m, self.mesh_devices[m], root,
                                       donate, self.mesh_device_ids[m][0])
            return SpmdStageExecutable(
                comp, m, PhysicalDeviceMesh(meshes[m].devices),
                self.mesh_device_ids[m], root, as_option, logical_shapes[m],
                as_dicts[m], [paths.get(v, "") for v in comp.invars], donate,
                {ov: summed_to_acc[ov] for ov in comp.outvars
                 if ov in summed_to_acc},
                {ov: state_out[ov] for ov in comp.outvars if ov in state_out})

        self.stage_execs = [make(c, s) for s, c in enumerate(fwd_stages)] + [
            make(c, s) for s, c in enumerate(bwd_stages)]
        for e in self.stage_execs:
            # a backward stage adds into its accumulators in place
            e.donate_idx = tuple(i for i, v in enumerate(e.invars)
                                 if v in self.acc_pairs)
            # summed output -> its accumulator input (the translation
            # validation's accumulation map)
            e.acc_out_map = {ov: summed_to_acc[ov] for ov in e.outvars
                             if ov in summed_to_acc}
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
            make(c, m, [i for i, v in enumerate(c.invars)
                        if v in donated_global and use_count[v] == 1])
            if c.nodes or c.outvars else None
            for m, c in enumerate(apply_comps)]
        # stages of several devices: agree on shared values' specs, then
        # fix each plan and partition it
        wide = [e for e in self.stage_execs + self.apply_execs
                if isinstance(e, SpmdStageExecutable)]
        if wide:
            post_alias = {post: acc_info[pre][1]
                          for pre, post in grad_pairs if pre in acc_info}
            unify_same_mesh_shardings(wide, post_alias)
            olds = set(state_out.values())
            state_specs = {v: (sp, tuple(e.logical_mesh.shape))
                           for e in wide for v, sp in zip(e.invars,
                                                          e.in_specs)
                           if v in olds}
            for e in wide:
                e.state_specs = state_specs
                e.compile()
        # (mesh, logical shape) -> the logical mesh its values live on
        self._logical_meshes = {(e.mesh_id, tuple(e.logical_mesh.shape)):
                                e.logical_mesh for e in wide}
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
        # telemetry: per-instruction span names, the device clocks of the
        # uncaptured programs, the last step's device-clock ops (None when
        # it was not traced), the step count and the last step ingested
        # into the calibration store
        self._inst_name_table = None
        self._clocks: Dict[str, _DeviceClock] = {}
        self._clock = None
        self._anchors = {}
        self._device_ops = None
        self._steps = 0
        self._ingested_step = 0
        self._last_program = None
        self._step_t0_us = self._step_t1_us = 0.0
        self._acct_lock = threading.Lock()
        # the quiesce gate: recovery pauses new launches and waits out
        # those in flight before it snapshots the state.  The gate flag
        # and the count of launches in flight change only together, under
        # ``_quiesce_cv``, so no launch can pass an open gate and count
        # itself after a quiesce has read the count as 0.
        self._gate_open = True
        self._inflight_launches = 0
        self._quiesce_cv = threading.Condition()
        self._moved = 0
        self.executed_cross_mesh_bytes = 0.0
        self.executed_intra_mesh_bytes = 0.0
        self._keep_ptrs: set = set()
        self.last_dispatch_stats: Dict[str, Any] = {}
        # the bytes the last launch copied, per input and per output
        self.last_copies: Dict[str, Dict[int, int]] = {"in": {}, "out": {}}
        # CUDA graphs: the first call warms up, the second captures; a mesh
        # of several devices runs its partitioned program uncaptured, and
        # so does the rest of its executable (ROADMAP A.3.2), as does a
        # step whose RESHARDs run the activation codec
        self._use_graphs = (all(d.type == "cuda" for d in self.mesh_devices)
                            and max(self.mesh_sizes) == 1 and not any(
                                isinstance(i.resharding[0],
                                           QuantizedTransfer)
                                for i in self.instructions
                                if i.opcode == PipelineInstType.RESHARD))
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
        # the plan analyses: the plan's verdict (verified once, on the
        # program of the first mode lowered, however often the plan is
        # lowered and captured, in any mode), the refusal under
        # verify_plans="error", the superoptimizer's outcome and the list
        # it rewrote
        self._verdict = None
        self.verified_mode = None
        self._refusal = None
        self._superopt_outcome = None
        self.baseline_instructions = self.instructions

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
        # (node, instance, mesh) -> the value's sharding on that mesh
        sharding_at: Dict[Tuple[Any, int, int], MeshSharding] = {}
        # global input -> meshes it is placed on at launch, and its
        # sharding on each (a mesh of several devices)
        self.input_place: Dict[fx.Node, List[int]] = {}
        self.input_sharding: Dict[Tuple[fx.Node, int], MeshSharding] = {}
        self.acc_allocs: List[Tuple[fx.Node, int]] = []
        self.acc_sharding: Dict[Tuple[fx.Node, int], MeshSharding] = {}
        self.planned_resharding_bytes = 0.0
        self.naive_resharding_bytes = 0.0
        self.naive_cross_mesh_bytes = 0.0
        first_mb_of: Dict[int, int] = {}

        def key_of(v, mb, first_mb):
            if v in self.acc_pairs:
                return (v, -1) if mb == first_mb else (self.acc_pairs[v], -1)
            if v in post_alias:
                return (post_alias[v], -1)
            if v in ginvar_idx:
                return (v, mb) if v in batch_var else (v, -1)
            return (v, mb)

        def place(v, mesh_id, sharding):
            place = self.input_place.setdefault(v, [])
            if mesh_id not in place:
                place.append(mesh_id)
                self.input_sharding[(v, mesh_id)] = sharding

        def reshard_inst(key, src, dst, sharding, info):
            v = key[0]
            inst = PipelineInstruction(
                PipelineInstType.RESHARD, var_key=key, src_mesh=src,
                dst_mesh=dst, info=info)
            inst.resharding = self._plan_transfer(
                v, sharding_at[(v, key[1], src)], src, sharding, dst,
                weight=key[1] < 0)
            instructions.append(inst)

        def ensure_on_mesh(key, mesh_id, sharding, info):
            v = key[0]
            if key not in location:
                if v not in ginvar_idx:
                    raise ValueError(f"{info} reads {v}, which no earlier "
                                     "instruction produces")
                place(v, mesh_id, sharding)
                location[key] = dict.fromkeys(self.input_place[v])
                for m in self.input_place[v]:
                    sharding_at[(v, key[1], m)] = \
                        self.input_sharding[(v, m)]
            if mesh_id not in location[key]:
                if v in ginvar_idx and v not in batch_var:
                    # a non-batch global input read on several meshes (the
                    # tied embedding) is placed on each of them at launch
                    place(v, mesh_id, sharding)
                    location[key][mesh_id] = None
                    sharding_at[(v, key[1], mesh_id)] = sharding
                    return
                reshard_inst(key, next(iter(location[key])), mesh_id,
                             sharding, info)
                location[key][mesh_id] = None
                sharding_at[(v, key[1], mesh_id)] = sharding
                return
            if not _same_tiles(v, sharding_at[(v, key[1], mesh_id)],
                               sharding):
                # on this mesh under another sharding: a relayout
                reshard_inst(key, mesh_id, mesh_id, sharding,
                             f"relayout:{info}")
                sharding_at[(v, key[1], mesh_id)] = sharding

        def emit_run(exec_, stage_id: int, mb: int, mesh_id: int):
            first_mb = first_mb_of.setdefault(id(exec_), mb)
            in_keys = []
            for pos, v in enumerate(exec_.invars):
                k = key_of(v, mb, first_mb)
                sharding = exec_.in_shardings[pos]
                if v in self.acc_pairs and k == (v, -1):
                    self.acc_allocs.append((v, mesh_id))
                    self.acc_sharding[(v, mesh_id)] = sharding
                    location[k] = {mesh_id: None}
                    sharding_at[(v, -1, mesh_id)] = sharding
                ensure_on_mesh(k, mesh_id, sharding, exec_.name)
                in_keys.append(k)
            out_keys = [(v, -1) if v in self._summed else (v, mb)
                        for v in exec_.outvars]
            for k, sharding in zip(out_keys, exec_.out_shardings):
                location[k] = {mesh_id: None}
                sharding_at[(k[0], k[1], mesh_id)] = sharding
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

    def _plan_transfer(self, v, src_sh: MeshSharding, src: int,
                       dst_sh: MeshSharding, dst: int, weight: bool):
        """The transfer of ``v`` from ``src_sh`` on mesh ``src`` to
        ``dst_sh`` on mesh ``dst``: its tile plan, the one that runs (whose
        bytes the executable sums with the naive plan's), lowered as JAX's
        emitter lowers a RESHARD (``runtime_emitter.py:1330``): under
        ``resharding_execution="planned"`` a cross-mesh edge is planned
        with the all-gather rewrite and runs its plan as it is
        (``ReshardingTask`` in "tiled" or, with
        ``resharding_mode="broadcast"``, "broadcast" mode); else it is
        planned without and ``make_transfer`` picks the direct, collective
        or quantized executor (never quantized for a ``weight``, a value
        every microbatch shares); and a callable wrapping the shards."""
        execution = global_config.resharding_execution
        if execution not in ("device_put", "planned"):
            raise ValueError("global_config.resharding_execution must be "
                             f"'device_put' or 'planned', got {execution!r}")
        planned = execution == "planned" and src != dst
        val = v.meta["val"]
        shape, itemsize = tuple(val.shape), val.element_size()
        dst_mesh = self._logical_meshes.get((dst, tuple(dst_sh.mesh_shape)))
        plan = plan_resharding(shape, itemsize, src_sh, dst_sh,
                               allow_allgather_rewrite=planned,
                               logical_mesh=dst_mesh)
        naive = naive_transfer_bytes(shape, itemsize, dst_sh)
        self.planned_resharding_bytes += plan.transfer_bytes
        self.naive_resharding_bytes += naive
        if src != dst:
            self.naive_cross_mesh_bytes += naive
        src_devs, dst_devs = (self.mesh_device_lists[src],
                              self.mesh_device_lists[dst])
        if planned:
            mode = ("broadcast" if global_config.resharding_mode ==
                    "broadcast" else "tiled")
            transfer = ReshardingTask(plan, src_devs, dst_devs, mode)
        else:
            transfer = make_transfer(plan, src_sh, dst_sh, src_devs,
                                     dst_devs, val.dtype, cross=src != dst,
                                     weight=weight,
                                     dst_logical_mesh=dst_mesh)
        return transfer, functools.partial(self._distribute, dst, dst_sh,
                                           shape=shape, dtype=val.dtype)

    def _distribute(self, mesh_id: int, sharding: MeshSharding, shards,
                    shape, dtype):
        """A value of mesh ``mesh_id`` from its shards: the tensor itself
        on a mesh of one device, else a ``DistributedArray``."""
        if self.mesh_sizes[mesh_id] == 1:
            return shards[0]
        return DistributedArray(shards, sharding.spec, self._logical_meshes[
            (mesh_id, tuple(sharding.mesh_shape))], shape, dtype)

    def _shared_input_keys(self) -> Dict[Tuple[Any, int, int],
                                         Tuple[Any, int, int]]:
        """A non-batch input placed on several one-device meshes of one
        device is one tensor: map each of its keys to the first, so a write
        in place waits for every mesh's readers (on a mesh of several
        devices it is placed as shards of its own)."""
        alias = {}
        for v, meshes in self.input_place.items():
            if self.batch_invars[self._input_index[v]]:
                continue
            first: Dict[torch.device, int] = {}
            for m in meshes:
                if self.mesh_sizes[m] > 1:
                    continue
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
        # blocks while quiesced: a launch racing a recovery would
        # dispatch onto a device being probed or restored (an in-place
        # restore writes into the tensors its graphs read)
        with self._quiesce_cv:
            self._quiesce_cv.wait_for(lambda: self._gate_open)
            self._inflight_launches += 1
        try:
            return self._launch_counted(*flat_args)
        finally:
            with self._quiesce_cv:
                self._inflight_launches -= 1
                self._quiesce_cv.notify_all()

    def quiesce(self, timeout: Optional[float] = None) -> bool:
        """Close the launch gate and wait until the launches in flight
        drain, then for the cards' queues (``sync``).  True when a
        quiescent point was reached within ``timeout``; launches stay
        blocked until ``resume``."""
        with self._quiesce_cv:
            self._gate_open = False
            drained = self._quiesce_cv.wait_for(
                lambda: self._inflight_launches == 0, timeout)
        if drained:
            try:
                self.sync()
            except Exception:  # pylint: disable=broad-except
                # a dead card cannot sync; quiescing on the host must
                # still succeed so that recovery can go on
                logger.exception("quiesce: device sync failed")
        return bool(drained)

    def resume(self):
        """Open the launch gate again after recovery."""
        with self._quiesce_cv:
            self._gate_open = True
            self._quiesce_cv.notify_all()

    def sync(self):
        """Wait for every card of the meshes to finish its queued work."""
        for d in self._cuda_devices():
            torch.cuda.synchronize(d)

    def _launch_counted(self, *flat_args):
        t0 = time.perf_counter()
        step_span = _ttrace.begin("pipeshard.step", "runtime")
        self._step_t0_us = _ttrace.now_us()
        self._clock = None
        self._device_ops = None
        self._steps += 1
        try:
            outs = self._launch(*flat_args)
            if self._clock is not None:
                self._flush_device_spans()
            return outs
        except BaseException:
            # the ops that led up to the failure (nothing when the ring
            # is empty or already dumped)
            _flight.auto_dump("pipeshard step raised")
            raise
        finally:
            self._step_t1_us = _ttrace.now_us()
            _ttrace.end(step_span)
            _DISPATCH_SECONDS.observe(time.perf_counter() - t0)

    def _launch(self, *flat_args):
        mode = self._dispatch_mode()
        self._ensure_verified(mode)
        inputs = self._unshare_written_inputs(flat_args)
        self.last_copies = {"in": {}, "out": {}}
        self._moved = 0
        self.executed_cross_mesh_bytes = 0.0
        self.executed_intra_mesh_bytes = 0.0
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
        devices = list(dict.fromkeys(d for devs in self.mesh_device_lists
                                     for d in devs if d.type == "cuda"))
        if devices:
            self._peak_bytes = max(torch.cuda.max_memory_allocated(d)
                                   for d in devices)
        return outs

    def _placements(self, inputs):
        """``(key, value)`` of every input placement: each batch slice and
        each other input on every mesh that reads it, on a mesh of several
        devices as a ``DistributedArray`` under the sharding its first
        reader there takes (one the last step returned under it, as it
        is; a whole block on the tensor's own device, once per step, as
        the tensor itself, every other block a copy of its own)."""
        n_mb = self.num_micro_batches
        used: set = set()   # the tensors a mesh's position holds as they are
        for v, meshes in self.input_place.items():
            i = self._input_index[v]
            for m in meshes:
                if self.mesh_sizes[m] > 1:
                    for key, x in self._place_wide(v, i, m, inputs[i], used):
                        yield key, x, i
                    continue
                x = inputs[i]
                if isinstance(x, DistributedArray):
                    x = x.gather(self.mesh_devices[m])
                x = _to_tensor(x, self.in_dtypes[i], self.mesh_devices[m])
                if self.batch_invars[i]:
                    for mb, part in enumerate(x.chunk(n_mb)):
                        yield (v, mb, m), part, i
                else:
                    yield (v, -1, m), x, i

    def _place_wide(self, v, i, m, x, used):
        sharding = self.input_sharding[(v, m)]
        mesh = self._logical_meshes[(m, tuple(sharding.mesh_shape))]
        if not self.batch_invars[i] and isinstance(x, DistributedArray) and \
                x.spec == sharding.spec and x.dtype == self.in_dtypes[i] and \
                x.logical_mesh.shape == mesh.shape and \
                x.logical_mesh.flat_devices() == mesh.flat_devices():
            yield (v, -1, m), x
            return
        first = self.mesh_devices[m]
        if isinstance(x, DistributedArray):
            x = x.gather(first)
        full = _to_tensor(x, self.in_dtypes[i], first)
        if self.batch_invars[i]:
            for mb, part in enumerate(full.chunk(self.num_micro_batches)):
                yield (v, mb, m), DistributedArray.from_full(
                    part, sharding.spec, mesh)
        else:
            yield (v, -1, m), _distribute_full(full, sharding.spec, mesh,
                                               used)
    def _zero_accumulator(self, acc, m):
        val = acc.meta["val"]
        if self.mesh_sizes[m] == 1:
            return torch.zeros(val.shape, dtype=val.dtype,
                               device=self.mesh_devices[m])
        sharding = self.acc_sharding[(acc, m)]
        mesh = self._logical_meshes[(m, tuple(sharding.mesh_shape))]
        shape = local_shape(val, sharding.spec, mesh.shape)
        return DistributedArray(
            [torch.zeros(shape, dtype=val.dtype, device=d)
             for d in mesh.flat_devices()], sharding.spec, mesh,
            tuple(val.shape), val.dtype)

    def _run_eager(self, exec_: StageExecutable, args):
        outs = exec_(args)
        for i in exec_.free_after:
            for t in _tensors(args[i]):
                _release(t, self._keep_ptrs)
        return outs

    def _transfer_eager(self, inst: PipelineInstruction):
        task, wrap = inst.resharding

        cross = inst.src_mesh != inst.dst_mesh

        def planned(x):
            shards, n = task(as_shards(x))
            rep = task.last_report
            with self._acct_lock:
                self._moved += n
                # a relayout moves its pieces inside its mesh
                self.executed_cross_mesh_bytes += \
                    rep.cross_mesh_bytes if cross else 0.0
                self.executed_intra_mesh_bytes += rep.intra_mesh_bytes + (
                    0.0 if cross else rep.cross_mesh_bytes)
            return wrap(shards)
        return planned

    def _launch_eager(self, flat_args, inputs, mode):
        """The stage graphs run as they are, on the current stream."""
        self._keep_ptrs = self._owned_ptrs() | {
            x.untyped_storage().data_ptr()
            for x, d in zip(flat_args, self.donated_invars)
            if isinstance(x, torch.Tensor) and not d}
        env: Dict[Tuple[Any, int, int], Any] = {}
        for key, x, i in self._placements(inputs):
            env[key] = x
            if not (isinstance(inputs[i], torch.Tensor) and
                    isinstance(x, torch.Tensor) and
                    x.untyped_storage().data_ptr() ==
                    inputs[i].untyped_storage().data_ptr()):
                self._count_copy("in", i, x)
        for acc, m in self.acc_allocs:
            env[(acc, -1, m)] = self._zero_accumulator(acc, m)
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
                                 "recaptures": self.recapture_count,
                                 "meshes": self._mesh_modes(graphs)}
        traced = _ttrace.enabled() or global_config.collect_trace
        on_cuda = self._device_timed()
        if mode in ("registers", "overlap"):
            prog = self._program(mode, runs, transfers, step)
            regs: List[Any] = [None] * prog.num_slots
            slot_of = prog.slot_of
            for key, x in env.items():
                regs[slot_of[key]] = x
            ops = step.programs[mode][1] if step is not None else None
            timer = None
            if traced and on_cuda:
                if step is not None:
                    if mode not in step.timed:
                        step.timed[mode] = self._timed_stream_ops(
                            prog, step, transfers)
                    ops, timer = step.timed[mode]
                else:
                    timer = self._eager_clock(mode, prog)
                self._start_clock(timer)
            prog.execute(regs, ops, timer)
            self._last_program = prog
            if step is None:
                self._register_program = prog
            stats["n_ops"] = len(prog.ops)
            if mode == "overlap":
                from alpa_tpu_torch.pipeline_parallel.runtime_emitter \
                    import record_overlap_step
                record_overlap_step(prog)
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
        else:
            self._last_program = None
            clock = None
            if traced and on_cuda:
                clock = self._eager_clock("instructions", None)
                self._start_clock(clock)
            run = self._inst_runner(env, runs, transfers, clock)
            if mode == "threaded":
                self._run_streams_threaded(run, step)
            else:
                for i in range(len(self.instructions)):
                    run(i)
            get = env.__getitem__
        stats["loop_s"] = loop = time.perf_counter() - loop_tic
        stats["per_inst_us"] = loop / max(1, len(self.instructions)) * 1e6
        self.last_dispatch_stats = stats
        return get

    def _mesh_modes(self, graphs: bool) -> List[str]:
        """How each mesh's stage runs ran: replayed CUDA graphs, the stage
        graphs uncaptured, or (a mesh of several devices) the partitioned
        program over its devices, uncaptured; in an executable with such a
        mesh every mesh runs uncaptured (ROADMAP A.3.2)."""
        return [f"spmd over {n} devices, uncaptured" if n > 1 else
                ("cuda graphs" if graphs else "uncaptured")
                for n in self.mesh_sizes]

    def _exec_inst(self, idx, inst, env, runs, transfers):
        if inst.opcode == PipelineInstType.RUN:
            m = inst.dst_mesh
            args = [env[(k[0], k[1], m)] for k in inst.input_keys]
            if _fault.instrumented():
                # a donating run is not idempotent (a rerun would read
                # inputs it wrote or freed): only injected faults, which
                # fire before it runs, are retried there
                def attempt():
                    _fault.fire("stage_launch", stage=inst.info, mesh_id=m)
                    return runs[idx](args)
                outs = _fault.call_with_retry(
                    attempt, site="stage_launch", idempotent=not getattr(
                        inst.executable, "donate_idx", ()))
            else:
                outs = runs[idx](args)
            for k, o in zip(inst.output_keys, outs):
                env[(k[0], k[1], m)] = o
        elif inst.opcode == PipelineInstType.RESHARD:
            v, i = inst.var_key
            src = env[(v, i, inst.src_mesh)]
            if _fault.instrumented():
                # a transfer reads its source as it is: a rerun is safe
                def transfer():
                    _fault.fire("cross_mesh_send", var=str(v),
                                src_mesh=inst.src_mesh,
                                dst_mesh=inst.dst_mesh)
                    return transfers[idx](src)
                out = _fault.call_with_retry(transfer,
                                             site="cross_mesh_send")
            else:
                out = transfers[idx](src)
            env[(v, i, inst.dst_mesh)] = out
        else:
            for key in inst.free_keys:
                env.pop(tuple(key), None)

    def _inst_names(self) -> List[Tuple[str, int]]:
        """``(span name, mesh)`` of each instruction, as the register-file
        lowering names its ops."""
        if self._inst_name_table is None:
            from alpa_tpu_torch.pipeline_parallel.runtime_emitter import \
                _strategy_of
            table = []
            for inst in self.instructions:
                if inst.opcode == PipelineInstType.RUN:
                    table.append((f"RUN {inst.info}", inst.dst_mesh))
                elif inst.opcode == PipelineInstType.RESHARD:
                    strategy = _strategy_of(inst)
                    tag = "" if strategy == "direct_p2p" else \
                        f" [{strategy}]"
                    table.append((f"RESHARD {inst.src_mesh}->"
                                  f"{inst.dst_mesh}{tag}", inst.dst_mesh))
                else:
                    table.append(("FREE", inst.free_keys[0][2]
                                  if inst.free_keys else 0))
            self._inst_name_table = table
        return self._inst_name_table

    def _inst_runner(self, env, runs, transfers, clock):
        """``run(idx)``: instruction ``idx`` of the "sequential" and
        "threaded" loops, inside a flight event and a span (the device
        clock's on CUDA) where those are on."""
        insts = self.instructions

        def plain(idx):
            self._exec_inst(idx, insts[idx], env, runs, transfers)
        trace_on = _ttrace.enabled() or global_config.collect_trace
        flight_on = _flight.enabled()
        if not (trace_on or flight_on):
            return plain
        names = self._inst_names()
        rec = _flight.get_recorder() if flight_on else None
        trec = _ttrace.get_recorder()

        def hooked(idx):
            name, mesh = names[idx]
            op = lambda regs: plain(idx)  # noqa: E731
            if clock is not None:
                op = clock.wrap(op, idx, name, "instruction", f"mesh {mesh}")
            t0 = _flight.now_us()
            try:
                if trace_on and clock is None:
                    with trec.span(name, "instruction", None, f"mesh {mesh}"):
                        op(None)
                else:
                    op(None)
            except BaseException as e:  # noqa: B036 -- recorded, re-raised
                if rec is not None:
                    rec.record("exec", name, mesh, idx, (), t0,
                               _flight.now_us(), f"error:{type(e).__name__}")
                raise
            if rec is not None:
                rec.record("exec", name, mesh, idx, (), t0, _flight.now_us(),
                           "ok")
        return hooked

    def _run_streams_threaded(self, run, step):
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
                            run(idx)
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

    def _preplaced_keys(self) -> List[Tuple[Any, int, int]]:
        """The ``(node, instance, mesh)`` keys placed at launch: every
        batch slice and other input on each mesh that reads it, and the
        accumulators."""
        return ([(v, mb, m) for v, meshes in self.input_place.items()
                 for m in meshes
                 for mb in (range(self.num_micro_batches)
                            if self.batch_invars[self._input_index[v]]
                            else (-1,))] +
                [(acc, -1, m) for acc, m in self.acc_allocs])

    def _program(self, mode, runs, transfers, step):
        """The register-file program of ``mode``: lowered once per mode over
        the eager run and transfer tables, and once per capture over the
        graphs (whose ops are also put on the CUDA streams).  The plan's
        first lowering is verified; later ones, of any mode, carry its
        verdict."""
        preplaced = self._preplaced_keys()
        cache = self._register_programs if step is None else step.programs
        if mode not in cache:
            verify = (self._plan_context() if self._verdict is None and
                      global_config.verify_plans != "off" else None)
            prog = lower_to_register_file(
                self.instructions, preplaced, runs.__getitem__,
                transfers.__getitem__, mode=mode,
                overlap_window=self.schedule.overlap_window_hint(),
                verify=verify)
            if verify is not None:
                self._verdict, self.verified_mode = prog.verdict, mode
            else:
                prog.verdict = self._verdict
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

    def _eager_clock(self, key, prog) -> "_DeviceClock":
        """The device clock of the uncaptured ops of ``key`` (a dispatch
        mode's program, or "instructions" for the interpreter loops), each
        timed on its mesh's device."""
        clock = self._clocks.get(key)
        if clock is None:
            meshes = ([h.mesh for h in prog.hooks] if prog is not None else
                      [m for _, m in self._inst_names()])
            clock = self._clocks[key] = _DeviceClock(
                [self.mesh_devices[m] for m in meshes])
        return clock

    def _start_clock(self, clock: "_DeviceClock"):
        """Sync the cards and take the host/device anchors of a traced
        step; its spans are recorded after the step."""
        clock.pending.clear()
        self._clock = clock
        self._anchors = _DeviceClock.anchor(self._cuda_devices())

    def _device_timed(self) -> bool:
        """Whether the step's ops are timed on the device clock (CUDA): a
        replayed graph returns to the host in microseconds, so only a
        traced step times them.  On the CPU the host clock is the
        device's."""
        return self.mesh_devices[0].type == "cuda"

    def _cuda_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(
            torch.device("cuda", d.index or 0) for devs in
            self.mesh_device_lists for d in devs if d.type == "cuda"))

    def _flush_device_spans(self):
        """After a traced step on CUDA: sync the cards, record each op's
        device-clock span (``complete``; the host's dispatch time as the
        ``host_dispatch_us`` argument) and keep them for
        ``get_perf_report``."""
        from alpa_tpu_torch.analysis.critical_path import TimedOp
        for d in self._cuda_devices():
            torch.cuda.synchronize(d)
        clock, self._clock = self._clock, None
        rec = _ttrace.get_recorder()
        prog = self._last_program
        kinds = ([h.kind for h in prog.hooks] if prog is not None and
                 prog.hooks is not None else None)
        ops = []
        for k, name, cat, track, ts, dur, host_us in clock.spans(
                self._anchors):
            rec.complete(name, cat, ts, dur, {"host_dispatch_us": host_us,
                                              "clock": "device"}, track)
            kind = kinds[k] if kinds is not None else "exec"
            ops.append(TimedOp(idx=len(ops), name=name, kind=kind,
                               track=track, t0_us=ts, t1_us=ts + dur))
        self._device_ops = (ops, prog)

    def _timed_stream_ops(self, prog, step, transfers):
        """The program's stream ops with a timing event pair baked into
        each (``_on_stream``), and their clock."""
        stream_of = self._instruction_streams.stream_of
        devices = []
        for kind, members, _, _ in prog.op_info:
            # the device of the stream ``_stream_ops`` puts the op on
            m = (self.instructions[members[0]].dst_mesh if kind == "launch"
                 else stream_of[members[0]])
            devices.append(self.mesh_devices[m])
        clock = _DeviceClock(devices, baked=True)
        return self._stream_ops(prog, step, transfers, clock.pairs), clock

    def _stream_ops(self, prog, step, transfers, timing=None):
        """The program's ops on CUDA streams: each instruction's op on its
        mesh's stream after the events of its cross-stream dependencies; a
        launched transfer on its device's side stream after the events of
        all its predecessors in the dataflow graph; a wait makes the
        destination's stream wait for the transfer's event.  ``timing``:
        a pair of timing events per op, recorded around it."""
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
        for k, (op, (kind, members, srcs, dsts), waits) in enumerate(zip(
                prog.ops, prog.op_info, waits_of)):
            wait_evs = [step.events[d] for d in sorted(waits)]
            tm = timing[k] if timing is not None else None
            if kind == "exec":
                stream = step.mesh_streams[stream_of[members[0]]]
                records = [step.events[i] for i in members if i in needed]
                ops.append(_on_stream(op, stream, wait_evs, records, tm))
            elif kind == "launch":
                inst = self.instructions[members[0]]
                stream = step.side_streams[self.mesh_devices[inst.dst_mesh]]
                ts = [transfers[i] for i in members]

                def launch(regs, _t=ts, _s=srcs, _d=dsts):
                    for t, s, d in zip(_t, _s, _d):
                        regs[d] = t(regs[s])
                ops.append(_on_stream(launch, stream, wait_evs,
                                      [step.events[i] for i in members], tm))
            else:
                stream = step.mesh_streams[stream_of[members[0]]]
                ops.append(_on_stream(lambda regs: None, stream, wait_evs,
                                      [], tm))
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
            self._count_copy("in", i, buf)
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
            self._count_copy("in", i, buf)
        for i, m, buf in step.copy_loads:
            x = inputs[i]
            if isinstance(x, torch.Tensor) and x.data_ptr() == buf.data_ptr():
                continue   # the buffer the last step handed back
            self._count_copy("in", i, buf)
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
                if isinstance(x, DistributedArray) and not x.shape:
                    x = x.shards[0]
                if j in feedback:
                    i, buf = feedback[j]
                    if x.data_ptr() != buf.data_ptr():
                        buf.copy_(x)
                        self._count_copy("out", j, buf)
                    x = buf.detach()
                    step.handed[i] = weakref.ref(x)
                elif copy_out and isinstance(x, torch.Tensor) and \
                        x.untyped_storage().data_ptr() not in user:
                    x = x.clone()
                    self._count_copy("out", j, x)
                outs.append(x)
            else:
                v, meshes = payload
                vals = [get((v, mb, m)) for mb, m in meshes]
                if n_mb == 1:
                    x = vals[0]
                    if copy_out and x.untyped_storage().data_ptr() \
                            not in user:
                        x = x.clone()
                        self._count_copy("out", j, x)
                    outs.append(x)
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

    def _count_copy(self, kind: str, idx: int, x):
        table = self.last_copies[kind]
        table[idx] = table.get(idx, 0) + sum(
            t.numel() * t.element_size() for t in _tensors(x))

    def get_copy_stats(self) -> Dict[str, Dict[int, int]]:
        """The bytes the last launch copied: ``"in"`` per flat input (into a
        buffer of the step, a microbatch slice or another device or dtype)
        and ``"out"`` per flat output (out of a CUDA graph's memory)."""
        return {k: dict(v) for k, v in self.last_copies.items()}

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
        """Release the storage of donated input tensors (and shards) that no
        output and no undonated input shares (the counterpart of JAX
        deleting a donated buffer)."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(t) for x in outs for t in _tensors(x)}
        keep.update(ptr(t) for x, d in zip(flat_args, self.donated_invars)
                    if not d for t in _tensors(x))
        keep.update(self._owned_ptrs())
        for x, d in zip(flat_args, self.donated_invars):
            if not d:
                continue
            for t in _tensors(x):
                if ptr(t) not in keep:
                    storage = t.untyped_storage()
                    if storage.resizable():
                        storage.resize_(0)

    def __call__(self, *args):
        return self.launch_on_driver(*args)

    # ---- introspection ----
    # ---- the plan analyses ----
    def _plan_context(self) -> PlanContext:
        """What the plan verifier reads of this executable (the JAX
        driver's ``_make_lowerer``): the placed values' shardings, the
        optimizer-state keys and each placed value's provenance by its
        pytree path, the program outputs and the equivalence reference,
        derived from the list before any rewrite."""
        from alpa_tpu_torch.shard_parallel.auto_sharding import (
            is_opt_state_path, is_param_path)
        n_mb = self.num_micro_batches
        preplaced: Dict[Tuple[Any, int, int], Any] = {}
        provenance: Dict[Tuple[Any, int, int], str] = {}
        opt_state = set()
        for v, meshes in self.input_place.items():
            batch = self.batch_invars[self._input_index[v]]
            path = self.invar_paths.get(v, "")
            prov = ("opt_state" if is_opt_state_path(path) else
                    "param" if is_param_path(path) else "activation")
            for m in meshes:
                for mb in (range(n_mb) if batch else (-1,)):
                    preplaced[(v, mb, m)] = self.input_sharding[(v, m)]
                    if self.invar_paths:
                        provenance[(v, mb, m)] = prov
                if self.invar_paths and is_opt_state_path(path):
                    opt_state.add((v, -1, m))
        for acc, m in self.acc_allocs:
            preplaced[(acc, -1, m)] = self.acc_sharding[(acc, m)]
            provenance[(acc, -1, m)] = "gradient"
        protected = set()
        for kind, payload in self.output_specs:
            if kind == "env":
                (k, m) = payload
                protected.add((k[0], k[1], m))
            elif kind == "concat":
                v, meshes = payload
                protected.update((v, mb, m) for mb, m in meshes)
        reference = None
        if global_config.verify_plans_equiv != "off":
            from alpa_tpu_torch.analysis import equivalence as _equiv
            reference = _equiv.build_reference(self.baseline_instructions,
                                               n_mb)
        return PlanContext(
            preplaced_shardings=preplaced,
            protected_keys=frozenset(protected),
            opt_state_keys=frozenset(opt_state),
            provenance_keys=provenance, reference=reference,
            plan_fingerprint=self.get_plan_fingerprint(),
            devices=tuple(d for devs in self.mesh_device_lists
                          for d in devs))

    def _lower_for_analysis(self, instructions, mode: str,
                            context: PlanContext):
        """``instructions`` lowered and verified with no run or transfer
        behind its ops (the superoptimizer's candidates)."""
        return lower_to_register_file(
            list(instructions), self._preplaced_keys(), lambda i: None,
            lambda i: None, mode=mode,
            overlap_window=self.schedule.overlap_window_hint(),
            verify=context)

    def _ensure_verified(self, mode: str):
        """Before the first launch: the superoptimizer (under
        ``superopt_mode`` "suggest" or "auto"), then the plan's verdict,
        on the program ``mode`` replays ("registers" for the interpreter
        loops).  Under ``verify_plans="error"`` (or "error" on numerics or
        equivalence) a finding raises ``PlanVerificationError`` here, and
        again at every later launch."""
        if self._refusal is not None:
            raise self._refusal
        vmode = mode if mode in ("registers", "overlap") else "registers"
        if self._verdict is not None:
            return
        from alpa_tpu_torch.analysis.plan_verifier import \
            PlanVerificationError
        try:
            if global_config.superopt_mode in ("suggest", "auto") and \
                    self._superopt_outcome is None:
                self._run_superopt(vmode)
            if global_config.verify_plans == "off" or \
                    self._verdict is not None:
                return
            runs, transfers = self._eager_tables()
            self._program(vmode, runs, transfers, None)
        except PlanVerificationError as e:
            self._verdict, self.verified_mode = e.verdict, vmode
            self._refusal = e
            raise

    def _run_superopt(self, mode: str):
        """The certified superoptimization decision (the JAX driver's
        ``_run_superopt``): lower and verify the baseline, search, gate the
        winner on the verdict diff and, under "auto" with an accepted
        rewrite, run the rewritten list from now on: every table indexed
        by instruction (the eager runs and transfers, the captures, the
        span names, the streams) is built from it."""
        from alpa_tpu_torch.analysis import superopt as _superopt
        from alpa_tpu_torch.analysis.plan_verifier import PlanVerdict
        smode = global_config.superopt_mode
        old_verify = global_config.verify_plans
        if old_verify == "off":
            # the gate needs verified programs
            global_config.verify_plans = "warn"
        try:
            context = self._plan_context()
            baseline = self._lower_for_analysis(self.instructions, mode,
                                                context)
            candidate_ctx = dataclasses.replace(context,
                                                plan_fingerprint=None)

            def lower(insts):
                return self._lower_for_analysis(insts, mode, candidate_ctx)

            def verify(prog, _insts):
                v = prog.verdict
                return v if v is not None else PlanVerdict()

            try:
                outcome = _superopt.run_superopt(
                    list(self.instructions), self.num_meshes, baseline,
                    lower, verify, mode=smode)
            except Exception:  # pylint: disable=broad-except
                logger.exception(
                    "superopt: engine failed; keeping the baseline plan")
                outcome = _superopt.SuperoptOutcome(
                    mode=smode, searched=True, cache_hit=False,
                    accepted=False,
                    layout=_superopt.identity_layout(
                        len(self.instructions)),
                    baseline_score=_superopt.PlanScore(0.0, ()),
                    best_score=_superopt.PlanScore(0.0, ()),
                    baseline_fingerprint=baseline.fingerprint(),
                    fingerprint=None,
                    rejected=[("superopt", "engine-error")], log=[])
        finally:
            global_config.verify_plans = old_verify
        self._superopt_outcome = outcome
        if smode == "auto" and outcome.accepted and \
                outcome.instructions is not None:
            self._set_instructions(outcome.instructions)
            self._verdict = outcome.program.verdict
        else:
            self._verdict = baseline.verdict
        self.verified_mode = mode

    def _set_instructions(self, instructions, as_baseline: bool = False):
        """Run ``instructions`` from now on, dropping every table built
        from the old list.  ``as_baseline``: the list replaces the driver's
        own (the equivalence reference and the superoptimizer's baseline
        are derived from it; tests and ``chip_smoke.py`` plant a
        deoptimized list so)."""
        self.instructions = list(instructions)
        if as_baseline:
            self.baseline_instructions = self.instructions
            self._superopt_outcome = None
            self._refusal = None
        self._instruction_streams = partition_streams(
            self.instructions, self.num_meshes, self._key_alias)
        self._has_cross_mesh = any(
            i.opcode == PipelineInstType.RESHARD and i.src_mesh != i.dst_mesh
            for i in self.instructions)
        self._register_programs = {}
        self._register_program = None
        self._eager = None
        self._inst_name_table = None
        self._clocks = {}
        self._race_checker = None
        self._captured = None
        self._verdict = None

    def get_plan_verdict(self, mode: str = "registers"):
        """The plan verifier's ``PlanVerdict``, lowering and verifying the
        program of ``mode`` on demand before the first launch.  One verdict
        per plan: once a mode's program was verified (the first launch
        verifies the mode it dispatches), that verdict is the plan's, for
        every mode.  None when ``verify_plans`` is off or lowering
        failed."""
        if self._verdict is None:
            from alpa_tpu_torch.analysis.plan_verifier import \
                PlanVerificationError
            try:
                self._ensure_verified(mode)
            except PlanVerificationError as e:
                # under verify_plans="error" the launch is refused, but the
                # caller asked for a report
                return e.verdict
            except Exception:  # pylint: disable=broad-except
                logger.exception("get_plan_verdict: lowering failed")
                return None
        return self._verdict

    def _verdict_or_none(self, what: str):
        try:
            return self.get_plan_verdict()
        except Exception:  # pylint: disable=broad-except
            logger.exception("%s failed", what)
            return None

    def get_plan_verdict_text(self) -> str:
        """``plan_verdict.txt`` of ``monitoring.dump_debug_info``."""
        verdict = self._verdict_or_none("get_plan_verdict_text")
        if verdict is None:
            return ("plan verdict: (not available — verify_plans=off or "
                    "lowering failed)")
        return verdict.format_table()

    def get_model_check_text(self) -> str:
        """``model_check.txt``: the model checker's stats and findings."""
        verdict = self._verdict_or_none("get_model_check_text")
        if verdict is None:
            return ("model check: (not available — verify_plans=off or "
                    "lowering failed)")
        mc_stats = verdict.stats.get("model_check")
        if not mc_stats:
            return ("model check: (not run — verify_plans_model_check=off "
                    "or the plan exceeds the fixture-mode size gate)")
        from alpa_tpu_torch.analysis import model_check as _mc
        return _mc.format_stats(mc_stats, [f for f in verdict.findings()
                                           if f.analysis == "model_check"])

    def get_numerics_text(self) -> str:
        """``numerics.txt``: the per-output bound table and findings."""
        verdict = self._verdict_or_none("get_numerics_text")
        if verdict is None:
            return ("numerics: (not available — verify_plans=off or "
                    "lowering failed)")
        num_stats = verdict.stats.get("numerics")
        if not num_stats:
            return "numerics: (not run — verify_plans_numerics=off)"
        from alpa_tpu_torch.analysis import numerics as _num
        return _num.format_numerics(num_stats, [f for f in verdict.findings()
                                                if f.analysis == "numerics"])

    def get_equiv_text(self) -> str:
        """``equiv.txt``: the per-output proofs and findings."""
        verdict = self._verdict_or_none("get_equiv_text")
        if verdict is None:
            return ("equiv: (not available — verify_plans=off or lowering "
                    "failed)")
        eq_stats = verdict.stats.get("equiv")
        if not eq_stats:
            return "equiv: (not run — verify_plans_equiv=off)"
        from alpa_tpu_torch.analysis import equivalence as _eq
        return _eq.format_equiv(eq_stats, [f for f in verdict.findings()
                                           if f.analysis == "equiv"])

    def get_superopt_text(self) -> str:
        """``superopt.txt``: the superoptimizer's decision."""
        from alpa_tpu_torch.analysis import superopt as _superopt
        return _superopt.format_superopt_report(self._superopt_outcome)

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

    def get_collective_counts(self) -> Dict[str, Dict[str, Any]]:
        """Per collective kind, ``{"count", "bytes", "backend"}`` of one step:
        the collectives of every RUN of a stage of several devices (its
        partitioned program's, once per RUN)."""
        out: Dict[str, Dict[str, Any]] = {}
        for inst in self.instructions:
            e = inst.executable
            if inst.opcode != PipelineInstType.RUN or \
                    not isinstance(e, SpmdStageExecutable):
                continue
            for rec in e.program.records:
                row = out.setdefault(rec.kind, {"count": 0, "bytes": 0,
                                                "backend": rec.backend})
                row["count"] += 1
                row["bytes"] += rec.nbytes
                if row["backend"] != rec.backend:
                    row["backend"] = "mixed"
        return out

    def get_resharding_stats(self) -> Dict[str, Any]:
        """The step's RESHARDs: cross-mesh and relayouts, and the bytes the
        tile plans and the naive plans move (``planned_resharding_bytes``,
        ``naive_resharding_bytes``); the bytes the last launch moved
        between distinct devices are ``executed_resharding_bytes``, and
        the ``ExecutionReport``s of its uncaptured transfers sum to
        ``executed_cross_mesh_bytes`` (cross-mesh edges) and
        ``executed_intra_mesh_bytes`` (their intra-mesh legs and the
        relayouts), beside ``naive_cross_mesh_bytes``, the naive plans of
        the cross-mesh edges.
        ``strategies``: the RESHARDs per executor ("direct_p2p", a
        collective strategy, "quantized_int8", "tiled", ...)."""
        reshards = [i for i in self.instructions
                    if i.opcode == PipelineInstType.RESHARD]
        kinds: Dict[str, int] = {}
        for i in reshards:
            t = i.resharding[0]
            kind = getattr(t, "strategy", None) or t.mode
            kinds[kind] = kinds.get(kind, 0) + 1
        return {"cross_mesh": sum(i.src_mesh != i.dst_mesh
                                  for i in reshards),
                "relayouts": sum(i.src_mesh == i.dst_mesh for i in reshards),
                "planned_bytes": self.planned_resharding_bytes,
                "naive_bytes": self.naive_resharding_bytes,
                "executed_bytes": self.executed_resharding_bytes,
                "naive_cross_mesh_bytes": self.naive_cross_mesh_bytes,
                "cross_mesh_bytes": self.executed_cross_mesh_bytes,
                "intra_mesh_bytes": self.executed_intra_mesh_bytes,
                "strategies": kinds}

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

    # ---- measurement ----
    def _last_joined(self):
        """The last step's ops as a ``telemetry.perf.JoinedStep``: on CUDA
        the device-clock ops ``_flush_device_spans`` kept (in op order,
        joined to the program's hooks), None when the last step was not
        traced; on the CPU the recorder's host spans (JAX's join), else
        the flight ring."""
        from alpa_tpu_torch.telemetry import perf as _perf
        prog = self._last_program
        if self._device_timed():
            if self._device_ops is None:
                return None, prog
            ops, dprog = self._device_ops
            rec = _ttrace.get_recorder()
            t0, t1 = self._step_t0_us, self._step_t1_us
            pool = [s for s in rec.spans()
                    if (s.get("track") or "").startswith("alpa-overlap")
                    and t0 - 1.0 <= s["ts_us"] <= t1 + 1.0]
            aligned = (dprog is not None and dprog.hooks is not None and
                       len(ops) == len(dprog.hooks))
            if ops:
                t0 = min(t0, min(o.t0_us for o in ops))
                t1 = max(t1, max(o.t1_us for o in ops))
            return _perf.JoinedStep(ops=ops, t0_us=t0, envelope_us=t1 - t0,
                                    pool_spans=pool, source="trace",
                                    aligned=aligned), dprog
        joined = _perf.joined_from_recorder(_ttrace.get_recorder(), prog)
        if joined is None and _flight.enabled():
            joined = _perf.joined_from_flight(
                _flight.get_recorder().snapshot(), prog)
        return joined, prog

    def get_perf_report(self):
        """The last step's ``telemetry.perf.StepPerfReport`` (``alpa_tpu/
        pipeline_parallel/pipeshard_executable.py:1555``): critical path,
        per-mesh bubbles, transfer overlap, stage MFU, joined against the
        lowered program's dataflow graph.  On CUDA it reads the device
        clock, so the last step must have been traced (``telemetry.trace.
        set_enabled(True)`` or ``collect_trace``): else None, never the
        flight ring's host times, which order the ops only.  Publishes
        ``alpa_stage_mfu``, ``alpa_step_bubble_fraction`` and
        ``alpa_critical_path_us``, and feeds the calibration store once
        per step.  None when no step was recorded."""
        from alpa_tpu_torch.telemetry import calibration as _calibration
        from alpa_tpu_torch.telemetry import perf as _perf
        joined, prog = self._last_joined()
        if joined is None:
            return None
        stats = self.last_dispatch_stats or {}
        peak = None
        if self.mesh_devices[0].type != "cuda":
            # no card: MFU against the knob, else nothing meaningful
            peak = global_config.device_peak_tflops or float("inf")
        report = _perf.build_step_report(
            joined, program=prog, schedule=self.schedule,
            stage_execs=self.stage_execs + [e for e in self.apply_execs
                                            if e is not None],
            mode=stats.get("mode"), run_stats=stats, peak_tflops=peak)
        _perf.publish_report(report)
        if self._ingested_step != self._steps:
            self._ingested_step = self._steps
            try:
                _calibration.ingest_joined(joined)
            except Exception:  # pylint: disable=broad-except
                logger.exception("calibration ingest failed")
        self._last_joined_step = joined
        return report

    def get_perf_report_text(self) -> str:
        """The report as text, or why there is none."""
        report = None
        try:
            report = self.get_perf_report()
        except Exception:  # pylint: disable=broad-except
            logger.exception("get_perf_report_text failed")
        if report is None:
            if self._device_timed():
                return ("perf report: (not available -- the last step was "
                        "not traced; enable tracing via ALPA_TPU_TRACE=1 "
                        "or collect_trace and run a step)")
            return ("perf report: (not available -- no step recorded; "
                    "enable tracing via ALPA_TPU_TRACE=1 or the flight "
                    "ring via ALPA_TPU_FLIGHT=1 and run a step)")
        return report.format_text()

    def get_calibration_text(self) -> str:
        """The calibration store's entries ranked by drift from the
        analytic model."""
        from alpa_tpu_torch.telemetry.calibration import \
            format_calibration_report
        return format_calibration_report()

    def consider_replan(self, report=None):
        """Profile-guided replanning (``alpa_tpu/pipeline_parallel/
        pipeshard_executable.py:1610``) per ``global_config.replan_mode``:
        "off" returns None; "suggest" predicts the step's critical path
        from the calibration store's measured stage and wire medians
        (``simulate_dag`` over the report's dependency DAG) and returns the
        verdict.  "auto" raises: it would re-choose the resharding
        strategies from the store, and the port's strategy chooser prices
        edges by the wire model, not by the store (ROADMAP A.6).  None
        when off or when no step was measured."""
        from alpa_tpu_torch.analysis.critical_path import simulate_dag
        from alpa_tpu_torch.telemetry import calibration as _calibration
        mode = global_config.replan_mode
        if mode == "off":
            return None
        if mode == "auto":
            raise NotImplementedError(
                "replan_mode='auto' re-chooses resharding strategies from "
                "the calibration store, which the port's strategy chooser "
                "does not read yet (ROADMAP A.6); use 'suggest'")
        if report is None:
            report = self.get_perf_report()
        if report is None or not report.sim_durs_us:
            return None
        store = _calibration.get_calibration_store()
        baseline_us, _ = simulate_dag(report.sim_durs_us, report.sim_preds)
        durs = list(report.sim_durs_us)
        for op in report.sim_ops:
            stage = _calibration._stage_from_name(op.name)  # pylint: disable=protected-access
            m = None
            if stage is not None:
                m = store.measured_us("stage_run",
                                      _calibration.stage_signature(stage))
            elif op.kind == "wait":
                edge = _calibration._edge_from_name(op.name)  # pylint: disable=protected-access
                if edge is not None:
                    m = store.measured_us("reshard_wire",
                                          _calibration.edge_signature(*edge))
            if m is not None and 0 <= op.idx < len(durs):
                durs[op.idx] = m
        predicted_us, _ = simulate_dag(durs, report.sim_preds)
        verdict = {
            "mode": mode,
            "baseline_critical_path_us": baseline_us,
            "predicted_critical_path_us": predicted_us,
            "predicted_ratio": (predicted_us / baseline_us
                                if baseline_us > 0 else 1.0),
            "strategy_flips": [],
            "applied": False,
            "calibration_fingerprint": store.fingerprint(),
        }
        logger.info("replan(%s): predicted critical path %.1f us vs "
                    "measured %.1f us", mode, predicted_us, baseline_us)
        return verdict

    def get_plan_fingerprint(self) -> str:
        """A content hash of the compiled plan: the instruction stream and
        every stage's input and output shardings (``alpa_tpu/
        pipeline_parallel/pipeshard_executable.py:1738``).  Two
        executables with equal fingerprints replay alike."""
        import hashlib
        import re
        parts = [self.get_instruction_text()]
        for ex in self.stage_execs + [e for e in self.apply_execs
                                      if e is not None]:
            parts.append(ex.name)
            parts.append(repr([str(sh) for sh in ex.in_shardings]))
            parts.append(repr([str(sh) for sh in ex.out_shardings]))
        text = re.sub(r"0x[0-9a-fA-F]+", "0x0", "\n".join(parts))
        return hashlib.sha256(text.encode()).hexdigest()

    def dump_stage_execution_trace(self, filename: str):
        """Write the recorder's events (and the deprecated
        ``timer.tracer``'s) as a Chrome trace JSON file.  Needs
        ``collect_trace`` or tracing on while the steps ran; warns when
        there is nothing."""
        import json
        from alpa_tpu_torch.timer import tracer
        events = _ttrace.get_recorder().to_chrome_trace().get(
            "traceEvents", [])
        timed = [e for e in events if e.get("ph") != "M"]
        legacy = tracer.to_chrome_trace()
        if not timed and not legacy:
            logger.warning(
                "dump_stage_execution_trace: no events collected (last "
                "dispatch mode: %s) -- set global_config.collect_trace = "
                "True before running",
                (self.last_dispatch_stats or {}).get("mode"))
        with open(filename, "w", encoding="utf-8") as f:
            json.dump({"traceEvents": events + legacy}, f)


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
