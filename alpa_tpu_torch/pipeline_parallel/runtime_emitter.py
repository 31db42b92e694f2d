"""Pipeline instructions, per-mesh streams, FREE emission and the
register-file lowering.

Counterpart of ``alpa_tpu/pipeline_parallel/runtime_emitter.py``: the
instruction set (``RUN``, ``RESHARD``, ``FREE``), the split of the global
instruction list into per-mesh streams with their cross-stream
dependencies, ``FREE`` after each value's last use, the dispatch race
checker, the instruction dataflow graph with its static hazard check, the
overlap schedule, and the lowering of the instruction list to a flat
register file that the "registers" and "overlap" dispatch modes replay.  A
value is keyed ``(node, instance)``: instance is the microbatch for
per-microbatch values and -1 for values shared by all microbatches
(parameters, accumulators, apply-grad results).

The lowering is device-agnostic: a RUN op calls the callable the driver
gives for its instruction (a ``GraphModule`` call, or the replay of its
CUDA graph), a RESHARD op the driver's transfer callable.  Each op records
what it replays (``RegisterFileProgram.op_info``), so the driver can put
it on a CUDA stream with its cross-stream waits.

Each op also carries an ``OpHook`` (its kind, span name, mesh, dataflow
node and slot footprint) and ``op_meta`` (span name, category, track
``"mesh N"``), built at lowering.  ``RegisterFileProgram.execute`` checks
once per step whether any instrumentation is on (``collect_trace`` or
tracing, the flight recorder, ``debug_dispatch_races``) and then replays
a wrapped op list compiled for that combination and cached by it: trace
span > flight event > ``SlotHazardChecker`` > fault site, as the JAX module
nests them.  The fault hook (compiled in only while ``fault.instrumented()``)
fires a RUN's ``stage_launch`` and a RESHARD's (or a group's, once per
member) ``cross_mesh_send`` on the host before the op runs or replays,
under ``fault.call_with_retry``: a RUN that donates its inputs is retried
only for injected faults, which fire before it runs.  With all of it off
the raw closures run.  The executable may hand ``execute`` a ``timer`` that
times ops on the device instead of the host (the CUDA event pairs of
``pipeshard_executable``).

Each lowering records, per instruction, what the plan analyses read
(``analysis/``): a RUN's precision classification
(``shard_parallel.eqn_classify``), its stage-decomposition facts for the
translation validation and, under ``grad_quantize``, the gradient codec's
tag; a RESHARD's strategy, codec and whether it may join a batched group
(only ``direct_p2p`` edges may).  The program's ``text`` (one line per
instruction, values named by their fx nodes) gives its ``fingerprint``.
Where the caller passes ``verify`` (the executable's lowering context),
``analysis.plan_verifier.verify_program`` runs over the program at the end
of the lowering and its verdict is ``prog.verdict``.  Registers-mode
coalescing asks ``analysis.superopt.reshard_group_extent``, the one
legality oracle it shares with the superoptimizer's fusion family, which
honours ``superopt_max_group``.
"""
import dataclasses
import enum
import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from alpa_tpu_torch import fault as _fault
from alpa_tpu_torch.analysis.superopt import reshard_group_extent
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import flight as _flight
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace


class PipelineInstType(enum.IntEnum):
    RUN = 0
    RESHARD = 1
    FREE = 2


@dataclasses.dataclass
class PipelineInstruction:
    """One step of the static pipeline program."""
    opcode: PipelineInstType
    # RUN
    stage_id: Optional[int] = None
    micro_batch: Optional[int] = None
    input_keys: Optional[List[Tuple[Any, int]]] = None
    output_keys: Optional[List[Tuple[Any, int]]] = None
    # RESHARD (and the mesh a RUN executes on)
    var_key: Optional[Tuple[Any, int]] = None
    src_mesh: Optional[int] = None
    dst_mesh: Optional[int] = None
    # FREE: (node, instance, mesh)
    free_keys: Optional[List[Tuple[Any, int, int]]] = None
    info: str = ""
    # RUN: the stage's runnable
    executable: Any = dataclasses.field(default=None, repr=False)
    # RESHARD: its planned transfer (the tile plan and its executor)
    resharding: Any = dataclasses.field(default=None, repr=False)

    def __repr__(self):
        if self.opcode == PipelineInstType.RUN:
            return f"RUN(stage={self.stage_id}, mb={self.micro_batch})"
        if self.opcode == PipelineInstType.RESHARD:
            return (f"RESHARD({self.var_key}, {self.src_mesh}->"
                    f"{self.dst_mesh})")
        return f"FREE({len(self.free_keys)})"


@dataclasses.dataclass
class InstructionStreams:
    """``streams[m]``: the global instruction indices mesh ``m`` executes,
    in order; ``deps[i]``: the indices in other streams instruction ``i``
    waits for (read after write, and write or kill after any access).
    Every edge points to an earlier index, so in-order stream workers cannot
    deadlock."""
    streams: List[List[int]]
    deps: Dict[int, set]
    stream_of: Dict[int, int]


def instruction_accesses(inst, key_alias: Optional[Dict] = None
                         ) -> List[Tuple[Tuple[Any, int, int], str]]:
    """The (value key, "read" | "write" | "kill") pairs an instruction
    touches; an input the RUN's executable donates (``donate_idx``: written
    in place or released) is a kill.  ``key_alias`` maps a key to the key
    it shares storage with (one tensor placed on meshes of one device)."""
    acc = []
    if inst.opcode == PipelineInstType.RUN:
        donated = set(getattr(inst.executable, "donate_idx", ()) or ())
        for pos, k in enumerate(inst.input_keys):
            acc.append(((k[0], k[1], inst.dst_mesh),
                        "kill" if pos in donated else "read"))
        for k in inst.output_keys:
            acc.append(((k[0], k[1], inst.dst_mesh), "write"))
    elif inst.opcode == PipelineInstType.RESHARD:
        acc.append(((inst.var_key[0], inst.var_key[1], inst.src_mesh),
                    "read"))
        acc.append(((inst.var_key[0], inst.var_key[1], inst.dst_mesh),
                    "write"))
    else:
        acc.extend((tuple(key), "kill") for key in inst.free_keys)
    if key_alias:
        acc = [(key_alias.get(key, key), kind) for key, kind in acc]
    return acc


def instructions_independent(a, b) -> bool:
    """Whether two instructions commute: no value key is touched by both
    with at least one of them writing or killing it."""
    keys_b: Dict[Tuple[Any, int, int], str] = {}
    for key, kind in instruction_accesses(b):
        if keys_b.get(key) not in ("write", "kill"):
            keys_b[key] = kind
    for key, kind in instruction_accesses(a):
        other = keys_b.get(key)
        if other is not None and (kind != "read" or other != "read"):
            return False
    return True


def partition_streams(instructions: List[PipelineInstruction],
                      num_meshes: int, key_alias: Optional[Dict] = None
                      ) -> InstructionStreams:
    """Split the global instruction list into per-mesh streams.  RUN and
    RESHARD go to their destination mesh; FREE follows the instruction
    before it (its last user)."""
    streams: List[List[int]] = [[] for _ in range(num_meshes)]
    stream_of: Dict[int, int] = {}
    deps: Dict[int, set] = {}
    history: Dict[Tuple[Any, int, int], List[Tuple[int, int, str]]] = {}
    prev_stream = 0
    for i, inst in enumerate(instructions):
        m = prev_stream if inst.opcode == PipelineInstType.FREE \
            else inst.dst_mesh
        m = m if 0 <= m < num_meshes else 0
        streams[m].append(i)
        stream_of[i] = prev_stream = m
        d = set()
        for key, kind in instruction_accesses(inst, key_alias):
            hist = history.setdefault(key, [])
            if kind == "read":
                for j, sm, k in reversed(hist):
                    if k in ("write", "kill"):
                        if sm != m:
                            d.add(j)
                        break
            else:
                d.update(j for j, sm, _ in hist if sm != m)
            hist.append((i, m, kind))
        if d:
            deps[i] = d
    return InstructionStreams(streams, deps, stream_of)


class DispatchRaceChecker:
    """Runtime race detector of threaded dispatch (``debug_dispatch_races``):
    each worker reports its instruction's value accesses before executing
    it and withdraws them after.  Two accesses from different streams to
    one key, at least one a write or kill, at once, are a violation: the
    stream dependencies failed to order them."""

    def __init__(self, instructions, stream_of, key_alias=None):
        self._stream_of = stream_of
        self._accs = [instruction_accesses(i, key_alias)
                      for i in instructions]
        self._lock = threading.Lock()
        self._active: Dict[Tuple, Dict[int, str]] = {}
        self.violations: List[str] = []

    @staticmethod
    def _conflict(a: str, b: str) -> bool:
        return a != "read" or b != "read"

    def begin(self, idx: int):
        accs = self._accs[idx]
        me = self._stream_of[idx]
        with self._lock:
            for key, kind in accs:
                holders = self._active.setdefault(key, {})
                for other, okind in holders.items():
                    if self._stream_of[other] != me and \
                            self._conflict(kind, okind):
                        self.violations.append(
                            f"inst {idx} ({kind} {key}) raced inst "
                            f"{other} ({okind}) across streams "
                            f"{me}/{self._stream_of[other]}")
                holders[idx] = kind
        return accs

    def end(self, idx: int, accs):
        with self._lock:
            for key, _ in accs:
                holders = self._active.get(key)
                if holders is not None:
                    holders.pop(idx, None)
                    if not holders:
                        self._active.pop(key, None)

    def reset(self):
        """Clear violations and in-flight accesses (at each launch)."""
        with self._lock:
            self._active = {}
            self.violations = []

    def check(self):
        if self.violations:
            raise RuntimeError(
                "threaded dispatch raced (stream dependency edges failed "
                "to serialize conflicting accesses):\n  " +
                "\n  ".join(self.violations[:10]))


########################################
# the instruction dataflow graph
########################################


@dataclasses.dataclass
class DataflowNode:
    """One lowered instruction's register-slot footprint."""
    idx: int
    kind: str                           # "RUN" | "RESHARD" | "FREE"
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    kills: Tuple[int, ...] = ()         # donation / FREE targets
    edge: Optional[Tuple[int, int]] = None  # RESHARD (src_mesh, dst_mesh)
    cross_mesh: bool = False
    info: str = ""


@dataclasses.dataclass
class InstructionDataflowGraph:
    """Producer/consumer edges over register slots: a reader depends on
    the last writer of each slot it reads (RAW); a writer or killer on the
    previous writer and every reader since (WAW, WAR, kill).  Every edge
    points to an earlier index."""
    nodes: List[DataflowNode]
    preds: List[Tuple[int, ...]]
    succs: List[Tuple[int, ...]]

    @classmethod
    def build(cls, nodes: Sequence[DataflowNode]
              ) -> "InstructionDataflowGraph":
        last_writer: Dict[int, int] = {}
        readers_since: Dict[int, List[int]] = {}
        preds: List[set] = [set() for _ in nodes]
        for node in nodes:
            i = node.idx
            for s in node.reads:
                w = last_writer.get(s)
                if w is not None and w != i:
                    preds[i].add(w)
                readers_since.setdefault(s, []).append(i)
            for s in tuple(node.writes) + tuple(node.kills):
                w = last_writer.get(s)
                if w is not None and w != i:
                    preds[i].add(w)
                for r in readers_since.get(s, ()):
                    if r != i:
                        preds[i].add(r)
                readers_since[s] = []
                last_writer[s] = i
        succs: List[set] = [set() for _ in nodes]
        for i, ps in enumerate(preds):
            for p in ps:
                succs[p].add(i)
        return cls(list(nodes), [tuple(sorted(p)) for p in preds],
                   [tuple(sorted(s)) for s in succs])

    @property
    def n_cross_mesh(self) -> int:
        return sum(1 for n_ in self.nodes if n_.cross_mesh)

    def check(self) -> None:
        """Re-derive every slot hazard with a forward walk and assert that
        ``preds`` covers it; validate the RESHARD nodes' structure (one
        read, one write, an edge that agrees with ``cross_mesh``).  Raises
        on a missing or forward edge."""
        nodes = self.nodes
        problems: List[str] = []
        for i, node in enumerate(nodes):
            if node.idx != i:
                problems.append(
                    f"node at position {i} carries idx {node.idx}")
            if node.kind == "RESHARD":
                if node.edge is None:
                    problems.append(
                        f"RESHARD node {i} carries no mesh edge")
                elif node.cross_mesh != (node.edge[0] != node.edge[1]):
                    problems.append(
                        f"RESHARD node {i} cross_mesh={node.cross_mesh}"
                        f" disagrees with edge {node.edge}")
                if len(node.reads) != 1 or len(node.writes) != 1:
                    problems.append(
                        f"RESHARD node {i} must read/write exactly one "
                        f"slot each, has reads={node.reads} "
                        f"writes={node.writes}")
        last_writer: Dict[int, int] = {}
        readers_since: Dict[int, List[int]] = {}
        for node in nodes:
            if len(problems) > 20:
                break
            i = node.idx
            preds = set(self.preds[i]) if i < len(self.preds) else set()
            for p in preds:
                if p >= i:
                    problems.append(
                        f"node {i} ({node.kind}) has a non-backward "
                        f"edge to node {p}")
            for s in node.reads:
                w = last_writer.get(s)
                if w is not None and w != i and w not in preds:
                    problems.append(
                        f"RAW hazard: node {i} ({node.kind}) reads slot "
                        f"{s} with no edge to its writer, node {w}")
                readers_since.setdefault(s, []).append(i)
            for s in tuple(node.writes) + tuple(node.kills):
                kill = s in node.kills
                verb = "kills" if kill else "writes"
                w = last_writer.get(s)
                if w is not None and w != i and w not in preds:
                    if kill and nodes[w].cross_mesh:
                        problems.append(
                            f"FREE of an in-flight transfer destination:"
                            f" node {i} ({node.kind}) kills slot {s} "
                            f"with no edge to cross-mesh transfer node "
                            f"{w}")
                    else:
                        problems.append(
                            f"WAW hazard: node {i} ({node.kind}) {verb} "
                            f"slot {s} with no edge to its previous "
                            f"writer, node {w}")
                for r in readers_since.get(s, ()):
                    if r != i and r not in preds:
                        problems.append(
                            f"write-after-read on a live slot: node {i} "
                            f"({node.kind}) {verb} slot {s} with no "
                            f"edge to its reader, node {r}")
                readers_since[s] = []
                last_writer[s] = i
        if problems:
            raise RuntimeError(
                "instruction dataflow graph failed the static hazard "
                "check (a dependency edge is missing or malformed):\n  "
                + "\n  ".join(problems[:20]))


def schedule_overlap(graph: InstructionDataflowGraph, window: int
                     ) -> Tuple[List[Tuple[str, int]], int]:
    """Greedy overlap schedule: replay the dataflow graph with cross-mesh
    RESHARDs launched as soon as their producers retire, at most ``window``
    launched and not yet waited.  Returns ``(plan, n_hoisted)``: ``plan`` is
    a list of ``("exec" | "launch" | "wait", node)`` steps, ``n_hoisted``
    the transfers launched before their place in the flat order.  Every
    node issues once, after all its predecessors retired; other ops keep
    their flat order; each launch has one later wait."""
    nodes = graph.nodes
    n = len(nodes)
    window = max(1, int(window))
    unmet = [len(graph.preds[i]) for i in range(n)]
    issued = [False] * n
    retired = [False] * n
    inflight: List[int] = []
    ready: List[int] = []
    plan: List[Tuple[str, int]] = []
    n_hoisted = 0

    def retire(i):
        retired[i] = True
        for s in graph.succs[i]:
            unmet[s] -= 1
            if unmet[s] == 0 and nodes[s].cross_mesh and not issued[s]:
                heapq.heappush(ready, s)

    def wait(i):
        plan.append(("wait", i))
        inflight.remove(i)
        retire(i)

    def launch(i, cur):
        nonlocal n_hoisted
        plan.append(("launch", i))
        issued[i] = True
        inflight.append(i)
        if i > cur:
            n_hoisted += 1

    def pump(cur):
        while ready and len(inflight) < window:
            i = heapq.heappop(ready)
            if not issued[i]:
                launch(i, cur)

    for i in range(n):
        if unmet[i] == 0 and nodes[i].cross_mesh:
            heapq.heappush(ready, i)
    pump(-1)
    for cur in range(n):
        node = nodes[cur]
        if node.cross_mesh:
            if not issued[cur]:
                while len(inflight) >= window:
                    wait(inflight[0])
                for p in graph.preds[cur]:
                    if not retired[p]:
                        wait(p)
                launch(cur, cur)
            pump(cur)
            continue
        for p in graph.preds[cur]:
            if not retired[p]:
                wait(p)
        plan.append(("exec", cur))
        issued[cur] = True
        retire(cur)
        pump(cur)
    while inflight:
        wait(inflight[0])
    return plan, n_hoisted


########################################
# the register-file lowering
########################################


@dataclasses.dataclass
class OpHook:
    """One op's hook point, built at lowering (``alpa_tpu/
    pipeline_parallel/runtime_emitter.py:591``): which dataflow node the
    op replays, its slot footprint, its span name and mesh.  A batched
    group op carries the union footprint and all its members."""
    kind: str                             # "exec" | "launch" | "wait"
    name: str                             # span / flight event label
    node: int                             # dataflow node (group: first)
    mesh: int
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    kills: Tuple[int, ...] = ()
    slots: Tuple[int, ...] = ()           # union footprint (flight events)
    members: Tuple[int, ...] = ()         # instruction indices replayed
    fault_site: Optional[str] = None      # fault.py site name
    fault_infos: Tuple[Any, ...] = ()     # one info dict per member
    idempotent: bool = True               # retry semantics (donation)
    precision: Optional[Dict[str, Any]] = None   # RUN: eqn_classify
    equiv: Optional[Dict[str, Any]] = None       # RUN: stage facts


class SlotHazardChecker:
    """The register and overlap replay's slot accesses held against the
    transfers in flight (``alpa_tpu/pipeline_parallel/
    runtime_emitter.py:630``): between a transfer's launch and its wait
    nothing may read its destination slot, write either endpoint, or free
    or donate them.  Armed by ``global_config.debug_dispatch_races``; a
    violation raises at the step's end.  Driver thread only."""

    def __init__(self):
        self._inflight_src: Dict[int, int] = {}   # slot -> launch node
        self._inflight_dst: Dict[int, int] = {}
        self.violations: List[str] = []

    def begin_step(self):
        self._inflight_src.clear()
        self._inflight_dst.clear()
        self.violations = []

    def on_launch(self, hook: OpHook):
        for s in hook.reads:
            self._inflight_src[s] = hook.node
        for s in hook.writes:
            self._inflight_dst[s] = hook.node

    def on_wait(self, hook: OpHook):
        for s in hook.reads:
            self._inflight_src.pop(s, None)
        for s in hook.writes:
            self._inflight_dst.pop(s, None)

    def on_exec(self, hook: OpHook):
        for s in hook.reads:
            n = self._inflight_dst.get(s)
            if n is not None:
                self.violations.append(
                    f"{hook.name} (node {hook.node}) reads slot {s} "
                    f"still owned by in-flight transfer node {n}")
        for s in hook.writes:
            for owners, role in ((self._inflight_src, "source"),
                                 (self._inflight_dst, "destination")):
                n = owners.get(s)
                if n is not None:
                    self.violations.append(
                        f"{hook.name} (node {hook.node}) writes slot "
                        f"{s}, the {role} of in-flight transfer node "
                        f"{n}")
        for s in hook.kills:
            for owners, role in ((self._inflight_src, "source"),
                                 (self._inflight_dst, "destination")):
                n = owners.get(s)
                if n is not None:
                    self.violations.append(
                        f"{hook.name} (node {hook.node}) frees/donates "
                        f"slot {s}, the {role} of in-flight transfer "
                        f"node {n}")

    def check(self):
        if self.violations:
            raise RuntimeError(
                "register/overlap replay raced an in-flight transfer "
                "(graph schedule failed to serialize slot accesses):"
                "\n  " + "\n  ".join(self.violations[:10]))


def _wrap_hazard(op, hook: OpHook, checker: SlotHazardChecker):
    if hook.kind == "launch":
        def wrapped(regs, _op=op, _h=hook, _c=checker):
            _c.on_launch(_h)
            _op(regs)
    elif hook.kind == "wait":
        def wrapped(regs, _op=op, _h=hook, _c=checker):
            _op(regs)
            _c.on_wait(_h)
    else:
        def wrapped(regs, _op=op, _h=hook, _c=checker):
            _c.on_exec(_h)
            _op(regs)
    return wrapped


def _wrap_fault(op, hook: OpHook):
    """Fault-site hook: fire every member's site before the op, retry
    under the site policy; the same FaultSpec hit counts as the
    instruction loops' per-instruction wrapping."""
    def wrapped(regs, _op=op, _site=hook.fault_site,
                _infos=hook.fault_infos, _idem=hook.idempotent):
        def attempt():
            for info in _infos:
                _fault.fire(_site, **info)
            _op(regs)
        _fault.call_with_retry(attempt, site=_site, idempotent=_idem)
    return wrapped


def _wrap_flight(op, hook: OpHook, rec):
    """One ring event per op on the host clock, outcome included; the
    op's exception is re-raised after it is recorded.  Never syncs."""
    def wrapped(regs, _op=op, _rec=rec.record, _now=_flight.now_us,
                _k=hook.kind, _n=hook.name, _m=hook.mesh,
                _nd=hook.node, _s=hook.slots):
        t0 = _now()
        try:
            _op(regs)
        except BaseException as e:  # noqa: B036 -- record, then re-raise
            _rec(_k, _n, _m, _nd, _s, t0, _now(),
                 f"error:{type(e).__name__}")
            raise
        _rec(_k, _n, _m, _nd, _s, t0, _now(), "ok")
    return wrapped


def _wrap_trace(op, name, cat, track, rec):
    def wrapped(regs, _op=op, _span=rec.span, _n=name, _c=cat, _t=track):
        with _span(_n, _c, None, _t):
            _op(regs)
    return wrapped


@dataclasses.dataclass
class RegisterFileProgram:
    """The instruction list lowered to a flat register file.  Replay is
    ``for op in ops: op(regs)`` over ``regs = [None] * num_slots``: every
    ``(node, instance, mesh)`` key has an integer slot, RUN ops hold
    precomputed slot tuples, FREE clears slots, adjacent RESHARDs of one
    mesh edge run as one group; in overlap mode cross-mesh RESHARDs are
    launch/wait pairs.  ``op_info[k]``: ``(kind, instruction indices,
    source slots, destination slots)`` of op ``k``, kind "exec", "launch"
    or "wait"; ``hooks[k]`` and ``op_meta[k]`` its hook point and span
    (name, category, track)."""
    num_slots: int
    ops: List[Callable]
    n_instructions: int
    by_opcode: Dict[str, int]
    slot_of: Dict[Tuple[Any, int, int], int]
    n_coalesced_groups: int
    op_info: List[Tuple[str, Tuple[int, ...], Tuple[int, ...],
                        Tuple[int, ...]]]
    mode: str = "registers"
    graph: Optional[InstructionDataflowGraph] = None
    n_cross_mesh: int = 0
    n_hoisted: int = 0
    n_launches: int = 0
    n_free_hops: int = 0
    overlap_window: int = 0
    # one line per instruction: what ``fingerprint`` hashes
    text: str = ""
    # the plan verifier's ``PlanVerdict`` when the lowering verified
    verdict: Any = None
    run_stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"transfer_busy_s": 0.0,
                                 "wait_blocked_s": 0.0})
    op_meta: Optional[List[Tuple[str, str, str]]] = None
    hooks: Optional[List[OpHook]] = None
    # which hook families ran last step
    last_hooks: Tuple[str, ...] = ()
    # compiled wrapped-op lists, keyed by (active-hook signature, the base
    # op list, the timer)
    _hooked: Dict[Any, Tuple[List[Callable], Any]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def fingerprint(self) -> str:
        """A content hash of the program: its mode and every
        instruction's line (stage, microbatch, slots, edge, strategy)."""
        import hashlib
        return hashlib.sha256(
            f"mode={self.mode}\n{self.text}".encode()).hexdigest()

    def execute(self, regs: List[Any], ops: Optional[List[Callable]] = None,
                timer: Any = None):
        """Replay ``ops`` (default: the program's own; a driver passes the
        same ops put on CUDA streams) over ``regs``.  ``timer``: with
        tracing on, ``timer.wrap(op, k, name, category, track)`` times op
        ``k`` in place of a host span (the driver's device clock)."""
        self.run_stats["transfer_busy_s"] = 0.0
        self.run_stats["wait_blocked_s"] = 0.0
        base = ops if ops is not None else self.ops
        sig = self._active_hook_signature() if self.hooks is not None \
            else None
        if sig is None:
            self.last_hooks = ()
            for op in base:
                op(regs)
            return
        key = (sig, id(base), id(timer) if sig[0] else 0)
        entry = self._hooked.get(key)
        if entry is None or entry[2] is not base:
            entry = self._compile_hooks(sig, base, timer) + (base,)
            self._hooked[key] = entry
        wrapped, hazard, _ = entry
        self.last_hooks = tuple(name for on, name in zip(
            (sig[0], sig[2], sig[3], sig[5]),
            ("trace", "race", "flight", "fault")) if on)
        if hazard is not None:
            hazard.begin_step()
        for op in wrapped:
            op(regs)
        if hazard is not None:
            hazard.check()

    @staticmethod
    def _active_hook_signature():
        """One check per step: None when nothing is on (the raw closures
        run); else which families are on and the recorders' identities
        (tests swap recorders)."""
        trace_on = _ttrace.enabled() or global_config.collect_trace
        race_on = global_config.debug_dispatch_races
        flight_on = _flight.enabled()
        fault_on = _fault.instrumented()
        if not (trace_on or race_on or flight_on or fault_on):
            return None
        return (trace_on,
                id(_ttrace.get_recorder()) if trace_on else 0,
                race_on, flight_on,
                id(_flight.get_recorder()) if flight_on else 0,
                fault_on)

    def _compile_hooks(self, sig, base, timer):
        """The wrapped op list for the active instrumentation, nesting
        (outermost first) trace span > flight event > hazard check >
        fault site, so a retry re-fires inside one span and the flight
        event records the outcome after the retries."""
        trace_on, _tid, race_on, flight_on, _fid, fault_on = sig
        hooks, meta = self.hooks, self.op_meta
        if hooks is None or len(hooks) != len(base):
            return list(base), None
        trec = _ttrace.get_recorder() if trace_on else None
        frec = _flight.get_recorder() if flight_on else None
        hazard = SlotHazardChecker() if race_on else None
        wrapped: List[Callable] = []
        for k, (op, hook) in enumerate(zip(base, hooks)):
            w = op
            if fault_on and hook.fault_site is not None:
                w = _wrap_fault(w, hook)
            if hazard is not None:
                w = _wrap_hazard(w, hook, hazard)
            if flight_on:
                w = _wrap_flight(w, hook, frec)
            if trace_on and meta is not None:
                name, cat, track = meta[k]
                w = (timer.wrap(w, k, name, cat, track) if timer is not None
                     else _wrap_trace(w, name, cat, track, trec))
            wrapped.append(w)
        return wrapped, hazard


def _make_run_op(run, in_slots, out_slots):
    def op(regs, _r=run, _i=in_slots, _o=out_slots):
        outs = _r([regs[s] for s in _i])
        for s, o in zip(_o, outs):
            regs[s] = o
    return op


def _make_reshard_op(transfer, src_slot, dst_slot):
    def op(regs, _t=transfer, _s=src_slot, _d=dst_slot):
        regs[_d] = _t(regs[_s])
    return op


def _make_reshard_group_op(transfers, src_slots, dst_slots):
    def op(regs, _t=transfers, _s=src_slots, _d=dst_slots):
        for t, s, d in zip(_t, _s, _d):
            regs[d] = t(regs[s])
    return op


def _make_free_op(slots):
    def op(regs, _s=slots):
        for i in _s:
            regs[i] = None
    return op


_TRANSFER_POOL = None
_TRANSFER_POOL_LOCK = threading.Lock()


def _transfer_pool():
    """The process-wide thread pool of overlap-mode transfers (the window,
    not the pool size, bounds the transfers in flight)."""
    global _TRANSFER_POOL
    with _TRANSFER_POOL_LOCK:
        if _TRANSFER_POOL is None:
            from concurrent.futures import ThreadPoolExecutor
            _TRANSFER_POOL = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="alpa-overlap")
    return _TRANSFER_POOL


class _PendingTransfer:
    """A launched transfer parked in its destination slots until its wait
    op; the dataflow graph guarantees nothing reads them in between."""
    __slots__ = ("future",)

    def __init__(self, future):
        self.future = future


# launched but unretired transfers, the "transfers_in_flight" counter
# track (touched only while tracing)
_INFLIGHT_LOCK = threading.Lock()
_INFLIGHT = 0


def _inflight_delta(d: int):
    global _INFLIGHT
    with _INFLIGHT_LOCK:
        _INFLIGHT += d
        v = _INFLIGHT
    _ttrace.counter("transfers_in_flight", v)


def _record_pool_spans(label, t_sub_us, t_run_us, t_end_us):
    """One transfer's pool-side spans (host clock): the labelled parent
    from submit to retire, with ``reshard.wait`` (queued between the
    driver's submit and a worker taking it) and ``reshard.wire`` (the
    transfer running) children."""
    rec = _ttrace.get_recorder()
    rec.complete(label, "transfer", t_sub_us, t_end_us - t_sub_us)
    rec.complete("reshard.wait", "transfer", t_sub_us,
                 max(0.0, t_run_us - t_sub_us))
    rec.complete("reshard.wire", "transfer", t_run_us,
                 max(0.0, t_end_us - t_run_us))


def _make_launch_op(transfers, src_slots, dst_slots, label="transfer"):
    def op(regs, _t=transfers, _s=src_slots, _d=dst_slots, _l=label):
        vals = [regs[s] for s in _s]
        traced = _ttrace.enabled()
        t_sub = _ttrace.now_us() if traced else 0.0

        def work(_traced=traced, _sub=t_sub):
            t_run = _ttrace.now_us() if _traced else 0.0
            tic = time.perf_counter()
            if _fault.instrumented():
                # a fault inside the transfer (a tile task's
                # cross_mesh_recv) surfaces here, in the pool: retried
                # under cross_mesh_send, as the instruction loops do
                outs = [_fault.call_with_retry(
                    lambda _tt=t, _v=v: _tt(_v), site="cross_mesh_send")
                    for t, v in zip(_t, vals)]
            else:
                outs = [t(v) for t, v in zip(_t, vals)]
            busy = time.perf_counter() - tic
            if _traced:
                _record_pool_spans(_l, _sub, t_run, _ttrace.now_us())
            return outs, busy

        if traced:
            _inflight_delta(1)
        regs[_d[0]] = _PendingTransfer(_transfer_pool().submit(work))
    return op


def _make_wait_op(dst_slots, stats):
    def op(regs, _d=dst_slots, _st=stats):
        pending = regs[_d[0]]
        if type(pending) is _PendingTransfer:
            tic = time.perf_counter()
            outs, busy = pending.future.result()
            _st["wait_blocked_s"] += time.perf_counter() - tic
            _st["transfer_busy_s"] += busy
            for d, o in zip(_d, outs):
                regs[d] = o
            if _ttrace.enabled():
                _inflight_delta(-1)
    return op


# the overlap runtime's counters, as the JAX module keeps them
_OVERLAP_REG = _tmetrics.get_registry()
_OVERLAP_STEPS = _OVERLAP_REG.counter(
    "alpa_overlap_steps_total", "Overlap-mode pipeshard steps executed")
_OVERLAP_BUSY = _OVERLAP_REG.counter(
    "alpa_overlap_transfer_busy_seconds_total",
    "Accumulated pool-side transfer execution time")
_OVERLAP_BLOCKED = _OVERLAP_REG.counter(
    "alpa_overlap_wait_blocked_seconds_total",
    "Accumulated driver time blocked in transfer waits")
_OVERLAP_HOISTED = _OVERLAP_REG.counter(
    "alpa_overlap_hoisted_total",
    "Cross-mesh transfers launched ahead of flat instruction order")
_OVERLAP_LAUNCHES = _OVERLAP_REG.counter(
    "alpa_overlap_launches_total",
    "Async transfer launches issued (a batched group counts once)")
_OVERLAP_LAST_FRACTION = _OVERLAP_REG.gauge(
    "alpa_overlap_last_overlap_fraction",
    "Last step's 1 - wait_blocked/transfer_busy overlap fraction")
_OVERLAP_LAST_WINDOW = _OVERLAP_REG.gauge(
    "alpa_overlap_last_window",
    "Last step's in-flight transfer window")


def record_overlap_step(prog: "RegisterFileProgram") -> None:
    """Fold one overlap-mode step into the ``alpa_overlap_*`` counters."""
    busy = prog.run_stats["transfer_busy_s"]
    blocked = prog.run_stats["wait_blocked_s"]
    _OVERLAP_STEPS.inc()
    _OVERLAP_BUSY.inc(busy)
    _OVERLAP_BLOCKED.inc(blocked)
    _OVERLAP_HOISTED.inc(prog.n_hoisted)
    _OVERLAP_LAUNCHES.inc(prog.n_launches)
    _OVERLAP_LAST_FRACTION.set(max(0.0, min(1.0, 1 - blocked / busy))
                               if busy > 0 else 1.0)
    _OVERLAP_LAST_WINDOW.set(prog.overlap_window)


def get_overlap_runtime_stats() -> Dict[str, Any]:
    """The overlap runtime's counters as ``monitoring.get_overlap_stats``
    reads them (JAX's dict)."""
    return {
        "steps": int(_OVERLAP_STEPS.value),
        "transfer_busy_s": _OVERLAP_BUSY.value,
        "wait_blocked_s": _OVERLAP_BLOCKED.value,
        "n_hoisted": int(_OVERLAP_HOISTED.value),
        "n_launches": int(_OVERLAP_LAUNCHES.value),
        "last_overlap_fraction": _OVERLAP_LAST_FRACTION.value,
        "last_window": int(_OVERLAP_LAST_WINDOW.value),
    }


def lower_to_register_file(
        instructions: List[PipelineInstruction],
        preplaced_keys: Sequence[Tuple[Any, int, int]],
        run_fn: Callable[[int], Callable],
        transfer_fn: Callable[[int], Callable],
        mode: str = "registers",
        overlap_window: int = 4,
        verify: Optional["PlanContext"] = None) -> RegisterFileProgram:
    """Lower the instruction list into a ``RegisterFileProgram``.

    ``preplaced_keys``: the ``(node, instance, mesh)`` keys placed at launch
    (inputs, accumulators), which get the first slots.  ``run_fn(i)``: the
    callable a RUN at index ``i`` replays (inputs list -> outputs);
    ``transfer_fn(i)``: that of a RESHARD (value -> value on its
    destination).  Phase 1, the same for every mode, numbers the slots and
    builds the dataflow graph, which ``InstructionDataflowGraph.check``
    holds to its hazards.  Phase 2: "registers" replays the flat order,
    with the RESHARDs of one edge coalesced past the FREEs between them;
    "overlap" replays ``schedule_overlap``'s plan, consecutive launches of
    one edge merged into one.  ``verify``: the executable's
    ``PlanContext``; with it (and ``verify_plans`` not "off") the plan
    verifier runs over the program, as the JAX package's lowering runs it
    on every compile."""
    if mode not in ("registers", "overlap"):
        raise ValueError(f"unknown lowering mode: {mode!r}")
    slot_of: Dict[Tuple[Any, int, int], int] = {}

    def slot(key):
        s = slot_of.get(key)
        if s is None:
            s = slot_of[key] = len(slot_of)
        return s

    for key in preplaced_keys:
        slot(key)

    verifying = verify is not None and global_config.verify_plans != "off"
    want_numerics = verifying and \
        global_config.verify_plans_numerics != "off"
    want_equiv = verifying and \
        global_config.verify_plans_equiv != "off" and \
        verify.reference is not None
    precision_of: Dict[int, Any] = {}

    def _precision(ex):
        if not want_numerics:
            return None
        if id(ex) not in precision_of:
            from alpa_tpu_torch.shard_parallel.eqn_classify import \
                classify_stage_precision
            precision_of[id(ex)] = classify_stage_precision(ex)
        return precision_of[id(ex)]

    def _equiv(inst):
        if not want_equiv:
            return None
        from alpa_tpu_torch.analysis.equivalence import stage_equiv_info
        info = stage_equiv_info(inst.executable)
        mb = inst.micro_batch
        return {"stage": info["stage"],
                "mb": int(mb) if mb is not None else -1,
                "donate": list(info["donate"]), "acc": dict(info["acc"])}

    # the gradient codec's facts on every RUN under grad_quantize; None
    # when it is off, so records (and fingerprints) are unchanged
    grad_tag = None
    if verifying and global_config.grad_quantize != "off":
        mbs = {int(inst.micro_batch or 0) for inst in instructions
               if inst.opcode == PipelineInstType.RUN and
               inst.micro_batch is not None}
        grad_tag = {"mode": global_config.grad_quantize,
                    "ef": bool(global_config.grad_error_feedback),
                    "hops": max(1, len(mbs)), "rs": False}

    recs: List[Dict[str, Any]] = []
    by_opcode = {"RUN": 0, "RESHARD": 0, "FREE": 0}
    for idx, inst in enumerate(instructions):
        if inst.opcode == PipelineInstType.RUN:
            by_opcode["RUN"] += 1
            in_slots = tuple(slot((k[0], k[1], inst.dst_mesh))
                             for k in inst.input_keys)
            out_slots = tuple(slot((k[0], k[1], inst.dst_mesh))
                              for k in inst.output_keys)
            donated = set(getattr(inst.executable, "donate_idx", ()) or ())
            recs.append({
                "kind": "RUN", "idx": idx,
                "op": _make_run_op(run_fn(idx), in_slots, out_slots),
                "reads": in_slots, "writes": out_slots,
                "kills": tuple(sorted({in_slots[p] for p in donated})),
                "name": f"RUN {inst.info}", "mesh": inst.dst_mesh,
                # the fault site and retry semantics of the instruction
                # loops' RUN: a donating run is retried only for
                # injected faults
                "site": "stage_launch",
                "finfo": {"stage": inst.info, "mesh_id": inst.dst_mesh},
                "idem": not donated,
                "precision": _precision(inst.executable),
                "equiv": _equiv(inst),
                "grad_quant": (_grad_quant_of(inst.executable, grad_tag)
                               if grad_tag else None),
                "line": (f"RUN {inst.info} mb={inst.micro_batch} "
                         f"in={list(in_slots)} out={list(out_slots)} "
                         f"kill={sorted({in_slots[p] for p in donated})}")})
        elif inst.opcode == PipelineInstType.RESHARD:
            by_opcode["RESHARD"] += 1
            v, instance = inst.var_key
            ss = slot((v, instance, inst.src_mesh))
            ds = slot((v, instance, inst.dst_mesh))
            t = transfer_fn(idx)
            strategy = _strategy_of(inst)
            tag = "" if strategy == "direct_p2p" else f" [{strategy}]"
            recs.append({
                "kind": "RESHARD", "idx": idx,
                "op": _make_reshard_op(t, ss, ds), "transfer": t,
                "ss": ss, "ds": ds, "edge": (inst.src_mesh, inst.dst_mesh),
                "cross": inst.src_mesh != inst.dst_mesh,
                "reads": (ss,), "writes": (ds,), "kills": (),
                "name": f"RESHARD {inst.src_mesh}->{inst.dst_mesh}{tag}",
                "mesh": inst.dst_mesh, "site": "cross_mesh_send",
                "finfo": {"var": str(v), "src_mesh": inst.src_mesh,
                          "dst_mesh": inst.dst_mesh, "strategy": strategy,
                          "codec": (strategy if strategy.startswith(
                              "quantized") else None)},
                "idem": True, "strategy": strategy,
                # only direct transfers coalesce into batched groups
                "groupable": strategy == "direct_p2p",
                "nbytes": _reshard_nbytes(inst),
                "line": (f"RESHARD {v}@{instance} {inst.src_mesh}->"
                         f"{inst.dst_mesh} slot {ss}->{ds}"
                         + ("" if strategy == "direct_p2p"
                            else f" strategy={strategy}"))})
        else:
            by_opcode["FREE"] += 1
            slots = tuple(slot(tuple(k)) for k in inst.free_keys)
            recs.append({
                "kind": "FREE", "idx": idx, "op": _make_free_op(slots),
                "slots": slots, "reads": (), "writes": (), "kills": slots,
                "name": "FREE",
                "mesh": inst.free_keys[0][2] if inst.free_keys else 0,
                "line": f"FREE {list(slots)}"})

    for i, r in enumerate(recs):
        r["pos"] = i
    graph = InstructionDataflowGraph.build([
        DataflowNode(idx=i, kind=r["kind"], reads=r["reads"],
                     writes=r["writes"], kills=r["kills"],
                     edge=r.get("edge"), cross_mesh=r.get("cross", False))
        for i, r in enumerate(recs)])
    graph.check()
    n = len(recs)
    ops: List[Callable] = []
    info: List[Tuple[str, Tuple[int, ...], Tuple[int, ...],
                     Tuple[int, ...]]] = []
    n_groups = n_free_hops = n_hoisted = n_launches = 0
    run_stats = {"transfer_busy_s": 0.0, "wait_blocked_s": 0.0}
    meta: List[Tuple[str, str, str]] = []
    hooks: List[OpHook] = []

    def hook_of(mem: List[Dict[str, Any]], kind: str, name: str):
        reads = tuple(x for m in mem for x in m["reads"])
        writes = tuple(x for m in mem for x in m["writes"])
        kills = tuple(x for m in mem for x in m["kills"])
        # a wait retires a launch that fired its sites; a FREE has none
        site = mem[0].get("site") if kind != "wait" else None
        return OpHook(kind=kind, name=name,
                      node=mem[0]["pos"],
                      mesh=mem[0]["mesh"], reads=reads, writes=writes,
                      kills=kills, slots=tuple(sorted({*reads, *writes,
                                                       *kills})),
                      members=tuple(m["idx"] for m in mem),
                      fault_site=site,
                      fault_infos=(tuple(m["finfo"] for m in mem)
                                   if site else ()),
                      idempotent=all(m.get("idem", True) for m in mem),
                      precision=(mem[0].get("precision") if len(mem) == 1
                                 else None),
                      equiv=mem[0].get("equiv") if len(mem) == 1 else None)

    lines: List[str] = []

    def emit(r):
        lines.append(r["line"])
        ops.append(r["op"])
        info.append(("exec", (r["idx"],), r["reads"], r["writes"]))
        meta.append((r["name"], "instruction", f"mesh {r['mesh']}"))
        hooks.append(hook_of([r], "exec", r["name"]))

    window = 0
    if mode == "registers":
        i = 0
        while i < n:
            r = recs[i]
            if r["kind"] != "RESHARD":
                emit(r)
                i += 1
                continue
            members, hopped, hops, i = reshard_group_extent(
                recs, i, max_members=global_config.superopt_max_group)
            n_free_hops += hops
            mem = [recs[m] for m in members]
            if len(mem) == 1:
                emit(mem[0])
            else:
                n_groups += 1
                lines.extend(m["line"] + f" edgegroup={len(mem)}"
                             for m in mem)
                ops.append(_make_reshard_group_op(
                    tuple(m["transfer"] for m in mem),
                    tuple(m["ss"] for m in mem),
                    tuple(m["ds"] for m in mem)))
                info.append(("exec", tuple(members),
                             tuple(m["ss"] for m in mem),
                             tuple(m["ds"] for m in mem)))
                name = (f"RESHARD-GROUP x{len(mem)} "
                        f"{mem[0]['edge'][0]}->{mem[0]['edge'][1]}")
                meta.append((name, "instruction", f"mesh {mem[0]['mesh']}"))
                hooks.append(hook_of(mem, "exec", name))
            for q in hopped:
                emit(recs[q])
    else:
        window = max(1, min(int(overlap_window), max(1, graph.n_cross_mesh)))
        plan, n_hoisted = schedule_overlap(graph, window)
        # consecutive launches of one edge become one group
        group_of: Dict[int, List[int]] = {}
        k = 0
        while k < len(plan):
            kind, idx = plan[k]
            if kind != "launch":
                k += 1
                continue
            mem = [idx]
            k += 1
            while (k < len(plan) and plan[k][0] == "launch" and
                   recs[idx]["groupable"] and
                   recs[plan[k][1]]["groupable"] and
                   recs[plan[k][1]]["edge"] == recs[idx]["edge"]):
                mem.append(plan[k][1])
                k += 1
            for m in mem:
                group_of[m] = mem
        waited = set()
        for kind, idx in plan:
            r = recs[idx]
            if kind == "exec":
                emit(r)
                continue
            # a group launches with its first member and is waited for at
            # the first wait of any member
            mem = group_of[idx]
            if (mem[0] != idx if kind == "launch" else mem[0] in waited):
                continue
            srcs = tuple(recs[m]["ss"] for m in mem)
            dsts = tuple(recs[m]["ds"] for m in mem)
            edge = f"{r['edge'][0]}->{r['edge'][1]}"
            lines.append(f"{kind.upper()} " +
                         "; ".join(recs[m]["line"] for m in mem))
            if kind == "launch":
                n_launches += 1
                n_groups += len(mem) > 1
                name = (f"LAUNCH {r['name']}" if len(mem) == 1 else
                        f"LAUNCH-GROUP x{len(mem)} {edge}")
                ops.append(_make_launch_op(
                    tuple(recs[m]["transfer"] for m in mem), srcs, dsts,
                    label=(r["name"] if len(mem) == 1 else
                           f"{r['name']} x{len(mem)}")))
            else:
                waited.add(mem[0])
                name = (f"WAIT {r['name']}" if len(mem) == 1 else
                        f"WAIT-GROUP x{len(mem)}")
                ops.append(_make_wait_op(dsts, run_stats))
            meta.append((name, "transfer", f"mesh {r['mesh']}"))
            hooks.append(hook_of([recs[m] for m in mem], kind, name))
            info.append((kind, tuple(recs[m]["idx"] for m in mem), srcs,
                         dsts))
    if mode == "overlap":
        lines.append(f"MODE overlap window={window} hoisted={n_hoisted} "
                     f"launches={n_launches}")
    prog = RegisterFileProgram(
        num_slots=len(slot_of), ops=ops, n_instructions=n,
        by_opcode=by_opcode, slot_of=slot_of, n_coalesced_groups=n_groups,
        op_info=info, mode=mode, graph=graph,
        n_cross_mesh=graph.n_cross_mesh, n_hoisted=n_hoisted,
        n_launches=n_launches, n_free_hops=n_free_hops,
        overlap_window=window, text="\n".join(lines),
        run_stats=run_stats, op_meta=meta, hooks=hooks)
    if verifying:
        from alpa_tpu_torch.analysis import plan_verifier
        prog.verdict = plan_verifier.verify_program(
            instructions, prog, verify.preplaced_shardings, recs,
            protected_keys=verify.protected_keys,
            opt_state_keys=verify.opt_state_keys,
            provenance_keys=verify.provenance_keys,
            reference=verify.reference if want_equiv else None,
            plan_fingerprint=verify.plan_fingerprint,
            devices=verify.devices)
    return prog


@dataclasses.dataclass
class PlanContext:
    """What the plan verifier needs of an executable beyond the instruction
    list (``pipeshard_executable._make_lowerer``): the shardings of the
    values placed at launch, keyed ``(node, instance, mesh)``; the program
    outputs (never freed); the optimizer-state keys; each placed value's
    provenance ("param", "opt_state", "gradient", "activation"); the
    equivalence reference; the executable's plan fingerprint; the meshes'
    devices."""
    preplaced_shardings: Dict[Tuple[Any, int, int], Any]
    protected_keys: frozenset = frozenset()
    opt_state_keys: frozenset = frozenset()
    provenance_keys: Optional[Dict[Tuple[Any, int, int], str]] = None
    reference: Optional[Dict[str, Any]] = None
    plan_fingerprint: Optional[str] = None
    devices: Tuple[Any, ...] = ()


def _grad_quant_of(ex, tag):
    """The gradient codec's facts for a RUN: the tag, with ``rs`` set where
    the stage is wide (its gradient sync is the quantized
    reduce-scatter)."""
    if getattr(ex, "num_devices", 1) > 1:
        return dict(tag, rs=True)
    return dict(tag)


def _reshard_nbytes(inst) -> int:
    """The payload bytes of a RESHARD: its transfer's, else its value's."""
    t = inst.resharding[0] if isinstance(inst.resharding, tuple) else \
        inst.resharding
    n = getattr(t, "nbytes", None)
    if n:
        return int(n)
    val = getattr(inst.var_key[0], "meta", {}).get("val")
    return int(val.numel() * val.element_size()) \
        if hasattr(val, "numel") else 0


def _strategy_of(inst: PipelineInstruction) -> str:
    """The executor a RESHARD runs: its strategy ("direct_p2p", a
    collective strategy, "quantized_int8"/"quantized_fp8"), or a planned
    ``ReshardingTask``'s mode ("tiled", "broadcast")."""
    t = inst.resharding[0] if isinstance(inst.resharding, tuple) else \
        inst.resharding
    strategy = getattr(t, "strategy", None)
    if strategy is None:
        mode = getattr(t, "mode", None)
        strategy = mode if mode and mode != "device_put" else "direct_p2p"
    return strategy


def emit_free_instructions(instructions: List[PipelineInstruction],
                           protected_keys) -> List[PipelineInstruction]:
    """Insert a FREE after the last use of each (node, instance, mesh)
    value that an instruction defined and no output needs; inputs placed
    at launch are the driver's."""
    last_use: Dict[Tuple[Any, int, int], int] = {}
    defined = set()
    for i, inst in enumerate(instructions):
        if inst.opcode == PipelineInstType.RUN:
            for k in inst.input_keys:
                last_use[(k[0], k[1], inst.dst_mesh)] = i
            for k in inst.output_keys:
                defined.add((k[0], k[1], inst.dst_mesh))
        elif inst.opcode == PipelineInstType.RESHARD:
            last_use[(inst.var_key[0], inst.var_key[1], inst.src_mesh)] = i
            defined.add((inst.var_key[0], inst.var_key[1], inst.dst_mesh))
    frees_at: Dict[int, List[Tuple[Any, int, int]]] = {}
    for key, i in last_use.items():
        if key in defined and key not in protected_keys:
            frees_at.setdefault(i, []).append(key)
    out: List[PipelineInstruction] = []
    for i, inst in enumerate(instructions):
        out.append(inst)
        if i in frees_at:
            out.append(PipelineInstruction(PipelineInstType.FREE,
                                           free_keys=frees_at[i]))
    return out
