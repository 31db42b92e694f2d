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
it on a CUDA stream with its cross-stream waits.  The per-op hooks (fault,
flight recorder, trace spans, the slot hazard checker), the plan verifier
and the superoptimizer of the JAX module are not ported (ROADMAP A.6,
A.7).
"""
import dataclasses
import enum
import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


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
class RegisterFileProgram:
    """The instruction list lowered to a flat register file.  Replay is
    ``for op in ops: op(regs)`` over ``regs = [None] * num_slots``: every
    ``(node, instance, mesh)`` key has an integer slot, RUN ops hold
    precomputed slot tuples, FREE clears slots, adjacent RESHARDs of one
    mesh edge run as one group; in overlap mode cross-mesh RESHARDs are
    launch/wait pairs.  ``op_info[k]``: ``(kind, instruction indices,
    source slots, destination slots)`` of op ``k``, kind "exec", "launch"
    or "wait"."""
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
    run_stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"transfer_busy_s": 0.0,
                                 "wait_blocked_s": 0.0})

    def execute(self, regs: List[Any], ops: Optional[List[Callable]] = None):
        self.run_stats["transfer_busy_s"] = 0.0
        self.run_stats["wait_blocked_s"] = 0.0
        for op in ops if ops is not None else self.ops:
            op(regs)


def reshard_group_extent(recs: Sequence[Dict[str, Any]], i: int
                         ) -> Tuple[List[int], List[int], int, int]:
    """The longest group of RESHARDs of one mesh edge starting at record
    ``i``, hopping the FREEs between them (a FREE follows its slots' last
    use, so it runs after the group); a RESHARD touching a hopped FREE's
    slot ends the group.  Returns ``(members, hopped FREEs, FREE hops that
    let a later member join, the index to resume at)``."""
    edge = recs[i]["edge"]
    n = len(recs)
    members: List[int] = []
    hopped: List[int] = []
    blocked: set = set()
    n_free_hops = counted = 0
    j = i
    while j < n:
        q = recs[j]
        if q["kind"] == "RESHARD" and q["edge"] == edge:
            if q["ss"] in blocked or q["ds"] in blocked:
                break
            if len(hopped) > counted:
                n_free_hops += len(hopped) - counted
                counted = len(hopped)
            members.append(j)
            j += 1
        elif q["kind"] == "FREE":
            hopped.append(j)
            blocked.update(q["slots"])
            j += 1
        else:
            break
    return members, hopped, n_free_hops, j


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


def _make_launch_op(transfers, src_slots, dst_slots):
    def op(regs, _t=transfers, _s=src_slots, _d=dst_slots):
        vals = [regs[s] for s in _s]

        def work():
            tic = time.perf_counter()
            outs = [t(v) for t, v in zip(_t, vals)]
            return outs, time.perf_counter() - tic

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
    return op


def lower_to_register_file(
        instructions: List[PipelineInstruction],
        preplaced_keys: Sequence[Tuple[Any, int, int]],
        run_fn: Callable[[int], Callable],
        transfer_fn: Callable[[int], Callable],
        mode: str = "registers",
        overlap_window: int = 4) -> RegisterFileProgram:
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
    one edge merged into one."""
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
                "kills": tuple(sorted({in_slots[p] for p in donated}))})
        elif inst.opcode == PipelineInstType.RESHARD:
            by_opcode["RESHARD"] += 1
            v, instance = inst.var_key
            ss = slot((v, instance, inst.src_mesh))
            ds = slot((v, instance, inst.dst_mesh))
            t = transfer_fn(idx)
            recs.append({
                "kind": "RESHARD", "idx": idx,
                "op": _make_reshard_op(t, ss, ds), "transfer": t,
                "ss": ss, "ds": ds, "edge": (inst.src_mesh, inst.dst_mesh),
                "cross": inst.src_mesh != inst.dst_mesh,
                "reads": (ss,), "writes": (ds,), "kills": ()})
        else:
            by_opcode["FREE"] += 1
            slots = tuple(slot(tuple(k)) for k in inst.free_keys)
            recs.append({
                "kind": "FREE", "idx": idx, "op": _make_free_op(slots),
                "slots": slots, "reads": (), "writes": (), "kills": slots})

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

    def emit(r):
        ops.append(r["op"])
        info.append(("exec", (r["idx"],), r["reads"], r["writes"]))

    window = 0
    if mode == "registers":
        i = 0
        while i < n:
            r = recs[i]
            if r["kind"] != "RESHARD":
                emit(r)
                i += 1
                continue
            members, hopped, hops, i = reshard_group_extent(recs, i)
            n_free_hops += hops
            mem = [recs[m] for m in members]
            if len(mem) == 1:
                emit(mem[0])
            else:
                n_groups += 1
                ops.append(_make_reshard_group_op(
                    tuple(m["transfer"] for m in mem),
                    tuple(m["ss"] for m in mem),
                    tuple(m["ds"] for m in mem)))
                info.append(("exec", tuple(members),
                             tuple(m["ss"] for m in mem),
                             tuple(m["ds"] for m in mem)))
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
            if kind == "launch":
                n_launches += 1
                n_groups += len(mem) > 1
                ops.append(_make_launch_op(
                    tuple(recs[m]["transfer"] for m in mem), srcs, dsts))
            else:
                waited.add(mem[0])
                ops.append(_make_wait_op(dsts, run_stats))
            info.append((kind, tuple(recs[m]["idx"] for m in mem), srcs,
                         dsts))
    return RegisterFileProgram(
        num_slots=len(slot_of), ops=ops, n_instructions=n,
        by_opcode=by_opcode, slot_of=slot_of, n_coalesced_groups=n_groups,
        op_info=info, mode=mode, graph=graph,
        n_cross_mesh=graph.n_cross_mesh, n_hoisted=n_hoisted,
        n_launches=n_launches, n_free_hops=n_free_hops,
        overlap_window=window, run_stats=run_stats)


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
