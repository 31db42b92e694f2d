"""Explicit-state model checker over lowered register-file plans.

Counterpart of ``alpa_tpu/analysis/model_check.py``, with its names,
budgets (``DEFAULT_STATE_BUDGET``, ``FIXTURE_MAX_OPS``), finding codes and
metrics.  The four single-order analyses of ``plan_verifier`` each examine
one order: the flat emission order (typing, liveness) or one
happens-before relation.  Run over several hosts, the per-mesh streams
execute concurrently over send/recv channels of finite capacity, where
correctness must hold under every interleaving of the streams; this module
explores that space:

* **State model** — every cross-mesh RESHARD is split into an explicit
  SEND micro-op (on the source-mesh stream, where the payload is
  consumed) and a RECV micro-op (at the RESHARD's position on the
  destination-mesh stream), joined by a per-``(src, dst)``-mesh FIFO
  channel.  A state is the per-stream program counters plus the
  channel queue contents plus a digest of the slot liveness map; the
  checker runs a DFS with a visited set over that space.
* **Channel semantics matrix** — each plan is checked twice: under
  *rendezvous* semantics (capacity-1 channels: a SEND blocks while its
  channel holds an unconsumed payload) and under *buffered*
  capacity-k semantics (k = the declared overlap window, at least 2).
  A plan that deadlocks under the buffered model is broken everywhere
  (``model.deadlock``, error); a plan that only deadlocks under
  rendezvous needs channel buffering the runtime may not guarantee on
  every backend (``model.rendezvous-deadlock``, warning).
* **Hazard freedom in all interleavings** — the
  ``SlotHazardChecker`` invariants (use-after-free, use-undefined,
  double-free, free/write of an in-flight transfer endpoint) are
  re-checked on every explored schedule, not just the flat replay
  order (``model.hazard-*``, errors).
* **Partial-order reduction** — a micro-op whose slot footprint is
  touched by no other stream, that uses no channel, and that no other
  op waits on commutes with every concurrent transition; when one is
  enabled the checker commits it deterministically instead of
  branching (a singleton ample set; the state graph is acyclic, so the
  classic ignoring problem cannot arise).  The achieved reduction is
  reported as ``reduction_ratio``.
* **Window bound as a property** — the overlap scheduler *promises*
  at most ``overlap_inflight_window`` launched-but-unwaited transfers;
  the checker verifies the promise by walking the compiled hook
  sequence (``model.inflight-exceeds-window``, error) instead of
  trusting ``schedule_overlap``.
* **Fault/retry safety** — for every ``fault.KNOWN_SITES`` site
  reachable from the plan, symbolically replay inject-fail-then-retry:
  a retry double-applies a donated-buffer RUN
  (``retry.unsafe-donation``), resends every member of a partially
  delivered ``DirectTransferGroup`` (``retry.partial-group``), or
  re-enqueues behind a younger in-flight transfer on the same FIFO
  channel (``retry.fifo-reorder``).  Each site is classified
  safe / unsafe / unreachable in the verdict stats;
  ``fault.call_with_retry`` consults the classification and refuses
  statically-unsafe retries under ``verify_plans=error``.

Everything here is a pure function of the :class:`PlanModel` + hooks
(:func:`check_model`); :func:`plan_verifier.verify_program` wires it in
as the fifth analysis behind ``global_config.verify_plans_model_check``
and exports the ``alpa_model_check_*`` metrics.  A state budget
(``global_config.model_check_state_budget``) bounds exploration so
plans of fixture size finish in well under a second; exhaustion is
reported as coverage (``model.budget-exhausted`` note, ``partial``
stat), never silence.
"""
import dataclasses
import time
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.analysis.plan_verifier import (Finding, OpModel,
                                                   PlanModel, SlotModel)

__all__ = [
    "DEFAULT_STATE_BUDGET", "FIXTURE_MAX_OPS", "MicroOp",
    "ModelCheckResult", "check_model", "classify_retry_sites",
    "severity_of", "format_stats", "model_to_dict", "model_from_dict",
    "load_fixture", "export_metrics",
]

#: default DFS state budget (overridable via
#: ``global_config.model_check_state_budget`` / the check_model arg)
DEFAULT_STATE_BUDGET = 50000

#: "fixture" knob mode model-checks only plans at most this many ops
FIXTURE_MAX_OPS = 256

_REG = _tmetrics.get_registry()
_STATES_TOTAL = _REG.counter(
    "alpa_model_check_states_total",
    "States explored by the plan model checker, summed over runs")
_MC_TOTAL = _REG.counter(
    "alpa_plan_model_check_total",
    "Plan model-check outcomes by result",
    labelnames=("result",))

_UNDEF, _LIVE, _DEAD = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class MicroOp:
    """One transition of the interleaving model.  Cross-mesh RESHARDs
    contribute a ``send``/``recv`` pair; every other instruction is a
    single ``exec``."""
    uid: int
    op: int                                 # flat instruction index
    kind: str                               # "exec" | "send" | "recv"
    stream: int
    reads: Tuple[int, ...] = ()
    writes: Tuple[int, ...] = ()
    kills: Tuple[int, ...] = ()
    channel: Optional[Tuple[int, int]] = None
    deps: FrozenSet[int] = frozenset()      # uids that must run first
    label: str = ""


@dataclasses.dataclass
class ModelCheckResult:
    """Findings + stats of one :func:`check_model` run.  ``stats`` is
    JSON-able and stored verbatim at ``PlanVerdict.stats["model_check"]``
    so cached verdicts replay the identical report."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(severity_of(f.code) == "error"
                       for f in self.findings)

    def format(self) -> str:
        return format_stats(self.stats, self.findings)


#: finding code -> severity the verifier merges it at.  Hazards and
#: buffered-model deadlocks are hard errors; a rendezvous-only deadlock
#: is a warning (the plan is correct whenever the backend buffers at
#: least one payload per channel, which the in-process CPU backend and
#: buffered DCN transports do); retry-safety classifications and budget
#: exhaustion are notes — they describe the plan, they don't fail it.
_SEVERITY = {
    "model.deadlock": "error",
    "model.channel-endpoint": "error",
    "model.inflight-exceeds-window": "error",
    "model.rendezvous-deadlock": "warning",
    "model.budget-exhausted": "note",
    "retry.unsafe-donation": "note",
    "retry.partial-group": "note",
    "retry.fifo-reorder": "note",
}


def severity_of(code: str) -> str:
    """Severity class (``"error" | "warning" | "note"``) the plan
    verifier merges a model-check finding at."""
    if code in _SEVERITY:
        return _SEVERITY[code]
    if code.startswith("model.hazard-"):
        return "error"
    return "note"


########################################
# micro-op construction
########################################


def _stream_of_ops(model: PlanModel) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for m, stream in enumerate(model.streams):
        for i in stream:
            out[i] = m
    return out


def _is_split(op: OpModel) -> bool:
    return (op.kind == "RESHARD" and op.cross and op.edge is not None
            and op.edge[0] != op.edge[1])


def build_micro_ops(model: PlanModel) -> List[List[MicroOp]]:
    """The per-stream micro-op lists: every cross-mesh RESHARD becomes
    a SEND on the source-mesh stream (ordered by its global instruction
    index among that stream's ops — where the payload leaves the
    sender) and a RECV at the RESHARD's own position on the
    destination-mesh stream; everything else is one EXEC in place.

    Cross-stream dependency edges from ``partition_streams`` are
    re-attached to the half they guard: a dependency that orders the
    *source* slot's producer/consumer binds the SEND; everything else
    binds the RECV (transfer completion)."""
    stream_of = _stream_of_ops(model)
    n_streams = max(model.num_meshes, 1)
    # per-stream member (op idx, kind) lists: given stream order is
    # preserved verbatim (it IS the property under test — a mutated
    # receive order must stay mutated); SENDs are interleaved into the
    # source-mesh stream at their global-emission position (before the
    # first member with a larger instruction index)
    per_stream: List[List[Tuple[int, str]]] = [
        [] for _ in range(n_streams)]
    split: Dict[int, bool] = {}
    for m, stream in enumerate(model.streams[:n_streams]):
        for i in stream:
            if i >= len(model.ops):
                continue
            op = model.ops[i]
            split[i] = _is_split(op)
            per_stream[m].append((i, "recv" if split[i] else "exec"))
    for op in model.ops:
        if op.idx in split:
            continue  # unreachable from any stream (defensive)
        split[op.idx] = False
    for op in model.ops:
        if not split.get(op.idx):
            continue
        src = op.edge[0] if 0 <= op.edge[0] < n_streams else 0
        members = per_stream[src]
        pos = next((p for p, (j, _k) in enumerate(members)
                    if j > op.idx), len(members))
        members.insert(pos, (op.idx, "send"))

    uid_of: Dict[Tuple[int, str], int] = {}
    placed: List[Tuple[int, int, str, int]] = []  # stream, op, kind, uid
    uid = 0
    for s in range(n_streams):
        for i, kind in per_stream[s]:
            uid_of[(i, kind)] = uid
            placed.append((s, i, kind, uid))
            uid += 1

    def _completion_uid(j: int,
                        waiter_foot: FrozenSet[int]) -> Optional[int]:
        if not split.get(j):
            return uid_of.get((j, "exec"))
        # a waiter that conflicts on j's source slot is ordered against
        # j's SEND (where the source is consumed); otherwise it waits
        # for the transfer to complete (RECV)
        j_src = model.ops[j].reads[0] if model.ops[j].reads else None
        if j_src is not None and j_src in waiter_foot:
            return uid_of.get((j, "send"))
        return uid_of.get((j, "recv"))

    deps_of: Dict[int, set] = {}
    for i, waits in model.deps.items():
        if i >= len(model.ops):
            continue
        op = model.ops[i]
        foot = frozenset(op.reads) | frozenset(op.writes) | \
            frozenset(op.kills)
        if split.get(i):
            src_slot = op.reads[0] if op.reads else None
            send_u, recv_u = uid_of[(i, "send")], uid_of[(i, "recv")]
            for j in waits:
                if j >= len(model.ops) or j == i:
                    continue
                j_op = model.ops[j]
                touches_src = src_slot is not None and (
                    src_slot in j_op.writes or src_slot in j_op.kills
                    or src_slot in j_op.reads)
                target = _completion_uid(j, foot)
                if target is None:
                    continue
                if touches_src:
                    deps_of.setdefault(send_u, set()).add(target)
                else:
                    deps_of.setdefault(recv_u, set()).add(target)
        else:
            u = uid_of.get((i, "exec"))
            if u is None:
                continue
            for j in waits:
                if j >= len(model.ops) or j == i:
                    continue
                target = _completion_uid(j, foot)
                if target is not None:
                    deps_of.setdefault(u, set()).add(target)

    streams_micro: List[List[MicroOp]] = [[] for _ in range(n_streams)]
    for s, i, kind, u in placed:
        op = model.ops[i]
        if kind == "send":
            reads = tuple(op.reads[:1])
            writes: Tuple[int, ...] = ()
            label = f"SEND {op.label} ch{op.edge[0]}->{op.edge[1]}"
        elif kind == "recv":
            reads = ()
            writes = tuple(op.writes[:1])
            label = f"RECV {op.label} ch{op.edge[0]}->{op.edge[1]}"
        else:
            reads, writes = tuple(op.reads), tuple(op.writes)
            label = op.label or op.kind
        streams_micro[s].append(MicroOp(
            uid=u, op=i, kind=kind, stream=s,
            reads=reads, writes=writes,
            kills=tuple(op.kills) if kind == "exec" else (),
            channel=tuple(op.edge) if kind in ("send", "recv") else None,
            deps=frozenset(deps_of.get(u, ())),
            label=label))
    return streams_micro


########################################
# the explorer
########################################


@dataclasses.dataclass
class _RunResult:
    capacity: int
    states: int = 0
    transitions: int = 0
    por_commits: int = 0
    partial: bool = False
    n_deadlock_states: int = 0
    deadlock_trace: Optional[List[str]] = None
    # (code, op idx) -> (message, trace)
    hazards: Dict[Tuple[str, int], Tuple[str, List[str]]] = \
        dataclasses.field(default_factory=dict)
    seconds: float = 0.0


def _explore(model: PlanModel, streams_micro: List[List[MicroOp]],
             capacity: int, budget: int) -> _RunResult:
    t0 = time.perf_counter()
    res = _RunResult(capacity=capacity)
    n_streams = len(streams_micro)
    pos: Dict[int, Tuple[int, int]] = {}
    by_uid: Dict[int, MicroOp] = {}
    for s, st in enumerate(streams_micro):
        for p, u in enumerate(st):
            pos[u.uid] = (s, p)
            by_uid[u.uid] = u
    channels = sorted({u.channel for st in streams_micro for u in st
                       if u.channel is not None})
    # POR precomputation: slots touched by >1 stream, uids waited on
    slot_streams: Dict[int, set] = {}
    dep_targets: set = set()
    for st in streams_micro:
        for u in st:
            for s in (*u.reads, *u.writes, *u.kills):
                slot_streams.setdefault(s, set()).add(u.stream)
            dep_targets.update(u.deps)

    def _local(u: MicroOp) -> bool:
        if u.channel is not None or u.uid in dep_targets:
            return False
        return all(slot_streams.get(s, set()) <= {u.stream}
                   for s in (*u.reads, *u.writes, *u.kills))

    pcs = [0] * n_streams
    queues: Dict[Tuple[int, int], List[int]] = {c: [] for c in channels}
    slot_state: Dict[int, int] = {}
    # destination slots of queued payloads (a SEND copies the source
    # into the channel, so the source is NOT held in flight — freeing
    # it after the send is the normal plan shape; the destination is
    # owned by the channel until its RECV lands)
    inflight_dst: Dict[int, int] = {}
    state_hash = 0
    for s, sm in model.slots.items():
        if sm.preplaced:
            slot_state[s] = _LIVE
            state_hash ^= hash((s, _LIVE))
    op_dst: Dict[int, Optional[int]] = {}
    for op in model.ops:
        op_dst[op.idx] = op.writes[0] if op.writes else None

    def _executed(uid: int) -> bool:
        s, p = pos[uid]
        return pcs[s] > p

    def _enabled(u: MicroOp) -> bool:
        if any(not _executed(d) for d in u.deps):
            return False
        if u.kind == "send":
            return len(queues[u.channel]) < capacity
        if u.kind == "recv":
            q = queues[u.channel]
            return bool(q) and q[0] == u.op
        return True

    def _enabled_list() -> List[MicroOp]:
        out = []
        for s in range(n_streams):
            p = pcs[s]
            if p < len(streams_micro[s]):
                u = streams_micro[s][p]
                if _enabled(u):
                    out.append(u)
        return out

    def _var(slot: int) -> str:
        sm = model.slots.get(slot)
        return sm.var if sm is not None else f"slot{slot}"

    path: List[MicroOp] = []

    def _trace(extra: Optional[List[str]] = None) -> List[str]:
        lines = [f"{i:3d}. m{u.stream}: {u.label}  (op {u.op})"
                 for i, u in enumerate(path)]
        return lines + (extra or [])

    def _blocked_lines() -> List[str]:
        lines = ["-- blocked --"]
        for s in range(n_streams):
            p = pcs[s]
            if p >= len(streams_micro[s]):
                lines.append(f"  m{s}: done")
                continue
            u = streams_micro[s][p]
            why = []
            unmet = [d for d in u.deps if not _executed(d)]
            if unmet:
                why.append("waits for "
                           + ", ".join(by_uid[d].label for d in unmet))
            if u.kind == "send" and len(queues[u.channel]) >= capacity:
                why.append(
                    f"channel {u.channel[0]}->{u.channel[1]} full "
                    f"(capacity {capacity}, holds op(s) "
                    f"{queues[u.channel]})")
            if u.kind == "recv":
                q = queues[u.channel]
                if not q:
                    why.append(f"channel {u.channel[0]}->{u.channel[1]}"
                               " empty")
                elif q[0] != u.op:
                    why.append(
                        f"channel {u.channel[0]}->{u.channel[1]} FIFO "
                        f"head is op {q[0]}, needs op {u.op}")
            lines.append(f"  m{s}: {u.label} — "
                         + ("; ".join(why) or "not enabled"))
        return lines

    def _set_slot(slot: int, new: int, changes: list):
        old = slot_state.get(slot, _UNDEF)
        nonlocal state_hash
        if old != _UNDEF:
            state_hash ^= hash((slot, old))
        if new != _UNDEF:
            state_hash ^= hash((slot, new))
        slot_state[slot] = new
        changes.append((slot, old))

    def _hazard(u: MicroOp) -> Optional[Tuple[str, str]]:
        for s in u.reads:
            st = slot_state.get(s, _UNDEF)
            if st == _DEAD:
                return ("model.hazard-use-after-free",
                        f"{u.label}: reads slot {s} ({_var(s)}) after "
                        f"it was freed in this schedule")
            if st == _UNDEF:
                return ("model.hazard-use-undefined",
                        f"{u.label}: reads slot {s} ({_var(s)}) before "
                        f"any producer ran in this schedule")
        if u.kind == "exec":
            for s in u.writes:
                if inflight_dst.get(s):
                    return ("model.hazard-write-in-flight",
                            f"{u.label}: writes slot {s} ({_var(s)}), "
                            f"the destination of an in-flight transfer "
                            f"in this schedule")
            for s in u.kills:
                st = slot_state.get(s, _UNDEF)
                if st == _DEAD:
                    return ("model.hazard-double-free",
                            f"{u.label}: frees slot {s} ({_var(s)}) "
                            f"twice in this schedule")
                if inflight_dst.get(s):
                    return ("model.hazard-free-in-flight",
                            f"{u.label}: frees/donates slot {s} "
                            f"({_var(s)}), the destination of an "
                            f"in-flight transfer in this schedule")
        return None

    def _apply(u: MicroOp):
        changes: list = []
        pcs[u.stream] += 1
        if u.kind == "send":
            queues[u.channel].append(u.op)
            dst = op_dst[u.op]
            if dst is not None:
                inflight_dst[dst] = inflight_dst.get(dst, 0) + 1
        elif u.kind == "recv":
            queues[u.channel].pop(0)
            dst = op_dst[u.op]
            if dst is not None:
                inflight_dst[dst] -= 1
            for s in u.writes:
                _set_slot(s, _LIVE, changes)
        else:
            for s in u.kills:
                _set_slot(s, _DEAD, changes)
            for s in u.writes:
                _set_slot(s, _LIVE, changes)
        return changes

    def _undo(u: MicroOp, changes: list):
        nonlocal state_hash
        pcs[u.stream] -= 1
        if u.kind == "send":
            queues[u.channel].pop()
            dst = op_dst[u.op]
            if dst is not None:
                inflight_dst[dst] -= 1
        elif u.kind == "recv":
            queues[u.channel].insert(0, u.op)
            dst = op_dst[u.op]
            if dst is not None:
                inflight_dst[dst] += 1
        for slot, old in reversed(changes):
            new = slot_state[slot]
            if new != _UNDEF:
                state_hash ^= hash((slot, new))
            if old != _UNDEF:
                state_hash ^= hash((slot, old))
            slot_state[slot] = old

    def _key():
        return (tuple(pcs),
                tuple(tuple(queues[c]) for c in channels),
                state_hash)

    def _select(en: List[MicroOp]) -> List[MicroOp]:
        for u in en:
            if _local(u):
                res.por_commits += 1
                return [u]
        return en

    visited = {_key()}
    res.states = 1
    frames: List[List[Any]] = [[_select(_enabled_list()), 0]]
    undo_stack: List[Tuple[MicroOp, list]] = []
    while frames:
        choices, i = frames[-1]
        if i >= len(choices):
            frames.pop()
            if undo_stack:
                u, changes = undo_stack.pop()
                _undo(u, changes)
                path.pop()
            continue
        frames[-1][1] += 1
        u = choices[i]
        haz = _hazard(u)
        if haz is not None:
            code, msg = haz
            key = (code, u.op)
            if key not in res.hazards:
                res.hazards[key] = (
                    msg, _trace([f"  -> {msg}"]))
            res.transitions += 1
            continue
        changes = _apply(u)
        res.transitions += 1
        path.append(u)
        k = _key()
        if k in visited:
            _undo(u, changes)
            path.pop()
            continue
        visited.add(k)
        res.states += 1
        if res.states >= budget:
            res.partial = True
            _undo(u, changes)
            path.pop()
            break
        en = _enabled_list()
        if not en:
            if any(pcs[s] < len(streams_micro[s])
                   for s in range(n_streams)):
                res.n_deadlock_states += 1
                if res.deadlock_trace is None:
                    res.deadlock_trace = _trace(_blocked_lines())
            _undo(u, changes)
            path.pop()
            continue
        frames.append([_select(en), 0])
        undo_stack.append((u, changes))
    res.seconds = time.perf_counter() - t0
    return res


########################################
# property families outside the interleaving model
########################################


def check_channel_endpoints(model: PlanModel) -> List[Finding]:
    """Structural channel check: a cross-mesh RESHARD's source slot
    must live on ``edge[0]`` and its destination slot on ``edge[1]`` —
    a corrupted edge binds the SEND/RECV pair to the wrong FIFO."""
    out: List[Finding] = []
    for op in model.ops:
        if not _is_split(op):
            continue
        src = model.slots.get(op.reads[0]) if op.reads else None
        dst = model.slots.get(op.writes[0]) if op.writes else None
        if src is not None and src.mesh != op.edge[0]:
            out.append(Finding(
                "model_check", "model.channel-endpoint",
                f"{op.label}: source slot {src.slot} ({src.var}) lives "
                f"on mesh {src.mesh} but the channel edge says the "
                f"SEND runs on mesh {op.edge[0]}", op.idx))
        if dst is not None and dst.mesh != op.edge[1]:
            out.append(Finding(
                "model_check", "model.channel-endpoint",
                f"{op.label}: destination slot {dst.slot} ({dst.var}) "
                f"lives on mesh {dst.mesh} but the channel edge says "
                f"the RECV runs on mesh {op.edge[1]}", op.idx))
    return out


def check_inflight_window(hooks: Optional[Sequence[Any]],
                          window: int
                          ) -> Tuple[List[Finding], int]:
    """Walk the compiled hook sequence counting launched-but-unwaited
    transfers (a batched group counts once, matching the scheduler's
    accounting) and verify the declared ``overlap_inflight_window``
    bound as a property instead of trusting the scheduler."""
    out: List[Finding] = []
    active: Dict[Tuple[int, ...], int] = {}
    max_inflight = 0
    first_over = -1
    for hook in hooks or ():
        kind = getattr(hook, "kind", "exec")
        members = tuple(getattr(hook, "members", ()) or ())
        if kind == "launch":
            active[members] = getattr(hook, "node", -1)
            if len(active) > max_inflight:
                max_inflight = len(active)
                if window and max_inflight > window and first_over < 0:
                    first_over = getattr(hook, "node", -1)
        elif kind == "wait":
            active.pop(members, None)
    if window and max_inflight > window:
        out.append(Finding(
            "model_check", "model.inflight-exceeds-window",
            f"the compiled schedule holds up to {max_inflight} "
            f"transfers in flight but declares "
            f"overlap_inflight_window={window} — the staging-memory "
            f"bound the window promises is not honored", first_over))
    return out, max_inflight


def classify_retry_sites(model: PlanModel,
                         hooks: Optional[Sequence[Any]]
                         ) -> Tuple[List[Finding],
                                    Dict[str, Dict[str, Any]]]:
    """Static inject-fail-then-retry replay over the compiled hooks.

    For each ``fault.KNOWN_SITES`` site, symbolically fail every hook
    bound to it mid-operation and re-run it, checking the three
    non-idempotence sources the model exposes: donated-buffer RUNs
    (the retry re-reads slots the first attempt consumed), multi-member
    transfer groups (the retry resends members that already landed),
    and same-channel in-flight overlap (the retry re-enqueues behind a
    younger payload, breaking FIFO pairing).  Returns note-severity
    findings plus the per-site classification installed into
    ``fault.install_retry_classification``."""
    from alpa_tpu_torch import fault as _fault
    sites: Dict[str, Dict[str, Any]] = {
        s: {"classification": "unreachable", "reasons": [], "hooks": 0}
        for s in sorted(_fault.KNOWN_SITES)}
    findings: List[Finding] = []
    donated: Dict[str, List[int]] = {}
    grouped: Dict[str, List[int]] = {}
    reordered: Dict[str, List[int]] = {}
    launch_channel: Dict[Tuple[int, ...], Tuple[int, int]] = {}
    inflight_per_channel: Dict[Tuple[int, int], int] = {}

    def _edge_of(hook) -> Optional[Tuple[int, int]]:
        members = tuple(getattr(hook, "members", ()) or ())
        if members and 0 <= members[0] < len(model.ops):
            e = model.ops[members[0]].edge
            return tuple(e) if e else None
        return None

    for hook in hooks or ():
        kind = getattr(hook, "kind", "exec")
        members = tuple(getattr(hook, "members", ()) or ())
        if kind == "wait":
            ch = launch_channel.pop(members, None)
            if ch is not None:
                inflight_per_channel[ch] -= 1
            continue
        site = getattr(hook, "fault_site", None)
        if site is None or site not in sites:
            continue
        ent = sites[site]
        ent["hooks"] += 1
        if ent["classification"] == "unreachable":
            ent["classification"] = "safe"
        node = getattr(hook, "node", -1)
        if getattr(hook, "kills", ()) and \
                not getattr(hook, "idempotent", True):
            donated.setdefault(site, []).append(node)
        if len(members) > 1:
            grouped.setdefault(site, []).append(node)
        if kind == "launch":
            ch = _edge_of(hook)
            if ch is not None:
                if inflight_per_channel.get(ch, 0) > 0:
                    reordered.setdefault(site, []).append(node)
                inflight_per_channel[ch] = \
                    inflight_per_channel.get(ch, 0) + 1
                launch_channel[members] = ch

    for site, nodes in donated.items():
        sites[site]["classification"] = "unsafe"
        sites[site]["reasons"].append("unsafe-donation")
        findings.append(Finding(
            "model_check", "retry.unsafe-donation",
            f"site {site}: replaying inject-fail-then-retry "
            f"double-applies donated-buffer op(s) {nodes[:6]} — the "
            f"retry re-reads slots the first attempt consumed; "
            f"call_with_retry refuses the retry under "
            f"verify_plans=error", nodes[0]))
    for site, nodes in grouped.items():
        sites[site]["classification"] = "unsafe"
        sites[site]["reasons"].append("partial-group")
        findings.append(Finding(
            "model_check", "retry.partial-group",
            f"site {site}: op(s) {nodes[:6]} batch multiple transfers "
            f"into one DirectTransferGroup — a mid-group failure "
            f"retried whole resends members that already landed, "
            f"double-enqueueing onto the FIFO channel", nodes[0]))
    for site, nodes in reordered.items():
        sites[site]["classification"] = "unsafe"
        sites[site]["reasons"].append("fifo-reorder")
        findings.append(Finding(
            "model_check", "retry.fifo-reorder",
            f"site {site}: launch op(s) {nodes[:6]} overlap an older "
            f"in-flight transfer on the same channel — retrying the "
            f"older launch would re-enqueue its payload behind the "
            f"younger one, breaking FIFO send/recv pairing", nodes[0]))
    return findings, sites


########################################
# driver
########################################


def check_model(model: PlanModel,
                hooks: Optional[Sequence[Any]] = None,
                overlap_window: int = 0,
                budget: int = DEFAULT_STATE_BUDGET) -> ModelCheckResult:
    """Model-check one plan: explore all interleavings under buffered
    and rendezvous channel semantics, verify the in-flight window
    bound, and classify retry safety.  Pure function of its inputs."""
    t0 = time.perf_counter()
    findings: List[Finding] = list(check_channel_endpoints(model))
    streams_micro = build_micro_ops(model)
    n_micro = sum(len(s) for s in streams_micro)
    channels = sorted({u.channel for st in streams_micro for u in st
                       if u.channel is not None})

    cap_buffered = max(2, overlap_window) if overlap_window else 4
    runs = {}
    if not findings:
        # a corrupted channel edge makes the interleaving model
        # meaningless — report the structural break alone
        runs["buffered"] = _explore(model, streams_micro,
                                    cap_buffered, budget)
        runs["rendezvous"] = _explore(model, streams_micro, 1, budget)

    semantics: Dict[str, str] = {}
    counterexample: Optional[List[str]] = None
    hazard_keys = set()
    for name in ("buffered", "rendezvous"):
        r = runs.get(name)
        if r is None:
            semantics[name] = "skipped"
            continue
        verdict = "pass"
        if r.hazards:
            verdict = "hazard"
        if r.deadlock_trace is not None:
            verdict = "deadlock"
        elif r.partial:
            verdict = "partial"
        semantics[name] = verdict
        for (code, op), (msg, trace) in r.hazards.items():
            if (code, op) in hazard_keys:
                continue
            hazard_keys.add((code, op))
            findings.append(Finding("model_check", code, msg, op))
            if counterexample is None:
                counterexample = trace
    buf, rdv = runs.get("buffered"), runs.get("rendezvous")
    if buf is not None and buf.deadlock_trace is not None:
        counterexample = buf.deadlock_trace
        findings.append(Finding(
            "model_check", "model.deadlock",
            f"a reachable schedule deadlocks under buffered "
            f"(capacity-{cap_buffered}) channel semantics — "
            f"{buf.n_deadlock_states} deadlocked state(s) found; see "
            f"the counterexample schedule in the model-check report"))
    elif rdv is not None and rdv.deadlock_trace is not None:
        counterexample = rdv.deadlock_trace
        findings.append(Finding(
            "model_check", "model.rendezvous-deadlock",
            f"the plan is deadlock-free under buffered channels but a "
            f"reachable schedule deadlocks under rendezvous "
            f"(capacity-1) semantics — {rdv.n_deadlock_states} "
            f"deadlocked state(s); backends without per-channel "
            f"buffering would hang"))
    if any(r is not None and r.partial for r in (buf, rdv)):
        findings.append(Finding(
            "model_check", "model.budget-exhausted",
            f"state budget {budget} exhausted before full coverage "
            f"(partial exploration; raise "
            f"ALPA_TPU_MODEL_CHECK_BUDGET for a complete proof)"))

    window_findings, max_inflight = check_inflight_window(
        hooks, overlap_window)
    findings += window_findings
    retry_findings, retry_sites = classify_retry_sites(model, hooks)
    findings += retry_findings

    states = sum(r.states for r in runs.values())
    transitions = sum(r.transitions for r in runs.values())
    por = sum(r.por_commits for r in runs.values())
    stats: Dict[str, Any] = {
        "states": states,
        "transitions": transitions,
        "por_commits": por,
        "reduction_ratio": round(por / transitions, 4)
        if transitions else 0.0,
        "partial": any(r.partial for r in runs.values()),
        "budget": budget,
        "n_micro_ops": n_micro,
        "n_channels": len(channels),
        "capacity_buffered": cap_buffered,
        "semantics": semantics,
        "declared_window": overlap_window,
        "max_inflight": max_inflight,
        "retry_sites": retry_sites,
        "counterexample": counterexample,
        "seconds": round(time.perf_counter() - t0, 6),
    }
    return ModelCheckResult(findings=findings, stats=stats)


def format_stats(stats: Dict[str, Any],
                 findings: Optional[Sequence[Finding]] = None) -> str:
    """Human-readable model-check report (``model_check.txt``).  Works
    from the JSON-able stats dict alone, so cached verdicts render
    identically."""
    sem = stats.get("semantics", {})
    lines = [
        "model check: "
        + "  ".join(f"{k}={v}" for k, v in sorted(sem.items()))
        + (" (PARTIAL — state budget exhausted)"
           if stats.get("partial") else ""),
        f"states={stats.get('states', 0)}  "
        f"transitions={stats.get('transitions', 0)}  "
        f"por_commits={stats.get('por_commits', 0)}  "
        f"reduction_ratio={stats.get('reduction_ratio', 0.0)}  "
        f"seconds={stats.get('seconds', 0.0)}",
        f"micro_ops={stats.get('n_micro_ops', 0)}  "
        f"channels={stats.get('n_channels', 0)}  "
        f"buffered_capacity={stats.get('capacity_buffered', 0)}  "
        f"window declared={stats.get('declared_window', 0)} "
        f"max_inflight={stats.get('max_inflight', 0)}",
    ]
    retry = stats.get("retry_sites", {})
    if retry:
        lines.append("retry sites:")
        for site, ent in sorted(retry.items()):
            reasons = ",".join(ent.get("reasons", ())) or "-"
            lines.append(
                f"  {site:<18} {ent.get('classification', '?'):<12} "
                f"hooks={ent.get('hooks', 0)}  reasons={reasons}")
    if findings:
        lines.append("findings:")
        for f in findings:
            at = f" (op {f.op})" if f.op >= 0 else ""
            lines.append(
                f"  [{severity_of(f.code)}] [{f.code}]{at} {f.message}")
    ce = stats.get("counterexample")
    if ce:
        lines.append("counterexample schedule:")
        lines += [f"  {ln}" for ln in ce]
    return "\n".join(lines)


def export_metrics(stats: Dict[str, Any], result: str) -> None:
    """Record one model-check outcome in the central registry
    (``alpa_model_check_states_total`` /
    ``alpa_plan_model_check_total{result}``)."""
    states = stats.get("states", 0) if stats else 0
    if states:
        _STATES_TOTAL.inc(states)
    _MC_TOTAL.labels(result).inc()


########################################
# fixture (de)serialization
########################################


def model_to_dict(model: PlanModel,
                  hooks: Optional[Sequence[Any]] = None,
                  overlap_window: int = 0) -> Dict[str, Any]:
    """JSON-able form of a plan model + hooks + declared window (format
    ``alpa-model-check-plan/v1``, the JAX package's fixture format: a dict
    from either package's ``model_to_dict`` reads in the other's
    ``model_from_dict``)."""
    out = {
        "format": "alpa-model-check-plan/v1",
        "mode": model.mode,
        "num_meshes": model.num_meshes,
        "overlap_window": overlap_window,
        "slots": [dataclasses.asdict(sm)
                  for _s, sm in sorted(model.slots.items())],
        # the "equiv" / "grad_quant" facts are omitted
        # when absent so pre-existing committed fixtures round-trip
        # byte-identically
        "ops": [{k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in dataclasses.asdict(op).items()
                 if not (k in ("equiv", "grad_quant") and v is None)}
                for op in model.ops],
        "streams": [list(s) for s in model.streams],
        "deps": {str(i): sorted(v) for i, v in model.deps.items()},
        "hooks": [
            dict({"kind": h.kind, "name": h.name, "node": h.node,
                  "mesh": h.mesh, "reads": list(h.reads),
                  "writes": list(h.writes), "kills": list(h.kills),
                  "slots": list(h.slots), "fault_site": h.fault_site,
                  "idempotent": h.idempotent,
                  "members": list(h.members)},
                 **({"equiv": h.equiv}
                    if getattr(h, "equiv", None) is not None else {}))
            for h in (hooks or ())],
    }
    if model.reference is not None:
        out["reference"] = model.reference
    return out


def model_from_dict(d: Dict[str, Any]
                    ) -> Tuple[PlanModel, List[Any], int]:
    """Inverse of :func:`model_to_dict`:
    ``(model, hooks, overlap_window)``."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import OpHook
    slots = {}
    for sd in d.get("slots", ()):
        sm = SlotModel(**{k: (tuple(v) if k == "shape" else v)
                          for k, v in sd.items()})
        slots[sm.slot] = sm
    ops = []
    for od in d.get("ops", ()):
        kw = dict(od)
        for k in ("reads", "writes", "kills"):
            kw[k] = tuple(tuple(x) if isinstance(x, list) else x
                          for x in kw.get(k, ()))
        for k in ("in_avals", "out_avals"):
            # avals are ((shape, dtype) | None) pairs whose shape must
            # come back as a tuple (the typing pass compares tuples)
            kw[k] = tuple(
                (tuple(a[0]), a[1])
                if isinstance(a, (list, tuple)) and len(a) == 2 and
                isinstance(a[0], (list, tuple)) else
                (tuple(a) if isinstance(a, list) else a)
                for a in kw.get(k, ()))
        if kw.get("edge") is not None:
            kw["edge"] = tuple(kw["edge"])
        ops.append(OpModel(**kw))
    model = PlanModel(
        ops=ops, slots=slots,
        num_meshes=int(d.get("num_meshes", 1)),
        streams=[list(s) for s in d.get("streams", ())],
        deps={int(i): set(v) for i, v in d.get("deps", {}).items()},
        mode=d.get("mode", "registers"),
        reference=d.get("reference"))
    hooks = [OpHook(kind=h["kind"], name=h["name"], node=h["node"],
                    mesh=h["mesh"], reads=tuple(h["reads"]),
                    writes=tuple(h["writes"]), kills=tuple(h["kills"]),
                    slots=tuple(h.get("slots", ())),
                    fault_site=h.get("fault_site"),
                    idempotent=bool(h.get("idempotent", True)),
                    members=tuple(h["members"]),
                    equiv=h.get("equiv"))
             for h in d.get("hooks", ())]
    return model, hooks, int(d.get("overlap_window", 0))


def load_fixture(path: str) -> Tuple[PlanModel, List[Any], int]:
    """Load a plan dict written as JSON by ``model_to_dict``."""
    import json
    with open(path, encoding="utf-8") as f:
        return model_from_dict(json.load(f))
