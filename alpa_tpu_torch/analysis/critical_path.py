"""Critical-path analysis over measured instruction timings.

Counterpart of ``alpa_tpu/analysis/critical_path.py``.  A pure data
layer under ``telemetry/perf.py``: no device, no recorder -- the
inputs are :class:`TimedOp` samples (one per replayed op, timestamps on
the shared trace epoch) plus optional causal predecessor sets derived
from the lowering-time :class:`~alpa_tpu_torch.pipeline_parallel.
runtime_emitter.InstructionDataflowGraph`.  Two complementary models:

* **Measured walk** (:func:`measured_critical_path`) — backward walk
  over the *observed* timeline: from the op that retires last, repeatedly
  step to the op whose completion gated the current op's start.  Causal
  edges (dataflow preds, same-track order) win when they bind; otherwise
  the latest earlier finisher anywhere binds (the driver serializes op
  dispatch, which is a real resource edge even though the dataflow graph
  does not carry it).  The resulting chain spans the step envelope —
  op time on the chain plus attributed gaps equals the envelope — so
  per-op *share* answers "where did the step go".

* **DAG re-simulation** (:func:`simulate_dag` / :func:`whatif`) — replay
  the dependency DAG with per-op durations under an idealized
  infinitely-parallel driver (causal edges only).  This is the what-if
  engine: zero a chosen op class and compare makespans ("if this RESHARD
  were free, step time −X%").  Zeroing never increases the makespan, and
  zeroing an op off the simulated critical path helps at most as much as
  zeroing the path's binding ops.
"""
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "TimedOp", "PathStep", "CriticalPathReport", "MemSpec",
    "measured_critical_path", "simulate_dag", "longest_path", "whatif",
]

# clock-jitter tolerance when deciding whether a candidate predecessor's
# completion "touches" the current op's start (microseconds)
_EPS_US = 2.0


@dataclasses.dataclass(frozen=True)
class TimedOp:
    """One measured op: a span joined back to its replayed instruction."""
    idx: int                 # position in the analyzed op list
    name: str                # span label ("RUN stage_0", "WAIT ...", ...)
    kind: str                # "exec" | "launch" | "wait"
    track: str               # "mesh 0", "mesh 1", ...
    t0_us: float
    t1_us: float

    @property
    def dur_us(self) -> float:
        return self.t1_us - self.t0_us


@dataclasses.dataclass
class PathStep:
    """One link of the critical path, earliest first."""
    op: TimedOp
    gap_us: float = 0.0      # idle between the previous link's finish
                             # and this op's start
    via: str = "start"       # "start" | "dep" | "track" | "issue"
    share: float = 0.0       # op duration / path op-time total


@dataclasses.dataclass
class CriticalPathReport:
    envelope_us: float       # measured step envelope
    total_us: float          # op time on the path
    gap_us: float            # attributed idle on the path
    steps: List[PathStep]

    @property
    def coverage(self) -> float:
        """(path op time + gaps) / envelope — ~1.0 when the walk spans
        the whole step (the perf_tool acceptance check)."""
        if self.envelope_us <= 0:
            return 0.0
        return (self.total_us + self.gap_us) / self.envelope_us

    def top(self, k: int) -> List[PathStep]:
        return sorted(self.steps, key=lambda s: -s.op.dur_us)[:k]

    def by_kind(self) -> Dict[str, float]:
        """Path op time per op kind (exec/launch/wait), microseconds."""
        acc: Dict[str, float] = {}
        for s in self.steps:
            acc[s.op.kind] = acc.get(s.op.kind, 0.0) + s.op.dur_us
        return acc

    def format_table(self, top: int = 10) -> str:
        lines = [
            f"critical path: {self.total_us:.1f} us op time + "
            f"{self.gap_us:.1f} us gaps over a {self.envelope_us:.1f} us "
            f"envelope ({100.0 * self.coverage:.1f}% coverage, "
            f"{len(self.steps)} ops)",
            f"{'share':>7}  {'dur_us':>10}  {'via':>5}  "
            f"{'track':<8} name",
        ]
        for s in self.top(top):
            lines.append(
                f"{100.0 * s.share:6.2f}%  {s.op.dur_us:10.1f}  "
                f"{s.via:>5}  {s.op.track:<8} {s.op.name}")
        return "\n".join(lines)


def _finalize(steps: List[PathStep],
              envelope_us: float) -> CriticalPathReport:
    total = sum(s.op.dur_us for s in steps)
    gaps = sum(s.gap_us for s in steps)
    if total > 0:
        for s in steps:
            s.share = s.op.dur_us / total
    return CriticalPathReport(envelope_us=envelope_us, total_us=total,
                              gap_us=gaps, steps=steps)


def measured_critical_path(
        ops: Sequence[TimedOp],
        preds_of: Optional[Dict[int, Iterable[int]]] = None,
        envelope_us: Optional[float] = None,
        eps_us: float = _EPS_US) -> CriticalPathReport:
    """Backward walk over the measured timeline (module docstring).

    ``preds_of`` maps op idx -> causal predecessor op idxs (dataflow
    edges mapped into op space).  Same-track order and driver issue
    order are always candidate edges; causal edges win ties so the path
    reads as dependencies, not dispatch accidents.
    """
    if not ops:
        return CriticalPathReport(envelope_us or 0.0, 0.0, 0.0, [])
    preds_of = preds_of or {}
    by_idx = {o.idx: o for o in ops}
    # issue order: strictly increasing position guarantees the walk
    # terminates even with zero-duration or clock-jittered spans
    order = sorted(ops, key=lambda o: (o.t0_us, o.t1_us, o.idx))
    pos = {o.idx: i for i, o in enumerate(order)}
    if envelope_us is None:
        envelope_us = (max(o.t1_us for o in ops) -
                       min(o.t0_us for o in ops))
    # prefix max of t1 over issue order, for the O(1) "latest earlier
    # finisher" fallback
    best_prefix: List[TimedOp] = []
    best = None
    for o in order:
        if best is None or o.t1_us > best.t1_us:
            best = o
        best_prefix.append(best)
    last_on_track: Dict[str, List[TimedOp]] = {}
    for o in order:
        last_on_track.setdefault(o.track, []).append(o)

    cur = max(ops, key=lambda o: (o.t1_us, o.idx))
    steps: List[PathStep] = [PathStep(op=cur)]
    while pos[cur.idx] > 0:
        limit = cur.t0_us + eps_us
        fallback = best_prefix[pos[cur.idx] - 1]
        # causal candidates: dataflow preds + previous op on this track
        causal: List[Tuple[TimedOp, str]] = []
        for p in preds_of.get(cur.idx, ()):
            o = by_idx.get(p)
            if o is not None and pos[o.idx] < pos[cur.idx] and \
                    o.t1_us <= limit:
                causal.append((o, "dep"))
        seq = last_on_track.get(cur.track, ())
        for o in reversed(seq):
            if pos[o.idx] < pos[cur.idx]:
                if o.t1_us <= limit:
                    causal.append((o, "track"))
                break
        chosen, via = None, "issue"
        if causal:
            chosen, via = max(causal, key=lambda c: (c[0].t1_us,
                                                     pos[c[0].idx]))
        if chosen is None or (fallback.t1_us > chosen.t1_us + eps_us and
                              fallback.t1_us <= limit):
            # nothing causal binds: the latest earlier finisher does
            # (driver/issue-order serialization)
            if fallback.t1_us <= limit:
                chosen, via = fallback, "issue"
        if chosen is None:
            # cur started while every earlier op was still running —
            # concurrent tracks; fall back to issue order to keep the
            # walk spanning the envelope
            chosen, via = order[pos[cur.idx] - 1], "issue"
        # via/gap describe the edge INTO the current head; the walk's
        # first op keeps the "start" placeholder
        steps[0].gap_us = max(0.0, cur.t0_us - chosen.t1_us)
        steps[0].via = via
        steps.insert(0, PathStep(op=chosen))
        cur = chosen
    return _finalize(steps, envelope_us)


@dataclasses.dataclass(frozen=True)
class MemSpec:
    """Per-op memory effects for the DAG re-simulation: the
    slot-level footprint the plan verifier's liveness pass walks
    statically, here replayed on the *simulated* timeline so schedule
    rewrites can be scored on peak-live-bytes before they are lowered.

    ``writes[i]`` / ``kills[i]`` are the slot ids op ``i`` defines /
    frees; ``nbytes``/``mesh_of`` map slot id -> size / owning mesh;
    ``preplaced`` slots are live from t=0 (launch placement).  The state
    machine matches ``plan_verifier.check_liveness`` exactly — a write
    allocates only when the slot is not already live, a kill releases
    only a live slot — so a serial replay in program order reproduces
    the static ``alpa_plan_peak_bytes`` figure bit for bit."""
    writes: Sequence[Sequence[int]]
    kills: Sequence[Sequence[int]]
    nbytes: Dict[int, float]
    mesh_of: Dict[int, int]
    num_meshes: int = 1
    preplaced: frozenset = frozenset()


def _simulate_peaks(finish: Sequence[float],
                    mem: MemSpec) -> List[float]:
    """Peak live bytes per mesh over the simulated timeline: each op's
    memory effects (writes then kills, mirroring the static walk's
    per-op order) land at its simulated finish time; ties resolve in op
    order so a serial chain replays program order."""
    n_meshes = max(1, mem.num_meshes)

    def _mesh(s):
        m = mem.mesh_of.get(s, 0)
        return m if 0 <= m < n_meshes else 0

    live_bytes = [0.0] * n_meshes
    _UNDEF, _LIVE, _DEAD = 0, 1, 2
    state: Dict[int, int] = {}
    for s in mem.preplaced:
        state[s] = _LIVE
        live_bytes[_mesh(s)] += mem.nbytes.get(s, 0)
    peaks = list(live_bytes)
    order = sorted(range(len(finish)), key=lambda i: (finish[i], i))
    for i in order:
        for s in mem.kills[i]:
            if state.get(s, _UNDEF) == _LIVE:
                live_bytes[_mesh(s)] -= mem.nbytes.get(s, 0)
            state[s] = _DEAD
        for s in mem.writes[i]:
            if state.get(s, _UNDEF) != _LIVE:
                m = _mesh(s)
                live_bytes[m] += mem.nbytes.get(s, 0)
                if live_bytes[m] > peaks[m]:
                    peaks[m] = live_bytes[m]
            state[s] = _LIVE
    return peaks


def simulate_dag(durs_us: Sequence[float],
                 preds: Sequence[Iterable[int]],
                 mem: Optional[MemSpec] = None):
    """Earliest-finish replay of the dependency DAG (causal edges only,
    idealized parallel driver).  ``preds[i]`` must reference earlier
    indices; later/self references are ignored.  Returns
    ``(makespan_us, finish_us)`` — or, with a :class:`MemSpec`,
    ``(makespan_us, finish_us, peak_bytes_per_mesh)`` tracking the
    simulated peak-live-bytes each mesh reaches (the FREE-motion
    objective)."""
    n = len(durs_us)
    finish = [0.0] * n
    for i in range(n):
        start = 0.0
        for p in preds[i]:
            if 0 <= p < i and finish[p] > start:
                start = finish[p]
        finish[i] = start + durs_us[i]
    makespan = max(finish) if finish else 0.0
    if mem is None:
        return makespan, finish
    return makespan, finish, _simulate_peaks(finish, mem)


def longest_path(durs_us: Sequence[float],
                 preds: Sequence[Iterable[int]]
                 ) -> Tuple[float, List[int]]:
    """Longest-duration chain through the DAG: the simulated critical
    path.  Returns ``(length_us, op_idx_list)`` ordered start→end."""
    n = len(durs_us)
    finish = [0.0] * n
    best_pred = [-1] * n
    for i in range(n):
        start, bp = 0.0, -1
        for p in preds[i]:
            if 0 <= p < i and finish[p] > start:
                start, bp = finish[p], p
        finish[i] = start + durs_us[i]
        best_pred[i] = bp
    if not finish:
        return 0.0, []
    i = max(range(n), key=lambda j: finish[j])
    path: List[int] = []
    while i >= 0:
        path.append(i)
        i = best_pred[i]
    path.reverse()
    return max(finish), path


def whatif(durs_us: Sequence[float],
           preds: Sequence[Iterable[int]],
           zeroed: Set[int],
           mem: Optional[MemSpec] = None):
    """Makespan with the chosen ops made free — the "if this RESHARD
    cost nothing" re-simulation.  Monotone: never exceeds the baseline
    :func:`simulate_dag` makespan.  With a :class:`MemSpec`, returns
    ``(makespan_us, peak_bytes_per_mesh)`` so memory-motion what-ifs
    ("if this FREE ran right after the last use") are scored on the
    same timeline."""
    durs = [0.0 if i in zeroed else d for i, d in enumerate(durs_us)]
    if mem is None:
        makespan, _ = simulate_dag(durs, preds)
        return makespan
    makespan, _, peaks = simulate_dag(durs, preds, mem)
    return makespan, peaks
