"""Certified plan superoptimization.

Counterpart of ``alpa_tpu/analysis/superopt.py``, with its names, knobs,
metrics, layouts and cache namespace.  The plan verifier's seven analyses
exist so that lowered plans can be rewritten boldly and checked for free.
This module is a search-based rewrite engine that runs after
``lower_to_register_file`` and transforms the pipeline instruction list
under four rewrite families, re-lowers the winner, and accepts it **only
if the full verdict on the rewritten program introduces no ``(analysis,
code)`` finding absent from the baseline verdict**; any new finding
rejects the rewrite, so an unsound search heuristic costs a rejected
candidate, never a wrong answer.

Rewrite families (searched greedily with a bounded beam and a
rewrite-step budget, scored by :func:`~alpa_tpu_torch.analysis.critical_path.
simulate_dag` over CalibrationStore-calibrated costs with an analytic
fallback below ``calibration_min_samples``):

1. **Re-scheduling** — reorder instructions within the
   ``partition_streams`` dependency order (hazard edges + per-channel
   FIFO order preserved) by critical-path list scheduling, shrinking
   the simulated makespan.
2. **FREE sinking/hoisting** — the same scheduler with a memory-aware
   priority (FREEs eagerly, allocations lazily) cuts the simulated
   peak-live-bytes each mesh reaches (``alpa_plan_peak_bytes`` is the
   static analogue the verifier exports).
3. **Transfer fusion/fission** — relocate same-edge groupable RESHARDs
   adjacent (past intervening *independent* instructions, beyond the
   coalescer's adjacent/interleaved-FREE reach) so lowering batches
   them; fission caps oversized groups via ``superopt_max_group``
   (threaded into the shared legality oracle, see
   :func:`reshard_group_extent`).
4. **Recompute-vs-keep flips** — clone a cheap, idempotent activation
   producer in front of a late consumer and free the original value
   after its early consumers, trading one cheap RUN for a shorter live
   range.

A candidate is *admissible* only if it regresses neither the simulated
critical path nor the simulated total peak bytes; the best admissible
candidate is then lowered for real and gated on the verdict diff.
Accepted decisions are cached in the ``superopt`` compile-cache
namespace keyed by baseline program fingerprint + calibration-store
fingerprint + knobs, so warm restarts replay the winning rewrite with
zero search and an identical plan fingerprint.

Shared legality oracle: :func:`reshard_group_extent` is the single
same-edge RESHARD grouping legality check — the registers-mode
coalescer in ``runtime_emitter`` (phase 2a) and the fusion family here
are its two callers.

Knobs: ``superopt_mode`` off|suggest|auto (+ ``superopt_beam_width``,
``superopt_step_budget``, ``superopt_verify_budget``,
``superopt_max_group``; all under ``ALPA_TPU_SUPEROPT*``).  Metrics:
``alpa_superopt_*``.  Debug dump: ``superopt.txt``
(``monitoring.dump_debug_info``).

In the port a rewritten list is what the executable runs: its eager run
and transfer tables, its CUDA-graph captures and its span names are built
from the rewritten list, so a recompute clone is a second capture of its
stage's graph.
"""
import copy
import dataclasses
import logging
from typing import (Any, Callable, Dict, FrozenSet, List, Optional,
                    Sequence, Set, Tuple)

from alpa_tpu_torch.analysis.critical_path import MemSpec, simulate_dag
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

__all__ = [
    "PlanScore", "SuperoptOutcome", "reshard_group_extent",
    "apply_layout", "check_layout", "score_instructions",
    "superopt_search", "run_superopt", "verdict_new_findings",
    "verdict_diff", "format_superopt_report", "SUPEROPT_VERSION",
]

#: Bump to invalidate cached superopt decisions on engine changes.
SUPEROPT_VERSION = 1

# analytic fallbacks (µs) when the calibration store has no measured
# override — only relative magnitudes matter to the search, and every
# candidate and its baseline are priced by the same model
_DEFAULT_RUN_US = 100.0
_DEFAULT_WIRE_BYTES_PER_S = 1e9
_FREE_US = 1.0

_REG = _tmetrics.get_registry()
_M_ATTEMPTED = _REG.counter(
    "alpa_superopt_rewrites_attempted_total",
    "Superopt rewrite candidates scored, by rewrite family",
    labelnames=("family",))
_M_ACCEPTED = _REG.counter(
    "alpa_superopt_rewrites_accepted_total",
    "Superopt rewrites accepted by the seven-analysis verdict gate")
_M_REJECTED = _REG.counter(
    "alpa_superopt_rewrites_rejected_total",
    "Superopt rewrites rejected, by reason (verifier = the verdict "
    "gate found a new (analysis, code) finding; score = no admissible "
    "improvement; fingerprint = warm-restart replay mismatch)",
    labelnames=("reason",))
_M_CP_DELTA = _REG.gauge(
    "alpa_superopt_critical_path_delta_us",
    "Simulated critical-path change of the last accepted rewrite "
    "(negative = faster)")
_M_PEAK_DELTA = _REG.gauge(
    "alpa_superopt_peak_bytes_delta",
    "Simulated total peak-live-bytes change of the last accepted "
    "rewrite (negative = smaller)")
_M_CACHE = _REG.counter(
    "alpa_superopt_cache_total",
    "Superopt compile-cache lookups, by result (hit = zero-search "
    "warm replay)",
    labelnames=("result",))


########################################
# shared fusion legality oracle (satellite 2)
########################################


def reshard_group_extent(recs: Sequence[Dict[str, Any]], i: int,
                         max_members: int = 0
                         ) -> Tuple[List[int], List[int], int, int]:
    """The maximal legal same-edge RESHARD group starting at rec ``i``.

    ONE legality oracle, two callers: the registers-mode coalescer in
    ``runtime_emitter.lower_to_register_file`` (phase 2a) and the
    superopt fusion family.  Group membership may hop intervening FREEs
    — safe because ``emit_free_instructions`` places every FREE after
    its slots' last use, so the batched group runs first and the FREE is
    re-emitted right after it — but a same-edge RESHARD touching a
    hopped slot ends the group instead of joining (it would reorder past
    a FREE of its own slots).  Only ``groupable`` (direct_p2p) members
    may join a multi-member group; ``max_members > 0`` caps the group
    size (the fission knob ``superopt_max_group``: oversized groups
    serialize behind the overlap in-flight window, so splitting them is
    a legal de-optimization the search may prefer).

    Returns ``(members, hopped, n_free_hops, next_i)``: rec indices in
    the group, hopped FREE rec indices to re-emit after it, the number
    of FREE hops that actually enabled a later member, and the index the
    caller resumes scanning at.
    """
    r = recs[i]
    n = len(recs)
    edge = r["edge"]
    members: List[int] = []
    hopped: List[int] = []
    blocked: Set[int] = set()
    n_free_hops = 0
    counted = 0
    j = i
    while j < n:
        q = recs[j]
        if (q["kind"] == "RESHARD" and q["edge"] == edge and
                (j == i or (r.get("groupable", True) and
                            q.get("groupable", True)))):
            if q["ss"] in blocked or q["ds"] in blocked:
                break   # would reorder past a FREE of its slots
            if max_members > 0 and len(members) >= max_members:
                break   # fission: cap the batched group size
            if len(hopped) > counted:
                n_free_hops += len(hopped) - counted
                counted = len(hopped)
            members.append(j)
            j += 1
            continue
        if q["kind"] == "FREE":
            hopped.append(j)
            blocked.update(q["slots"])
            j += 1
            continue
        break
    return members, hopped, n_free_hops, j


########################################
# layouts: serializable rewrite decisions
########################################
#
# A layout describes a rewritten instruction list purely in terms of the
# baseline list, so accepted decisions are cacheable and replayable with
# zero search:
#
#   i                  -> baseline instruction i, verbatim
#   ["clone", i]       -> a copy of baseline RUN i (recompute flips)
#   ["free", i, [p..]] -> a FREE of the given key positions of baseline
#                         FREE i (free splitting / motion)
#
# Every baseline non-FREE instruction appears exactly once; the key
# positions of each baseline FREE appear at most once across the layout.


def _entry_kind(e) -> str:
    if isinstance(e, int):
        return "orig"
    return str(e[0])


def identity_layout(n: int) -> List[Any]:
    return list(range(n))


def check_layout(instructions: Sequence[Any], layout: Sequence[Any]):
    """Validate a layout against the baseline list; raises ValueError
    on malformed entries (the cache-replay safety check)."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import \
        PipelineInstType
    n = len(instructions)
    seen: Set[int] = set()
    free_positions: Dict[int, Set[int]] = {}
    for e in layout:
        if isinstance(e, int):
            if not 0 <= e < n:
                raise ValueError(f"layout index {e} out of range")
            if instructions[e].opcode != PipelineInstType.FREE:
                if e in seen:
                    raise ValueError(f"instruction {e} appears twice")
                seen.add(e)
            else:
                pos = set(range(len(instructions[e].free_keys)))
                if free_positions.setdefault(e, set()) & pos:
                    raise ValueError(f"FREE {e} keys emitted twice")
                free_positions[e] |= pos
            continue
        kind = _entry_kind(e)
        if kind == "clone":
            i = int(e[1])
            if not 0 <= i < n or \
                    instructions[i].opcode != PipelineInstType.RUN:
                raise ValueError(f"clone of non-RUN instruction {i}")
        elif kind == "free":
            i, pos = int(e[1]), set(int(p) for p in e[2])
            if not 0 <= i < n or \
                    instructions[i].opcode != PipelineInstType.FREE:
                raise ValueError(f"free-split of non-FREE {i}")
            if not pos or max(pos) >= len(instructions[i].free_keys):
                raise ValueError(f"free-split positions {sorted(pos)} "
                                 f"out of range for FREE {i}")
            if free_positions.setdefault(i, set()) & pos:
                raise ValueError(f"FREE {i} keys emitted twice")
            free_positions[i] |= pos
        else:
            raise ValueError(f"unknown layout entry {e!r}")
    missing = [i for i, inst in enumerate(instructions)
               if inst.opcode != PipelineInstType.FREE and i not in seen]
    if missing:
        raise ValueError(f"layout drops instruction(s) {missing[:8]}")


def apply_layout(instructions: Sequence[Any],
                 layout: Sequence[Any]) -> List[Any]:
    """Materialize the rewritten instruction list a layout describes."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        PipelineInstType, PipelineInstruction)
    out: List[Any] = []
    for e in layout:
        if isinstance(e, int):
            out.append(instructions[e])
        elif _entry_kind(e) == "clone":
            out.append(copy.copy(instructions[int(e[1])]))
        else:  # free
            src = instructions[int(e[1])]
            keys = [src.free_keys[int(p)] for p in e[2]]
            out.append(PipelineInstruction(
                PipelineInstType.FREE, free_keys=keys, info=src.info))
    return out


def _compose(base_layout: Sequence[Any],
             edits: Sequence[Any]) -> List[Any]:
    """Compose a layout-over-the-current-list with the current layout,
    yielding a layout over the baseline list."""
    out: List[Any] = []
    for e in edits:
        if isinstance(e, int):
            out.append(base_layout[e])
            continue
        kind = _entry_kind(e)
        cur = base_layout[int(e[1])]
        if kind == "clone":
            out.append(["clone", cur if isinstance(cur, int)
                        else int(cur[1])])
        else:  # free over a possibly-already-split FREE
            if isinstance(cur, int):
                out.append(["free", cur, [int(p) for p in e[2]]])
            else:
                out.append(["free", int(cur[1]),
                            [int(cur[2][int(p)]) for p in e[2]]])
    return out


########################################
# plan-level cost model + simulation
########################################


def _key_nbytes(var) -> float:
    """The bytes of a value key's fx node (its ``meta["val"]``)."""
    import torch
    val = getattr(var, "meta", {}).get("val") if hasattr(var, "meta") \
        else None
    if not isinstance(val, torch.Tensor):
        return 0.0
    return float(val.numel() * val.element_size())


class _CostModel:
    """Per-instruction durations: calibrated medians when the store has
    enough samples (``calibration_min_samples``), analytic fallback
    otherwise.  Group-marginal pricing: a cross-mesh RESHARD directly
    following a same-edge RESHARD pays only the byte leg (no per-message
    latency) — the lowering will coalesce the pair into one batched
    group, which is exactly what makes the fusion family profitable."""

    def __init__(self, store=None, min_samples: Optional[int] = None):
        self.store = store
        self.min_samples = min_samples
        self._cache: Dict[int, Tuple[str, float, float]] = {}
        latency_s = float(getattr(
            global_config, "resharding_transfer_latency_s", 0.0) or 0.0)
        self.latency_us = latency_s * 1e6
        bw = float(getattr(
            global_config, "resharding_wire_bandwidth", 0.0) or 0.0)
        self.bytes_per_us = (bw or _DEFAULT_WIRE_BYTES_PER_S) / 1e6

    def _measured(self, kind: str, signature: str) -> Optional[float]:
        if self.store is None:
            return None
        return self.store.measured_us(kind, signature, self.min_samples)

    def _base(self, inst) -> Tuple[str, float, float]:
        """(kind, full_cost_us, marginal_cost_us) for one instruction."""
        key = id(inst)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
            PipelineInstType)
        from alpa_tpu_torch.telemetry import calibration as _cal
        if inst.opcode == PipelineInstType.RUN:
            c = self._measured(
                "stage_run", _cal.stage_signature(str(inst.info)))
            c = c if c is not None else _DEFAULT_RUN_US
            out = ("RUN", c, c)
        elif inst.opcode == PipelineInstType.RESHARD:
            nbytes = _key_nbytes(inst.var_key[0])
            wire = nbytes / self.bytes_per_us if self.bytes_per_us else 0.0
            cross = inst.src_mesh != inst.dst_mesh
            c = self._measured("reshard_wire", _cal.edge_signature(
                str(inst.src_mesh), str(inst.dst_mesh)))
            if c is None:
                c = (self.latency_us + wire) if cross else \
                    max(1.0, 0.5 * wire)
            out = ("RESHARD", c, max(1.0, c - self.latency_us)
                   if cross else c)
        else:
            out = ("FREE", _FREE_US, _FREE_US)
        self._cache[key] = out
        return out

    def durations(self, instructions: Sequence[Any]) -> List[float]:
        from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
            PipelineInstType)
        durs: List[float] = []
        prev_edge = None
        for inst in instructions:
            kind, full, marginal = self._base(inst)
            if kind == "RESHARD" and inst.src_mesh != inst.dst_mesh:
                edge = (inst.src_mesh, inst.dst_mesh)
                durs.append(marginal if edge == prev_edge else full)
                prev_edge = edge
            else:
                durs.append(full)
                if inst.opcode != PipelineInstType.FREE:
                    prev_edge = None
        return durs


@dataclasses.dataclass(frozen=True)
class PlanScore:
    """One candidate's simulated figures of merit."""
    makespan_us: float
    peak_bytes: Tuple[float, ...]

    @property
    def total_peak(self) -> float:
        return float(sum(self.peak_bytes))

    def admissible_vs(self, base: "PlanScore",
                      eps: float = 1e-9) -> bool:
        """True when this candidate regresses neither objective."""
        return (self.makespan_us <= base.makespan_us * (1 + eps) + eps
                and self.total_peak <= base.total_peak * (1 + eps) + eps)

    def to_dict(self) -> Dict[str, Any]:
        return {"makespan_us": round(self.makespan_us, 3),
                "peak_bytes": {str(m): b for m, b in
                               enumerate(self.peak_bytes)}}


def _mem_spec(instructions: Sequence[Any],
              num_meshes: int) -> MemSpec:
    """Slot-level memory footprint of an instruction list, mirroring
    phase-1 lowering's value-key slots (launch-placed keys — read or
    killed before any write — count as preplaced)."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        instruction_accesses)
    slot_ids: Dict[Tuple[Any, int, int], int] = {}
    nbytes: Dict[int, float] = {}
    mesh_of: Dict[int, int] = {}
    writes: List[List[int]] = []
    kills: List[List[int]] = []
    written: Set[int] = set()
    preplaced: Set[int] = set()

    def _slot(key):
        s = slot_ids.get(key)
        if s is None:
            s = slot_ids[key] = len(slot_ids)
            nbytes[s] = _key_nbytes(key[0])
            mesh_of[s] = key[2] if 0 <= key[2] < num_meshes else 0
        return s

    for inst in instructions:
        w: List[int] = []
        k: List[int] = []
        for key, kind in instruction_accesses(inst):
            s = _slot(key)
            if kind == "write":
                w.append(s)
                written.add(s)
            elif kind == "kill":
                k.append(s)
                if s not in written:
                    preplaced.add(s)
            elif s not in written:
                preplaced.add(s)
        writes.append(w)
        kills.append(k)
    return MemSpec(writes=writes, kills=kills, nbytes=nbytes,
                   mesh_of=mesh_of, num_meshes=max(1, num_meshes),
                   preplaced=frozenset(preplaced))


def score_instructions(instructions: Sequence[Any], num_meshes: int,
                       cost_model: Optional[_CostModel] = None
                       ) -> PlanScore:
    """Simulate one instruction list: per-mesh streams chained serially,
    cross-stream hazard deps, calibrated durations -> (makespan,
    per-mesh simulated peak live bytes)."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        partition_streams)
    cost_model = cost_model or _CostModel()
    streams = partition_streams(list(instructions), num_meshes)
    preds: List[Set[int]] = [set(streams.deps.get(i, ()))
                             for i in range(len(instructions))]
    for stream in streams.streams:
        for a, b in zip(stream, stream[1:]):
            preds[b].add(a)
    durs = cost_model.durations(instructions)
    mem = _mem_spec(instructions, num_meshes)
    makespan, _, peaks = simulate_dag(durs, preds, mem)
    return PlanScore(makespan_us=makespan, peak_bytes=tuple(peaks))


########################################
# hazard graph + rewrite families
########################################


def _hazard_preds(instructions: Sequence[Any]) -> List[Set[int]]:
    """Full reordering-legality graph: RAW/WAW/WAR/kill edges over value
    keys plus per-(src,dst) channel FIFO order (cross-mesh RESHARDs on
    one edge must keep their send order — the model checker's
    ``deadlock.channel-reorder`` invariant)."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        PipelineInstType, instruction_accesses)
    preds: List[Set[int]] = [set() for _ in instructions]
    history: Dict[Any, List[Tuple[int, str]]] = {}
    last_on_edge: Dict[Tuple[int, int], int] = {}
    prev_producer: Dict[Tuple[int, int], int] = {}
    for i, inst in enumerate(instructions):
        if inst.opcode == PipelineInstType.RESHARD and \
                inst.src_mesh != inst.dst_mesh:
            edge = (inst.src_mesh, inst.dst_mesh)
            prev = last_on_edge.get(edge)
            if prev is not None:
                preds[i].add(prev)
            last_on_edge[edge] = i
            # production order must track the channel's send order
            # (``deadlock.channel-reorder``): chain consecutive
            # payload producers on each edge
            src_key = (inst.var_key[0], inst.var_key[1], inst.src_mesh)
            h = history.get(src_key, ())
            prod = next((j for j, k in reversed(h) if k == "write"),
                        None)
            if prod is not None:
                pp = prev_producer.get(edge)
                if pp is not None and pp != prod:
                    preds[prod].add(pp)
                prev_producer[edge] = prod
        for key, kind in instruction_accesses(inst):
            # j == i happens when one instruction both kills and writes
            # a key (donated grad-accumulation RUNs) — never an edge.
            h = history.setdefault(key, [])
            if kind == "read":
                for j, k in reversed(h):
                    if k != "read":
                        if j != i:
                            preds[i].add(j)
                        break
            else:  # write / kill orders against every earlier access
                for j, _k in h:
                    if j != i:
                        preds[i].add(j)
            h.append((i, kind))
    return preds


def _list_schedule(instructions: Sequence[Any], durs: Sequence[float],
                   preds: Sequence[Set[int]],
                   gamma: float) -> List[int]:
    """Priority-topological reorder of the hazard DAG.  Priority is the
    critical-path bottom level minus ``gamma`` x net allocated bytes
    (gamma = 0 is pure critical-path list scheduling; gamma > 0 defers
    allocators and promotes FREEs, the memory-motion variant).  Returns
    a permutation of instruction indices."""
    n = len(instructions)
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for i, ps in enumerate(preds):
        for p in ps:
            succs[p].append(i)
            indeg[i] += 1
    b_level = [0.0] * n
    for i in range(n - 1, -1, -1):
        tail = max((b_level[s] for s in succs[i]), default=0.0)
        b_level[i] = durs[i] + tail
    net_alloc = [0.0] * n
    if gamma:
        mem = _mem_spec(instructions, 1)
        for i in range(n):
            net_alloc[i] = (sum(mem.nbytes[s] for s in mem.writes[i]) -
                            sum(mem.nbytes[s] for s in mem.kills[i]))
    import heapq
    ready = [(-(b_level[i] - gamma * net_alloc[i]), i)
             for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        _, i = heapq.heappop(ready)
        order.append(i)
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(
                    ready, (-(b_level[s] - gamma * net_alloc[s]), s))
    if len(order) != n:     # cycle: keep the original order (never
        return list(range(n))   # happens on emitter output)
    return order


def _resched_candidates(instructions, cost_model,
                        ) -> List[Tuple[str, List[Any]]]:
    """Families 1 + 2: critical-path and memory-aware list schedules."""
    durs = cost_model.durations(instructions)
    preds = _hazard_preds(instructions)
    makespan = max(1.0, sum(durs))
    mem = _mem_spec(instructions, 1)
    peak = max(1.0, *(
        [sum(mem.nbytes[s] for s in mem.writes[i]) for i in
         range(len(instructions))] or [1.0]))
    out = []
    for family, gamma in (("reschedule", 0.0),
                          ("free_motion", makespan / peak),
                          ("free_motion", 10.0 * makespan / peak)):
        order = _list_schedule(instructions, durs, preds, gamma)
        if order != list(range(len(instructions))):
            out.append((family, list(order)))
    return out


def _fusion_candidates(instructions) -> List[Tuple[str, List[Any]]]:
    """Family 3: pull a cross-mesh RESHARD up adjacent to the previous
    same-edge RESHARD when every intervening instruction is independent
    of it — beyond the coalescer's FREE-hopping reach, so lowering can
    batch the pair into one grouped transfer."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        PipelineInstType, instructions_independent)
    out: List[Tuple[str, List[Any]]] = []
    last_at: Dict[Tuple[int, int], int] = {}
    n = len(instructions)
    for j in range(n):
        inst = instructions[j]
        if inst.opcode != PipelineInstType.RESHARD or \
                inst.src_mesh == inst.dst_mesh:
            continue
        edge = (inst.src_mesh, inst.dst_mesh)
        i = last_at.get(edge)
        last_at[edge] = j
        if i is None or j == i + 1:
            continue
        between = instructions[i + 1:j]
        if all(b.opcode == PipelineInstType.FREE or
               instructions_independent(b, inst) for b in between):
            order = (list(range(i + 1)) + [j] +
                     list(range(i + 1, j)) + list(range(j + 1, n)))
            out.append(("transfer_fusion", order))
            if len(out) >= 4:
                break
    return out


def _recompute_candidates(instructions) -> List[Tuple[str, List[Any]]]:
    """Family 4: for a value produced by a cheap idempotent RUN with a
    late extra consumer, free it after its early consumers and clone the
    producer right before the late one — shorter live range for one
    re-executed stage."""
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        PipelineInstType, instruction_accesses)
    n = len(instructions)
    producers: Dict[Any, int] = {}
    readers: Dict[Any, List[int]] = {}
    killers: Dict[Any, int] = {}
    kills_at: Dict[int, Set[Any]] = {}
    for i, inst in enumerate(instructions):
        for key, kind in instruction_accesses(inst):
            if kind == "write":
                producers.setdefault(key, i)
            elif kind == "read":
                readers.setdefault(key, []).append(i)
            else:
                killers[key] = i
                kills_at.setdefault(i, set()).add(key)
    out: List[Tuple[str, List[Any]]] = []
    for key, reads in readers.items():
        if len(reads) < 2 or key not in producers or key not in killers:
            continue
        prod, late, early = producers[key], reads[-1], reads[-2]
        fi = killers[key]
        if late - early < 4 or fi < late:
            continue
        p_inst = instructions[prod]
        if p_inst.opcode != PipelineInstType.RUN:
            continue
        donated = set(getattr(getattr(p_inst, "executable", None),
                              "donate_idx", ()) or ())
        if donated:
            continue    # not idempotent: re-running consumes its inputs
        # producer inputs must still be live at the clone point
        in_keys = {(k[0], k[1], p_inst.dst_mesh)
                   for k in p_inst.input_keys}
        if any(killers.get(k, n) < late for k in in_keys):
            continue
        f_inst = instructions[fi]
        pos = [p for p, k in enumerate(f_inst.free_keys)
               if tuple(k) == key]
        if not pos:
            continue
        rest = [p for p in range(len(f_inst.free_keys))
                if p not in pos]
        layout: List[Any] = []
        for i in range(n):
            if i == fi:
                if rest:
                    layout.append(["free", fi, rest])
                continue
            if i == late:
                layout.append(["clone", prod])
            layout.append(i)
            if i == early:
                layout.append(["free", fi, pos])
        out.append(("recompute", layout))
        if len(out) >= 2:
            break
    return out


def deoptimize_instructions(instructions: Sequence[Any],
                            cost_model: Optional[_CostModel] = None
                            ) -> List[Any]:
    """A hazard-legal adversarial reorder of an instruction list:
    topological over the full hazard DAG (so RAW/WAR/WAW and per-edge
    channel FIFO order all hold — the program is semantically
    identical), but with inverted list-scheduling priority and every
    FREE deferred as late as legality allows.  Live ranges stretch
    (peak bytes inflate) and streams serialize badly (the simulated
    critical path inflates).  This is the adversarial baseline: the plan
    a register-file emitter *could* legally have produced, which
    ``superopt_mode=auto`` must then recover."""
    import heapq
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        PipelineInstType)
    cost_model = cost_model or _CostModel()
    durs = cost_model.durations(instructions)
    preds = _hazard_preds(instructions)
    n = len(instructions)
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for i, ps in enumerate(preds):
        for p in ps:
            succs[p].append(i)
            indeg[i] += 1
    b_level = [0.0] * n
    for i in range(n - 1, -1, -1):
        tail = max((b_level[s] for s in succs[i]), default=0.0)
        b_level[i] = durs[i] + tail

    def _prio(i):
        # max-heap on (-key): shallow ops first, FREEs dead last
        penalty = 1e18 if \
            instructions[i].opcode == PipelineInstType.FREE else 0.0
        return -(-b_level[i] - penalty)

    ready = [(_prio(i), i) for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order: List[int] = []
    while ready:
        _, i = heapq.heappop(ready)
        order.append(i)
        for s in succs[i]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, (_prio(s), s))
    if len(order) != n:
        return list(instructions)
    return [instructions[i] for i in order]


########################################
# beam search
########################################


def superopt_search(instructions: Sequence[Any], num_meshes: int,
                    cost_model: Optional[_CostModel] = None,
                    beam_width: Optional[int] = None,
                    step_budget: Optional[int] = None
                    ) -> Tuple[List[Any], PlanScore, PlanScore,
                               List[Dict[str, Any]],
                               List[Tuple[List[Any], PlanScore]]]:
    """Greedy bounded-beam search over the four rewrite families.

    Returns ``(layout, baseline_score, best_score, log, candidates)``
    where ``layout`` describes the best admissible candidate over the
    baseline list (the identity layout when nothing improves) and
    ``candidates`` is the final admissible pool best-first — the gate's
    fallback order when the winner is rejected by the verifier.  Pure
    search: no lowering, no verification — the caller gates the winner.
    """
    beam_width = beam_width if beam_width is not None else int(
        getattr(global_config, "superopt_beam_width", 4))
    step_budget = step_budget if step_budget is not None else int(
        getattr(global_config, "superopt_step_budget", 32))
    cost_model = cost_model or _CostModel()
    base_score = score_instructions(instructions, num_meshes, cost_model)
    n = len(instructions)
    base = (identity_layout(n), list(instructions), base_score)
    beam = [base]
    best = base
    seen: Set[str] = set()
    log: List[Dict[str, Any]] = []
    steps = 0
    improved = True
    while improved and steps < step_budget:
        improved = False
        frontier = []
        for layout, insts, score in beam:
            cands = (_resched_candidates(insts, cost_model) +
                     _fusion_candidates(insts) +
                     _recompute_candidates(insts))
            for family, edits in cands:
                if steps >= step_budget:
                    break
                steps += 1
                _M_ATTEMPTED.labels(family).inc()
                new_layout = _compose(layout, edits)
                sig = repr(new_layout)
                if sig in seen:
                    continue
                seen.add(sig)
                try:
                    check_layout(instructions, new_layout)
                    new_insts = apply_layout(instructions, new_layout)
                    new_score = score_instructions(
                        new_insts, num_meshes, cost_model)
                except (ValueError, KeyError, IndexError) as e:
                    logger.debug("superopt: %s candidate invalid: %s",
                                 family, e)
                    continue
                if not new_score.admissible_vs(base_score):
                    continue
                log.append({
                    "family": family,
                    "makespan_us": round(new_score.makespan_us, 3),
                    "peak_bytes": round(new_score.total_peak, 1),
                })
                frontier.append((new_layout, new_insts, new_score))
        if frontier:
            frontier.sort(key=lambda t: (
                t[2].makespan_us / max(base_score.makespan_us, 1e-9) +
                t[2].total_peak / max(base_score.total_peak, 1e-9)))
            beam = frontier[:max(1, beam_width)]
            if (beam[0][2].makespan_us, beam[0][2].total_peak) < \
                    (best[2].makespan_us, best[2].total_peak):
                best = beam[0]
                improved = True
    # the gate pool holds only STRICT improvements — an equal-score
    # rewrite is pointless churn (and would dirty the plan fingerprint
    # for nothing), so it never reaches the verifier
    pool: List[Tuple[List[Any], PlanScore]] = []
    pool_seen: Set[str] = set()
    for layout, _insts, score in [best] + beam:
        sig = repr(layout)
        if sig in pool_seen or layout == base[0]:
            continue
        if not (score.makespan_us < base_score.makespan_us - 1e-9 or
                score.total_peak < base_score.total_peak - 1e-9):
            continue
        pool_seen.add(sig)
        pool.append((layout, score))
    # gate order = the search objective (normalized makespan + peak),
    # so the balanced winner is verified before single-axis rewrites
    pool.sort(key=lambda t: (
        t[1].makespan_us / max(base_score.makespan_us, 1e-9) +
        t[1].total_peak / max(base_score.total_peak, 1e-9)))
    return best[0], base_score, best[2], log, pool


########################################
# verdict gate
########################################


def verdict_new_findings(baseline, candidate) -> List[Tuple[str, str]]:
    """The ``(analysis, code)`` pairs present in the candidate verdict
    but absent from the baseline — the acceptance gate: non-empty means
    the rewrite is rejected."""
    base = {(f.analysis, f.code) for f in baseline.findings()}
    return sorted({(f.analysis, f.code) for f in candidate.findings()}
                  - base)


def verdict_diff(baseline, candidate) -> Dict[str, Any]:
    """Machine-readable verdict diff (the JAX package's shape)."""
    base = {(f.analysis, f.code) for f in baseline.findings()}
    cand = {(f.analysis, f.code) for f in candidate.findings()}
    return {
        "baseline_findings": sorted(f"{a}.{c}" if not c.startswith(a)
                                    else c for a, c in base),
        "candidate_findings": sorted(f"{a}.{c}" if not c.startswith(a)
                                     else c for a, c in cand),
        "new": [f"{a}:{c}" for a, c in sorted(cand - base)],
        "resolved": [f"{a}:{c}" for a, c in sorted(base - cand)],
        "ok": not (cand - base),
    }


########################################
# driver: cache + gate + metrics
########################################


@dataclasses.dataclass
class SuperoptOutcome:
    """Everything one superopt run decided, for the executable and the
    ``superopt.txt`` dump."""
    mode: str                           # superopt_mode at decision time
    searched: bool                      # False on a warm cache replay
    cache_hit: bool
    accepted: bool
    layout: List[Any]
    baseline_score: PlanScore
    best_score: PlanScore
    baseline_fingerprint: str
    fingerprint: Optional[str]          # accepted program fingerprint
    rejected: List[Tuple[str, str]]     # gate findings that rejected it
    log: List[Dict[str, Any]]
    program: Any = None                 # accepted RegisterFileProgram
    instructions: Optional[List[Any]] = None

    @property
    def critical_path_delta_us(self) -> float:
        return self.best_score.makespan_us - \
            self.baseline_score.makespan_us

    @property
    def peak_bytes_delta(self) -> float:
        return self.best_score.total_peak - \
            self.baseline_score.total_peak

    def to_dict(self) -> Dict[str, Any]:
        return {
            "mode": self.mode,
            "searched": self.searched,
            "cache_hit": self.cache_hit,
            "accepted": self.accepted,
            "baseline": self.baseline_score.to_dict(),
            "best": self.best_score.to_dict(),
            "critical_path_delta_us": round(
                self.critical_path_delta_us, 3),
            "peak_bytes_delta": round(self.peak_bytes_delta, 1),
            "baseline_fingerprint": self.baseline_fingerprint,
            "fingerprint": self.fingerprint,
            "rejected_by": [f"{a}:{c}" for a, c in self.rejected],
            "n_rewrites": sum(
                1 for i, e in enumerate(self.layout)
                if not isinstance(e, int) or e != i),
            "log": self.log,
        }


def _knob_bits() -> Tuple:
    return (int(getattr(global_config, "superopt_beam_width", 4)),
            int(getattr(global_config, "superopt_step_budget", 32)),
            int(getattr(global_config, "superopt_max_group", 0)))


def run_superopt(instructions: Sequence[Any], num_meshes: int,
                 baseline_prog, lower: Callable[[Sequence[Any]], Any],
                 verify: Callable[[Any, Sequence[Any]], Any],
                 mode: Optional[str] = None) -> SuperoptOutcome:
    """The full certified-superoptimization driver.

    ``lower(insts)`` re-lowers a candidate instruction list into a
    RegisterFileProgram; ``verify(prog, insts)`` returns its
    seven-analysis verdict (reusing ``prog.verdict`` when lowering
    already verified).  Flow: consult the ``superopt`` compile-cache
    namespace (baseline fingerprint + calibration-store fingerprint +
    knobs) — a hit replays the accepted layout with **zero search**;
    otherwise beam-search, lower the best admissible candidate, and gate
    it on :func:`verdict_new_findings`.  ``mode="suggest"`` searches and
    reports but never applies; ``"auto"`` returns the accepted program
    for the executable to swap in.
    """
    from alpa_tpu_torch.compile_cache import get_compile_cache
    from alpa_tpu_torch.telemetry import calibration as _cal
    import time
    t0 = time.perf_counter()
    mode = mode or getattr(global_config, "superopt_mode", "off")
    store = _cal.get_calibration_store()
    cost_model = _CostModel(store=store)
    base_fp = baseline_prog.fingerprint()
    n = len(instructions)

    def _outcome(**kw) -> SuperoptOutcome:
        base_score = kw.pop("baseline_score")
        return SuperoptOutcome(
            mode=mode, baseline_score=base_score,
            baseline_fingerprint=base_fp, **kw)

    cache = get_compile_cache()
    cache_key = cache.make_key("superopt", (
        "superopt", SUPEROPT_VERSION, base_fp, baseline_prog.mode,
        store.fingerprint() if len(store) else "analytic",
        _knob_bits()))
    cached = cache.get("superopt", cache_key)
    base_verdict = verify(baseline_prog, instructions)

    if cached is not None:
        _M_CACHE.labels("hit").inc()
        layout = cached["layout"]
        try:
            check_layout(instructions, layout)
            new_insts = apply_layout(instructions, layout)
            prog = lower(new_insts)
            replay_ok = prog.fingerprint() == cached["fingerprint"]
        except Exception as e:  # pylint: disable=broad-except
            logger.warning("superopt: cached layout replay failed "
                           "(%s); re-searching", e)
            replay_ok = False
        if replay_ok:
            verdict = verify(prog, new_insts)
            new = verdict_new_findings(base_verdict, verdict)
            if not new:
                score = score_instructions(new_insts, num_meshes,
                                           cost_model)
                base_score = PlanScore(
                    makespan_us=cached["baseline_makespan_us"],
                    peak_bytes=tuple(cached["baseline_peak_bytes"]))
                _record_accept(score, base_score)
                cache.record_saved_seconds(
                    "superopt", float(cached.get("search_seconds", 0.0)))
                return _outcome(
                    searched=False, cache_hit=True, accepted=True,
                    layout=layout, baseline_score=base_score,
                    best_score=score, fingerprint=prog.fingerprint(),
                    rejected=[], log=cached.get("log", []),
                    program=prog, instructions=new_insts)
            _M_REJECTED.labels("verifier").inc()
        else:
            _M_REJECTED.labels("fingerprint").inc()
    else:
        _M_CACHE.labels("miss").inc()

    # cold path: bounded beam search, then gate the winners for real —
    # up to superopt_verify_budget candidate lowerings, best-first
    layout, base_score, best_score, log, candidates = superopt_search(
        instructions, num_meshes, cost_model)
    if not candidates:
        _M_REJECTED.labels("score").inc()
        return _outcome(
            searched=True, cache_hit=False, accepted=False,
            layout=identity_layout(n), baseline_score=base_score,
            best_score=base_score, fingerprint=None, rejected=[],
            log=log)

    verify_budget = max(1, int(getattr(
        global_config, "superopt_verify_budget", 2)))
    rejected: List[Tuple[str, str]] = []
    for layout, score in candidates[:verify_budget]:
        try:
            new_insts = apply_layout(instructions, layout)
            prog = lower(new_insts)
            verdict = verify(prog, new_insts)
        except Exception as e:  # pylint: disable=broad-except
            # under verify_plans=strict an unsound candidate raises at
            # lowering — that is a gate rejection, not a compile error
            _M_REJECTED.labels("verifier").inc()
            logger.info("superopt: candidate lowering rejected: %s", e)
            rejected.append(("lowering", type(e).__name__))
            continue
        new = verdict_new_findings(base_verdict, verdict)
        if new:
            _M_REJECTED.labels("verifier").inc()
            logger.info("superopt: candidate rejected by the verdict "
                        "gate: %s",
                        ", ".join(f"{a}:{c}" for a, c in new))
            rejected.extend(new)
            continue
        _record_accept(score, base_score)
        search_seconds = time.perf_counter() - t0
        cache.record_solve_seconds("superopt", search_seconds)
        cache.put("superopt", cache_key, {
            "search_seconds": search_seconds,
            "layout": layout,
            "fingerprint": prog.fingerprint(),
            "baseline_fingerprint": base_fp,
            "baseline_makespan_us": base_score.makespan_us,
            "baseline_peak_bytes": list(base_score.peak_bytes),
            "makespan_us": score.makespan_us,
            "peak_bytes": list(score.peak_bytes),
            "log": log,
        })
        logger.info(
            "superopt: accepted rewrite (%s): critical path "
            "%.1f -> %.1f us, peak bytes %.0f -> %.0f",
            mode, base_score.makespan_us, score.makespan_us,
            base_score.total_peak, score.total_peak)
        return _outcome(
            searched=True, cache_hit=False, accepted=True,
            layout=layout, baseline_score=base_score, best_score=score,
            fingerprint=prog.fingerprint(), rejected=[], log=log,
            program=prog, instructions=new_insts)
    return _outcome(
        searched=True, cache_hit=False, accepted=False,
        layout=identity_layout(n), baseline_score=base_score,
        best_score=base_score, fingerprint=None,
        rejected=sorted(set(rejected)), log=log)


def _record_accept(score: PlanScore, base: PlanScore):
    _M_ACCEPTED.inc()
    _M_CP_DELTA.set(score.makespan_us - base.makespan_us)
    _M_PEAK_DELTA.set(score.total_peak - base.total_peak)


def load_cached_decisions(cache=None) -> List[Dict[str, Any]]:
    """Accepted superopt decisions from the compile cache's disk tier,
    newest first, WITHOUT recompiling anything:
    ``[{"key", "mtime", "decision"}, ...]`` (mirrors
    ``plan_verifier.load_cached_verdicts``)."""
    import pickle
    from alpa_tpu_torch import compile_cache as _cc
    cache = cache or _cc.get_compile_cache()
    out = []
    for e in cache.entries():
        if e["namespace"] != "superopt":
            continue
        try:
            with open(e["path"], "rb") as f:
                value = pickle.load(f)
            if isinstance(value, dict) and "__cache_format__" in value:
                value = value["payload"]
        except Exception:  # pylint: disable=broad-except
            continue
        if isinstance(value, dict) and "layout" in value:
            out.append({"key": e["key"], "mtime": e["mtime"],
                        "decision": value})
    out.sort(key=lambda d: d["mtime"], reverse=True)
    return out


def format_superopt_report(outcome: Optional[SuperoptOutcome]) -> str:
    """Human-readable ``superopt.txt`` (monitoring.dump_debug_info)."""
    if outcome is None:
        return "superopt: (not run — superopt_mode=off or not lowered)"
    d = outcome.to_dict()
    lines = [
        f"superopt: mode={d['mode']} accepted={d['accepted']} "
        f"cache_hit={d['cache_hit']} searched={d['searched']}",
        f"  simulated critical path: "
        f"{d['baseline']['makespan_us']:.1f} -> "
        f"{d['best']['makespan_us']:.1f} us "
        f"(delta {d['critical_path_delta_us']:+.1f})",
        f"  simulated peak bytes:    "
        f"{sum(float(v) for v in d['baseline']['peak_bytes'].values()):.0f}"
        f" -> "
        f"{sum(float(v) for v in d['best']['peak_bytes'].values()):.0f}"
        f" (delta {d['peak_bytes_delta']:+.0f})",
        f"  baseline fingerprint: {d['baseline_fingerprint'][:16]}",
        f"  rewritten fingerprint: "
        f"{(d['fingerprint'] or '-')[:16]}",
        f"  non-identity layout entries: {d['n_rewrites']}",
    ]
    if d["rejected_by"]:
        lines.append("  rejected by verdict gate: "
                     + ", ".join(d["rejected_by"]))
    if d["log"]:
        lines.append("  accepted-candidate search log "
                     f"({len(d['log'])} admissible candidates):")
        for e in d["log"][-12:]:
            lines.append(f"    {e['family']:<16} makespan "
                         f"{e['makespan_us']:.1f} us, peak "
                         f"{e['peak_bytes']:.0f} B")
    return "\n".join(lines)
