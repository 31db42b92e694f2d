"""Numerics certification: precision-flow abstract interpretation with
end-to-end quantization error bounds.

Counterpart of ``alpa_tpu/analysis/numerics.py``, with its finding codes,
metrics and the codecs' ``ERROR_BOUND`` contract read from the port's
``pipeline_parallel/reshard_codec.py`` (the activation codec's ``int8`` and
``fp8`` entries on RESHARDs; the gradient codec's ``grad_*`` and, for a
quantized reduce-scatter of a wide stage, ``grad_*_rs`` entries on RUNs).

The sixth ``verify_program`` analysis.  The plan verifier's other
passes prove *where* values move; this one proves *how much precision
survives the trip*.  Every register slot carries an abstract precision
value — storage dtype, narrowest accumulation dtype seen on its
producing path, a composed worst-case relative-error bound, a
provenance class (``param`` / ``opt_state`` / ``gradient`` /
``activation``, seeded from the invar-path plumbing), and the
ordered list of lossy hops it crossed — propagated through the lowered
RUN/RESHARD/FREE program in flat emission order:

* **RUN** — outputs inherit the max input bound (error propagation
  through a stage is modeled unamplified: stages are
  Lipschitz-normalized matmul/elementwise pipelines, and the bound is a
  *relative-to-blockmax* term, not an absolute one), the merged lossy
  hop list, and the highest-priority provenance
  (opt_state > param > gradient > activation) of the stage's *donated*
  inputs — a donation is an in-place update of the same logical state
  (grad accumulate, apply_grad), so param/opt-state identity survives
  it, while an output computed from a merely-*read* param is a fresh
  activation that may legally cross lossy hops.  The stage executable's
  aten-level classification
  (:func:`alpa_tpu_torch.shard_parallel.eqn_classify.classify_stage_precision`)
  types each stage's matmul/reduce/cast population; a reduction that
  accumulates below fp32 raises ``numerics.bf16-accumulation``.
* **RESHARD** — a lossy hop composes the codec's documented bound from
  :data:`alpa_tpu_torch.pipeline_parallel.reshard_codec.ERROR_BOUND` (the
  int8 ``blockmax/254`` and fp8-e4m3 ``7% blockmax`` contract — the
  same constants the codec's property tests pin) first-order additively
  onto the flowing value, appends the hop, and is enumerated as a
  ``numerics.quantized-reduction`` note — the ROADMAP item-3 typing of
  which collectives are quantized vs full-precision.
* Lossless hops and FREEs propagate / drop values untouched.

Finding taxonomy (:func:`severity_of`):

* ``numerics.lossy-weight-path`` (error) — a value of ``param``
  provenance (or a weight edge) crosses a lossy hop.  Strengthens the
  typing pass's per-edge weight check into a full-flow proof: a weight
  that became an activation-name three hops ago is still caught.
* ``numerics.lossy-opt-state-path`` (error) — optimizer state (incl.
  future error-feedback accumulators) routed through a lossy hop.
* ``numerics.budget-exceeded`` (error) — a value's composed worst-case
  bound crossed ``global_config.numerics_error_budget``.
* ``numerics.bf16-accumulation`` (warning) — a stage reduction
  accumulates below fp32.
* ``numerics.quantized-reduction`` (note) — one per lossy collective,
  enumerating codec, edge, and the composed bound after the hop.
* ``numerics.quantized-gradient`` (note) — one per RUN whose
  gradient-provenance accumulation runs through the stochastic-rounding
  gradient codec (``grad_quantize != off``): composes
  ``ERROR_BOUND["grad_<mode>"]`` (the ``_rs`` two-hop variant for
  reduce-scatter syncs) onto the flowing bound, amortized to a single
  hop under error feedback and additive in the microbatch hop count
  without it; ``numerics_error_budget`` gates the result exactly like
  a resharding hop.

Gated by ``global_config.verify_plans_numerics`` (``off | warn |
error``, default ``warn``; env ``ALPA_TPU_VERIFY_NUMERICS``) —
``error`` blocks ``_launch`` with :class:`PlanVerificationError` even
when ``verify_plans`` itself is only warning.  Stats land at
``PlanVerdict.stats["numerics"]`` (JSON-able, deterministic, replayed
byte-identically from the verdict cache), render as ``numerics.txt``
in ``dump_debug_info``, export the ``alpa_numerics_max_error_bound`` /
``alpa_numerics_lossy_edges_total{kind}`` gauges.
"""
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PrecisionValue", "NumericsResult", "check_numerics", "severity_of",
    "format_numerics", "export_metrics", "DEFAULT_ERROR_BUDGET",
]

#: fallback per-tensor relative-error budget when the caller passes
#: none (mirrors the global_env default)
DEFAULT_ERROR_BUDGET = 0.05

#: provenance merge priority: the most precision-critical class wins
#: when a stage mixes inputs
_PROV_PRIORITY = {"opt_state": 3, "param": 2, "gradient": 1,
                  "activation": 0, "": -1}

#: finding code -> severity the plan verifier merges it at
_SEVERITY = {
    "numerics.lossy-weight-path": "error",
    "numerics.lossy-opt-state-path": "error",
    "numerics.budget-exceeded": "error",
    "numerics.bf16-accumulation": "warning",
    "numerics.quantized-reduction": "note",
    "numerics.quantized-gradient": "note",
}


def severity_of(code: str) -> str:
    """Severity class (``"error" | "warning" | "note"``) the plan
    verifier merges a numerics finding at."""
    return _SEVERITY.get(code, "note")


@dataclasses.dataclass(frozen=True)
class PrecisionValue:
    """The abstract domain: one slot's precision facts at a program
    point."""
    storage: str                        # dtype the value is stored in
    accum: str                          # narrowest accumulation dtype
    rel_bound: float                    # composed worst-case rel error
                                        # (fraction of block max)
    provenance: str                     # param|opt_state|gradient|
                                        # activation|""
    lossy_hops: Tuple[str, ...] = ()    # ordered "<edge>:<codec>" hops


@dataclasses.dataclass
class NumericsResult:
    """Findings + stats of one :func:`check_numerics` run.  ``stats``
    is JSON-able and stored verbatim at
    ``PlanVerdict.stats["numerics"]`` so cached verdicts replay the
    identical report."""
    findings: List[Any] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(severity_of(f.code) == "error"
                       for f in self.findings)

    def format(self) -> str:
        return format_numerics(self.stats, self.findings)


def _error_bounds() -> Dict[str, float]:
    """The codec's machine-readable contract, never duplicated here."""
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import ERROR_BOUND
    return dict(ERROR_BOUND)


def _merge_provenance(provs: Sequence[str]) -> str:
    best = ""
    for p in provs:
        if _PROV_PRIORITY.get(p, -1) > _PROV_PRIORITY.get(best, -1):
            best = p
    return best


def _merge_hops(hop_lists: Sequence[Tuple[str, ...]]
                ) -> Tuple[str, ...]:
    out: List[str] = []
    for hops in hop_lists:
        for h in hops:
            if h not in out:
                out.append(h)
    return tuple(out)


def check_numerics(model, hooks: Optional[Sequence[Any]] = None,
                   budget: Optional[float] = None) -> NumericsResult:
    """Run the precision-flow abstract interpretation over a
    :class:`~alpa_tpu_torch.analysis.plan_verifier.PlanModel`.  Pure function
    of its inputs — no globals, no cache, no metrics (see
    ``verify_program`` for the compile-time wrapper)."""
    from alpa_tpu_torch.analysis.plan_verifier import Finding
    del hooks  # footprint checks are the structure pass's job
    t0 = time.perf_counter()
    if budget is None:
        budget = DEFAULT_ERROR_BUDGET
    budget = float(budget)
    bounds = _error_bounds()
    findings: List[Finding] = []

    # abstract state: slot -> PrecisionValue; seeded from the slot
    # table (launch-placed values carry their provenance class)
    vals: Dict[int, PrecisionValue] = {}
    for s, sm in model.slots.items():
        if sm.preplaced or sm.dtype:
            prov = getattr(sm, "provenance", "") or ""
            if not prov and getattr(sm, "opt_state", False):
                prov = "opt_state"
            vals[s] = PrecisionValue(
                storage=sm.dtype, accum=sm.dtype, rel_bound=0.0,
                provenance=prov if sm.preplaced else "",
                lossy_hops=())

    lossy_edges: Dict[str, int] = {}
    n_bf16 = 0
    budget_hit: set = set()     # dst slots already reported

    def _slot_var(s: int) -> str:
        sm = model.slots.get(s)
        return sm.var if sm is not None else f"slot{s}"

    for op in model.ops:
        if op.kind == "RUN":
            ins = [vals.get(s) for s in op.reads]
            ins = [v for v in ins if v is not None]
            in_bound = max((v.rel_bound for v in ins), default=0.0)
            # error bounds and lossy-hop lists flow through compute
            # from EVERY input, but provenance only flows from donated
            # (killed) inputs — a donation is an in-place update of
            # the same logical state (grad accumulate, apply_grad),
            # whereas an output computed from a merely-read param is a
            # new activation and may legally cross lossy hops
            donated = set(op.kills)
            in_prov = _merge_provenance(
                [v.provenance for s, v in zip(op.reads,
                                              [vals.get(s)
                                               for s in op.reads])
                 if v is not None and s in donated])
            in_hops = _merge_hops([v.lossy_hops for v in ins])
            prec = getattr(op, "precision", None) or {}
            if prec.get("below_fp32_accum"):
                n_bf16 += 1
                findings.append(Finding(
                    "numerics", "numerics.bf16-accumulation",
                    f"{op.label}: {prec.get('n_reduce', 0)} "
                    f"reduction(s) / {prec.get('n_matmul', 0)} "
                    f"contraction(s) accumulate in "
                    f"{prec.get('min_accum', '?')} (below fp32) — "
                    f"partial sums lose mantissa before the final "
                    f"cast", op.idx))
            accum = str(prec.get("min_accum") or "")
            # Quantized gradient sync: a RUN carrying a
            # grad_quant fact whose donated inputs have gradient
            # provenance is a quantized gradient accumulation/sync —
            # compose the codec's stochastic-rounding bound.  With
            # error feedback the residual carries untransmitted mass
            # forward, so the cumulative bound over all accumulation
            # hops amortizes to a single hop; without it the worst
            # case is additive in the hop count.
            gq = getattr(op, "grad_quant", None) or {}
            if gq and in_prov == "gradient":
                mode = str(gq.get("mode", "int8"))
                bkey = f"grad_{mode}" + ("_rs" if gq.get("rs") else "")
                per_hop = bounds.get(bkey, max(bounds.values()))
                n_hops = 1 if gq.get("ef", True) else \
                    max(1, int(gq.get("hops", 1)))
                add = per_hop * n_hops
                new_bound = in_bound + add
                hop = f"{op.label or f'op{op.idx}'}:{bkey}"
                in_bound = new_bound
                in_hops = in_hops + (hop,)
                lossy_edges[bkey] = lossy_edges.get(bkey, 0) + 1
                findings.append(Finding(
                    "numerics", "numerics.quantized-gradient",
                    f"{op.label}: quantized gradient sync ({bkey}, "
                    f"documented bound {per_hop:.6g} of blockmax x "
                    f"{n_hops} hop(s)"
                    + (", error-feedback amortized" if gq.get("ef", True)
                       else "") +
                    f"); composed bound after sync {new_bound:.6g}",
                    op.idx))
                if new_bound > budget:
                    dsts = [s for s in op.writes if s not in budget_hit]
                    budget_hit.update(dsts)
                    findings.append(Finding(
                        "numerics", "numerics.budget-exceeded",
                        f"{op.label}: composed worst-case gradient "
                        f"bound {new_bound:.6g} exceeds "
                        f"numerics_error_budget {budget:.6g} after "
                        f"quantized sync {hop}", op.idx))
            for pos, s in enumerate(op.writes):
                declared = (op.out_avals[pos]
                            if pos < len(op.out_avals) else None)
                sm = model.slots.get(s)
                storage = (declared[1] if declared
                           else (sm.dtype if sm is not None else ""))
                vals[s] = PrecisionValue(
                    storage=storage, accum=accum or storage,
                    rel_bound=in_bound, provenance=in_prov,
                    lossy_hops=in_hops)
        elif op.kind == "RESHARD":
            src = op.reads[0] if op.reads else None
            dst = op.writes[0] if op.writes else None
            v = vals.get(src) if src is not None else None
            if v is None:
                sm = model.slots.get(src) if src is not None else None
                v = PrecisionValue(
                    storage=sm.dtype if sm is not None else "",
                    accum=sm.dtype if sm is not None else "",
                    rel_bound=0.0,
                    provenance=(getattr(sm, "provenance", "")
                                if sm is not None else ""),
                    lossy_hops=())
            codec = getattr(op, "codec", None)
            if codec is None and op.strategy == "quantized":
                codec = "int8"      # quantized edge with unknown mode
            if codec:
                hop_bound = bounds.get(codec,
                                       max(bounds.values()))
                edge = (f"{op.edge[0]}->{op.edge[1]}"
                        if op.edge else "?")
                hop = f"{edge}:{codec}"
                prov = v.provenance
                weightish = op.weight or prov == "param"
                new_bound = v.rel_bound + hop_bound
                v = PrecisionValue(
                    storage=v.storage, accum=v.accum,
                    rel_bound=new_bound, provenance=prov,
                    lossy_hops=v.lossy_hops + (hop,))
                lossy_edges[codec] = lossy_edges.get(codec, 0) + 1
                findings.append(Finding(
                    "numerics", "numerics.quantized-reduction",
                    f"{op.label}: lossy collective ({codec}, "
                    f"documented bound {hop_bound:.6g} of blockmax) on "
                    f"edge {edge}; composed bound after hop "
                    f"{new_bound:.6g}", op.idx))
                if weightish:
                    findings.append(Finding(
                        "numerics", "numerics.lossy-weight-path",
                        f"{op.label}: parameter-provenance value "
                        f"{_slot_var(src)} crosses lossy hop {hop} — "
                        f"weights must flow losslessly end to end",
                        op.idx))
                if prov == "opt_state":
                    findings.append(Finding(
                        "numerics", "numerics.lossy-opt-state-path",
                        f"{op.label}: optimizer-state value "
                        f"{_slot_var(src)} crosses lossy hop {hop} — "
                        f"opt state must flow losslessly end to end",
                        op.idx))
                if new_bound > budget and dst not in budget_hit:
                    budget_hit.add(dst)
                    findings.append(Finding(
                        "numerics", "numerics.budget-exceeded",
                        f"{op.label}: composed worst-case bound "
                        f"{new_bound:.6g} of {_slot_var(src)} exceeds "
                        f"numerics_error_budget {budget:.6g} after "
                        f"hops {list(v.lossy_hops)}", op.idx))
            if dst is not None:
                vals[dst] = v
        # FREE: values simply die; nothing to propagate

    # per-output bound table (protected slots = program outputs), plus
    # the program-wide worst case over every tracked slot
    table: List[Dict[str, Any]] = []
    for s in sorted(model.slots):
        sm = model.slots[s]
        if not sm.protected:
            continue
        v = vals.get(s)
        if v is None:
            continue
        table.append({
            "slot": s, "var": sm.var,
            "provenance": v.provenance or "activation",
            "storage": v.storage, "accum": v.accum,
            "bound": v.rel_bound, "hops": list(v.lossy_hops),
        })
    max_bound = max((v.rel_bound for v in vals.values()), default=0.0)

    stats = {
        "max_error_bound": max_bound,
        "lossy_edges": dict(sorted(lossy_edges.items())),
        "n_lossy_collectives": sum(lossy_edges.values()),
        "n_bf16_reductions": n_bf16,
        "bound_table": table,
        "budget": budget,
        "n_tracked": len(vals),
        "seconds": round(time.perf_counter() - t0, 6),
    }
    return NumericsResult(findings=findings, stats=stats)


def format_numerics(stats: Dict[str, Any],
                    findings: Optional[Sequence[Any]] = None) -> str:
    """Human-readable numerics report (``numerics.txt``).  Works from the JSON-able stats dict
    alone so cached verdicts render identically."""
    lossy = stats.get("lossy_edges", {})
    lines = [
        "numerics certification: "
        + ("no lossy hops" if not lossy else
           "  ".join(f"{k}={v}" for k, v in sorted(lossy.items()))),
        f"max_error_bound={stats.get('max_error_bound', 0.0):.6g}  "
        f"budget={stats.get('budget', 0.0):.6g}  "
        f"lossy_collectives={stats.get('n_lossy_collectives', 0)}  "
        f"bf16_reductions={stats.get('n_bf16_reductions', 0)}  "
        f"tracked_slots={stats.get('n_tracked', 0)}  "
        f"seconds={stats.get('seconds', 0.0)}",
    ]
    table = stats.get("bound_table", ())
    if table:
        lines.append("per-output bounds:")
        lines.append(f"  {'output':<20} {'provenance':<11} "
                     f"{'storage':<10} {'accum':<10} {'bound':>12}  "
                     f"hops")
        for row in table:
            hops = ", ".join(row.get("hops", ())) or "-"
            lines.append(
                f"  {str(row.get('var', '?')):<20} "
                f"{row.get('provenance', '?'):<11} "
                f"{row.get('storage', '?'):<10} "
                f"{row.get('accum', '?'):<10} "
                f"{row.get('bound', 0.0):>12.6g}  {hops}")
    if findings:
        lines.append("findings:")
        for f in findings:
            at = f" (op {f.op})" if f.op >= 0 else ""
            lines.append(
                f"  [{severity_of(f.code)}] [{f.code}]{at} {f.message}")
    return "\n".join(lines)


def export_metrics(stats: Optional[Dict[str, Any]]) -> None:
    """Publish one numerics run's gauges in the central registry
    (``alpa_numerics_max_error_bound`` /
    ``alpa_numerics_lossy_edges_total{kind}``).  Gauges are *set* from
    the deterministic stats, so warm-restart cache replays export
    exactly the cold compile's values."""
    if not stats:
        return
    _MAX_BOUND.set(float(stats.get("max_error_bound", 0.0)))
    for kind, n in (stats.get("lossy_edges") or {}).items():
        _LOSSY_EDGES.labels(str(kind)).set(float(n))


from alpa_tpu_torch.telemetry import metrics as _tmetrics  # noqa: E402

_REG = _tmetrics.get_registry()
_MAX_BOUND = _REG.gauge(
    "alpa_numerics_max_error_bound",
    "Numerics certification: worst composed relative error bound "
    "(fraction of block max) over every register slot of the last "
    "verified plan")
_LOSSY_EDGES = _REG.gauge(
    "alpa_numerics_lossy_edges_total",
    "Numerics certification: lossy (quantized) transfer hops in the "
    "last verified plan, by codec kind",
    labelnames=("kind",))
