"""Translation validation: certify that every lowered plan computes the
traced step.

Counterpart of ``alpa_tpu/analysis/equivalence.py``, with its names,
axioms, finding codes and metrics; a stage is named by the
``compile_cache.graph_fingerprint`` of its aten graph where the JAX
package hashes its jaxpr.  The seventh ``verify_program`` analysis.  The
other six prove the lowered ``RegisterFileProgram`` internally consistent
(typed, deadlock-free, leak-free, structurally sound, schedulable,
precise); none compares the program with the traced step, and a lowering
bug that wires the wrong value of the right shape (a stale weight after
donation, a dropped microbatch, a gradient accumulated twice, a mis-paired
reshard) passes every one of them.  This pass closes that loop by symbolic
execution over an opaque term algebra:

* **Term model.**  Values are hash-consed terms over one shared intern
  table: ``leaf(var, instance)`` for launch-placed values (parameters,
  batch shards, accumulator zero-buffers), ``app(stage_sig, out_pos,
  args...)`` for a stage application (the stage's graph is opaque — its
  deterministic signature identifies it), and an n-ary ``sum{...}`` for
  gradient accumulation.  ``sum`` members are kept as a *sorted
  multiset*, which bakes the accumulation reassociation/commutation
  axiom into term identity; equality is pointer equality on interned
  ids.
* **Candidate execution.**  The lowered program runs over its register
  slots in flat emission order: each RUN applies its stage as an
  opaque term over the symbolic values currently in its operand slots
  (donated inputs consume their term — a later read of the consumed
  slot is ``equiv.stale-operand``); accumulated outputs compose as
  ``sum(acc_in, contrib(stage, mb, non-acc args))``; RESHARD / SEND /
  RECV / BROADCAST are value identities (the resharding-identity
  axiom; quantized edges are identity-within-bound, cross-referencing
  the numerics certificate); FREE kills the slot.
* **Reference execution.**  The driver's pre-lowering instruction
  stream (``pipeshard_executable`` plumbs it down as
  ``equiv_reference``) serially composes the *same* stage
  decomposition over ``(var, microbatch)`` value keys — the traced
  step's semantics under the scheduler-independent serial order.
* **Proof obligation.**  Every protected output's candidate term must
  equal its reference term, modulo the two documented rewrite axioms
  (accumulation reassociation/commutation, resharding identity) plus
  the certificate-backed quantized-within-bound identity.

Finding taxonomy (:func:`severity_of`):

* ``equiv.output-mismatch`` (error) — a protected output's term graph
  differs structurally from the reference; the finding carries a
  rendered term-diff witness naming the first divergence.
* ``equiv.stale-operand`` (error) — an op reads a slot whose value was
  consumed (donated away or freed) — the plan wires a stale buffer.
* ``equiv.dropped-microbatch`` (error) — an accumulated output is
  missing one or more microbatch contributions present in the
  reference sum.
* ``equiv.duplicated-accumulation`` (error) — an accumulated output
  contains a contribution more times than the reference (a gradient
  counted twice).
* ``equiv.unproven-output`` (warning) — the proof needs an axiom
  outside the allowed set: the quantized-within-bound identity was
  used but no valid numerics certificate backs it.
* ``equiv.budget-exhausted`` (note) — the term table hit
  ``equiv_term_budget``; the verdict is partial, never false.

Gated by ``global_config.verify_plans_equiv`` (``off | warn | error``,
default ``warn``; env ``ALPA_TPU_VERIFY_EQUIV``) — ``error`` blocks
``_launch`` with ``PlanVerificationError`` independently of
``verify_plans``.  Stats land at ``PlanVerdict.stats["equiv"]``
(JSON-able, deterministic, replayed byte-identically from the verdict
cache), render as ``equiv.txt`` in ``dump_debug_info``, export the
``alpa_plan_equiv_total{result}`` counter and the
``alpa_equiv_terms_total`` gauge.
"""
import dataclasses
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

__all__ = [
    "TermTable", "EquivResult", "check_equiv", "severity_of",
    "format_equiv", "export_metrics", "render_term",
    "stage_signature", "stage_equiv_info", "build_reference",
    "reference_digest", "DEFAULT_TERM_BUDGET",
    "AXIOM_ACC", "AXIOM_RESHARD", "AXIOM_QUANT",
]

#: fallback hash-consed term budget when the caller passes none
#: (mirrors the global_env default)
DEFAULT_TERM_BUDGET = 100000

#: the documented rewrite axioms a proof may use
AXIOM_ACC = "accumulation-reassociation"
AXIOM_RESHARD = "resharding-identity"
AXIOM_QUANT = "quantized-within-bound"

#: finding code -> severity the plan verifier merges it at
_SEVERITY = {
    "equiv.output-mismatch": "error",
    "equiv.stale-operand": "error",
    "equiv.dropped-microbatch": "error",
    "equiv.duplicated-accumulation": "error",
    "equiv.unproven-output": "warning",
    "equiv.budget-exhausted": "note",
}

#: marker prefix for the poison leaf a stale read substitutes so
#: execution can continue past the finding
_STALE = "⊥stale"


def severity_of(code: str) -> str:
    """Severity class (``"error" | "warning" | "note"``) the plan
    verifier merges an equivalence finding at."""
    return _SEVERITY.get(code, "note")


class _BudgetExhausted(Exception):
    pass


class TermTable:
    """Hash-consing intern table: structurally equal terms get the same
    integer id, so term-graph equality is id equality and ``sum``
    multisets can sort by id.  One table is shared between the
    candidate and reference executions of a single proof."""

    __slots__ = ("_intern", "terms", "budget")

    def __init__(self, budget: Optional[int] = None):
        self._intern: Dict[Tuple, int] = {}
        self.terms: List[Tuple] = []
        self.budget = budget

    def __len__(self) -> int:
        return len(self.terms)

    def _make(self, struct: Tuple) -> int:
        tid = self._intern.get(struct)
        if tid is None:
            if self.budget is not None and \
                    len(self.terms) >= self.budget:
                raise _BudgetExhausted()
            tid = len(self.terms)
            self._intern[struct] = tid
            self.terms.append(struct)
        return tid

    def leaf(self, var: Any, instance: int) -> int:
        return self._make(("leaf", str(var), int(instance)))

    def app(self, sig: str, out: Any, args: Sequence[int]) -> int:
        return self._make(("app", str(sig), out, tuple(args)))

    def sum_(self, members: Sequence[int]) -> int:
        """N-ary accumulation sum: nested sums flatten and the member
        multiset sorts by interned id — reassociation and commutation
        are identities by construction (the documented axiom)."""
        flat: List[int] = []
        for m in members:
            s = self.terms[m]
            if s[0] == "sum":
                flat.extend(s[1])
            else:
                flat.append(m)
        return self._make(("sum", tuple(sorted(flat))))


def render_term(table: TermTable, tid: int, depth: int = 4,
                maxlen: int = 220) -> str:
    """Bounded-depth pretty-printer for term-diff witnesses."""
    def go(t: int, d: int) -> str:
        s = table.terms[t]
        if s[0] == "leaf":
            return s[1] + ("" if s[2] < 0 else f"@mb{s[2]}")
        if d <= 0:
            return "…"
        if s[0] == "app":
            out = s[2]
            o = (f"contrib{out[1]}.mb{out[2]}"
                 if isinstance(out, tuple) else f"out{out}")
            return (f"{s[1]}.{o}("
                    + ", ".join(go(a, d - 1) for a in s[3]) + ")")
        return "sum{" + " + ".join(go(m, d - 1) for m in s[1]) + "}"

    text = go(tid, depth)
    return text if len(text) <= maxlen else text[:maxlen - 1] + "…"


def _first_divergence(table: TermTable, want: int, got: int
                      ) -> Tuple[List[str], int, int]:
    """Descend through matching application heads to the smallest
    differing subterms; returns the path taken plus both sides."""
    path: List[str] = []
    while want != got:
        sw, sg = table.terms[want], table.terms[got]
        if (sw[0] == "app" and sg[0] == "app" and sw[1] == sg[1]
                and sw[2] == sg[2] and len(sw[3]) == len(sg[3])):
            diffs = [i for i, (a, b) in enumerate(zip(sw[3], sg[3]))
                     if a != b]
            if len(diffs) == 1:
                path.append(f"{sw[1]}.arg{diffs[0]}")
                want, got = sw[3][diffs[0]], sg[3][diffs[0]]
                continue
        break
    return path, want, got


def _witness(table: TermTable, want: int, got: int) -> str:
    path, w, g = _first_divergence(table, want, got)
    at = "/".join(path) or "root"
    return (f"at {at}: reference computes {render_term(table, w)} "
            f"but the plan computes {render_term(table, g)}")


def _is_tainted(table: TermTable, tid: int,
                memo: Dict[int, bool]) -> bool:
    """Whether a term contains a stale-read poison leaf."""
    hit = memo.get(tid)
    if hit is not None:
        return hit
    s = table.terms[tid]
    if s[0] == "leaf":
        out = s[1].startswith(_STALE)
    elif s[0] == "app":
        out = any(_is_tainted(table, a, memo) for a in s[3])
    else:
        out = any(_is_tainted(table, m, memo) for m in s[1])
    memo[tid] = out
    return out


########################################
# stage decomposition metadata (shared emitter <-> driver helpers)
########################################


def stage_signature(ex) -> str:
    """Deterministic opaque signature of a stage executable: its name and
    the ``graph_fingerprint`` of its aten graph.  The same helper names
    the stage on both the candidate (lowering record) and the reference
    (driver decomposition) side, so a matching decomposition matches by
    construction."""
    sig = getattr(ex, "_equiv_stage_sig", None)
    if sig is None:
        from alpa_tpu_torch.compile_cache import graph_fingerprint
        name = str(getattr(ex, "name", "") or "stage")
        module = getattr(ex, "module", None)
        try:
            digest = graph_fingerprint(module)[:8] if module is not None \
                else "0" * 8
        except Exception:  # pylint: disable=broad-except
            digest = "0" * 8
        sig = f"{name}#{digest}"
        try:
            ex._equiv_stage_sig = sig
        except Exception:  # pylint: disable=broad-except
            pass
    return sig


def stage_equiv_info(ex) -> Dict[str, Any]:
    """Per-stage equivalence metadata: opaque signature, donated invar
    positions, and the accumulation map ``{out_pos: acc_in_pos}``
    (string keys so the dict survives a JSON round-trip) derived from
    the executable's ``acc_out_map`` (summed output -> accumulator input,
    set by the driver).  Cached on the executable —
    every RUN of the same stage shares one dict."""
    info = getattr(ex, "_equiv_stage_info", None)
    if info is not None:
        return info
    invars = list(getattr(ex, "invars", ()) or ())
    outvars = list(getattr(ex, "outvars", ()) or ())
    acc_out = getattr(ex, "acc_out_map", None) or {}
    acc: Dict[str, int] = {}
    for pos, ov in enumerate(outvars):
        iv = acc_out.get(ov)
        if iv is not None and iv in invars:
            acc[str(pos)] = invars.index(iv)
    info = {
        "stage": stage_signature(ex),
        "donate": sorted(int(i) for i in
                         (getattr(ex, "donate_idx", ()) or ())),
        "acc": acc,
    }
    try:
        ex._equiv_stage_info = info
    except Exception:  # pylint: disable=broad-except
        pass
    return info


def build_reference(instructions: Sequence[Any],
                    num_microbatches: int = 0) -> Dict[str, Any]:
    """The reference decomposition: the driver's pre-lowering RUN
    stream as serial stage applications over ``(var, instance)`` value
    keys (format ``alpa-equiv-reference/v1``, JSON-able).  Built by
    the executable's lowerer (``pipeshard_executable._make_lowerer``) and
    plumbed into
    ``lower_to_register_file`` — deliberately *not* derived from the
    register lowering under verification."""
    apps: List[Dict[str, Any]] = []
    for inst in instructions:
        if getattr(getattr(inst, "opcode", None), "name", "") != "RUN":
            continue
        ex = inst.executable
        info = stage_equiv_info(ex)
        mb = getattr(inst, "micro_batch", None)
        apps.append({
            "stage": info["stage"],
            "mb": int(mb) if mb is not None else -1,
            "donate": list(info["donate"]),
            "acc": dict(info["acc"]),
            "in": [[str(v), int(i)]
                   for v, i in (inst.input_keys or ())],
            "out": [[str(v), int(i)]
                    for v, i in (inst.output_keys or ())],
        })
    return {"format": "alpa-equiv-reference/v1", "apps": apps,
            "num_microbatches": int(num_microbatches)}


def reference_digest(reference: Optional[Dict[str, Any]]) -> str:
    """Short deterministic digest of a reference decomposition — part
    of the verdict cache key (a changed reference must re-derive the
    proof).  Var-repr object ids are scrubbed so warm restarts of the
    same program hash identically."""
    if not reference:
        return "none"
    import hashlib
    import json
    import re
    text = json.dumps(reference, sort_keys=True, default=str)
    text = re.sub(r"\bid=\d+\b", "id=?", text)
    text = re.sub(r"0x[0-9a-fA-F]+", "0x?", text)
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


########################################
# the analysis
########################################


@dataclasses.dataclass
class EquivResult:
    """Findings + stats of one :func:`check_equiv` run.  ``stats`` is
    JSON-able and stored verbatim at ``PlanVerdict.stats["equiv"]`` so
    cached verdicts replay the identical report."""
    findings: List[Any] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not any(severity_of(f.code) == "error"
                       for f in self.findings)

    def format(self) -> str:
        return format_equiv(self.stats, self.findings)


def _exec_reference(reference: Dict[str, Any], table: TermTable
                    ) -> Dict[Tuple[str, int], int]:
    """Serially compose the stage decomposition over value keys —
    the traced step's semantics, scheduler-independent."""
    env: Dict[Tuple[str, int], int] = {}
    for app in reference.get("apps", ()):
        sig = app.get("stage") or "stage"
        mb = int(app.get("mb", -1))
        acc = {int(k): int(v)
               for k, v in (app.get("acc") or {}).items()}
        keys = [(str(k[0]), int(k[1])) for k in app.get("in", ())]
        args = [env[k] if k in env else table.leaf(*k) for k in keys]
        acc_in = set(acc.values())
        contrib_args = tuple(t for i, t in enumerate(args)
                             if i not in acc_in)
        for pos, k in enumerate(app.get("out", ())):
            key = (str(k[0]), int(k[1]))
            if pos in acc:
                contrib = table.app(sig, ("contrib", pos, mb),
                                    contrib_args)
                env[key] = table.sum_((args[acc[pos]], contrib))
            else:
                env[key] = table.app(sig, pos, tuple(args))
    return env


def check_equiv(model, hooks: Optional[Sequence[Any]] = None,
                budget: Optional[int] = None,
                numerics_ok: Optional[bool] = None,
                reference: Optional[Dict[str, Any]] = None
                ) -> EquivResult:
    """Run the translation validation over a
    :class:`~alpa_tpu_torch.analysis.plan_verifier.PlanModel` carrying a
    reference decomposition (``model.reference`` or the ``reference``
    override).  ``numerics_ok`` is the certificate status: True
    when the numerics analysis ran without error findings (backs the
    quantized-within-bound axiom), False/None otherwise.  Pure function
    of its inputs — no globals, no cache, no metrics."""
    from alpa_tpu_torch.analysis.plan_verifier import Finding
    del hooks  # footprint checks are the structure pass's job
    t0 = time.perf_counter()
    if budget is None:
        budget = DEFAULT_TERM_BUDGET
    budget = int(budget)
    reference = reference if reference is not None else \
        getattr(model, "reference", None)
    findings: List[Finding] = []

    def done(stats_extra: Dict[str, Any]) -> EquivResult:
        stats = {
            "n_terms": len(table),
            "n_outputs": 0,
            "n_proved": 0,
            "n_apps": len((reference or {}).get("apps", ())),
            "num_microbatches":
                int((reference or {}).get("num_microbatches", 0)),
            "axioms_used": [],
            "per_output": [],
            "budget": budget,
            "partial": False,
        }
        stats.update(stats_extra)
        stats["seconds"] = round(time.perf_counter() - t0, 6)
        return EquivResult(findings=findings, stats=stats)

    table = TermTable(budget=budget)
    if not reference:
        # no decomposition available (legacy fixture / hand-built
        # model): nothing to prove against — empty, ok result
        return done({})

    def _var(s: int) -> str:
        sm = model.slots.get(s)
        return sm.var if sm is not None else f"slot{s}"

    try:
        ref_env = _exec_reference(reference, table)

        # ---- candidate: the lowered program over register slots ----
        env: Dict[int, int] = {}
        ax: Dict[int, frozenset] = {}
        consumed: Dict[int, int] = {}       # slot -> consuming op idx
        for s, sm in sorted(model.slots.items()):
            if sm.preplaced:
                env[s] = table.leaf(sm.var, sm.instance)
                ax[s] = frozenset()

        def read(op, s: int, pos: int) -> Tuple[int, frozenset]:
            if s in consumed and s not in env:
                findings.append(Finding(
                    "equiv", "equiv.stale-operand",
                    f"{op.label}: operand {pos} reads slot {s} "
                    f"({_var(s)}) whose value was consumed at op "
                    f"{consumed[s]} (donation / free) — the plan "
                    f"wires a stale buffer", op.idx))
                return (table.leaf(f"{_STALE}[slot{s}@op{op.idx}]",
                                   -1), frozenset())
            t = env.get(s)
            if t is None:
                # undefined read: liveness reports it; model the value
                # as the slot's launch key so execution continues
                sm = model.slots.get(s)
                t = table.leaf(sm.var if sm else f"slot{s}",
                               sm.instance if sm else -1)
                return t, frozenset()
            return t, ax.get(s, frozenset())

        for op in model.ops:
            if op.kind == "RUN":
                eq = getattr(op, "equiv", None) or {}
                sig = eq.get("stage") or op.label or f"run{op.idx}"
                mb = int(eq.get("mb", -1))
                acc = {int(k): int(v)
                       for k, v in (eq.get("acc") or {}).items()}
                args: List[int] = []
                arg_ax: List[frozenset] = []
                for pos, s in enumerate(op.reads):
                    t, a = read(op, s, pos)
                    args.append(t)
                    arg_ax.append(a)
                joined = frozenset().union(*arg_ax) if arg_ax \
                    else frozenset()
                # Quantized gradient sync: a stage whose
                # gradient accumulation runs through the stochastic-
                # rounding codec computes the traced step only up to
                # the certified bound — the proof needs the QUANT
                # axiom, admissible (like quantized RESHARDs) only
                # under a clean numerics certificate.
                if getattr(op, "grad_quant", None):
                    joined = joined | frozenset({AXIOM_QUANT})
                acc_in = set(acc.values())
                contrib_args = tuple(t for i, t in enumerate(args)
                                     if i not in acc_in)
                outs: List[Tuple[int, int, frozenset]] = []
                for pos, s in enumerate(op.writes):
                    if pos in acc and acc[pos] < len(args):
                        contrib = table.app(
                            sig, ("contrib", pos, mb), contrib_args)
                        t = table.sum_((args[acc[pos]], contrib))
                        outs.append((s, t, joined | {AXIOM_ACC}))
                    else:
                        outs.append((s, table.app(sig, pos,
                                                  tuple(args)),
                                     joined))
                for s in op.kills:
                    consumed[s] = op.idx
                    env.pop(s, None)
                for s, t, a in outs:
                    env[s] = t
                    ax[s] = a
            elif op.kind in ("RESHARD", "SEND", "RECV", "BROADCAST"):
                src = op.reads[0] if op.reads else None
                dst = op.writes[0] if op.writes else None
                if src is None or dst is None:
                    continue
                t, a = read(op, src, 0)
                hop = {AXIOM_RESHARD}
                if getattr(op, "codec", None) or \
                        getattr(op, "strategy", None) == "quantized":
                    hop.add(AXIOM_QUANT)
                env[dst] = t
                ax[dst] = a | hop
            elif op.kind == "FREE":
                for s in op.kills:
                    consumed[s] = op.idx
                    env.pop(s, None)

        # ---- proof obligations: every protected output ----
        taint_memo: Dict[int, bool] = {}
        per_output: List[Dict[str, Any]] = []
        n_proved = 0
        axioms_used: Set[str] = set()
        for s in sorted(model.slots):
            sm = model.slots[s]
            if not sm.protected:
                continue
            name = sm.var + ("" if sm.instance < 0
                             else f"@mb{sm.instance}")
            key = (sm.var, sm.instance)
            ref_t = ref_env.get(key)
            if ref_t is None:
                # output never produced by a stage: a launch-placed
                # pass-through — the reference value is its own leaf
                ref_t = table.leaf(*key)
            cand_t = env.get(s)
            used = sorted(ax.get(s, frozenset()))
            row: Dict[str, Any] = {
                "var": sm.var, "instance": sm.instance,
                "mesh": sm.mesh, "slot": s, "axioms": used,
            }
            if cand_t is None:
                row["status"] = "mismatched"
                w = (f"the plan never produces {name} (slot {s}"
                     + (f"; consumed at op {consumed[s]}"
                        if s in consumed else "") + "); reference "
                     f"computes {render_term(table, ref_t)}")
                row["witness"] = w
                findings.append(Finding(
                    "equiv", "equiv.output-mismatch",
                    f"protected output {name}: {w}"))
            elif _is_tainted(table, cand_t, taint_memo):
                # the stale read already carries the named finding;
                # record the output as stale rather than double-report
                row["status"] = "stale"
            elif cand_t == ref_t:
                axioms_used.update(used)
                if AXIOM_QUANT in used and numerics_ok is not True:
                    row["status"] = "unproven"
                    findings.append(Finding(
                        "equiv", "equiv.unproven-output",
                        f"protected output {name}: proof needs the "
                        f"{AXIOM_QUANT} axiom but no valid numerics "
                        f"certificate backs it "
                        f"(verify_plans_numerics off or failing) — "
                        f"outside the allowed axiom set"))
                else:
                    row["status"] = "proved"
                    n_proved += 1
            else:
                sr, sc = table.terms[ref_t], table.terms[cand_t]
                code = "equiv.output-mismatch"
                if sr[0] == "sum" and sc[0] == "sum":
                    want, got = Counter(sr[1]), Counter(sc[1])
                    missing = want - got
                    extra = got - want
                    if missing and not extra:
                        code = "equiv.dropped-microbatch"
                        w = ("missing accumulation member(s): "
                             + " + ".join(
                                 render_term(table, m)
                                 for m in sorted(missing.elements())))
                    elif extra and not missing:
                        code = "equiv.duplicated-accumulation"
                        w = ("surplus accumulation member(s): "
                             + " + ".join(
                                 render_term(table, m)
                                 for m in sorted(extra.elements())))
                    else:
                        w = _witness(table, ref_t, cand_t)
                else:
                    w = _witness(table, ref_t, cand_t)
                row["status"] = "mismatched"
                row["witness"] = w
                findings.append(Finding(
                    "equiv", code,
                    f"protected output {name}: {w}"))
            per_output.append(row)
    except _BudgetExhausted:
        findings.append(Finding(
            "equiv", "equiv.budget-exhausted",
            f"term table hit equiv_term_budget={budget} — proof "
            f"abandoned (partial verdict, never a false one); raise "
            f"ALPA_TPU_EQUIV_TERM_BUDGET to certify this plan"))
        return done({"partial": True})

    return done({
        "n_outputs": len(per_output),
        "n_proved": n_proved,
        "axioms_used": sorted(axioms_used),
        "per_output": per_output,
    })


def format_equiv(stats: Dict[str, Any],
                 findings: Optional[Sequence[Any]] = None) -> str:
    """Human-readable translation-validation report (``equiv.txt``).  Works from the JSON-able stats dict
    alone so cached verdicts render identically."""
    lines = [
        "translation validation: "
        + (f"{stats.get('n_proved', 0)}/{stats.get('n_outputs', 0)} "
           f"protected output(s) proved equivalent to the traced "
           f"step"
           if not stats.get("partial")
           else "PARTIAL — term budget exhausted"),
        f"terms={stats.get('n_terms', 0)}  "
        f"apps={stats.get('n_apps', 0)}  "
        f"microbatches={stats.get('num_microbatches', 0)}  "
        f"axioms={','.join(stats.get('axioms_used', ())) or '-'}  "
        f"budget={stats.get('budget', 0)}  "
        f"seconds={stats.get('seconds', 0.0)}",
    ]
    table = stats.get("per_output", ())
    if table:
        lines.append("per-output proofs:")
        lines.append(f"  {'output':<22} {'status':<11} axioms")
        for row in table:
            name = str(row.get("var", "?")) + (
                "" if row.get("instance", -1) < 0
                else f"@mb{row['instance']}")
            axioms = ", ".join(row.get("axioms", ())) or "-"
            lines.append(f"  {name:<22} "
                         f"{row.get('status', '?'):<11} {axioms}")
            if row.get("witness"):
                lines.append(f"    witness: {row['witness']}")
    if findings:
        lines.append("findings:")
        for f in findings:
            at = f" (op {f.op})" if f.op >= 0 else ""
            lines.append(
                f"  [{severity_of(f.code)}] [{f.code}]{at} "
                f"{f.message}")
    return "\n".join(lines)


def export_metrics(stats: Optional[Dict[str, Any]],
                   result: str) -> None:
    """Record one translation-validation outcome in the central
    registry (``alpa_plan_equiv_total{result}`` /
    ``alpa_equiv_terms_total``).  The terms gauge is *set* from the
    deterministic stats, so warm-restart cache replays export exactly
    the cold compile's value."""
    _EQUIV_TOTAL.labels(result).inc()
    if stats:
        _TERMS_TOTAL.set(float(stats.get("n_terms", 0)))


from alpa_tpu_torch.telemetry import metrics as _tmetrics  # noqa: E402

_REG = _tmetrics.get_registry()
_EQUIV_TOTAL = _REG.counter(
    "alpa_plan_equiv_total",
    "Translation-validation outcomes by result "
    "(ok / warning / error / skipped)",
    labelnames=("result",))
_TERMS_TOTAL = _REG.gauge(
    "alpa_equiv_terms_total",
    "Hash-consed symbolic terms interned while certifying the last "
    "verified plan against its traced step")
