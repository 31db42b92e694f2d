"""Post-step performance analysis: ``StepPerfReport``, and the one
peak-FLOPs / MFU formula of the port.

Counterpart of ``alpa_tpu/telemetry/perf.py``.  Joins one step's per-op
spans (the hooked register-file replay's ``op_meta`` spans; the flight
ring's events when tracing is off) back against the lowering-time
``InstructionDataflowGraph`` and reports:

* the **critical path**, the measured longest chain through the step
  (``analysis.critical_path``), with a what-if re-simulator;
* **bubbles**: per-mesh busy/warmup/steady-idle/drain shares of the step
  envelope against the schedule's warmup and drain depth, and exposed vs
  hidden transfer time, split into queue wait and wire time by the
  ``reshard.wait`` / ``reshard.wire`` child spans;
* **MFU** per stage: the stage's analytic flops (``util.node_flops`` over
  its graph, ``stage_flops``) over its measured RUN time and the card's
  peak (``device_peak_tflops`` knob / ``ALPA_TPU_DEVICE_PEAK_TFLOPS``,
  else ``GPU_SPECS`` for the detected card).

On a card the RUN and RESHARD spans are on the device clock: the driver
times each op by a CUDA event pair on its stream and records the spans
after the step's sync (``pipeshard_executable``); host spans of a
replayed CUDA graph would time its launch, not its work.

Published as ``alpa_stage_mfu{stage}``, ``alpa_step_bubble_fraction
{mesh}`` and ``alpa_critical_path_us``, and by
``PipeshardDriverExecutable.get_perf_report()``.  ``GPU_SPECS`` plays the
part of the JAX package's ``TPU_GENERATION_SPECS``: published peaks per
card, which the MFU and the kernels' bounds are taken against.
"""
import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from alpa_tpu_torch.analysis.critical_path import (
    CriticalPathReport, TimedOp, measured_critical_path, simulate_dag,
    whatif as _whatif_dag)
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import metrics as _tmetrics

__all__ = [
    "GPU_SPECS", "detect_gpu_generation",
    "device_peak_tflops", "peak_flops_info", "stage_flops",
    "compute_mfu", "mfu_from_time",
    "JoinedStep", "MeshBubbles", "TransferBreakdown", "StageMfu",
    "StepPerfReport",
    "joined_from_recorder", "joined_from_flight", "spans_from_chrome",
    "build_step_report", "report_from_trace",
    "publish_report", "record_gate_verdict",
]

# NVIDIA's H100 SXM data sheet: dense rates without sparsity, at the full
# 700 W power limit; ``nvlink_bytes_per_s`` is the card's NVLink 4
# bandwidth, 900 GB/s both directions together, so 450e9 one way
GPU_SPECS = {
    "h100-sxm": {
        "peak_bf16_tflops": 989.0,
        "peak_fp32_tflops": 67.0,
        "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s": 450e9,
    },
}


def detect_gpu_generation(device=None) -> str:
    """The ``GPU_SPECS`` key of a CUDA device, from its name."""
    name = torch.cuda.get_device_name(device)
    if "H100" in name and "PCIe" not in name:
        return "h100-sxm"
    raise ValueError(f"no published peaks for {name!r} in GPU_SPECS")


########################################
# the one peak-FLOPs / MFU formula
########################################


def peak_flops_info(generation: Optional[str] = None) -> Dict[str, Any]:
    """The card's peak used for MFU: the ``device_peak_tflops`` knob
    (``ALPA_TPU_DEVICE_PEAK_TFLOPS``) when set, else the detected card's
    published bf16 peak."""
    override = float(getattr(global_config, "device_peak_tflops", 0.0)
                     or 0.0)
    if override > 0:
        return {"generation": generation or "override",
                "peak_bf16_tflops": override}
    gen = generation or detect_gpu_generation()
    return {"generation": gen,
            "peak_bf16_tflops": GPU_SPECS[gen]["peak_bf16_tflops"]}


def device_peak_tflops(generation: Optional[str] = None) -> float:
    return peak_flops_info(generation)["peak_bf16_tflops"]


def compute_mfu(tflops_per_chip: float,
                peak_tflops: Optional[float] = None) -> float:
    """achieved TFLOPS per chip / peak TFLOPS per chip."""
    peak = peak_tflops if peak_tflops else device_peak_tflops()
    return tflops_per_chip / peak if peak > 0 else 0.0


def mfu_from_time(flops: float, seconds: float, n_devices: int,
                  peak_tflops: Optional[float] = None) -> float:
    """MFU from raw measurements: total model FLOPs over ``seconds``
    spread across ``n_devices`` cards."""
    if seconds <= 0 or n_devices <= 0:
        return 0.0
    return compute_mfu(flops / seconds / n_devices / 1e12, peak_tflops)


def stage_flops(nodes) -> float:
    """Analytic FLOPs of one stage invocation: ``util.node_flops`` summed
    over the stage's graph nodes (a ``PipelineComputation``'s ``nodes``,
    an ``fx.Graph`` or a ``GraphModule``)."""
    from alpa_tpu_torch.util import node_flops
    if hasattr(nodes, "graph"):
        nodes = nodes.graph
    if hasattr(nodes, "nodes"):
        nodes = nodes.nodes
    return float(sum(node_flops(n) for n in nodes))


########################################
# joining spans / flight events back to the lowered program
########################################


@dataclasses.dataclass
class JoinedStep:
    """One step's op samples on a common time axis, pre-report."""
    ops: List[TimedOp]
    t0_us: float
    envelope_us: float
    pool_spans: List[Dict[str, Any]]     # alpa-overlap-* track spans
    source: str                          # "trace" | "flight"
    aligned: bool                        # ops joined 1:1 to program hooks


def _kind_from_name(name: str) -> str:
    if name.startswith("LAUNCH"):
        return "launch"
    if name.startswith("WAIT"):
        return "wait"
    return "exec"


def _join_spans(spans: Sequence[Dict[str, Any]],
                program=None) -> Optional[JoinedStep]:
    """Window the span list to the last ``pipeshard.step`` envelope and
    align the per-op spans positionally against the program's
    ``op_meta``/``hooks`` (both are emitted in replay order)."""
    steps = [s for s in spans if s["name"] == "pipeshard.step"]
    w0 = w1 = None
    if steps:
        env = max(steps, key=lambda s: s["ts_us"])
        w0, w1 = env["ts_us"], env["ts_us"] + env["dur_us"]

    def in_window(s):
        return w0 is None or (s["ts_us"] >= w0 - 1.0 and
                              s["ts_us"] + s["dur_us"] <= w1 + 1.0)

    op_spans = sorted(
        (s for s in spans
         if s["category"] in ("instruction", "transfer") and
         (s.get("track") or "").startswith("mesh") and in_window(s)),
        key=lambda s: (s["ts_us"], s["ts_us"] + s["dur_us"]))
    if not op_spans:
        return None
    pool = [s for s in spans
            if (s.get("track") or "").startswith("alpa-overlap") and
            in_window(s)]
    hooks = getattr(program, "hooks", None) if program is not None \
        else None
    meta = getattr(program, "op_meta", None) if program is not None \
        else None
    aligned = (hooks is not None and meta is not None and
               len(op_spans) == len(meta) and
               all(s["name"] == m[0]
                   for s, m in zip(op_spans, meta)))
    ops = []
    for i, s in enumerate(op_spans):
        kind = hooks[i].kind if aligned else _kind_from_name(s["name"])
        ops.append(TimedOp(idx=i, name=s["name"], kind=kind,
                           track=s["track"], t0_us=s["ts_us"],
                           t1_us=s["ts_us"] + s["dur_us"]))
    if w0 is None:
        w0 = min(o.t0_us for o in ops)
        w1 = max(o.t1_us for o in ops)
    return JoinedStep(ops=ops, t0_us=w0, envelope_us=w1 - w0,
                      pool_spans=pool, source="trace", aligned=aligned)


def joined_from_recorder(rec, program=None) -> Optional[JoinedStep]:
    """Join the live trace recorder's spans (preferred source)."""
    return _join_spans(rec.spans(), program)


def joined_from_flight(events: Sequence[Any],
                       program=None) -> Optional[JoinedStep]:
    """Fallback join over flight-ring events (full tracing off).

    Events are ``(seq, kind, name, mesh, node, slots, t0, t1, outcome)``
    tuples (``flight._FIELDS``) or equivalent dicts from a dump."""
    rows = []
    for e in events:
        if isinstance(e, dict):
            rows.append((e["kind"], e["name"], e["mesh"],
                         e["t_start_us"], e["t_end_us"]))
        else:
            rows.append((e[1], e[2], e[3], e[6], e[7]))
    if not rows:
        return None
    hooks = getattr(program, "hooks", None) if program is not None \
        else None
    if hooks and len(rows) >= len(hooks):
        # the ring holds many steps; the trailing len(ops) events are
        # the last replay (each step appends exactly one event per op)
        tail = rows[-len(hooks):]
        if all(r[1] == h.name for r, h in zip(tail, hooks)):
            rows = tail
    aligned = bool(hooks) and len(rows) == len(hooks) and \
        all(r[1] == h.name for r, h in zip(rows, hooks))
    ops = []
    for i, (kind, name, mesh, t0, t1) in enumerate(rows):
        k = hooks[i].kind if aligned else (
            kind if kind in ("exec", "launch", "wait")
            else _kind_from_name(name))
        ops.append(TimedOp(idx=i, name=name, kind=k,
                           track=f"mesh {mesh}", t0_us=t0, t1_us=t1))
    w0 = min(o.t0_us for o in ops)
    w1 = max(o.t1_us for o in ops)
    return JoinedStep(ops=ops, t0_us=w0, envelope_us=w1 - w0,
                      pool_spans=[], source="flight", aligned=aligned)


def _op_dependencies(program, n_ops: int
                     ) -> Tuple[Dict[int, set], List[set]]:
    """Map dataflow-graph edges into op space.

    Returns ``(causal, sim_preds)``: ``causal[i]`` are the ops whose
    *retirement* (exec, or the wait of a launched transfer) gates op
    ``i`` — used by the measured walk; ``sim_preds`` additionally
    carries same-mesh issue order (each mesh is one serial instruction
    stream) and launch→wait edges — the re-simulation model."""
    graph, hooks = program.graph, program.hooks
    retire: Dict[int, int] = {}
    launch_of: Dict[int, int] = {}
    for i, h in enumerate(hooks):
        if h.kind in ("exec", "wait"):
            for m in h.members:
                retire[m] = i
        if h.kind == "launch":
            for m in h.members:
                launch_of[m] = i
    causal: Dict[int, set] = {i: set() for i in range(n_ops)}
    for i, h in enumerate(hooks):
        for m in h.members:
            for p in graph.preds[m]:
                j = retire.get(p)
                if j is not None and j != i:
                    causal[i].add(j)
        if h.kind == "wait":
            j = launch_of.get(h.members[0])
            if j is not None and j != i:
                causal[i].add(j)
    sim_preds = [set(causal[i]) for i in range(n_ops)]
    last_on_mesh: Dict[int, int] = {}
    for i, h in enumerate(hooks):
        p = last_on_mesh.get(h.mesh)
        if p is not None:
            sim_preds[i].add(p)
        last_on_mesh[h.mesh] = i
    return causal, sim_preds


########################################
# report pieces
########################################


@dataclasses.dataclass
class MeshBubbles:
    """One mesh's share of the step envelope."""
    mesh: str
    envelope_us: float
    busy_us: float
    warmup_us: float          # idle before the mesh's first op
    steady_idle_us: float     # gaps between ops
    drain_us: float           # idle after the mesh's last op
    n_ops: int
    stream_wait_us: float     # driver time blocked in WAIT ops here
    sched_warmup_ticks: Optional[int] = None
    sched_drain_ticks: Optional[int] = None
    sched_num_clock: Optional[int] = None

    def fractions(self) -> Dict[str, float]:
        e = self.envelope_us or 1.0
        return {"busy": self.busy_us / e,
                "warmup": self.warmup_us / e,
                "steady_idle": self.steady_idle_us / e,
                "drain": self.drain_us / e}

    @property
    def bubble_fraction(self) -> float:
        """1 − busy/envelope: the alpa_step_bubble_fraction gauge."""
        if self.envelope_us <= 0:
            return 0.0
        return max(0.0, 1.0 - self.busy_us / self.envelope_us)


@dataclasses.dataclass
class TransferBreakdown:
    """Exposed vs hidden transfer time (the dispatch's
    ``overlap_fraction``), with the queue-wait/wire split."""
    pool_busy_us: float = 0.0     # pool-side transfer occupancy
    wire_us: float = 0.0          # reshard.wire child spans
    queue_wait_us: float = 0.0    # reshard.wait child spans (scheduler
                                  # backpressure, NOT network time)
    exposed_wait_us: float = 0.0  # driver blocked in WAIT ops
    hidden_us: float = 0.0        # pool busy the driver never saw
    overlap_fraction: float = 1.0


@dataclasses.dataclass
class StageMfu:
    stage: str
    flops_per_run: float
    n_runs: int
    run_time_us: float
    n_devices: int
    peak_tflops: float
    tflops_per_chip: float
    mfu: float


@dataclasses.dataclass
class StepPerfReport:
    source: str                   # "trace" | "flight"
    mode: Optional[str]
    envelope_us: float
    n_ops: int
    aligned: bool                 # dataflow graph joined (vs track-only)
    critical_path: CriticalPathReport
    bubbles: Dict[str, MeshBubbles]
    transfers: TransferBreakdown
    stages: Dict[str, StageMfu]
    notes: List[str] = dataclasses.field(default_factory=list)
    # re-simulation model (kept for whatif; not part of the text report)
    sim_durs_us: List[float] = dataclasses.field(
        default_factory=list, repr=False)
    sim_preds: List[tuple] = dataclasses.field(
        default_factory=list, repr=False)
    sim_ops: List[TimedOp] = dataclasses.field(
        default_factory=list, repr=False)

    # ---- what-if re-simulation --------------------------------------

    def whatif(self, zero: str = "reshard",
               name_substr: Optional[str] = None) -> Dict[str, Any]:
        """Re-simulate the DAG with an op class made free.

        ``zero``: "reshard"/"transfer" (launch+wait+RESHARD execs),
        "run", "free", or "name" with ``name_substr``."""
        zeroed = {o.idx for o in self.sim_ops
                  if _matches_class(o, zero, name_substr)}
        baseline, _ = simulate_dag(self.sim_durs_us, self.sim_preds)
        after = _whatif_dag(self.sim_durs_us, self.sim_preds, zeroed)
        saving = max(0.0, baseline - after)
        return {
            "zero": zero if name_substr is None else f"name:{name_substr}",
            "n_zeroed": len(zeroed),
            "baseline_us": baseline,
            "whatif_us": after,
            "saving_us": saving,
            "saving_fraction": saving / baseline if baseline > 0 else 0.0,
        }

    # ---- serialization ----------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The report as a flat-ish, JSON-able dict."""
        return {
            "source": self.source,
            "mode": self.mode,
            "aligned": self.aligned,
            "n_ops": self.n_ops,
            "envelope_us": round(self.envelope_us, 3),
            "critical_path_us": round(self.critical_path.total_us, 3),
            "critical_path_coverage": round(self.critical_path.coverage,
                                            4),
            "critical_path_gap_us": round(self.critical_path.gap_us, 3),
            "bubbles": {
                m: {"bubble_fraction": round(b.bubble_fraction, 4),
                    "busy_us": round(b.busy_us, 3),
                    "n_ops": b.n_ops,
                    "stream_wait_us": round(b.stream_wait_us, 3),
                    **{f"{k}_fraction": round(v, 4)
                       for k, v in b.fractions().items()}}
                for m, b in sorted(self.bubbles.items())
            },
            "transfers": {
                "pool_busy_us": round(self.transfers.pool_busy_us, 3),
                "wire_us": round(self.transfers.wire_us, 3),
                "queue_wait_us": round(self.transfers.queue_wait_us, 3),
                "exposed_wait_us": round(self.transfers.exposed_wait_us,
                                         3),
                "hidden_us": round(self.transfers.hidden_us, 3),
                "overlap_fraction": round(self.transfers.overlap_fraction,
                                          4),
            },
            "stages": {
                name: {"mfu": round(s.mfu, 6),
                       "tflops_per_chip": round(s.tflops_per_chip, 6),
                       "flops_per_run": s.flops_per_run,
                       "n_runs": s.n_runs,
                       "run_time_us": round(s.run_time_us, 3),
                       "n_devices": s.n_devices,
                       "peak_tflops": s.peak_tflops}
                for name, s in sorted(self.stages.items())
            },
        }

    # ---- text report ------------------------------------------------

    def format_text(self, top: int = 10) -> str:
        lines = [
            f"step perf report ({self.source}"
            f"{', mode=' + self.mode if self.mode else ''}"
            f"{', graph-joined' if self.aligned else ', track-order only'}"
            f"): {self.n_ops} ops over {self.envelope_us:.1f} us",
            "",
            self.critical_path.format_table(top),
            "",
            "per-mesh bubbles (fractions of the step envelope):",
            f"  {'mesh':<8} {'busy':>7} {'warmup':>7} {'steady':>7} "
            f"{'drain':>7} {'bubble':>7} {'ops':>5} {'sched w/d':>10}",
        ]
        for m, b in sorted(self.bubbles.items()):
            f = b.fractions()
            sched = (f"{b.sched_warmup_ticks}/{b.sched_drain_ticks}"
                     if b.sched_warmup_ticks is not None else "-")
            lines.append(
                f"  {m:<8} {f['busy']:7.3f} {f['warmup']:7.3f} "
                f"{f['steady_idle']:7.3f} {f['drain']:7.3f} "
                f"{b.bubble_fraction:7.3f} {b.n_ops:5d} {sched:>10}")
        t = self.transfers
        lines += [
            "",
            f"transfers: pool busy {t.pool_busy_us:.1f} us "
            f"(wire {t.wire_us:.1f}, queue-wait {t.queue_wait_us:.1f}), "
            f"exposed {t.exposed_wait_us:.1f} us, hidden "
            f"{t.hidden_us:.1f} us, overlap fraction "
            f"{t.overlap_fraction:.3f}",
        ]
        if self.stages:
            lines += ["", "stage MFU:",
                      f"  {'stage':<24} {'runs':>5} {'time_us':>10} "
                      f"{'TFLOPS/chip':>12} {'MFU':>8}"]
            for name, s in sorted(self.stages.items()):
                lines.append(
                    f"  {name:<24} {s.n_runs:5d} {s.run_time_us:10.1f} "
                    f"{s.tflops_per_chip:12.4f} {s.mfu:8.4f}")
        if self.notes:
            lines += [""] + [f"note: {n}" for n in self.notes]
        return "\n".join(lines)


def _matches_class(op: TimedOp, zero: str,
                   name_substr: Optional[str]) -> bool:
    if name_substr is not None:
        return name_substr in op.name
    zero = zero.lower()
    if zero in ("reshard", "transfer"):
        return (op.kind in ("launch", "wait") or
                op.name.startswith("RESHARD"))
    if zero == "run":
        return op.name.startswith("RUN")
    if zero == "free":
        return op.name.startswith("FREE")
    raise ValueError(f"unknown what-if op class {zero!r} "
                     "(reshard|run|free, or pass name_substr)")


########################################
# report construction
########################################


def _mesh_bubbles(ops: Sequence[TimedOp], t0_us: float,
                  envelope_us: float,
                  schedule=None) -> Dict[str, MeshBubbles]:
    t1_env = t0_us + envelope_us
    by_track: Dict[str, List[TimedOp]] = collections.defaultdict(list)
    for o in ops:
        by_track[o.track].append(o)
    sched_first: Dict[int, int] = {}
    sched_last: Dict[int, int] = {}
    num_clock = None
    if schedule is not None:
        ticks = schedule.schedules
        num_clock = len(ticks)
        for t, tick in enumerate(ticks):
            for mesh_id, task in enumerate(tick):
                if task is not None:
                    sched_first.setdefault(mesh_id, t)
                    sched_last[mesh_id] = t
    out: Dict[str, MeshBubbles] = {}
    for track, group in by_track.items():
        group.sort(key=lambda o: o.t0_us)
        busy = sum(max(0.0, min(o.t1_us, t1_env) - max(o.t0_us, t0_us))
                   for o in group)
        first = max(t0_us, min(o.t0_us for o in group))
        last = min(t1_env, max(o.t1_us for o in group))
        warmup = max(0.0, first - t0_us)
        drain = max(0.0, t1_env - last)
        steady = max(0.0, envelope_us - busy - warmup - drain)
        wait_us = sum(o.dur_us for o in group if o.kind == "wait" or
                      o.name.startswith("WAIT"))
        mesh_id = None
        if track.startswith("mesh "):
            try:
                mesh_id = int(track.split()[1])
            except ValueError:
                pass
        out[track] = MeshBubbles(
            mesh=track, envelope_us=envelope_us, busy_us=busy,
            warmup_us=warmup, steady_idle_us=steady, drain_us=drain,
            n_ops=len(group), stream_wait_us=wait_us,
            sched_warmup_ticks=(sched_first.get(mesh_id)
                                if num_clock is not None and
                                mesh_id is not None else None),
            sched_drain_ticks=(num_clock - 1 - sched_last[mesh_id]
                               if num_clock is not None and
                               mesh_id in sched_last else None),
            sched_num_clock=num_clock)
    return out


def _transfer_breakdown(ops: Sequence[TimedOp],
                        pool_spans: Sequence[Dict[str, Any]],
                        run_stats: Optional[Dict[str, Any]] = None
                        ) -> TransferBreakdown:
    wire = sum(s["dur_us"] for s in pool_spans
               if s["name"] == "reshard.wire")
    queue = sum(s["dur_us"] for s in pool_spans
                if s["name"] == "reshard.wait")
    # parent submit→retire spans (the labeled LAUNCH payload spans);
    # reshard.* children and nested resharding-category spans excluded
    parent = sum(s["dur_us"] for s in pool_spans
                 if s["category"] == "transfer" and
                 not s["name"].startswith("reshard."))
    pool_busy = wire if wire > 0 else parent
    if pool_busy == 0 and run_stats:
        pool_busy = run_stats.get("transfer_busy_s", 0.0) * 1e6
    exposed = sum(o.dur_us for o in ops if o.kind == "wait" or
                  o.name.startswith("WAIT"))
    if exposed == 0 and run_stats:
        exposed = run_stats.get("wait_blocked_s", 0.0) * 1e6
    hidden = max(0.0, pool_busy - exposed)
    frac = max(0.0, min(1.0, 1.0 - exposed / pool_busy)) \
        if pool_busy > 0 else 1.0
    return TransferBreakdown(pool_busy_us=pool_busy, wire_us=wire,
                             queue_wait_us=queue,
                             exposed_wait_us=exposed, hidden_us=hidden,
                             overlap_fraction=frac)


def _n_devices(stage_exec) -> int:
    """The devices a stage runs on: a stage mesh's, else one."""
    return int(getattr(stage_exec, "num_devices", 1) or 1)


def _stage_mfu(ops: Sequence[TimedOp], stage_execs,
               peak_tflops: Optional[float] = None
               ) -> Dict[str, StageMfu]:
    if not stage_execs:
        return {}
    peak = peak_tflops if peak_tflops else device_peak_tflops()
    out: Dict[str, StageMfu] = {}
    for ex in stage_execs:
        name = getattr(ex, "name", None)
        if not name:
            continue
        spans = [o for o in ops if o.name == f"RUN {name}"]
        if not spans:
            continue
        t_us = sum(o.dur_us for o in spans)
        flops = getattr(ex, "flops", None)
        if flops is None:
            continue
        ndev = _n_devices(ex)
        tfpc = (flops * len(spans) / (t_us * 1e-6) / ndev / 1e12
                if t_us > 0 else 0.0)
        out[name] = StageMfu(stage=name, flops_per_run=flops,
                             n_runs=len(spans), run_time_us=t_us,
                             n_devices=ndev, peak_tflops=peak,
                             tflops_per_chip=tfpc,
                             mfu=tfpc / peak if peak > 0 else 0.0)
    return out


def build_step_report(joined: JoinedStep, program=None, schedule=None,
                      stage_execs=None, mode: Optional[str] = None,
                      run_stats: Optional[Dict[str, Any]] = None,
                      peak_tflops: Optional[float] = None
                      ) -> StepPerfReport:
    """Assemble the StepPerfReport from a joined step.

    ``program`` (when its hooks aligned) contributes the dataflow
    edges; without it the walk rides track order + issue order only.
    ``schedule`` keys the warmup/drain bubble expectation;
    ``stage_execs`` enable MFU attribution."""
    ops = joined.ops
    notes: List[str] = []
    causal: Dict[int, set] = {}
    if joined.aligned and program is not None and \
            program.graph is not None:
        causal, sim_preds = _op_dependencies(program, len(ops))
    else:
        if program is not None and not joined.aligned:
            notes.append("spans did not align 1:1 with the lowered "
                         "program; dataflow edges unavailable "
                         "(track-order analysis)")
        sim_preds = [set() for _ in ops]
        last_on_track: Dict[str, int] = {}
        for i, o in enumerate(ops):
            p = last_on_track.get(o.track)
            if p is not None:
                sim_preds[i].add(p)
            last_on_track[o.track] = i
    cp = measured_critical_path(ops, causal,
                                envelope_us=joined.envelope_us)
    bubbles = _mesh_bubbles(ops, joined.t0_us, joined.envelope_us,
                            schedule)
    transfers = _transfer_breakdown(ops, joined.pool_spans, run_stats)
    stages = _stage_mfu(ops, stage_execs, peak_tflops)
    return StepPerfReport(
        source=joined.source, mode=mode, envelope_us=joined.envelope_us,
        n_ops=len(ops), aligned=joined.aligned, critical_path=cp,
        bubbles=bubbles, transfers=transfers, stages=stages,
        notes=notes,
        sim_durs_us=[o.dur_us for o in ops],
        sim_preds=[tuple(sorted(p)) for p in sim_preds],
        sim_ops=list(ops))


########################################
# raw Chrome-trace entry point
########################################


def spans_from_chrome(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Reconstruct completed spans (name/category/ts_us/dur_us/track)
    from Chrome-trace B/E pairs, joining the ``M`` thread_name records
    so per-track identity survives the round trip."""
    track_of: Dict[Tuple[int, int], str] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            track_of[(e.get("pid", 0), e["tid"])] = e["args"]["name"]
    stacks: Dict[Tuple[int, int], List[Dict[str, Any]]] = \
        collections.defaultdict(list)
    spans: List[Dict[str, Any]] = []
    events = sorted(
        (e for e in trace.get("traceEvents", [])
         if e.get("ph") in ("B", "E")),
        key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    for e in events:
        key = (e.get("pid", 0), e["tid"])
        if e["ph"] == "B":
            stacks[key].append(e)
        elif stacks[key]:
            b = stacks[key].pop()
            spans.append({
                "name": b["name"],
                "category": b.get("cat", ""),
                "ts_us": b["ts"],
                "dur_us": e["ts"] - b["ts"],
                "track": track_of.get(key, f"tid {key[1]}"),
                "args": b.get("args"),
            })
    spans.sort(key=lambda s: s["ts_us"])
    return spans


def report_from_trace(trace: Dict[str, Any],
                      peak_tflops: Optional[float] = None
                      ) -> Optional[StepPerfReport]:
    """Analyze a saved Chrome trace (no program/graph available —
    track-order analysis of the last ``pipeshard.step`` envelope)."""
    joined = _join_spans(spans_from_chrome(trace), None)
    if joined is None:
        return None
    return build_step_report(joined, peak_tflops=peak_tflops)


########################################
# registry gauges
########################################

_PERF_REG = _tmetrics.get_registry()
_STAGE_MFU_GAUGE = _PERF_REG.gauge(
    "alpa_stage_mfu",
    "Last analyzed step's model-FLOPs utilization per pipeline stage",
    labelnames=("stage",))
_BUBBLE_GAUGE = _PERF_REG.gauge(
    "alpa_step_bubble_fraction",
    "Last analyzed step's per-mesh idle fraction of the step envelope",
    labelnames=("mesh",))
_CRITICAL_PATH_GAUGE = _PERF_REG.gauge(
    "alpa_critical_path_us",
    "Last analyzed step's measured critical-path op time")
_GATE_TOTAL = _PERF_REG.counter(
    "alpa_perf_gate_total",
    "Perf regression gate verdicts",
    labelnames=("result",))


def publish_report(report: StepPerfReport) -> None:
    """Fold one report into the central registry (GET /metrics)."""
    _CRITICAL_PATH_GAUGE.set(report.critical_path.total_us)
    for track, b in report.bubbles.items():
        label = track.split()[1] if track.startswith("mesh ") else track
        _BUBBLE_GAUGE.labels(label).set(b.bubble_fraction)
    for name, s in report.stages.items():
        _STAGE_MFU_GAUGE.labels(name).set(s.mfu)


def record_gate_verdict(passed: bool) -> None:
    _GATE_TOTAL.labels("pass" if passed else "fail").inc()
