"""Measured-cost calibration store and model-drift observability.

Counterpart of ``alpa_tpu/telemetry/calibration.py``.  The planners (the
stage DP, the intra-op ILP, the resharding strategy chooser) plan from
analytic cost models, while every traced step measures the truth
(per-stage RUN spans on the device clock, ``reshard.wire`` spans, the
step's critical path).  This module keeps it:

* ``CalibrationStore`` -- a persistent, content-addressed store (one JSON
  file per entry under ``ALPA_TPU_CALIBRATION_DIR``, atomic writes like
  ``compile_cache.py``) that ingests ``StepPerfReport`` spans and keeps
  robust statistics (median / p90 / EWMA / sample count) per signature:

  - ``stage_run`` -- per-stage RUN time, keyed by the stage label
    (``stage:<name>``) and by the stage cost fingerprint
    (``stage_cost:flops=...|ndev=...``) for the planners;
  - ``reshard_wire`` -- per-edge wire time, keyed by the edge label
    (``edge:<src>-><dst>``) and the edge signature
    (``wire:<shape>x<itemsize>|<src>-><dst>|<strategy>``);
  - ``collective`` -- intra-mesh collective time keyed like
    ``mesh_profiling``'s tables (``collective:<kind>|bytes=2^k``).

* Drift -- every calibrated entry carries the analytic prediction it
  supersedes; the worst measured/modeled ratio per kind is exported as
  ``alpa_cost_model_drift_ratio{kind}`` and sample totals as
  ``alpa_calibration_samples_total{kind}``.

* Replan keying -- ``calibration_cache_token`` folds the store's
  fingerprint into the stage-DP / ILP cache keys only when ``replan_mode
  != "off"``, so off-mode plans and keys are unchanged.

Consumers: ``mesh_profiling.estimate_stage_cost`` (stage compute) and
``PipeshardDriverExecutable.consider_replan``.
"""
import dataclasses
import hashlib
import json
import logging
import math
import os
import re
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

__all__ = [
    "CALIBRATION_FORMAT_VERSION", "CalibrationEntry", "CalibrationStore",
    "get_calibration_store", "reset_calibration_store", "replan_active",
    "calibration_cache_token",
    "stage_signature", "stage_cost_signature", "wire_signature",
    "edge_signature", "collective_signature",
    "ingest_joined", "ingest_report", "ingest_chrome_trace",
    "drift_table", "format_calibration_report",
]

# Bump to invalidate persisted entries on layout changes; entries with a
# different stamp are skipped (warned), never mis-parsed.  v2 split the
# reshard_wire signature on the transfer codec (``|codec=``); v1 entries
# migrate on load (wire entries get ``|codec=none``) with a warning.
CALIBRATION_FORMAT_VERSION = 2

# Bounded reservoir: the most recent N samples back the median/p90 so
# one entry file stays O(1) and old regimes age out.
MAX_SAMPLES = 64

# EWMA smoothing factor for the trend statistic.
EWMA_ALPHA = 0.25

_RESHARD_NAME_RE = re.compile(
    r"RESHARD\s+(\S+?)->(\S+?)(?:\s+mb\d+)?(?:\s+\[.*\])?$")
_RUN_NAME_RE = re.compile(r"RUN\s+(\S+?)(?:\s+mb\d+)?$")


########################################
# signatures
########################################


def stage_signature(stage_name: str) -> str:
    """Label-keyed stage signature (what a trace span names)."""
    return f"stage:{stage_name}"


def stage_cost_signature(flops: float, n_devices: int) -> str:
    """Planner-consult stage signature: the same (flops, submesh size)
    fingerprint ``estimate_stage_cost`` computes at plan time — content
    addressed, so it matches across compile and runtime without names."""
    return f"stage_cost:flops={float(flops):.6e}|ndev={int(n_devices)}"


def edge_signature(src: str, dst: str) -> str:
    """Label-keyed reshard-edge signature (what a trace span names)."""
    return f"edge:{src}->{dst}"


def wire_signature(shape, itemsize, src_key: str, dst_key: str,
                   strategy: str, codec: Optional[str] = None) -> str:
    """Planner-consult edge signature: the reshard-edge identity
    (shape, itemsize, device-id-free sharding keys) plus the executed
    strategy — only the strategy that actually ran gets its cost
    overridden; the alternatives stay analytic.  ``codec`` keeps quantized and full-precision prices in separate buckets: a
    quantized edge moves ~4x fewer bytes, so its measured samples must
    never re-price the lossless signature."""
    return (f"wire:{tuple(shape)}x{int(itemsize)}|"
            f"{src_key}->{dst_key}|{strategy}|codec={codec or 'none'}")


def collective_signature(kind: str, nbytes: float,
                         device_kind: Optional[str] = None,
                         backend: Optional[str] = None) -> str:
    """Collective cost signature, keyed like mesh_profiling's alpha-beta
    tables: kind + a power-of-two byte bucket (so nearby sizes share an
    entry the way an (alpha, beta) fit shares a line).  ``device_kind``
    and ``backend`` (``collectives.backend_of``), where given, split the
    entry, so a time of copies on one card never prices NCCL between
    cards; without them the signature is the JAX package's."""
    bucket = int(math.log2(max(float(nbytes), 1.0)))
    sig = f"collective:{kind}|bytes=2^{bucket}"
    if device_kind is not None or backend is not None:
        sig += f"|dev={device_kind}|backend={backend}"
    return sig


########################################
# store
########################################


@dataclasses.dataclass
class CalibrationEntry:
    """Robust statistics for one (kind, signature) cost."""
    kind: str
    signature: str
    samples: List[float] = dataclasses.field(default_factory=list)
    count: int = 0
    ewma_us: float = 0.0
    # the analytic prediction this entry supersedes (drift denominator);
    # None when the caller could not price the op analytically
    modeled_us: Optional[float] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _quantile(self, q: float) -> float:
        s = sorted(self.samples)
        if not s:
            return 0.0
        idx = q * (len(s) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (idx - lo)

    @property
    def median_us(self) -> float:
        return self._quantile(0.5)

    @property
    def p90_us(self) -> float:
        return self._quantile(0.9)

    @property
    def drift_ratio(self) -> Optional[float]:
        """measured median / analytic prediction; >1 = the model was
        optimistic, <1 = pessimistic, None = no prediction on file."""
        if self.modeled_us is None or self.modeled_us <= 0:
            return None
        return self.median_us / self.modeled_us

    def observe(self, measured_us: float,
                modeled_us: Optional[float] = None,
                meta: Optional[Dict[str, Any]] = None):
        self.samples.append(float(measured_us))
        if len(self.samples) > MAX_SAMPLES:
            del self.samples[:len(self.samples) - MAX_SAMPLES]
        self.count += 1
        self.ewma_us = (float(measured_us) if self.count == 1 else
                        (1 - EWMA_ALPHA) * self.ewma_us +
                        EWMA_ALPHA * float(measured_us))
        if modeled_us is not None:
            self.modeled_us = float(modeled_us)
        if meta:
            self.meta.update(meta)

    def to_json(self) -> Dict[str, Any]:
        return {
            "format": CALIBRATION_FORMAT_VERSION,
            "kind": self.kind,
            "signature": self.signature,
            "samples": [round(s, 4) for s in self.samples],
            "count": self.count,
            "ewma_us": round(self.ewma_us, 4),
            "modeled_us": (round(self.modeled_us, 4)
                           if self.modeled_us is not None else None),
            "meta": self.meta,
        }

    @classmethod
    def from_json(cls, data: Dict[str, Any]) -> "CalibrationEntry":
        return cls(kind=data["kind"], signature=data["signature"],
                   samples=[float(s) for s in data.get("samples", [])],
                   count=int(data.get("count", 0)),
                   ewma_us=float(data.get("ewma_us", 0.0)),
                   modeled_us=data.get("modeled_us"),
                   meta=dict(data.get("meta", {})))


class CalibrationStore:
    """In-memory mirror + optional on-disk tier of calibrated costs.

    Disk layout mirrors ``compile_cache.py``: one file per entry named
    ``<kind>-<sha256(signature)[:16]>.json``, published with tempfile +
    ``os.replace`` so concurrent readers only ever see complete JSON.
    """

    def __init__(self, store_dir: Optional[str] = None):
        self.store_dir = store_dir or None
        self._entries: Dict[Tuple[str, str], CalibrationEntry] = {}
        self._lock = threading.Lock()
        if self.store_dir:
            self._load_dir()

    # -- persistence ---------------------------------------------------

    def _path_of(self, entry: CalibrationEntry) -> Optional[str]:
        if not self.store_dir:
            return None
        digest = hashlib.sha256(entry.signature.encode()).hexdigest()[:16]
        return os.path.join(self.store_dir, f"{entry.kind}-{digest}.json")

    def _load_dir(self):
        if not os.path.isdir(self.store_dir):
            return
        for name in sorted(os.listdir(self.store_dir)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.store_dir, name)
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                fmt = int(data.get("format", 0))
                if fmt == 1:
                    # v1 -> v2 migration: wire signatures
                    # gained a ``|codec=`` suffix; pre-split samples
                    # were necessarily full-precision, so they land in
                    # the ``codec=none`` bucket.  Other kinds are
                    # layout-identical and just re-stamp.
                    sig = str(data.get("signature", ""))
                    if (sig.startswith("wire:") and
                            "|codec=" not in sig):
                        data["signature"] = sig + "|codec=none"
                    logger.warning(
                        "calibration entry %s has format 1 (want %s); "
                        "migrating and re-stamping", path,
                        CALIBRATION_FORMAT_VERSION)
                    entry = CalibrationEntry.from_json(data)
                    self._entries[(entry.kind, entry.signature)] = entry
                    new_path = self._path_of(entry)
                    self._save_entry(entry)
                    if new_path and new_path != path:
                        try:
                            os.remove(path)
                        except OSError:
                            pass
                    continue
                if fmt != CALIBRATION_FORMAT_VERSION:
                    logger.warning(
                        "calibration entry %s has format %s (want %s); "
                        "skipping", path, data.get("format"),
                        CALIBRATION_FORMAT_VERSION)
                    continue
                entry = CalibrationEntry.from_json(data)
                self._entries[(entry.kind, entry.signature)] = entry
            except Exception as e:  # pylint: disable=broad-except
                logger.warning("calibration entry %s unreadable (%s); "
                               "skipping", path, e)

    def _save_entry(self, entry: CalibrationEntry):
        path = self._path_of(entry)
        if not path:
            return
        try:
            os.makedirs(self.store_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.store_dir,
                                       prefix=".tmp-" + entry.kind)
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(entry.to_json(), f, indent=1)
                os.replace(tmp, path)  # atomic publish
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except Exception as e:  # pylint: disable=broad-except
            # the disk tier is an optimization; a read-only disk must
            # never fail a step
            logger.warning("calibration store write %s failed: %s",
                           path, e)

    # -- core API ------------------------------------------------------

    def observe(self, kind: str, signature: str, measured_us: float,
                modeled_us: Optional[float] = None,
                meta: Optional[Dict[str, Any]] = None) -> CalibrationEntry:
        """Fold one measured sample into the store (and its disk tier)."""
        with self._lock:
            entry = self._entries.get((kind, signature))
            if entry is None:
                entry = CalibrationEntry(kind=kind, signature=signature)
                self._entries[(kind, signature)] = entry
            entry.observe(measured_us, modeled_us=modeled_us, meta=meta)
        self._save_entry(entry)
        return entry

    def set_modeled(self, kind: str, signature: str, modeled_us: float):
        """Attach/overwrite the analytic prediction an entry supersedes
        (callers that learn the model's price after ingesting spans)."""
        with self._lock:
            entry = self._entries.get((kind, signature))
            if entry is None:
                return
            entry.modeled_us = float(modeled_us)
        self._save_entry(entry)

    def get(self, kind: str, signature: str) -> Optional[CalibrationEntry]:
        with self._lock:
            return self._entries.get((kind, signature))

    def entries(self) -> List[CalibrationEntry]:
        with self._lock:
            return sorted(self._entries.values(),
                          key=lambda e: (e.kind, e.signature))

    def __len__(self) -> int:
        return len(self._entries)

    def measured_us(self, kind: str, signature: str,
                    min_samples: Optional[int] = None) -> Optional[float]:
        """The calibrated cost (median µs), or None below the sample
        floor (``calibration_min_samples``) — the analytic fallback."""
        entry = self.get(kind, signature)
        if entry is None:
            return None
        if min_samples is None:
            from alpa_tpu_torch.global_env import global_config
            min_samples = int(getattr(global_config,
                                      "calibration_min_samples", 3))
        if entry.count < max(int(min_samples), 1):
            return None
        return entry.median_us

    def fingerprint(self) -> str:
        """Content hash over the calibrated costs the planners would
        consult: (kind, signature, rounded median/p90).  Counts are
        deliberately excluded so re-ingesting an identical workload does
        not churn cache keys; a cost that actually moved does."""
        h = hashlib.sha256()
        for e in self.entries():
            h.update(f"{e.kind}|{e.signature}|{e.median_us:.3f}|"
                     f"{e.p90_us:.3f}\n".encode())
        return h.hexdigest()

    def clear(self):
        with self._lock:
            self._entries.clear()
        if self.store_dir and os.path.isdir(self.store_dir):
            for name in os.listdir(self.store_dir):
                if name.endswith(".json"):
                    try:
                        os.remove(os.path.join(self.store_dir, name))
                    except OSError:
                        pass


########################################
# process-global store
########################################

_global_store: Optional[CalibrationStore] = None
_global_lock = threading.Lock()


def get_calibration_store() -> CalibrationStore:
    """The process-global store, built from
    ``global_config.calibration_dir`` on first use."""
    global _global_store
    with _global_lock:
        if _global_store is None:
            from alpa_tpu_torch.global_env import global_config
            _global_store = CalibrationStore(
                store_dir=getattr(global_config, "calibration_dir", None))
        return _global_store


def reset_calibration_store(store: Optional[CalibrationStore] = None):
    """Install ``store`` (or lazily rebuild from global_config) — test
    isolation and ``calibration_dir`` changes."""
    global _global_store
    with _global_lock:
        _global_store = store


def replan_active() -> bool:
    """True when measured costs may influence planning
    (``replan_mode`` is ``suggest`` or ``auto``)."""
    from alpa_tpu_torch.global_env import global_config
    return getattr(global_config, "replan_mode", "off") != "off"


def calibration_cache_token() -> Optional[str]:
    """The cache-key part planners append when replanning is active:
    ``None`` under ``replan_mode=off`` (keys stay byte-identical to a
    build without calibration), else ``cal:<store fingerprint>`` — so a
    calibrated re-solve caches like any other plan and a warm restart
    with an unchanged store replays it with zero solves."""
    if not replan_active():
        return None
    return f"cal:{get_calibration_store().fingerprint()}"


########################################
# ingestion: trace / flight spans -> store entries
########################################


def _edge_from_name(name: str) -> Optional[Tuple[str, str]]:
    m = _RESHARD_NAME_RE.search(name)
    if m is None:
        return None
    return m.group(1), m.group(2)


def _stage_from_name(name: str) -> Optional[str]:
    m = _RUN_NAME_RE.match(name)
    if m is None:
        return None
    return m.group(1)


def _wire_samples_from_pool(pool_spans: Sequence[Dict[str, Any]]
                            ) -> Dict[Tuple[str, str], List[float]]:
    """Per-edge wire samples from the overlap pool tracks: each labeled
    parent transfer span (``RESHARD a->b …``) names the edge; its
    ``reshard.wire`` child (contained in the parent window, same track)
    carries the actual transfer execution time."""
    parents = []
    wires = []
    for s in pool_spans:
        edge = _edge_from_name(s.get("name", ""))
        if edge is not None:
            parents.append((s, edge))
        elif s.get("name") == "reshard.wire":
            wires.append(s)
    out: Dict[Tuple[str, str], List[float]] = {}
    used = set()
    for parent, edge in parents:
        p0 = parent["ts_us"]
        p1 = p0 + parent["dur_us"]
        for i, w in enumerate(wires):
            if i in used or w.get("track") != parent.get("track"):
                continue
            if w["ts_us"] >= p0 - 1e-6 and \
                    w["ts_us"] + w["dur_us"] <= p1 + 1e-6:
                used.add(i)
                out.setdefault(edge, []).append(w["dur_us"])
                break
    return out


def _wire_samples_from_ops(ops) -> Dict[Tuple[str, str], List[float]]:
    """Flight-ring fallback (no pool tracks): one wire sample per
    matched LAUNCH/WAIT pair — submit-to-retire minus nothing, i.e. the
    driver-visible envelope of the transfer.  Coarser than the pool's
    ``reshard.wire`` split, but the keys and sample counts match the
    traced path, so a store fed only from the flight ring calibrates
    the same signatures."""
    launches: Dict[str, Any] = {}
    out: Dict[Tuple[str, str], List[float]] = {}
    for op in ops:
        name = op.name
        if name.startswith("LAUNCH"):
            launches[name.replace("LAUNCH", "", 1).strip()] = op
        elif name.startswith("WAIT"):
            body = name.replace("WAIT", "", 1).strip()
            edge = _edge_from_name(body)
            if edge is None:
                continue
            launch = launches.pop(body, None)
            t0 = launch.t0_us if launch is not None else op.t0_us
            out.setdefault(edge, []).append(max(0.0, op.t1_us - t0))
    return out


def _quantile_of(samples: Sequence[float], q: float) -> float:
    s = sorted(samples)
    if not s:
        return 0.0
    idx = q * (len(s) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (idx - lo)


_STRATEGY_TAG_RE = re.compile(r"\[(\S+)\]\s*$")


def _strategy_from_name(name: str) -> str:
    """The runtime labels non-default edges ``RESHARD a->b [strategy]``
    (runtime_emitter); an untagged label means the planner's default
    direct_p2p path."""
    m = _STRATEGY_TAG_RE.search(name)
    return m.group(1) if m else "direct_p2p"


def _bytes_from_args(args: Optional[Dict[str, Any]]) -> Optional[float]:
    if not isinstance(args, dict):
        return None
    for key in ("wire_bytes", "nbytes", "bytes"):
        v = args.get(key)
        if isinstance(v, (int, float)) and v > 0:
            return float(v)
    return None


def edge_wire_table(joined) -> List[Dict[str, Any]]:
    """Per-reshard-edge wire rows for one joined step — the
    human-readable view of exactly what :func:`ingest_joined` stores
    under ``reshard_wire``.  Prefers the pool tracks' ``reshard.wire``
    children (matched to their labeled parent like the ingest path);
    falls back to LAUNCH/WAIT envelopes when the trace has no pool
    tracks.  ``bytes``/``gbps`` are filled from span args when the
    producer recorded them, else ``None``."""
    rows: Dict[Tuple[str, str, str], Dict[str, Any]] = {}

    def add(src, dst, strategy, wire_us, nbytes):
        key = (src, dst, strategy)
        row = rows.setdefault(key, {
            "src": src, "dst": dst, "strategy": strategy,
            "samples": [], "bytes": None,
        })
        row["samples"].append(wire_us)
        if nbytes is not None:
            row["bytes"] = nbytes

    parents = []
    wires = []
    for s in joined.pool_spans:
        edge = _edge_from_name(s.get("name", ""))
        if edge is not None:
            parents.append((s, edge))
        elif s.get("name") == "reshard.wire":
            wires.append(s)
    used = set()
    for parent, edge in parents:
        p0 = parent["ts_us"]
        p1 = p0 + parent["dur_us"]
        for i, w in enumerate(wires):
            if i in used or w.get("track") != parent.get("track"):
                continue
            if w["ts_us"] >= p0 - 1e-6 and \
                    w["ts_us"] + w["dur_us"] <= p1 + 1e-6:
                used.add(i)
                add(edge[0], edge[1],
                    _strategy_from_name(parent.get("name", "")),
                    w["dur_us"],
                    _bytes_from_args(w.get("args"))
                    or _bytes_from_args(parent.get("args")))
                break
    if not rows:
        launches: Dict[str, Any] = {}
        for op in joined.ops:
            name = op.name
            if name.startswith("LAUNCH"):
                launches[name.replace("LAUNCH", "", 1).strip()] = op
            elif name.startswith("WAIT"):
                body = name.replace("WAIT", "", 1).strip()
                edge = _edge_from_name(body)
                if edge is None:
                    continue
                launch = launches.pop(body, None)
                t0 = launch.t0_us if launch is not None else op.t0_us
                add(edge[0], edge[1], _strategy_from_name(body),
                    max(0.0, op.t1_us - t0), None)

    out = []
    for (src, dst, strategy), row in sorted(rows.items()):
        samples = sorted(row["samples"])
        median = _quantile_of(samples, 0.5)
        nbytes = row["bytes"]
        gbps = None
        if nbytes is not None and median > 0:
            gbps = nbytes / (median * 1e-6) / 1e9
        out.append({
            "src": src, "dst": dst, "strategy": strategy,
            "n": len(samples),
            "median_us": median,
            "p90_us": _quantile_of(samples, 0.9),
            "total_us": sum(samples),
            "bytes": nbytes,
            "gbps": gbps,
        })
    out.sort(key=lambda r: -r["total_us"])
    return out


def format_edge_table(rows: Sequence[Dict[str, Any]]) -> str:
    """Fixed-width render of :func:`edge_wire_table` rows."""
    if not rows:
        return "no reshard wire spans in step"
    lines = [f"{'edge':<28} {'strategy':<14} {'n':>3} "
             f"{'median us':>10} {'p90 us':>10} {'bytes':>10} "
             f"{'GB/s':>7}"]
    for r in rows:
        nbytes = ("-" if r["bytes"] is None
                  else f"{int(r['bytes'])}")
        gbps = "-" if r["gbps"] is None else f"{r['gbps']:.2f}"
        lines.append(
            f"{r['src'] + '->' + r['dst']:<28} {r['strategy']:<14} "
            f"{r['n']:>3} {r['median_us']:>10.1f} {r['p90_us']:>10.1f} "
            f"{nbytes:>10} {gbps:>7}")
    return "\n".join(lines)


def ingest_joined(joined, store: Optional[CalibrationStore] = None,
                  modeled: Optional[Dict[str, float]] = None
                  ) -> Dict[str, int]:
    """Ingest one joined step (trace or flight source) into the store.

    ``modeled`` optionally maps label signatures (``stage:…`` /
    ``edge:…``) to the analytic prediction in µs, recorded as the drift
    denominator.  Returns ``{signature: n_new_samples}``."""
    store = store if store is not None else get_calibration_store()
    modeled = modeled or {}
    ingested: Dict[str, int] = {}

    def put(kind, sig, samples, meta=None):
        for v in samples:
            store.observe(kind, sig, v, modeled_us=modeled.get(sig),
                          meta=meta)
        if samples:
            ingested[sig] = ingested.get(sig, 0) + len(samples)

    by_stage: Dict[str, List[float]] = {}
    for op in joined.ops:
        stage = _stage_from_name(op.name)
        if stage is not None:
            by_stage.setdefault(stage, []).append(op.dur_us)
    for stage, samples in sorted(by_stage.items()):
        put("stage_run", stage_signature(stage), samples,
            meta={"stage": stage, "source": joined.source})

    wire = _wire_samples_from_pool(joined.pool_spans)
    if not wire:
        wire = _wire_samples_from_ops(joined.ops)
    for (src, dst), samples in sorted(wire.items()):
        put("reshard_wire", edge_signature(src, dst), samples,
            meta={"src": src, "dst": dst, "source": joined.source})
    return ingested


def ingest_report(report, store: Optional[CalibrationStore] = None,
                  modeled: Optional[Dict[str, float]] = None
                  ) -> Dict[str, int]:
    """Ingest a built :class:`StepPerfReport` via its re-simulation ops.

    Wire-leg detail (``reshard.wire`` pool spans) is not carried on the
    report, so edges ingest through the LAUNCH/WAIT fallback — callers
    holding the :class:`JoinedStep` should prefer :func:`ingest_joined`.
    """
    store = store if store is not None else get_calibration_store()

    class _Shim:
        ops = report.sim_ops
        pool_spans: List[Dict[str, Any]] = []
        source = report.source

    return ingest_joined(_Shim, store=store, modeled=modeled)


def ingest_chrome_trace(trace: Dict[str, Any],
                        store: Optional[CalibrationStore] = None,
                        modeled: Optional[Dict[str, float]] = None
                        ) -> Dict[str, int]:
    """Ingest a saved Chrome trace (scripts / replan_bench entry point):
    the last ``pipeshard.step`` envelope's spans, joined exactly like
    the perf analyzer joins them."""
    from alpa_tpu_torch.telemetry import perf as _perf
    joined = _perf._join_spans(  # pylint: disable=protected-access
        _perf.spans_from_chrome(trace), None)
    if joined is None:
        return {}
    return ingest_joined(joined, store=store, modeled=modeled)


########################################
# drift observability
########################################


def drift_table(store: Optional[CalibrationStore] = None,
                top: int = 0) -> List[Dict[str, Any]]:
    """Calibrated entries ranked by divergence from their analytic
    prediction (worst first; entries without a prediction sort last).
    ``top`` truncates (0 = all)."""
    store = store if store is not None else get_calibration_store()
    rows = []
    for e in store.entries():
        ratio = e.drift_ratio
        rows.append({
            "kind": e.kind,
            "signature": e.signature,
            "count": e.count,
            "median_us": round(e.median_us, 3),
            "p90_us": round(e.p90_us, 3),
            "ewma_us": round(e.ewma_us, 3),
            "modeled_us": (round(e.modeled_us, 3)
                           if e.modeled_us is not None else None),
            "drift_ratio": (round(ratio, 4) if ratio is not None
                            else None),
        })
    rows.sort(key=lambda r: (-abs(math.log(r["drift_ratio"]))
                             if r["drift_ratio"] else 0.0,
                             r["kind"], r["signature"]))
    return rows[:top] if top else rows


def format_calibration_report(store: Optional[CalibrationStore] = None
                              ) -> str:
    """``calibration.txt`` content for ``dump_debug_info`` (and
    ``scripts/perf_tool.py drift``)."""
    from alpa_tpu_torch.global_env import global_config
    store = store if store is not None else get_calibration_store()
    rows = drift_table(store)
    mode = getattr(global_config, "replan_mode", "off")
    head = (f"calibration store: {len(rows)} entries, "
            f"replan_mode={mode}, "
            f"min_samples={getattr(global_config, 'calibration_min_samples', 3)}, "
            f"dir={store.store_dir or '(memory-only)'}")
    if not rows:
        return head + "\n(no measurements ingested yet)"
    lines = [head, f"fingerprint: {store.fingerprint()[:16]}", "",
             f"{'kind':<13} {'n':>4} {'median_us':>10} {'p90_us':>10} "
             f"{'modeled_us':>10} {'drift':>7}  signature"]
    for r in rows:
        modeled = (f"{r['modeled_us']:10.3f}"
                   if r["modeled_us"] is not None else f"{'-':>10}")
        drift = (f"{r['drift_ratio']:7.3f}"
                 if r["drift_ratio"] is not None else f"{'-':>7}")
        lines.append(
            f"{r['kind']:<13} {r['count']:>4} {r['median_us']:>10.3f} "
            f"{r['p90_us']:>10.3f} {modeled} {drift}  {r['signature']}")
    return "\n".join(lines)


########################################
# registry gauges (live on GET /metrics)
########################################
# The store object is swapped per-test (reset_calibration_store), so the
# registry pulls the LIVE instance's stats at collect time — the same
# collector pattern compile_cache.py uses.

_REG = _tmetrics.get_registry()
_DRIFT_GAUGE = _REG.gauge(
    "alpa_cost_model_drift_ratio",
    "Worst measured/modeled cost divergence per calibration kind "
    "(>1 = analytic model optimistic)",
    labelnames=("kind",))
_SAMPLES_GAUGE = _REG.gauge(
    "alpa_calibration_samples_total",
    "Measured cost samples ingested into the calibration store, per kind",
    labelnames=("kind",))


def _collect_calibration(_registry):
    store = _global_store
    _DRIFT_GAUGE.reset()
    _SAMPLES_GAUGE.reset()
    if store is None:
        return
    samples: Dict[str, int] = {}
    worst: Dict[str, float] = {}
    for e in store.entries():
        samples[e.kind] = samples.get(e.kind, 0) + e.count
        ratio = e.drift_ratio
        if ratio is not None and ratio > 0:
            prev = worst.get(e.kind)
            if prev is None or abs(math.log(ratio)) > abs(math.log(prev)):
                worst[e.kind] = ratio
    for kind, n in samples.items():
        _SAMPLES_GAUGE.labels(kind).set(n)
    for kind, ratio in worst.items():
        _DRIFT_GAUGE.labels(kind).set(ratio)


_REG.register_collector(_collect_calibration)
