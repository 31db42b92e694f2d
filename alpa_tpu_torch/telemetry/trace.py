"""Span tracing: thread-safe recorder exporting Chrome-trace JSON.

Counterpart of ``alpa_tpu/telemetry/trace.py``, with its names, knobs
and export format.

One :class:`TraceRecorder` per process collects *spans* (named,
categorized, nested intervals), *instants* (point events — the legacy
``timer.Tracer`` bridge lands here) and *counter* samples (e.g. the
overlap transfer pool's in-flight window).  Every event carries a
*track*: a stable ``tid`` in the exported trace.  By default the track
is the recording thread (``"driver"`` for the main thread, the thread
name otherwise — pool workers get their ``alpa-overlap-N`` names), but
call sites that know better pass one explicitly (``"mesh 3"`` for
per-instruction spans).

``to_chrome_trace()`` emits the Chrome trace event format
(``{"traceEvents": [...]}``) with ``B``/``E`` duration pairs, ``M``
thread-name metadata, ``i`` instants and ``C`` counters — loadable
directly in Perfetto / chrome://tracing.  ``merge_chrome_traces``
combines per-mesh / per-process files onto distinct pids.

Zero-cost-when-off: the module-level ``_ENABLED`` flag (seeded from
``ALPA_TPU_TRACE`` via ``global_config.telemetry_enabled``) is checked
before *any* allocation — ``span()`` returns a shared no-op singleton
when tracing is off, and the register-file replay checks the flag once
per step, not per instruction.  On a card, spans of the replayed ops
are timed by CUDA events and recorded after the step on the device
clock (``pipeshard_executable``); the recorder itself never syncs.
"""
import json
import threading
import time
from typing import Any, Dict, List, Optional

from alpa_tpu_torch.global_env import global_config

__all__ = [
    "TraceRecorder", "get_recorder", "set_recorder", "enabled",
    "set_enabled", "span", "instant", "counter", "begin", "end",
    "now_us", "merge_chrome_traces", "CATEGORIES",
]

# category taxonomy -- free-form strings are accepted; these are the ones the built-in instrumentation uses.
CATEGORIES = ("compile", "instruction", "transfer", "resharding",
              "checkpoint", "serving", "runtime", "legacy")

# perf_counter epoch shared by every event in this process so that
# timestamps from different threads land on one comparable axis.
_EPOCH = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def now_us() -> float:
    """Current time on the recorder's shared epoch — pair with
    :meth:`TraceRecorder.complete` for externally-timed spans."""
    return _now_us()


class _NullSpan:
    """Shared do-nothing context manager returned while tracing is off.

    A singleton (``__slots__``, no state) so the disabled path allocates
    nothing — tests assert ``span("a") is span("b")``."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span token: context manager AND explicit begin/end handle."""
    __slots__ = ("_rec", "name", "category", "args", "track", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, category: str,
                 args: Optional[Dict[str, Any]], track: Optional[str]):
        self._rec = rec
        self.name = name
        self.category = category
        self.args = args
        self.track = track
        self._t0 = _now_us()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._rec._finish(self)
        return False


class TraceRecorder:
    """Thread-safe in-memory event store (bounded by ``max_events``)."""

    def __init__(self, max_events: Optional[int] = None):
        if max_events is None:
            max_events = int(getattr(global_config,
                                     "telemetry_max_events", 200000))
        self.max_events = max_events
        self._lock = threading.Lock()
        # completed spans: (name, category, ts_us, dur_us, tid, args)
        self._spans: List[tuple] = []
        # instants: (name, category, ts_us, tid, args)
        self._instants: List[tuple] = []
        # counters: (name, ts_us, value, tid)
        self._counters: List[tuple] = []
        self._tids: Dict[str, int] = {}
        self._dropped = 0

    # ---- track / tid bookkeeping ------------------------------------

    def _tid(self, track: Optional[str]) -> int:
        if track is None:
            t = threading.current_thread()
            track = ("driver" if t is threading.main_thread()
                     else t.name)
        tid = self._tids.get(track)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(track, len(self._tids) + 1)
        return tid

    def _room(self, store: List[tuple]) -> bool:
        if len(store) >= self.max_events:
            self._dropped += 1
            return False
        return True

    # ---- recording --------------------------------------------------

    def span(self, name: str, category: str = "runtime",
             args: Optional[Dict[str, Any]] = None,
             track: Optional[str] = None) -> _Span:
        return _Span(self, name, category, args, track)

    def _finish(self, s: _Span):
        t1 = _now_us()
        tid = self._tid(s.track)
        with self._lock:
            if self._room(self._spans):
                self._spans.append((s.name, s.category, s._t0,
                                    t1 - s._t0, tid, s.args))

    def begin(self, name: str, category: str = "runtime",
              args: Optional[Dict[str, Any]] = None,
              track: Optional[str] = None) -> _Span:
        """Explicit open for async work; close with :meth:`end`.  Pass
        ``track`` when begin and end run on different threads."""
        return self.span(name, category, args, track)

    def end(self, token: Optional[_Span]):
        if token is not None and token is not _NULL_SPAN:
            self._finish(token)

    def complete(self, name: str, category: str, ts_us: float,
                 dur_us: float, args: Optional[Dict[str, Any]] = None,
                 track: Optional[str] = None):
        """Record an already-timed span — async work whose start was
        stamped on another thread (e.g. the overlap pool's queue-wait
        child, whose begin is the driver-side submit).  ``ts_us`` must
        come from :func:`now_us` so it shares the process epoch."""
        tid = self._tid(track)
        with self._lock:
            if self._room(self._spans):
                self._spans.append((name, category, ts_us, dur_us, tid,
                                    args))

    def instant(self, name: str, category: str = "runtime",
                args: Optional[Dict[str, Any]] = None,
                track: Optional[str] = None):
        tid = self._tid(track)
        with self._lock:
            if self._room(self._instants):
                self._instants.append((name, category, _now_us(), tid,
                                       args))

    def counter(self, name: str, value: float,
                track: Optional[str] = None):
        tid = self._tid(track if track is not None else name)
        with self._lock:
            if self._room(self._counters):
                self._counters.append((name, _now_us(), value, tid))

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._instants.clear()
            self._counters.clear()
            self._tids.clear()
            self._dropped = 0

    # ---- introspection / export -------------------------------------

    @property
    def n_events(self) -> int:
        with self._lock:
            return (len(self._spans) + len(self._instants) +
                    len(self._counters))

    def spans(self) -> List[Dict[str, Any]]:
        """Completed spans as dicts (test/tooling convenience)."""
        with self._lock:
            items = list(self._spans)
            tids = dict(self._tids)
        names = {v: k for k, v in tids.items()}
        return [{"name": n, "category": c, "ts_us": ts, "dur_us": dur,
                 "tid": tid, "track": names.get(tid), "args": args}
                for n, c, ts, dur, tid, args in items]

    def to_chrome_trace(self, pid: int = 0,
                        process_name: str = "alpa_tpu") -> Dict[str, Any]:
        with self._lock:
            spans = list(self._spans)
            instants = list(self._instants)
            counters = list(self._counters)
            tids = dict(self._tids)
            dropped = self._dropped
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        }]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"name": track}})
        timed: List[Dict[str, Any]] = []
        for name, cat, ts, dur, tid, args in spans:
            b = {"name": name, "cat": cat, "ph": "B", "ts": ts,
                 "pid": pid, "tid": tid}
            if args:
                b["args"] = args
            timed.append(b)
            timed.append({"name": name, "cat": cat, "ph": "E",
                          "ts": ts + dur, "pid": pid, "tid": tid})
        for name, cat, ts, tid, args in instants:
            ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
                  "ts": ts, "pid": pid, "tid": tid}
            if args:
                ev["args"] = args
            timed.append(ev)
        for name, ts, value, tid in counters:
            timed.append({"name": name, "ph": "C", "ts": ts,
                          "pid": pid, "tid": tid,
                          "args": {"value": value}})
        # E before B on timestamp ties so a span ending exactly where a
        # sibling starts still nests; real perf_counter stamps are
        # strictly increasing per thread.
        timed.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
        events.extend(timed)
        trace = {"traceEvents": events,
                 "displayTimeUnit": "ms"}
        if dropped:
            trace["alpa_dropped_events"] = dropped
        return trace

    def save(self, path: str, pid: int = 0,
             process_name: str = "alpa_tpu"):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(pid, process_name), f)


def merge_chrome_traces(traces: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge chrome traces (e.g. one per mesh/process) onto distinct
    pids so every input keeps its own track group in Perfetto."""
    events: List[Dict[str, Any]] = []
    for pid, trace in enumerate(traces):
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---- module-level recorder + zero-cost-when-off front door -----------

_ENABLED = bool(getattr(global_config, "telemetry_enabled", False))
_RECORDER = TraceRecorder()


def get_recorder() -> TraceRecorder:
    return _RECORDER


def set_recorder(rec: TraceRecorder) -> TraceRecorder:
    """Swap the process recorder (tests install a fresh one); returns
    the previous recorder."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Flip tracing on/off; keeps ``global_config.telemetry_enabled`` in
    sync.  Returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(flag)
    global_config.telemetry_enabled = bool(flag)
    return prev


def span(name: str, category: str = "runtime",
         args: Optional[Dict[str, Any]] = None,
         track: Optional[str] = None):
    """Context manager recording a span — or the shared no-op singleton
    when tracing is off (no allocation on the disabled path)."""
    if not _ENABLED:
        return _NULL_SPAN
    return _RECORDER.span(name, category, args, track)


def begin(name: str, category: str = "runtime",
          args: Optional[Dict[str, Any]] = None,
          track: Optional[str] = None) -> Optional[_Span]:
    """Open an async span; returns None when tracing is off (safe to
    pass straight back to :func:`end`)."""
    if not _ENABLED:
        return None
    return _RECORDER.begin(name, category, args, track)


def end(token: Optional[_Span]):
    if token is not None:
        _RECORDER.end(token)


def instant(name: str, category: str = "runtime",
            args: Optional[Dict[str, Any]] = None,
            track: Optional[str] = None):
    if _ENABLED:
        _RECORDER.instant(name, category, args, track)


def counter(name: str, value: float, track: Optional[str] = None):
    if _ENABLED:
        _RECORDER.counter(name, value, track)
