"""Deprecation bridge over the unified telemetry layer.

.. deprecated::
    Counterpart of ``alpa_tpu/timer.py``, which predates the telemetry
    layer (the reference's ``alpa/timer.py:7-94``).  The runtime no longer uses it — dispatch
    latency lives in the ``alpa_pipeshard_dispatch_seconds`` /
    ``alpa_mesh_dispatch_seconds`` histograms and step timelines in
    ``telemetry.trace`` — but the module stays importable for
    third-party call sites:

    * ``timers(name).start()/.stop()`` keeps working and additionally
      mirrors each measured interval into the central metrics registry
      as the ``alpa_legacy_timer_seconds{name}`` histogram, so legacy
      timings show up on GET /metrics next to everything else.
    * ``tracer.log(...)`` keeps its local event list and mirrors into
      the process ``TraceRecorder`` as a ``legacy``-category instant
      when tracing is enabled (same merged Perfetto trace as
      span-instrumented code).

    New code should use ``alpa_tpu_torch.telemetry.metrics`` / ``.trace``.
"""
import time
from collections import namedtuple

TracerEvent = namedtuple("TracerEvent", ("tstamp", "name", "info"))


def _legacy_histogram():
    # lazy so ``alpa_tpu_torch.timer`` stays importable alone
    from alpa_tpu_torch.telemetry import metrics as _tmetrics
    return _tmetrics.get_registry().histogram(
        "alpa_legacy_timer_seconds",
        "Intervals measured through the deprecated alpa_tpu.timer bridge",
        labelnames=("name",))


class _Timer:
    """A named timer with start/stop/elapsed (deprecated; kept for API
    compatibility — each stop also feeds the telemetry histogram)."""

    def __init__(self, name: str):
        self.name = name
        self.started = False
        self.start_time = None
        # Each (start, stop) pair adds one entry.
        self.costs = []

    def start(self, sync_func=None):
        assert not self.started, f"timer {self.name} already started"
        if sync_func:
            sync_func()
        self.start_time = time.perf_counter()
        self.started = True

    def stop(self, sync_func=None):
        assert self.started, f"timer {self.name} not started"
        if sync_func:
            sync_func()
        dt = time.perf_counter() - self.start_time
        self.costs.append(dt)
        self.started = False
        try:
            _legacy_histogram().labels(self.name).observe(dt)
        except Exception:  # pylint: disable=broad-except
            pass

    def reset(self):
        self.started = False
        self.start_time = None
        self.costs = []

    def elapsed(self, mode: str = "average"):
        if not self.costs:
            return 0.0
        if mode == "average":
            return sum(self.costs) / len(self.costs)
        if mode == "sum":
            return sum(self.costs)
        if mode == "last":
            return self.costs[-1]
        raise ValueError(f"unknown mode {mode}")

    def log(self, mode: str = "average", normalizer: float = 1.0):
        print(f"timer {self.name}: {self.elapsed(mode) / normalizer:.6f} s")


class Timers:
    """A registry of named timers (deprecated shim)."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def __contains__(self, name: str):
        return name in self.timers

    def reset_all(self):
        for t in self.timers.values():
            t.reset()

    def log(self, names=None, mode="average", normalizer=1.0):
        for name in (names or self.timers):
            self.timers[name].log(mode, normalizer)


class Tracer:
    """Timestamped event log, dumpable as a Chrome trace (deprecated
    shim: when tracing is enabled every ``log()`` is mirrored into the
    process ``TraceRecorder`` as a ``legacy``-category instant)."""

    def __init__(self):
        self.events = []

    def log(self, name: str, info: str = ""):
        self.events.append(TracerEvent(time.time(), name, info))
        from alpa_tpu_torch.telemetry import trace as _ttrace
        if _ttrace.enabled():
            _ttrace.instant(name, "legacy",
                            {"info": info} if info else None)

    def clear(self):
        self.events = []

    def to_chrome_trace(self, pid: int = 0):
        """Render events as Chrome trace 'instant' records (deprecated:
        prefer ``telemetry.trace.TraceRecorder.to_chrome_trace()``)."""
        return [{
            "name": ev.name,
            "ph": "i",
            "ts": ev.tstamp * 1e6,
            "pid": pid,
            "tid": 0,
            "args": {"info": ev.info},
        } for ev in self.events]


timers = Timers()
tracer = Tracer()
