"""Central metrics registry: Counter / Gauge / Histogram with labels.

The registry is the single home for every runtime statistic alpa_tpu
keeps (compile cache hit/miss, overlap dispatch totals, checkpoint
traffic, fault-layer retries, serving queue depth / batch size / TTFT /
tokens-per-second, watchdog liveness).  The pre-existing ad-hoc dicts
(``monitoring.get_*_stats()``, ``checkpoint.metrics``,
``runtime_emitter._overlap_totals``, ...) are thin views over it, so
every number shows up exactly once and ``GET /metrics`` on the serving
controller can export the whole registry in Prometheus text exposition
format.

Design notes:

* Metric *families* are created idempotently via
  ``registry.counter(name, ...)`` — repeated calls with the same name
  return the same family, so modules can declare their metrics at
  import time without coordination.
* Labeled families hand out children via ``family.labels(v1, ...)``;
  an unlabeled family is its own child.
* ``Histogram`` keeps fixed cumulative buckets (for Prometheus
  ``_bucket`` samples) plus a bounded ring of recent raw samples for
  exact nearest-rank p50/p95/p99 summaries.
* ``register_collector(fn)`` lets a module with live per-instance state
  (e.g. the process compile cache, which tests swap per-test) publish
  into the registry lazily: collectors run at collect time
  (``to_prometheus_text()`` / ``snapshot()``) and typically set gauges.
"""
import bisect
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "reset_registry", "DEFAULT_BUCKETS",
]

# seconds-oriented default latency buckets (Prometheus-style)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_SUMMARY_RING = 2048  # raw samples kept per histogram child for p50/p95/p99


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n").replace(
        '"', '\\"')


def _label_str(labelnames: Sequence[str],
               labelvalues: Sequence[str]) -> str:
    if not labelnames:
        return ""
    pairs = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in zip(labelnames, labelvalues))
    return "{" + pairs + "}"


class _Child:
    """Base for a single (labelset, metric) time series."""

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, value: float = 1.0):
        if value < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class _GaugeChild(_Child):

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, value: float = 1.0):
        with self._lock:
            self._value += value

    def dec(self, value: float = 1.0):
        with self._lock:
            self._value -= value

    def set_max(self, value: float):
        """Keep the running maximum (used for high-watermark gauges)."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0


class _HistogramChild(_Child):

    def __init__(self, buckets: Sequence[float]):
        super().__init__()
        self._buckets = tuple(buckets)
        self._counts = [0] * (len(self._buckets) + 1)  # +Inf tail
        self._sum = 0.0
        self._count = 0
        self._ring: List[float] = []
        self._ring_pos = 0

    def observe(self, value: float):
        v = float(value)
        with self._lock:
            i = bisect.bisect_left(self._buckets, v)
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if len(self._ring) < _SUMMARY_RING:
                self._ring.append(v)
            else:
                self._ring[self._ring_pos] = v
                self._ring_pos = (self._ring_pos + 1) % _SUMMARY_RING

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the recent-sample ring.

        Exact for the first ``_SUMMARY_RING`` observations; a sliding
        window afterwards."""
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return 0.0
        k = max(0, min(len(data) - 1,
                       int(math.ceil(p / 100.0 * len(data))) - 1))
        return data[k]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """Cumulative (le, count) pairs, ending with +Inf."""
        with self._lock:
            out, cum = [], 0
            for le, c in zip(self._buckets + (float("inf"),),
                             self._counts):
                cum += c
                out.append((le, cum))
            return out

    def reset(self):
        with self._lock:
            self._counts = [0] * (len(self._buckets) + 1)
            self._sum = 0.0
            self._count = 0
            self._ring = []
            self._ring_pos = 0


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class _Family:
    """A named metric family; with labels it fans out to children, without
    labels it proxies to a single implicit child."""

    kind = None  # "counter" | "gauge" | "histogram"

    def __init__(self, name: str, description: str,
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.description = description
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self) -> _Child:
        cls = _CHILD_TYPES[self.kind]
        if self.kind == "histogram":
            return cls(self._buckets)
        return cls()

    def labels(self, *labelvalues) -> _Child:
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{labelvalues}")
        key = tuple(str(v) for v in labelvalues)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())

    def reset(self):
        with self._lock:
            if self.labelnames:
                self._children.clear()
            else:
                self._children[()].reset()

    # unlabeled families proxy the child API
    def _solo(self) -> _Child:
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first")
        return self._children[()]


class Counter(_Family):
    kind = "counter"

    def inc(self, value: float = 1.0):
        self._solo().inc(value)

    @property
    def value(self) -> float:
        return self._solo().value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float):
        self._solo().set(value)

    def inc(self, value: float = 1.0):
        self._solo().inc(value)

    def dec(self, value: float = 1.0):
        self._solo().dec(value)

    def set_max(self, value: float):
        self._solo().set_max(value)

    @property
    def value(self) -> float:
        return self._solo().value


class Histogram(_Family):
    kind = "histogram"

    def observe(self, value: float):
        self._solo().observe(value)

    def percentile(self, p: float) -> float:
        return self._solo().percentile(p)

    def summary(self) -> Dict[str, float]:
        return self._solo().summary()

    def bucket_counts(self) -> List[Tuple[float, int]]:
        return self._solo().bucket_counts()

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum


_FAMILY_TYPES = {"counter": Counter, "gauge": Gauge,
                 "histogram": Histogram}


class MetricsRegistry:
    """Process-global (or test-local) collection of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _get_or_create(self, kind: str, name: str, description: str,
                       labelnames: Sequence[str],
                       buckets: Optional[Sequence[float]]) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                return fam
            fam = _FAMILY_TYPES[kind](name, description, labelnames,
                                      buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, description: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create("counter", name, description,
                                   labelnames, None)

    def gauge(self, name: str, description: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create("gauge", name, description,
                                   labelnames, None)

    def histogram(self, name: str, description: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create("histogram", name, description,
                                   labelnames, buckets)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def register_collector(self, fn: Callable[["MetricsRegistry"], None]):
        """Run ``fn(registry)`` before every collection.  Collectors pull
        live module state (e.g. the current compile cache instance) into
        registry gauges.  Registering the same function twice is a
        no-op."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _run_collectors(self):
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except Exception:  # pragma: no cover - defensive: a broken
                pass           # collector must not take down /metrics

    def families(self) -> List[_Family]:
        self._run_collectors()
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict dump: ``name{labels}`` -> value (histograms ->
        summary dict).  Used by dump_debug_info and tests."""
        out: Dict[str, object] = {}
        for fam in self.families():
            for key, child in fam.children():
                sample = fam.name + _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    out[sample] = child.summary()
                else:
                    out[sample] = child.value
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.description:
                lines.append(f"# HELP {fam.name} {fam.description}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children():
                labels = _label_str(fam.labelnames, key)
                if fam.kind == "histogram":
                    for le, cum in child.bucket_counts():
                        le_lbl = _label_str(
                            fam.labelnames + ("le",),
                            key + (_fmt_value(le),))
                        lines.append(
                            f"{fam.name}_bucket{le_lbl} {cum}")
                    lines.append(
                        f"{fam.name}_sum{labels} "
                        f"{_fmt_value(child.sum)}")
                    lines.append(
                        f"{fam.name}_count{labels} {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{labels} "
                        f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    def reset(self, prefix: Optional[str] = None):
        """Zero every family (or only those whose name starts with
        ``prefix``).  Definitions and collectors survive."""
        with self._lock:
            fams = list(self._families.values())
        for fam in fams:
            if prefix is None or fam.name.startswith(prefix):
                fam.reset()


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_registry(prefix: Optional[str] = None):
    _REGISTRY.reset(prefix)
