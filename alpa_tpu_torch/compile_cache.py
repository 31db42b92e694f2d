"""Persistent compile cache: content-addressed, two-tier (memory + disk).

Counterpart of ``alpa_tpu/compile_cache.py``.  The planners' answers are
pure functions of their inputs (the traced aten graph, the mesh, the
options, the torch version), so they are safe to persist and replay.
The compile phases write through it:

* ``ilp`` -- auto-sharding solutions from
  ``shard_parallel/solver.py::plan_auto_sharding`` (the chosen logical
  mesh shape and the strategy vector);
* ``stage_dp`` -- stage-construction decisions from
  ``stage_construction.py::cluster_layers_and_slice_mesh`` (the layer ->
  stage clustering, submesh shapes, per-stage auto-sharding dicts);
* ``parallel_plan`` -- replayable ``ParallelPlan`` records saved by
  ``api.parallelize`` after each compile;
* ``reshard_strategy`` -- the strategy ``resolve_strategy`` picked for a
  cross-mesh edge;
* ``plan_verdict`` -- the plan verifier's ``PlanVerdict`` of a lowered
  program (``analysis/plan_verifier.py``), keyed by the program's
  fingerprint, the analyses' version and the knobs that shape the verdict:
  a warm restart replays the identical verdict without analysing;
* ``superopt`` -- the superoptimizer's accepted rewrite layout
  (``analysis/superopt.py``), keyed by the baseline program's fingerprint,
  the calibration store's and the search knobs: a warm restart replays the
  same rewrite with zero search.

The verifier and the superoptimizer record their seconds on a miss
(``solve_seconds``) and the seconds a hit skipped (``saved_seconds``).

Keying: sha256 over a canonical fingerprint of every input that shapes the
answer, always including ``torch.__version__`` and ``CACHE_FORMAT_VERSION``.
A traced graph enters the key through ``graph_fingerprint``: each node's
op, target, argument order (as positions of earlier nodes), shapes and
dtypes; a ``_tensor_constant*`` by its content; no object id and no
counter of the process, so two traces of one function key alike.

Tiers: an in-memory LRU in front of an on-disk pickle store under
``global_config.compile_cache_dir`` (env ``ALPA_TPU_CACHE_DIR``).  With no
directory the cache is memory-only.  Disk writes are atomic (tempfile +
rename), so processes sharing a directory read only complete entries.

Counters (hits / misses / puts / solve seconds spent vs saved) are per
namespace, exported as the ``alpa_compile_cache_*`` gauges.
"""
import collections
import dataclasses
import hashlib
import logging
import os
import pickle
import re
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence

from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)

# a repr may embed live addresses (``<function ... at 0x7f...>``); mask
# them so one program fingerprints alike across traces and processes
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")

# Bump to invalidate every persisted entry on cache-format changes; disk
# payloads are wrapped in a ``{"__cache_format__": N, "payload": ...}``
# envelope.
CACHE_FORMAT_VERSION = 2


def _torch_version() -> str:
    import torch
    return torch.__version__


def graph_fingerprint(graph) -> str:
    """A content fingerprint of a traced aten graph (an ``fx.Graph`` or
    ``GraphModule``): per node its op, target, arguments (an earlier node
    by position, a constant by ``repr``) and its value's shape and dtype.
    A ``get_attr`` constant of the owning module is hashed by content.
    Node names, object ids and the process's counters stay out."""
    import torch
    from torch import fx
    owner = graph if hasattr(graph, "graph") else None
    g = graph.graph if owner is not None else graph
    pos: Dict[Any, int] = {}
    h = hashlib.sha256()

    def arg(a):
        if isinstance(a, (list, tuple)):
            return "(" + ",".join(arg(x) for x in a) + ")"
        if isinstance(a, dict):
            return "{" + ",".join(f"{k}:{arg(v)}" for k, v in
                                  sorted(a.items())) + "}"
        if isinstance(a, fx.Node):
            return f"%{pos[a]}"
        return repr(a)

    def meta(n):
        v = n.meta.get("val")
        if isinstance(v, (list, tuple)):
            return "(" + ",".join(
                f"{tuple(x.shape)}{x.dtype}" if isinstance(x, torch.Tensor)
                else repr(type(x).__name__) for x in v) + ")"
        if isinstance(v, torch.Tensor):
            return f"{tuple(v.shape)}{v.dtype}"
        return type(v).__name__

    for i, n in enumerate(g.nodes):
        target = n.target
        if n.op == "get_attr":
            const = None
            if owner is not None:
                const = getattr(owner, str(target), None)
            if isinstance(const, torch.Tensor):
                # flat first: a 0-d tensor has no byte view of another
                # element size (make_fx keeps scalars as 0-d constants)
                c = const.detach().cpu().contiguous()
                target = "const:" + hashlib.sha256(
                    c.reshape(-1).view(torch.uint8).numpy().tobytes()
                    if c.numel() else b"").hexdigest()[:16] + \
                    f"{tuple(c.shape)}{c.dtype}"
            else:
                target = "attr"
        elif n.op == "placeholder":
            target = "input"
        else:
            target = str(target)
        line = f"{i}|{n.op}|{target}|{arg(n.args)}|{arg(n.kwargs)}|{meta(n)}"
        h.update(_ADDR_RE.sub("0x0", line).encode())
        h.update(b"\n")
        pos[n] = i
    return h.hexdigest()


def fingerprint_parts(parts: Sequence[Any]) -> str:
    """Canonical content fingerprint of heterogeneous key parts, led by
    the format and torch versions.

    Strings pass through; dataclasses expand to sorted field reprs (stable
    across processes, unlike default ``repr`` which may embed addresses);
    everything else uses ``repr``.  Each part is length-prefixed so
    adjacent parts cannot collide by concatenation.
    """
    h = hashlib.sha256()
    h.update(f"v{CACHE_FORMAT_VERSION}:torch={_torch_version()}".encode())
    for p in parts:
        if dataclasses.is_dataclass(p) and not isinstance(p, type):
            s = "{}({})".format(
                type(p).__name__,
                ",".join(f"{k}={v!r}" for k, v in
                         sorted(dataclasses.asdict(p).items())))
        elif isinstance(p, str):
            s = p
        else:
            s = repr(p)
        b = _ADDR_RE.sub("0x0", s).encode()
        h.update(f"|{len(b)}|".encode())
        h.update(b)
    return h.hexdigest()


def read_entry_format(path: str) -> Optional[int]:
    """The cache-format version a disk entry was written with: the
    envelope's ``__cache_format__`` for v2+ entries, 1 for bare legacy
    payloads (pre-dataflow-graph lowering), None if unreadable."""
    try:
        with open(path, "rb") as f:
            value = pickle.load(f)
    except Exception:  # pylint: disable=broad-except
        return None
    if isinstance(value, dict) and "__cache_format__" in value:
        try:
            return int(value["__cache_format__"])
        except (TypeError, ValueError):
            return None
    return 1


@dataclasses.dataclass
class NamespaceStats:
    """Hit/miss accounting for one cache namespace."""
    hits: int = 0
    misses: int = 0
    puts: int = 0
    disk_hits: int = 0
    # seconds spent producing entries that were then stored (the cost a
    # future hit avoids) and seconds a hit demonstrably skipped
    solve_seconds: float = 0.0
    saved_seconds: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "disk_hits": self.disk_hits,
            "solve_seconds": round(self.solve_seconds, 4),
            "saved_seconds": round(self.saved_seconds, 4),
        }


class CompileCache:
    """Two-tier (LRU memory + optional disk) content-addressed cache."""

    def __init__(self, cache_dir: Optional[str] = None,
                 memory_entries: int = 128):
        self.cache_dir = cache_dir or None
        self.memory_entries = memory_entries
        self._mem: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._stats: Dict[str, NamespaceStats] = {}

    # -- keying --------------------------------------------------------

    def make_key(self, namespace: str, parts: Sequence[Any]) -> str:
        return f"{namespace}-{fingerprint_parts(parts)}"

    # -- stats ---------------------------------------------------------

    def _ns_stats(self, namespace: str) -> NamespaceStats:
        return self._stats.setdefault(namespace, NamespaceStats())

    def record_solve_seconds(self, namespace: str, seconds: float):
        with self._lock:
            self._ns_stats(namespace).solve_seconds += seconds

    def record_saved_seconds(self, namespace: str, seconds: float):
        with self._lock:
            self._ns_stats(namespace).saved_seconds += seconds

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cache_dir": self.cache_dir,
                "memory_entries": len(self._mem),
                "namespaces": {ns: s.as_dict()
                               for ns, s in sorted(self._stats.items())},
            }

    # -- storage -------------------------------------------------------

    def _path_of(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, key + ".pkl")

    def get(self, namespace: str, key: str) -> Optional[Any]:
        """The cached value, or None.  Memory tier first, then disk;
        a disk hit is promoted into the memory tier."""
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                self._ns_stats(namespace).hits += 1
                _ttrace.instant("compile-cache.hit", "compile",
                                {"namespace": namespace}
                                if _ttrace.enabled() else None)
                return self._mem[key]
        path = self._path_of(key)
        if path and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    value = pickle.load(f)
                # v2 envelope; tolerate bare legacy payloads (their keys
                # embed the old format version so they can only be read
                # by explicit tooling, never hit by lookups)
                if isinstance(value, dict) and "__cache_format__" in value:
                    value = value["payload"]
            except Exception as e:  # pylint: disable=broad-except
                # a truncated/stale entry is a miss, never an error
                logger.warning("compile cache entry %s unreadable (%s); "
                               "dropping", path, e)
                try:
                    os.remove(path)
                except OSError:
                    pass
                with self._lock:
                    self._ns_stats(namespace).misses += 1
                return None
            with self._lock:
                st = self._ns_stats(namespace)
                st.hits += 1
                st.disk_hits += 1
                self._insert_mem(key, value)
            _ttrace.instant("compile-cache.disk-hit", "compile",
                            {"namespace": namespace}
                            if _ttrace.enabled() else None)
            return value
        with self._lock:
            self._ns_stats(namespace).misses += 1
        _ttrace.instant("compile-cache.miss", "compile",
                        {"namespace": namespace}
                        if _ttrace.enabled() else None)
        return None

    def put(self, namespace: str, key: str, value: Any):
        with self._lock:
            self._insert_mem(key, value)
            self._ns_stats(namespace).puts += 1
        path = self._path_of(key)
        if not path:
            return
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir,
                                       prefix=".tmp-" + namespace)
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump({"__cache_format__": CACHE_FORMAT_VERSION,
                                 "payload": value}, f)
                os.replace(tmp, path)  # atomic publish
            except BaseException:
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                raise
        except Exception as e:  # pylint: disable=broad-except
            # the disk tier is an optimization; a read-only or full disk
            # must never fail compilation
            logger.warning("compile cache write %s failed: %s", path, e)

    def _insert_mem(self, key: str, value: Any):
        self._mem[key] = value
        self._mem.move_to_end(key)
        while len(self._mem) > self.memory_entries:
            self._mem.popitem(last=False)

    # -- maintenance ---------------------------------------------------

    def entries(self) -> List[Dict[str, Any]]:
        """Disk-tier inventory."""
        out = []
        if not self.cache_dir or not os.path.isdir(self.cache_dir):
            return out
        for name in sorted(os.listdir(self.cache_dir)):
            if not name.endswith(".pkl"):
                continue
            path = os.path.join(self.cache_dir, name)
            ns, _, rest = name.rpartition(".pkl")[0].partition("-")
            try:
                st = os.stat(path)
            except OSError:
                continue
            out.append({
                "namespace": ns,
                "key": rest,
                "bytes": st.st_size,
                "mtime": st.st_mtime,
                "path": path,
            })
        return out

    def clear(self, namespace: Optional[str] = None,
              memory_only: bool = False) -> int:
        """Drop entries (all, or one namespace).  Returns the number of
        disk entries removed."""
        with self._lock:
            if namespace is None:
                self._mem.clear()
            else:
                for k in [k for k in self._mem
                          if k.startswith(namespace + "-")]:
                    del self._mem[k]
        removed = 0
        if memory_only:
            return removed
        for e in self.entries():
            if namespace is None or e["namespace"] == namespace:
                try:
                    os.remove(e["path"])
                    removed += 1
                except OSError:
                    pass
        return removed


# ---------------------------------------------------------------------
# process-global instance
# ---------------------------------------------------------------------

_global_cache: Optional[CompileCache] = None
_global_lock = threading.Lock()


def get_compile_cache() -> CompileCache:
    """The process-global cache, built from ``global_config`` on first
    use.  ``reset_compile_cache()`` rebuilds it (tests; dir changes)."""
    global _global_cache
    with _global_lock:
        if _global_cache is None:
            from alpa_tpu_torch.global_env import global_config
            _global_cache = CompileCache(
                cache_dir=global_config.compile_cache_dir,
                memory_entries=global_config.compile_cache_memory_entries)
        return _global_cache


def reset_compile_cache(cache: Optional[CompileCache] = None):
    """Install ``cache`` (or lazily rebuild from global_config).  Used by
    the pytest fixture to isolate the cache dir per test, and by callers
    after changing ``global_config.compile_cache_dir``."""
    global _global_cache
    with _global_lock:
        _global_cache = cache


def cache_enabled() -> bool:
    from alpa_tpu_torch.global_env import global_config
    return bool(global_config.compile_cache_enabled)


# ---------------------------------------------------------------------
# metrics registry export
# ---------------------------------------------------------------------
# The cache object is swapped per-test (reset_compile_cache), so the
# registry cannot hold counters directly — a collector pulls the LIVE
# instance's per-namespace stats into gauges at collect time, keeping
# GET /metrics truthful without breaking per-test isolation.

_REG = _tmetrics.get_registry()
_CC_MEMORY = _REG.gauge(
    "alpa_compile_cache_memory_entries",
    "Entries resident in the compile cache memory tier")
_CC_NS_GAUGES = {
    k: _REG.gauge(f"alpa_compile_cache_{k}", d, labelnames=("namespace",))
    for k, d in (
        ("hits", "Compile cache hits (memory + disk)"),
        ("disk_hits", "Compile cache hits served from the disk tier"),
        ("misses", "Compile cache misses"),
        ("puts", "Compile cache stores"),
        ("solve_seconds", "Seconds spent on solves whose results were "
                          "cached"),
        ("saved_seconds", "Solve seconds demonstrably skipped by hits"),
    )
}


def _collect_compile_cache(_registry):
    cache = _global_cache
    if cache is None:
        _CC_MEMORY.set(0)
        return
    st = cache.stats()
    _CC_MEMORY.set(st["memory_entries"])
    for fam in _CC_NS_GAUGES.values():
        fam.reset()   # drop namespaces from a previously-installed cache
    for ns, d in st["namespaces"].items():
        for k, fam in _CC_NS_GAUGES.items():
            fam.labels(ns).set(d[k])


_REG.register_collector(_collect_compile_cache)
