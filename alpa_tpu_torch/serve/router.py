"""Load-aware multi-replica router (counterpart of
``alpa_tpu/serve/router.py``; plain Python, no device code).

One ``Router`` spreads admission over N serving replicas, each a
``serve.controller.Controller`` in this process (``LocalReplicaHandle``)
or a controller reached over HTTP (``HTTPReplicaHandle``).  Placement
reads the controllers' load signals (queue depth, request p99, tokens in
flight: ``Controller.load_report``, also on every controller's
``/healthz``):

* ``least_loaded`` (default) scores each routable replica and picks the
  lightest; ``round_robin`` rotates (knob ``router_policy``);
* shedding is per replica: a saturated replica (queue depth or p99 over
  the ``router_shed_*`` knobs) is routed around, and a 503
  (``fault.ServiceDegradedError``) reaches the client only when every
  healthy replica is saturated or sheds;
* a replica whose ``/healthz`` fails ``router_health_fail_threshold``
  probes in a row leaves the rotation; one clean probe restores it;
* ``Router.rolling_reload`` deploys one replica at a time: stop placing
  on it, wait out its router-tracked requests, reload it through its
  ``/admin/reload`` drain barrier, probe, restore; with two replicas or
  more, traffic sees no error;
* autoscale hooks: aggregate load held above or below the
  ``router_autoscale_*`` thresholds for a window fires ``on_want_more`` /
  ``on_want_fewer`` (the router never creates replicas itself);
* disaggregated prefill/decode: replicas join with a ``phase``
  (``prefill``, ``decode`` or ``any``).  With ``disagg_mode=auto`` (both
  pools present) or ``forced``, a request is prefilled on the prefill
  pool, handed off as a content-hashed ``serve.disagg.KVHandoffArtifact``
  and decoded on the decode pool.  Each pool has its SLO steer
  (``disagg_ttft_slo_ms``, ``disagg_itl_slo_ms``), decode backlog
  throttles prefill admission (``disagg_backpressure_depth``), and no
  handoff is dropped: the prefill side retains every artifact until the
  stream's clean end is acked, so a dead decode replica or a corrupt copy
  re-ingests on a survivor.  ``disagg_mode=off`` is the monolithic path
  as it was.

``RouterServer`` puts the router behind HTTP (``/completions`` with SSE
pass-through for local and HTTP replicas, ``/healthz`` with the
per-replica view, ``/metrics``, ``POST /admin/rolling_reload``).

The decisions, counters and wire formats are the JAX package's line for
line, so the same stub replicas and load script give the same
placements, sheds, health changes and autoscale firings.
"""
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, List, Optional

from alpa_tpu_torch import fault
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.serve import disagg as _disagg
from alpa_tpu_torch.serve.controller import _HTTPServer
from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

_REG = _tmetrics.get_registry()
_ROUTER_REQS = _REG.counter(
    "alpa_router_requests_total",
    "Requests routed, by replica and outcome",
    labelnames=("replica", "outcome"))
_ROUTER_QDEPTH = _REG.gauge(
    "alpa_router_replica_queue_depth",
    "Last observed queue depth per replica",
    labelnames=("replica",))


class LocalReplicaHandle:
    """In-process replica: a Controller (one or more model replicas of
    its own — the router treats the whole controller as one unit)."""

    def __init__(self, controller, model: Optional[str] = None):
        self.controller = controller
        self.model = model

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.controller.completions(request)

    def completions_stream(self, request: Dict[str, Any]):
        return self.controller.completions_stream(request)

    def healthz(self):
        report = self.controller.health_report()
        recovery = self.controller._recovery
        if recovery is not None:
            report["status"] = recovery.state.value
            code = 503 if report["status"] == "degraded" else 200
        else:
            code = 503 if report["status"] == "shedding" else 200
        report["load"] = self.controller.load_report()
        return code, report

    def load(self) -> Dict[str, Any]:
        return self.controller.load_report()

    def reload(self, model: str, ckpt_dir: str,
               step: Optional[int] = None) -> Dict[str, Any]:
        return self.controller.reload_model(model, ckpt_dir, step=step)

    # disaggregated prefill/decode (same surface as HTTPReplicaHandle)
    def prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        return self.controller.disagg_prefill(request)

    def ingest(self, wire: Dict[str, Any]):
        return self.controller.disagg_ingest(wire)

    def disagg_fetch(self, request_id: str) -> Dict[str, Any]:
        return self.controller.disagg_fetch(request_id)

    def disagg_ack(self, request_id: str) -> bool:
        return self.controller.disagg_ack(request_id)


class _SSEStream:
    """Client half of the controller/router SSE wire format: iterates
    token ints from ``data: {"token": t}`` frames, raises on an error
    frame, and raises :class:`ConnectionError` when the transport dies
    before the ``done`` frame — exactly the signal the disaggregated
    failover path (and the router's health accounting) keys on."""

    def __init__(self, resp):
        self._resp = resp
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        while True:
            try:
                line = self._resp.readline()
            except (OSError, urllib.error.URLError):
                self.close()
                raise
            if not line:
                self.close()
                raise ConnectionError(
                    "SSE stream ended before its done frame")
            line = line.strip()
            if not line.startswith(b"data:"):
                continue
            evt = json.loads(line[len(b"data:"):].strip())
            if evt.get("done"):
                self.close()
                raise StopIteration
            if "error" in evt:
                self.close()
                raise RuntimeError(str(evt["error"]))
            if "token" in evt:
                return int(evt["token"])

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self._resp.close()
            except Exception:  # pylint: disable=broad-except
                pass


class HTTPReplicaHandle:
    """Remote replica behind ``http://host:port`` (a running
    ControllerServer).  Load signals ride the ``/healthz`` body."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _get(self, path: str):
        try:
            with urllib.request.urlopen(self.base_url + path,
                                        timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:  # pylint: disable=broad-except
                return e.code, {}

    def _post(self, path: str, payload: Dict[str, Any]):
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:  # pylint: disable=broad-except
                return e.code, {}

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        code, body = self._post("/completions", request)
        if code == 503:
            raise fault.ServiceDegradedError(
                body.get("error", "replica shedding"))
        if code != 200:
            raise RuntimeError(
                f"replica {self.base_url} returned {code}: "
                f"{body.get('error')}")
        return body

    def _post_stream(self, path: str, payload: Dict[str, Any]):
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=body,
            headers={"Content-Type": "application/json"})
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            try:
                err = json.loads(e.read()).get("error", "")
            except Exception:  # pylint: disable=broad-except
                err = ""
            if e.code == 503:
                raise fault.ServiceDegradedError(
                    err or "replica shedding") from e
            if e.code == 422:
                raise _disagg.ArtifactCorruptError(
                    err or "handoff artifact rejected") from e
            raise RuntimeError(
                f"replica {self.base_url} returned {e.code}: "
                f"{err}") from e
        return _SSEStream(resp)

    def completions_stream(self, request: Dict[str, Any]):
        return self._post_stream("/completions",
                                 dict(request, stream=True))

    # disaggregated prefill/decode surface
    def prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        code, body = self._post("/disagg/prefill", request)
        if code == 503:
            raise fault.ServiceDegradedError(
                body.get("error", "prefill replica shedding"))
        if code != 200:
            raise RuntimeError(
                f"prefill on {self.base_url} returned {code}: "
                f"{body.get('error')}")
        return body

    def ingest(self, wire: Dict[str, Any]):
        return self._post_stream("/disagg/ingest", wire)

    def disagg_fetch(self, request_id: str) -> Dict[str, Any]:
        code, body = self._post("/disagg/fetch",
                                {"request_id": request_id})
        if code != 200:
            raise KeyError(
                f"no retained artifact {request_id!r} on "
                f"{self.base_url} ({code}: {body.get('error')})")
        return body

    def disagg_ack(self, request_id: str) -> bool:
        code, body = self._post("/disagg/ack",
                                {"request_id": request_id})
        return code == 200 and bool(body.get("acked"))

    def healthz(self):
        return self._get("/healthz")

    def load(self) -> Dict[str, Any]:
        code, body = self._get("/healthz")
        if code not in (200, 503):
            raise RuntimeError(f"healthz returned {code}")
        return body.get("load", {})

    def reload(self, model: str, ckpt_dir: str,
               step: Optional[int] = None) -> Dict[str, Any]:
        payload = {"model": model, "ckpt_dir": ckpt_dir}
        if step is not None:
            payload["step"] = step
        code, body = self._post("/admin/reload", payload)
        if code != 200:
            raise RuntimeError(f"reload failed ({code}): {body}")
        return body


def _p99_ms(samples) -> Optional[float]:
    lat = sorted(samples)
    if not lat:
        return None
    return lat[int(0.99 * (len(lat) - 1))] * 1e3


class _ReplicaState:
    __slots__ = ("name", "handle", "phase", "healthy", "draining",
                 "fails", "inflight", "last_load", "latencies", "itls")

    def __init__(self, name: str, handle, phase: str = "any"):
        self.name = name
        self.handle = handle
        self.phase = phase
        self.healthy = True
        self.draining = False
        self.fails = 0
        self.inflight = 0
        self.last_load: Dict[str, Any] = {}
        self.latencies = deque(maxlen=256)
        #: router-observed inter-token gaps (disagg decode pool SLO)
        self.itls = deque(maxlen=512)

    def view(self) -> Dict[str, Any]:
        return {"healthy": self.healthy, "draining": self.draining,
                "phase": self.phase,
                "inflight": self.inflight,
                "consecutive_failures": self.fails,
                "queue_depth": self.last_load.get("queue_depth"),
                "tokens_in_flight":
                    self.last_load.get("tokens_in_flight"),
                "ttft_p99_ms": self.last_load.get("ttft_p99_ms"),
                "router_p99_ms": _p99_ms(self.latencies),
                "itl_p99_ms": _p99_ms(self.itls)}


class _RoutedStream:
    """Wraps a replica's token stream so the router's in-flight count
    (what rolling_reload drains on) covers streams end to end."""

    def __init__(self, inner, on_end: Callable[[], None]):
        self._inner = inner
        self._on_end = on_end
        self._ended = False

    def _end(self):
        if not self._ended:
            self._ended = True
            self._on_end()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            self._end()
            raise

    def close(self):
        try:
            self._inner.close()
        finally:
            self._end()


def _flatten_ids(x) -> List[int]:
    out: List[int] = []

    def rec(v):
        if isinstance(v, (list, tuple)):
            for e in v:
                rec(e)
        else:
            out.append(int(v))
    rec(x if x is not None else [])
    return out


class _DisaggStream:
    """A routed disaggregated stream: carries the decode replica's
    in-flight guard, observes the per-pool TTFT/ITL histograms, and —
    because the prefill side retains the artifact until the clean end
    is acked — survives a decode-replica death mid-stream by
    re-ingesting on a survivor and fast-forwarding the replay (greedy
    decode is deterministic, so the replayed prefix is checked
    token-for-token; sampled streams propagate the failure instead)."""

    def __init__(self, router, decode_st, prefill_st, wire, inner,
                 t0, do_sample):
        self._router = router
        self._dst = decode_st
        self._pst = prefill_st
        self._wire = wire
        self._inner = inner
        self._t0 = t0
        self._do_sample = do_sample
        self._emitted: List[int] = []
        self._replay = 0
        self._last = None
        self._ended = False

    def __iter__(self):
        return self

    def __next__(self):
        r = self._router
        while True:
            if self._ended:
                raise StopIteration
            try:
                t = next(self._inner)
            except StopIteration:
                self._end(ack=True)
                raise
            except (OSError, urllib.error.URLError) as e:
                self._failover(e)
                continue
            except BaseException:
                self._end(ack=False)
                raise
            if self._replay:
                k = len(self._emitted) - self._replay
                if int(t) != self._emitted[k]:
                    self._end(ack=False)
                    raise RuntimeError(
                        "re-ingested decode stream diverged from the "
                        "already-emitted prefix")
                self._replay -= 1
                continue
            now = r._clock()
            if self._last is None:
                _disagg.observe_ttft("prefill", now - self._t0)
            else:
                gap = now - self._last
                _disagg.observe_itl("decode", gap)
                self._dst.itls.append(gap)
            self._last = now
            self._emitted.append(int(t))
            return int(t)

    def _failover(self, err):
        r = self._router
        dead = self._dst
        try:
            self._inner.close()
        except Exception:  # pylint: disable=broad-except
            pass
        with r._lock:
            dead.inflight -= 1
            dead.fails += 1
            if dead.fails >= r.health_fail_threshold:
                dead.healthy = False
        _ROUTER_REQS.labels(dead.name, "error").inc()
        if self._do_sample:
            # sampled decode cannot replay deterministically; surface
            # the failure (the artifact stays retained for a manual or
            # client-driven retry)
            self._ended = True
            raise err
        logger.warning(
            "router: decode replica %s died mid-stream (%s); "
            "re-ingesting the retained handoff", dead.name, err)
        r.disagg_reingests += 1
        _disagg.count_reingest("decode_died")
        wire = self._wire
        try:
            wire = self._pst.handle.disagg_fetch(wire["request_id"])
        except Exception:  # pylint: disable=broad-except
            logger.warning(
                "router: re-fetch from the prefill side failed; using "
                "the router's in-memory copy")
        dst, inner = r._disagg_ingest(self._pst, wire,
                                      exclude={dead.name})
        self._dst, self._inner = dst, inner
        self._replay = len(self._emitted)

    def _end(self, ack: bool):
        if self._ended:
            return
        self._ended = True
        with self._router._lock:
            self._dst.inflight -= 1
        if ack:
            self._dst.fails = 0
            try:
                self._pst.handle.disagg_ack(self._wire["request_id"])
            except Exception:  # pylint: disable=broad-except
                logger.warning("router: disagg ack failed for %s",
                               self._wire.get("request_id"))

    def close(self):
        try:
            self._inner.close()
        except Exception:  # pylint: disable=broad-except
            pass
        self._end(ack=True)


class Router:
    """Spread admission across replicas; see the module docstring."""

    def __init__(self, policy: Optional[str] = None,
                 shed_queue_depth: Optional[int] = None,
                 shed_ttft_ms: Optional[float] = None,
                 health_fail_threshold: Optional[int] = None,
                 autoscale_window_s: Optional[float] = None,
                 autoscale_hi_queue: Optional[float] = None,
                 autoscale_lo_queue: Optional[float] = None,
                 disagg_mode: Optional[str] = None,
                 disagg_backpressure_depth: Optional[int] = None,
                 disagg_ttft_slo_ms: Optional[float] = None,
                 disagg_itl_slo_ms: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy or global_config.router_policy
        if self.policy not in ("least_loaded", "round_robin"):
            raise ValueError(f"unknown router_policy {self.policy!r}")
        self.shed_queue_depth = (global_config.router_shed_queue_depth
                                 if shed_queue_depth is None
                                 else shed_queue_depth)
        self.shed_ttft_ms = (global_config.router_shed_ttft_ms
                             if shed_ttft_ms is None else shed_ttft_ms)
        self.health_fail_threshold = (
            global_config.router_health_fail_threshold
            if health_fail_threshold is None else health_fail_threshold)
        self.autoscale_window_s = (
            global_config.router_autoscale_window_s
            if autoscale_window_s is None else autoscale_window_s)
        self.autoscale_hi_queue = (
            global_config.router_autoscale_hi_queue
            if autoscale_hi_queue is None else autoscale_hi_queue)
        self.autoscale_lo_queue = (
            global_config.router_autoscale_lo_queue
            if autoscale_lo_queue is None else autoscale_lo_queue)
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas: "Dict[str, _ReplicaState]" = {}
        self._rr = 0
        #: autoscale callbacks — called with (router, mean_depth)
        self.on_want_more: Optional[Callable] = None
        self.on_want_fewer: Optional[Callable] = None
        self.want_more_signals = 0
        self.want_fewer_signals = 0
        self._as_samples: "deque" = deque()
        self._as_last_fire = -float("inf")
        self.sheds = 0
        # ---- disaggregated prefill/decode ----
        self.disagg_mode = (global_config.disagg_mode
                            if disagg_mode is None else disagg_mode)
        if self.disagg_mode not in ("off", "auto", "forced"):
            raise ValueError(
                f"unknown disagg_mode {self.disagg_mode!r}")
        self.disagg_backpressure_depth = (
            global_config.disagg_backpressure_depth
            if disagg_backpressure_depth is None
            else disagg_backpressure_depth)
        self.disagg_ttft_slo_ms = (
            global_config.disagg_ttft_slo_ms
            if disagg_ttft_slo_ms is None else disagg_ttft_slo_ms)
        self.disagg_itl_slo_ms = (
            global_config.disagg_itl_slo_ms
            if disagg_itl_slo_ms is None else disagg_itl_slo_ms)
        self.disagg_handoffs = 0
        self.disagg_reingests = 0
        self.disagg_backpressure_sheds = 0

    # ---- membership -------------------------------------------------

    def add_replica(self, name: str, handle,
                    phase: str = "any") -> None:
        if phase not in ("any", "prefill", "decode"):
            raise ValueError(f"unknown replica phase {phase!r}")
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = _ReplicaState(name, handle, phase)
        logger.info("router: added replica %s (phase=%s)", name, phase)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
        logger.info("router: removed replica %s", name)

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    # ---- health probing ---------------------------------------------

    def probe(self) -> Dict[str, bool]:
        """Probe every replica's ``/healthz`` once, updating rotation
        membership (call periodically, or from a prober thread)."""
        with self._lock:
            states = list(self._replicas.values())
        out = {}
        for st in states:
            try:
                code, _body = st.handle.healthz()
                ok = code == 200
            except Exception:  # pylint: disable=broad-except
                ok = False
            if ok:
                st.fails = 0
                if not st.healthy:
                    logger.info("router: replica %s recovered", st.name)
                st.healthy = True
            else:
                st.fails += 1
                if (st.healthy and
                        st.fails >= self.health_fail_threshold):
                    logger.warning(
                        "router: replica %s dropped after %d failed "
                        "probes", st.name, st.fails)
                    st.healthy = False
            out[st.name] = st.healthy
        return out

    # ---- placement --------------------------------------------------

    def _refresh_load(self, st: _ReplicaState) -> None:
        try:
            st.last_load = st.handle.load() or {}
        except Exception:  # pylint: disable=broad-except
            st.last_load = {}
        qd = st.last_load.get("queue_depth")
        if qd is not None:
            _ROUTER_QDEPTH.labels(st.name).set(int(qd))

    def _saturated(self, st: _ReplicaState) -> bool:
        qd = st.last_load.get("queue_depth") or 0
        if self.shed_queue_depth and \
                qd + st.inflight > self.shed_queue_depth:
            return True
        p99 = st.last_load.get("ttft_p99_ms")
        if self.shed_ttft_ms and p99 is not None and \
                p99 > self.shed_ttft_ms:
            return True
        return False

    def _score(self, st: _ReplicaState) -> float:
        load = st.last_load
        return (2.0 * (load.get("queue_depth") or 0) +
                2.0 * st.inflight +
                0.01 * (load.get("tokens_in_flight") or 0) +
                0.001 * (load.get("ttft_p99_ms") or 0.0))

    def _slo_violated(self, st: _ReplicaState, phase: str) -> bool:
        """Phase SLO steer: prefer replicas inside their pool's SLO
        (router-observed TTFT p99 for prefill, inter-token p99 for
        decode).  A steer, not a shed — when every candidate violates,
        least-loaded placement still proceeds."""
        if phase == "prefill" and self.disagg_ttft_slo_ms:
            p99 = _p99_ms(st.latencies)
            return p99 is not None and p99 > self.disagg_ttft_slo_ms
        if phase == "decode" and self.disagg_itl_slo_ms:
            p99 = _p99_ms(st.itls)
            return p99 is not None and p99 > self.disagg_itl_slo_ms
        return False

    def _pick(self, exclude,
              phase: Optional[str] = None) -> Optional[_ReplicaState]:
        with self._lock:
            cands = [st for st in self._replicas.values()
                     if st.healthy and not st.draining
                     and st.name not in exclude
                     and (phase is None or
                          st.phase in ("any", phase))]
        for st in cands:
            self._refresh_load(st)
        cands = [st for st in cands if not self._saturated(st)]
        if phase is not None and cands:
            inside_slo = [st for st in cands
                          if not self._slo_violated(st, phase)]
            cands = inside_slo or cands
        if not cands:
            return None
        if self.policy == "round_robin":
            with self._lock:
                self._rr += 1
                return cands[self._rr % len(cands)]
        return min(cands, key=self._score)

    # ---- request paths ----------------------------------------------

    def submit(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Route one completion request, failing over across replicas.
        Raises ServiceDegradedError (HTTP 503) only when no routable
        replica remains un-saturated."""
        if self._disagg_active():
            stream = self._submit_disagg_stream(request)
            toks = list(stream)
            return {"output_ids":
                    [_flatten_ids(request.get("prompt_ids")) + toks]}
        excluded: set = set()
        self._observe_autoscale()
        while True:
            st = self._pick(excluded)
            if st is None:
                self.sheds += 1
                _ROUTER_REQS.labels("none", "shed").inc()
                raise fault.ServiceDegradedError(
                    "no replica can take the request (all saturated, "
                    "draining, or unhealthy)")
            with self._lock:
                st.inflight += 1
            tic = self._clock()
            try:
                out = st.handle.completions(request)
            except fault.ServiceDegradedError:
                # THIS replica sheds; others may still have room
                _ROUTER_REQS.labels(st.name, "shed").inc()
                excluded.add(st.name)
                continue
            except (OSError, urllib.error.URLError) as e:
                # transport-level failure: count toward health, fail over
                _ROUTER_REQS.labels(st.name, "error").inc()
                with self._lock:
                    st.fails += 1
                    if st.fails >= self.health_fail_threshold:
                        st.healthy = False
                logger.warning("router: replica %s errored (%s); "
                               "failing over", st.name, e)
                excluded.add(st.name)
                continue
            except Exception:
                # request-level error (bad model, bad payload): the
                # client's fault — do not burn other replicas on it
                _ROUTER_REQS.labels(st.name, "error").inc()
                raise
            finally:
                with self._lock:
                    st.inflight -= 1
            st.fails = 0
            st.latencies.append(self._clock() - tic)
            _ROUTER_REQS.labels(st.name, "ok").inc()
            return out

    def submit_stream(self, request: Dict[str, Any]):
        """Route a streaming request (local or HTTP replicas).  The
        stream counts as in-flight until exhausted or closed, so rolling
        deploys drain it before touching its replica."""
        if self._disagg_active():
            return self._submit_disagg_stream(request)
        self._observe_autoscale()
        st = self._pick(set())
        if st is None:
            self.sheds += 1
            _ROUTER_REQS.labels("none", "shed").inc()
            raise fault.ServiceDegradedError(
                "no replica can take the stream")
        with self._lock:
            st.inflight += 1
        try:
            inner = st.handle.completions_stream(request)
        except BaseException:
            with self._lock:
                st.inflight -= 1
            _ROUTER_REQS.labels(st.name, "error").inc()
            raise
        _ROUTER_REQS.labels(st.name, "ok").inc()

        def on_end():
            with self._lock:
                st.inflight -= 1
        return _RoutedStream(inner, on_end)

    # ---- disaggregated prefill/decode -------------------------------

    def _disagg_active(self) -> bool:
        """Whether requests take the split prefill/decode path.
        ``off`` short-circuits before touching any disagg state, so the
        monolithic path is byte-identical to a router without this
        feature."""
        mode = self.disagg_mode
        if mode == "off":
            return False
        if mode == "forced":
            return True
        with self._lock:
            phases = {st.phase for st in self._replicas.values()
                      if st.healthy}
        return "prefill" in phases and "decode" in phases

    def _decode_pool_depth(self) -> int:
        with self._lock:
            sts = [st for st in self._replicas.values()
                   if st.healthy and st.phase in ("any", "decode")]
        depth = 0
        for st in sts:
            self._refresh_load(st)
            depth += (st.last_load.get("queue_depth") or 0) + \
                st.inflight
        return depth

    def _submit_disagg_stream(self, request: Dict[str, Any]):
        self._observe_autoscale()
        # decode-pool backpressure throttles PREFILL admission: work
        # already prefilled is never dropped, new work sheds up front
        depth = self._decode_pool_depth()
        if self.disagg_backpressure_depth and \
                depth > self.disagg_backpressure_depth:
            self.sheds += 1
            self.disagg_backpressure_sheds += 1
            _disagg.count_backpressure_shed()
            _ROUTER_REQS.labels("none", "shed").inc()
            raise fault.ServiceDegradedError(
                f"decode pool backpressure (depth {depth} > "
                f"{self.disagg_backpressure_depth}); prefill admission "
                f"throttled")
        t0 = self._clock()
        pst, wire = self._disagg_prefill(request)
        handoff_t0 = self._clock()
        dst, inner = self._disagg_ingest(pst, wire)
        _disagg.observe_handoff(self._clock() - handoff_t0)
        self.disagg_handoffs += 1
        return _DisaggStream(self, dst, pst, wire, inner, t0,
                             bool(request.get("do_sample")))

    def _disagg_prefill(self, request: Dict[str, Any]):
        """Run the prefill phase with the same failover taxonomy as
        :meth:`submit`; returns (replica_state, artifact wire dict)."""
        excluded: set = set()
        while True:
            st = self._pick(excluded, phase="prefill")
            if st is None:
                self.sheds += 1
                _ROUTER_REQS.labels("none", "shed").inc()
                raise fault.ServiceDegradedError(
                    "no prefill replica can take the request")
            with self._lock:
                st.inflight += 1
            tic = self._clock()
            try:
                wire = st.handle.prefill(request)
            except fault.ServiceDegradedError:
                _ROUTER_REQS.labels(st.name, "shed").inc()
                excluded.add(st.name)
                continue
            except (OSError, urllib.error.URLError) as e:
                _ROUTER_REQS.labels(st.name, "error").inc()
                with self._lock:
                    st.fails += 1
                    if st.fails >= self.health_fail_threshold:
                        st.healthy = False
                logger.warning(
                    "router: prefill replica %s errored (%s); failing "
                    "over", st.name, e)
                excluded.add(st.name)
                continue
            except Exception:
                _ROUTER_REQS.labels(st.name, "error").inc()
                raise
            finally:
                with self._lock:
                    st.inflight -= 1
            st.fails = 0
            st.latencies.append(self._clock() - tic)
            return st, wire

    def _disagg_ingest(self, pst: _ReplicaState, wire: Dict[str, Any],
                       exclude=()):
        """Ingest the handoff on the decode pool.  A corrupt artifact
        is re-fetched from the prefill side's retained copy (never
        silently decoded); a dead decode replica is health-counted and
        the handoff re-ingests on a survivor."""
        excluded: set = set(exclude)
        refetches = 0
        while True:
            st = self._pick(excluded, phase="decode")
            if st is None:
                self.sheds += 1
                _ROUTER_REQS.labels("none", "shed").inc()
                raise fault.ServiceDegradedError(
                    "no decode replica can ingest the handoff")
            with self._lock:
                st.inflight += 1
            try:
                inner = st.handle.ingest(wire)
            except _disagg.ArtifactCorruptError:
                with self._lock:
                    st.inflight -= 1
                self.disagg_reingests += 1
                _disagg.count_reingest("corrupt")
                if refetches >= 2:
                    raise
                refetches += 1
                logger.warning(
                    "router: decode replica %s rejected corrupt "
                    "handoff %s; re-fetching the retained artifact",
                    st.name, wire.get("request_id"))
                wire = pst.handle.disagg_fetch(wire["request_id"])
                continue
            except fault.ServiceDegradedError:
                with self._lock:
                    st.inflight -= 1
                _ROUTER_REQS.labels(st.name, "shed").inc()
                excluded.add(st.name)
                continue
            except (OSError, urllib.error.URLError) as e:
                with self._lock:
                    st.inflight -= 1
                    st.fails += 1
                    if st.fails >= self.health_fail_threshold:
                        st.healthy = False
                _ROUTER_REQS.labels(st.name, "error").inc()
                self.disagg_reingests += 1
                _disagg.count_reingest("replica_failed")
                logger.warning(
                    "router: decode replica %s failed ingest (%s); "
                    "re-ingesting on a survivor", st.name, e)
                excluded.add(st.name)
                continue
            except Exception:
                with self._lock:
                    st.inflight -= 1
                _ROUTER_REQS.labels(st.name, "error").inc()
                raise
            _ROUTER_REQS.labels(st.name, "ok").inc()
            return st, inner

    # ---- rolling deploys --------------------------------------------

    def rolling_reload(self, model: str, ckpt_dir: str,
                       step: Optional[int] = None,
                       drain_timeout: float = 30.0) -> List[Dict]:
        """Hot-swap ``model`` on every replica, ONE replica at a time:
        stop placing on it, wait out its router-tracked in-flight work,
        reload through the replica's ``/admin/reload`` drain barrier,
        re-probe, restore.  With >= 2 replicas traffic keeps flowing the
        whole time (zero failed requests; tests/test_torch_router.py
        holds it)."""
        with self._lock:
            names = sorted(self._replicas)
        if len(names) < 2:
            logger.warning(
                "rolling reload over %d replica(s): requests arriving "
                "mid-swap will shed", len(names))
        results = []
        for name in names:
            with self._lock:
                st = self._replicas.get(name)
            if st is None:
                continue
            st.draining = True
            try:
                deadline = self._clock() + drain_timeout
                while st.inflight > 0 and self._clock() < deadline:
                    time.sleep(0.005)
                if st.inflight > 0:
                    logger.warning(
                        "replica %s still has %d in-flight after "
                        "%.0fs; its own drain barrier takes over",
                        name, st.inflight, drain_timeout)
                res = st.handle.reload(model, ckpt_dir, step=step)
                code, _ = st.handle.healthz()
                if code != 200:
                    st.fails = self.health_fail_threshold
                    st.healthy = False
                    raise RuntimeError(
                        f"replica {name} unhealthy after reload "
                        f"(healthz {code})")
                results.append({"replica": name, **res})
            finally:
                st.draining = False
        return results

    # ---- autoscale hooks --------------------------------------------

    def _observe_autoscale(self) -> None:
        with self._lock:
            states = [st for st in self._replicas.values() if st.healthy]
            n = max(1, len(states))
            depth = sum((st.last_load.get("queue_depth") or 0) +
                        st.inflight for st in states) / n
        now = self._clock()
        self._as_samples.append((now, depth))
        self.evaluate_autoscale(now)

    def evaluate_autoscale(self, now: Optional[float] = None) -> Optional[str]:
        """Fire ``on_want_more`` when the mean per-replica queue depth
        stayed above ``router_autoscale_hi_queue`` for a full window,
        ``on_want_fewer`` when it stayed below the lo threshold.  At
        most one signal per window.  Returns the signal fired (or
        None) so pollers can act without registering callbacks."""
        now = self._clock() if now is None else now
        w = self.autoscale_window_s
        while self._as_samples and self._as_samples[0][0] < now - 2 * w:
            self._as_samples.popleft()
        window = [d for (t, d) in self._as_samples if t >= now - w]
        if len(window) < 2 or not self._as_samples or \
                self._as_samples[0][0] > now - w:
            return None  # window not yet covered
        if now - self._as_last_fire < w:
            return None  # rate limit: one signal per window
        signal = None
        if min(window) > self.autoscale_hi_queue:
            signal = "want_more"
            self.want_more_signals += 1
            cb = self.on_want_more
        elif max(window) < self.autoscale_lo_queue:
            signal = "want_fewer"
            self.want_fewer_signals += 1
            cb = self.on_want_fewer
        else:
            return None
        self._as_last_fire = now
        mean = sum(window) / len(window)
        logger.info("router autoscale: %s (mean depth %.1f over %.0fs)",
                    signal, mean, w)
        if cb is not None:
            try:
                cb(self, mean)
            except Exception:  # pylint: disable=broad-except
                logger.exception("autoscale callback failed")
        return signal

    # ---- introspection ----------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Per-replica health/load view (the ``/healthz`` body of
        RouterServer)."""
        with self._lock:
            states = list(self._replicas.values())
        routable = [st for st in states
                    if st.healthy and not st.draining]
        return {"status": "ok" if routable else "degraded",
                "policy": self.policy,
                "replicas": {st.name: st.view() for st in states},
                "sheds": self.sheds,
                "want_more_signals": self.want_more_signals,
                "want_fewer_signals": self.want_fewer_signals,
                "disagg": {
                    "mode": self.disagg_mode,
                    "active": self._disagg_active(),
                    "pools": {ph: sorted(st.name for st in states
                                         if st.phase == ph)
                              for ph in ("prefill", "decode", "any")},
                    "handoffs": self.disagg_handoffs,
                    "reingests": self.disagg_reingests,
                    "backpressure_sheds":
                        self.disagg_backpressure_sheds}}


class _RouterHandler(BaseHTTPRequestHandler):
    router: Router = None  # set by RouterServer

    def log_message(self, fmt, *args):  # quiet
        logger.debug(fmt, *args)

    def _send(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            snap = self.router.snapshot()
            self._send(503 if snap["status"] == "degraded" else 200,
                       snap)
        elif self.path == "/metrics":
            import alpa_tpu_torch.monitoring  # noqa: F401  pylint: disable=unused-import
            import alpa_tpu_torch.serve.kv_cache  # noqa: F401  pylint: disable=unused-import
            text = _tmetrics.get_registry().to_prometheus_text()
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            request = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/admin/rolling_reload":
                name = request.get("model")
                ckpt_dir = request.get("ckpt_dir")
                if not name or not ckpt_dir:
                    raise ValueError(
                        "rolling_reload needs 'model' and 'ckpt_dir'")
                step = request.get("step")
                out = self.router.rolling_reload(
                    name, ckpt_dir,
                    step=None if step is None else int(step))
                self._send(200, {"reloads": out})
                return
            if self.path != "/completions":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            if request.get("stream"):
                self._stream(request)
                return
            self._send(200, self.router.submit(request))
        except fault.ServiceDegradedError as e:
            self._send(503, {"error": str(e)})
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
        except Exception as e:  # pylint: disable=broad-except
            logger.exception("router request failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def _stream(self, request):
        it = self.router.submit_stream(request)  # validates/places
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            try:
                for t in it:
                    self.wfile.write(
                        f"data: {json.dumps({'token': t})}\n\n".encode())
                    self.wfile.flush()
                final = {"done": True}
            except (BrokenPipeError, ConnectionResetError):
                it.close()
                return
            except Exception as e:  # pylint: disable=broad-except
                logger.exception("routed stream failed mid-generation")
                final = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            it.close()
        finally:
            self.close_connection = True


class RouterServer:
    """HTTP front end over a Router (mirror of ControllerServer)."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0):
        handler = type("BoundRouterHandler", (_RouterHandler,),
                       {"router": router})
        self.httpd = _HTTPServer((host, port), handler)
        self.router = router
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self):
        self.thread.start()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
