"""HTTP serving controller (counterpart of ``alpa_tpu/serve/controller.py``).

A ``ThreadingHTTPServer`` front end, a registry of named models with
round-robin replica dispatch, and per replica a ``RequestBatcher`` that
coalesces concurrent requests into one mixed-length ``Generator.generate``
call, and a continuous-batching engine (``serve.engine``) built at the
first streamed request, which serves every streamed request.

Endpoints:
  GET  /models       -> {"models": [...]}
  GET  /health       -> {"status": "ok" | "shedding"} (503 when shedding)
  GET  /healthz      -> the health report with ``last_flight_dump``, the
        path of the flight recorder's last post-mortem (null for none)
  GET  /metrics      -> the process registry's Prometheus text
  POST /completions  -> {"model", "prompt_ids", "max_new_tokens"?,
        "temperature"?, "top_k"?, "do_sample"?, "eos_token_id"?,
        "queue"?, "stream"?}
        => {"output_ids": [[...]]}, or with "stream": true server-sent
        events, one ``data: {"token": t}`` per token, then
        ``data: {"done": true}`` (or ``data: {"error": ...}``).

The batcher and the controller keep JAX's ``alpa_serving_*`` families and
``serve.request`` / ``batcher.generate`` spans.  Not ported yet: fault
sites, the batcher's degraded FIFO fallback, disaggregation, hot swap and
the router.
"""
import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.serve.engine import ContinuousBatchingEngine
from alpa_tpu_torch.serve.generation import (GenerationConfig, Generator,
                                             get_model)
from alpa_tpu_torch.serve.kv_cache import KVBlockPool
from alpa_tpu_torch.serve.scheduler import FIFOQueue
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)

_REG = _tmetrics.get_registry()
_QUEUE_DEPTH = _REG.gauge(
    "alpa_serving_queue_depth", "Requests waiting in the batcher queue")
_BATCH_SIZE = _REG.histogram(
    "alpa_serving_batch_size", "Prompts per batched generate call",
    buckets=(1, 2, 4, 8, 16, 32, 64))
_BATCHES = _REG.counter(
    "alpa_serving_batches_total", "Batched generate calls executed")
_REQUESTS = _REG.counter(
    "alpa_serving_requests_total", "Completion requests by outcome",
    labelnames=("outcome",))
_REQ_LATENCY = _REG.histogram(
    "alpa_serving_request_seconds",
    "End-to-end /completions latency (batched path)")


class ServiceDegradedError(RuntimeError):
    """The controller is shedding load; maps to HTTP 503."""


class RequestBatcher:
    """Groups concurrent completion requests into ONE mixed-length batched
    ``Generator.generate`` call.  Requests arriving while the device is
    busy queue up and ride the next batch.  Only requests with identical
    sampling settings share a batch; ``max_new_tokens`` may differ (the
    batch runs to the max, each request is truncated to its own).

    ``prefix``: a shared system prompt's ``PrefixHandle``; prompts are then
    suffixes over it.  ``scheduler``: the admission policy
    (``serve.scheduler``; FIFO by default)."""

    def __init__(self, generator: Generator, max_batch: int = 8,
                 max_wait_ms: float = 2.0, prefix=None, scheduler=None):
        self.generator = generator
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.prefix = prefix
        if scheduler is None:
            scheduler = FIFOQueue()
        for method in ("append", "take", "drain", "__len__"):
            if not hasattr(scheduler, method):
                # fail at registration: a protocol gap inside the worker
                # thread would kill it and hang every submit()
                raise TypeError(
                    f"scheduler {type(scheduler).__name__} lacks "
                    f"{method}(); see serve.scheduler's queue protocol")
        self._queue = scheduler
        self._cv = threading.Condition()
        self.batches_run = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def shutdown(self):
        """Stop the worker thread (it holds the generator and its weights)
        after its current batch; queued requests fail."""
        with self._cv:
            self._stop = True
            self._cv.notify()

    def submit(self, prompts: List[np.ndarray], cfg: GenerationConfig,
               queue: Optional[str] = None) -> List[np.ndarray]:
        item = {"prompts": prompts, "cfg": cfg,
                "done": threading.Event(), "result": None, "error": None,
                "queue": queue or "default"}
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher shut down")
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    @staticmethod
    def _group_key(cfg: GenerationConfig):
        return (cfg.do_sample, cfg.temperature, cfg.top_k,
                cfg.eos_token_id)

    def _take_batch(self) -> List[Dict]:
        """Selective take in queue order: the head item picks the
        sampling-settings group and compatible items join; skipped items
        keep their place."""
        state = {"key": None, "n": 0}

        def selector(item):
            if state["key"] is None:
                state["key"] = self._group_key(item["cfg"])
            fits = state["n"] + len(item["prompts"]) <= self.max_batch
            # an oversized request runs alone rather than starving
            if (self._group_key(item["cfg"]) == state["key"]
                    and (fits or state["n"] == 0)):
                state["n"] += len(item["prompts"])
                return "take"
            if state["n"] >= self.max_batch:
                return "stop"
            return "skip"

        return self._queue.take(selector)

    def _run(self):
        while True:
            with self._cv:
                while len(self._queue) == 0 and not self._stop:
                    self._cv.wait()
                if self._stop:
                    err = RuntimeError("batcher shut down")
                    for item in self._queue.drain():
                        item["error"] = err
                        item["done"].set()
                    return
            # a small window lets concurrent arrivals coalesce
            time.sleep(self.max_wait_s)
            with self._cv:
                batch = self._take_batch()
                _QUEUE_DEPTH.set(len(self._queue))
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[Dict]):
        try:
            prompts = [p for it in batch for p in it["prompts"]]
            run_cfg = dataclasses.replace(
                batch[0]["cfg"],
                max_new_tokens=max(it["cfg"].max_new_tokens
                                   for it in batch))
            _BATCH_SIZE.observe(len(prompts))
            with _ttrace.span("batcher.generate", "serving",
                              {"prompts": len(prompts),
                               "max_new_tokens": run_cfg.max_new_tokens}
                              if _ttrace.enabled() else None,
                              "serve-batcher"):
                outs = self.generator.generate(prompts, run_cfg,
                                               prefix=self.prefix)
            self.batches_run += 1
            _BATCHES.inc()
            i = 0
            for it in batch:
                rows = []
                for j, p in enumerate(it["prompts"]):
                    rows.append(outs[i + j][:len(p) +
                                            it["cfg"].max_new_tokens])
                it["result"] = rows
                i += len(it["prompts"])
        except Exception as e:  # pylint: disable=broad-except
            # the worker must outlive a failed batch: report it to every
            # waiting request instead of dying with their events unset
            logger.exception("batched generate failed")
            for it in batch:
                it["error"] = e
        for it in batch:
            it["done"].set()


class _Replica:
    """One replica of a model: its batcher and, built at the first streamed
    request, its continuous-batching engine."""

    def __init__(self, generator: Generator, prefix=None,
                 scheduler_factory=None, warm_prefix_ids=None):
        self.generator = generator
        self.batcher = RequestBatcher(
            generator, prefix=prefix,
            scheduler=scheduler_factory() if scheduler_factory else None)
        self.prefix = prefix
        self.scheduler_factory = scheduler_factory
        # the system prompt warmed into the paged prefix index when the
        # engine is built (kv_paged + kv_prefix_reuse)
        self.warm_prefix_ids = warm_prefix_ids
        self._engine = None
        self._lock = threading.Lock()

    @property
    def engine(self) -> ContinuousBatchingEngine:
        """The streaming engine, built at first use, so that a deployment
        that never streams runs no decode thread.  With a prefix, streamed
        prompt_ids are suffixes over it, unless ``kv_paged`` and
        ``kv_prefix_reuse`` are on: the prefix is then warmed into the
        engine's block pool and requests send full prompts (any shared
        token prefix hits)."""
        with self._lock:
            if self._engine is None:
                sched = (self.scheduler_factory()
                         if self.scheduler_factory else None)
                pool = None
                if global_config.kv_paged:
                    if self.prefix is not None:
                        logger.warning(
                            "kv_paged with a static PrefixHandle "
                            "(kv_prefix_reuse=off): the replica keeps the "
                            "unpaged suffix engine")
                    else:
                        pool = KVBlockPool.for_generator(self.generator)
                self._engine = ContinuousBatchingEngine(
                    self.generator,
                    prompt_bucket=self.generator.prompt_buckets[-1],
                    prefix=None if pool is not None else self.prefix,
                    scheduler=sched, kv_pool=pool)
                if pool is not None and self.warm_prefix_ids is not None:
                    pool.warm_prefix(self.generator, self.warm_prefix_ids)
            return self._engine

    def shutdown(self):
        self.batcher.shutdown()
        with self._lock:
            if self._engine is not None:
                self._engine.shutdown()


class Controller:
    """Model registry + dispatch.  ``device`` is the default device for
    models registered by name or config (``None`` -> CUDA)."""

    def __init__(self, device=None):
        self.device = device
        self._models: Dict[str, List[_Replica]] = {}
        self._rr: Dict[str, int] = {}
        self._prefix_ids: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._health = "ok"
        self._health_reason: Optional[str] = None

    def set_health(self, state: str, reason: Optional[str] = None):
        """"ok" serves; "shedding" rejects new requests with 503."""
        if state not in ("ok", "shedding"):
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            self._health, self._health_reason = state, reason

    def health_report(self) -> Dict[str, Any]:
        with self._lock:
            report = {"status": self._health}
            if self._health_reason:
                report["reason"] = self._health_reason
        return report

    def register_model(self, name: str, generator, prefix_ids=None,
                       scheduler_factory=None, device=None) -> Generator:
        """Add a replica of model ``name``.  ``generator`` is a
        ``Generator``, or a ladder name / ``GPTConfig`` built with random
        weights by ``get_model`` on ``device`` (default: the controller's
        device).

        ``prefix_ids``: a shared system prompt.  By default (``kv_paged``
        or ``kv_prefix_reuse`` off) its KV is computed once
        (``Generator.cache_prefix``, which needs the generator's chunked
        prefill) and every request to the model, batched or streamed,
        sends only its suffix; all replicas of a model must then share
        one prefix.  With ``kv_paged`` and ``kv_prefix_reuse`` on, the
        prefix is warmed into each replica's block pool instead, requests
        send full prompts, and any shared token prefix hits.

        ``scheduler_factory``: builds the replica's admission policy
        (``serve.scheduler``), one for the batcher and one for the engine;
        a request's ``"queue"`` field names its queue."""
        if not isinstance(generator, Generator):
            generator = get_model(
                generator, device=self.device if device is None else device)
        prefix_ids = (None if prefix_ids is None
                      else np.asarray(prefix_ids, np.int32).reshape(-1))
        if global_config.kv_paged and global_config.kv_prefix_reuse:
            # prompt_ids are always full prompts: no one-prefix rule
            with self._lock:
                self._models.setdefault(name, []).append(_Replica(
                    generator, scheduler_factory=scheduler_factory,
                    warm_prefix_ids=prefix_ids))
                self._rr.setdefault(name, 0)
            logger.info("registered model %s (%d replicas, paged KV)", name,
                        len(self._models[name]))
            return generator

        def check_consistent():
            prev = self._prefix_ids[name]
            same = ((prev is None and prefix_ids is None) or
                    (prev is not None and prefix_ids is not None and
                     np.array_equal(prev, prefix_ids)))
            if not same:
                raise ValueError(
                    f"model {name!r} replicas must share one prefix: an "
                    "inconsistent replica would make identical requests "
                    "mean different prompts")

        # check, compute the prefix outside the lock, then check again and
        # commit: a failing cache_prefix must not pin the name to a prefix
        with self._lock:
            if name in self._prefix_ids:
                check_consistent()
        prefix = None
        if prefix_ids is not None:
            prefix = generator.cache_prefix(prefix_ids)
        with self._lock:
            if name in self._prefix_ids:
                check_consistent()
            else:
                self._prefix_ids[name] = prefix_ids
            self._models.setdefault(name, []).append(_Replica(
                generator, prefix=prefix,
                scheduler_factory=scheduler_factory))
            self._rr.setdefault(name, 0)
        logger.info("registered model %s (%d replicas)", name,
                    len(self._models[name]))
        return generator

    def list_models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def _pick_replica(self, name: str) -> _Replica:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}; "
                               f"registered: {sorted(self._models)}")
            replicas = self._models[name]
            i = self._rr[name] % len(replicas)
            self._rr[name] += 1
        return replicas[i]

    def _parse_request(self, request: Dict[str, Any]):
        """(replica, prompt_ids, cfg, queue), one parser for the streamed
        and the batched path.  Sheds load first."""
        with self._lock:
            state, reason = self._health, self._health_reason
        if state == "shedding":
            raise ServiceDegradedError(
                f"service unavailable: {reason or 'shedding load'}")
        replica = self._pick_replica(request["model"])
        prompt_ids = np.asarray(request["prompt_ids"], np.int64)
        queue = request.get("queue")
        if queue is not None and (not isinstance(queue, str) or
                                  len(queue) > 64):
            # untrusted input headed for scheduler dict keys
            raise ValueError("queue must be a string of <= 64 chars")
        cfg = GenerationConfig(
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 1.0)),
            top_k=int(request.get("top_k", 0)),
            do_sample=bool(request.get("do_sample", False)),
            eos_token_id=request.get("eos_token_id"))
        return replica, prompt_ids, cfg, queue

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        tic = time.monotonic()
        try:
            with _ttrace.span("serve.request", "serving",
                              {"model": str(request.get("model"))}
                              if _ttrace.enabled() else None,
                              "serve-driver"):
                replica, prompt_ids, cfg, queue = \
                    self._parse_request(request)
                if prompt_ids.ndim == 1:
                    prompt_ids = prompt_ids[None]
                outs = replica.batcher.submit(list(prompt_ids), cfg,
                                              queue=queue)
        except ServiceDegradedError:
            _REQUESTS.labels("shed").inc()
            raise
        except Exception:
            _REQUESTS.labels("error").inc()
            raise
        _REQUESTS.labels("ok").inc()
        _REQ_LATENCY.observe(time.monotonic() - tic)
        return {"output_ids": [o.tolist() for o in outs]}

    def completions_stream(self, request: Dict[str, Any]):
        """Token iterator of a one-prompt streamed request, on the
        replica's continuous-batching engine.  Yields ints; the full row is
        prompt + the yielded tokens."""
        replica, prompt_ids, cfg, queue = self._parse_request(request)
        if prompt_ids.ndim > 1 and prompt_ids.shape[0] != 1:
            raise ValueError(
                "streaming accepts exactly one prompt per request; got "
                f"{prompt_ids.shape[0]} rows")
        return replica.engine.submit_stream(prompt_ids.reshape(-1), cfg,
                                            queue=queue)

    def shutdown(self):
        """Stop every replica's batcher and engine threads (pending
        requests fail)."""
        with self._lock:
            replicas = [r for reps in self._models.values() for r in reps]
        for rep_ in replicas:
            rep_.shutdown()


class _Handler(BaseHTTPRequestHandler):
    controller: Controller = None  # bound by ControllerServer

    def log_message(self, fmt, *args):  # quiet
        logger.debug(fmt, *args)

    def _send(self, code: int, payload: Dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str):
        body = text.encode()
        self.send_response(code)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _metrics(self):
        """The whole process registry as Prometheus text; the serving and
        KV families register when their modules load, which the
        controller's imports guarantee."""
        self._send_text(200, _tmetrics.get_registry().to_prometheus_text())

    def _healthz(self):
        """The health report with ``last_flight_dump``: where the flight
        recorder's last post-mortem landed (null when none was written)."""
        from alpa_tpu_torch.telemetry import flight as _flight
        report = self.controller.health_report()
        report["last_flight_dump"] = _flight.last_dump_path()
        self._send(503 if report["status"] == "shedding" else 200, report)

    def do_GET(self):
        if self.path == "/health":
            report = self.controller.health_report()
            self._send(503 if report["status"] == "shedding" else 200,
                       report)
        elif self.path == "/healthz":
            self._healthz()
        elif self.path == "/metrics":
            self._metrics()
        elif self.path == "/models":
            self._send(200, {"models": self.controller.list_models()})
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/completions":
            self._send(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            request = json.loads(self.rfile.read(length) or b"{}")
            if request.get("stream"):
                self._stream(request)
                return
            self._send(200, self.controller.completions(request))
        except ServiceDegradedError as e:
            self._send(503, {"error": str(e)})
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except (json.JSONDecodeError, ValueError, AssertionError,
                TypeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
        except Exception as e:  # pylint: disable=broad-except
            logger.exception("completions failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})


    def _stream(self, request):
        """Server-sent events: one ``data: {"token": t}`` per generated
        token, then ``data: {"done": true}``; close-delimited (no
        Content-Length, Connection: close).  The request is validated
        before the headers go out, so a bad one still gets its JSON error
        status; once streaming has begun a failure is reported as a final
        ``data: {"error": ...}`` event."""
        it = self.controller.completions_stream(request)  # validates
        self._stream_body(it)

    def _stream_body(self, it):
        """Write an already validated token iterator as SSE."""
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
                logger.info("stream client disconnected")
                it.close()  # flags the engine row cancelled
                return
            except Exception as e:  # pylint: disable=broad-except
                logger.exception("stream failed mid-generation")
                final = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            logger.info("stream client disconnected at finish")
            it.close()
        finally:
            self.close_connection = True


class _HTTPServer(ThreadingHTTPServer):
    # the standard library listens with a backlog of 5, which refuses a
    # burst of more concurrent clients than that
    request_queue_size = 128


class ControllerServer:
    """The running HTTP server."""

    def __init__(self, controller: Controller, host: str, port: int):
        handler = type("BoundHandler", (_Handler,),
                       {"controller": controller})
        self.httpd = _HTTPServer((host, port), handler)
        self.controller = controller
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
        self.controller.shutdown()


def run_controller(host: str = "127.0.0.1", port: int = 8000,
                   device=None) -> ControllerServer:
    """Create and start a controller server.  ``device`` is the default
    device of models registered by name or config (``None`` -> CUDA)."""
    server = ControllerServer(Controller(device=device), host, port)
    server.start()
    return server
