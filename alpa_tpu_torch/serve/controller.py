"""HTTP serving controller (counterpart of ``alpa_tpu/serve/controller.py``).

A ``ThreadingHTTPServer`` front end, a registry of named models with
round-robin replica dispatch, and per replica a ``RequestBatcher`` that
coalesces concurrent requests into one mixed-length ``Generator.generate``
call, and a continuous-batching engine (``serve.engine``) built at the
first streamed request, which serves every streamed request.

Endpoints:
  GET  /models       -> {"models": [...]}
  GET  /health       -> {"status": "ok" | "degraded" | "shedding"} (503
        when shedding)
  GET  /healthz      -> the recovery state when a ``RecoveryManager`` is
        attached (200 healthy/suspect/recovering, 503 degraded), else the
        health report; with ``last_flight_dump`` (the flight recorder's
        last post-mortem, null for none) and ``elastic`` (the
        ``ElasticSupervisor``'s report, null without one)
  GET  /metrics      -> the process registry's Prometheus text
  POST /disagg/prefill -> the body of /completions; => the KV handoff
        artifact's wire JSON (``serve.disagg``)
  POST /disagg/ingest  -> an artifact's wire JSON; => the SSE token stream
        of the request joining the decode batch (422 for a corrupt
        artifact)
  POST /disagg/fetch | /disagg/ack -> {"request_id"}: a retained
        artifact, again / released
  POST /admin/reload -> {"model", "ckpt_dir", "step"?}: stage and
        hash-verify a checkpoint's weights, then swap every replica of
        the model under a drain barrier (``checkpoint.hot_swap``); 409
        when streams outlive the drain window (weights unchanged)
  POST /completions  -> {"model", "prompt_ids", "max_new_tokens"?,
        "temperature"?, "top_k"?, "do_sample"?, "eos_token_id"?,
        "queue"?, "stream"?}
        => {"output_ids": [[...]]}, or with "stream": true server-sent
        events, one ``data: {"token": t}`` per token, then
        ``data: {"done": true}`` (or ``data: {"error": ...}``).

The batcher and the controller keep JAX's ``alpa_serving_*`` families and
``serve.request`` / ``batcher.generate`` spans.  Faults, as in JAX: the
batcher fires ``scheduler_take`` before it forms a batch, and a
scheduler (or an injected fault) that raises there demotes the batcher
to a fresh FIFO queue with every queued request carried over (health
"degraded": serving goes on, the policy is lost).  A bound
``RecoveryManager`` (``attach_recovery``) turns DEGRADED into load
shedding: new requests get ``fault.ServiceDegradedError``, HTTP 503,
until recovery clears it.  Disaggregated prefill and decode (the
``/disagg/*`` endpoints, ``serve/disagg.py``) and the multi-replica router
(``serve/router.py``) build on this controller.
"""
import dataclasses
import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from alpa_tpu_torch import fault as _fault
from alpa_tpu_torch.fault import ServiceDegradedError
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.serve import disagg as _disagg
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
        # the drain barrier of a hot weight swap: the worker holds it
        # while a batch runs on the device, so whoever else takes it
        # (``_Replica.swap_weights``) knows no batch is mid-flight
        self._gen_lock = threading.Lock()
        self.batches_run = 0
        # degraded mode: a broken scheduler demotes this batcher to a
        # fresh FIFO queue instead of failing the queued requests
        self.degraded = False
        self.degraded_reason: Optional[str] = None
        self.on_degraded = None       # callback(exc), set by _Replica
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
                try:
                    _fault.fire("scheduler_take", backlog=len(self._queue))
                    batch = self._take_batch()
                except Exception as e:  # pylint: disable=broad-except
                    self._demote(e)
                    continue
                _QUEUE_DEPTH.set(len(self._queue))
            if batch:
                self._run_batch(batch)

    def _demote(self, err: BaseException):
        """A scheduler that raised must not take the queued requests down
        with it: a fresh FIFO queue takes over with every item carried
        over (whatever ``drain`` yields before it fails, if it does), and
        the batcher serves on, degraded.  Called with ``_cv`` held."""
        logger.exception("scheduler.take failed; degrading to FIFO")
        fresh = FIFOQueue()
        try:
            for item in self._queue.drain():
                fresh.append(item)
        except Exception:  # pylint: disable=broad-except
            logger.exception("scheduler.drain also failed")
        self._queue = fresh
        if not self.degraded:
            self.degraded = True
            self.degraded_reason = f"{type(err).__name__}: {err}"
            if self.on_degraded is not None:
                try:
                    self.on_degraded(err)
                except Exception:  # pylint: disable=broad-except
                    logger.exception("on_degraded callback failed")

    def _run_batch(self, batch: List[Dict]):
        try:
            prompts = [p for it in batch for p in it["prompts"]]
            run_cfg = dataclasses.replace(
                batch[0]["cfg"],
                max_new_tokens=max(it["cfg"].max_new_tokens
                                   for it in batch))
            _BATCH_SIZE.observe(len(prompts))
            with self._gen_lock, _ttrace.span(
                    "batcher.generate", "serving",
                    {"prompts": len(prompts),
                     "max_new_tokens": run_cfg.max_new_tokens}
                    if _ttrace.enabled() else None, "serve-batcher"):
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
                 scheduler_factory=None, warm_prefix_ids=None,
                 on_degraded=None):
        self.generator = generator
        self.batcher = RequestBatcher(
            generator, prefix=prefix,
            scheduler=scheduler_factory() if scheduler_factory else None)
        self.batcher.on_degraded = on_degraded
        self.prefix = prefix
        self.scheduler_factory = scheduler_factory
        # the system prompt warmed into the paged prefix index when the
        # engine is built (kv_paged + kv_prefix_reuse)
        self.warm_prefix_ids = warm_prefix_ids
        self._engine = None
        self._prefill_engine = None
        self._lock = threading.Lock()

    @property
    def degraded(self) -> bool:
        return self.batcher.degraded

    def swap_weights(self, new_params, prefix_ids=None,
                     drain_timeout: float = 30.0) -> None:
        """Swap this replica onto staged weights under a drain barrier
        (the swap phase of ``checkpoint.hot_swap``; the weights share the
        current ones' names, shapes and dtypes, so they are copied into
        the model's own tensors).  The batch in flight finishes on the
        old weights; queued requests are never dropped and run on the
        new ones; a shared prefix's KV is recomputed under the barrier.
        The streaming engine is drained and retired first, and the next
        streamed request builds a fresh one with its KV pool (cached KV
        holds only for the weights that made it), and so is the prefill
        engine with its retained artifacts.  The copy is in place,
        so no tick of a live engine may overlap it: where the engine's
        streams outlive ``drain_timeout`` the swap raises
        ``HotSwapBusyError`` and the replica keeps its weights and its
        engine."""
        from alpa_tpu_torch.checkpoint.hot_swap import (HotSwapBusyError,
                                                        drain_engine)
        # the replica lock first: a new stream boards the engine under it
        # (``submit_stream``), so none can board the old engine while it
        # is retired
        with self._lock:
            old_engine = self._engine
            if old_engine is not None:
                if not drain_engine(old_engine, timeout=drain_timeout):
                    if old_engine._stop:
                        self._engine = None
                    raise HotSwapBusyError(
                        f"the streaming engine's requests outlived the "
                        f"{drain_timeout:g}s drain window; the weights are "
                        "unchanged")
                self._engine = None
            with self.batcher._gen_lock:
                self.generator.params = new_params
                new_prefix = None
                if prefix_ids is not None:
                    new_prefix = self.generator.cache_prefix(prefix_ids)
                self.prefix = new_prefix
                self.batcher.prefix = new_prefix
            if self._prefill_engine is not None:
                # its pool's KV and its retained artifacts hold only for
                # the weights that made them
                self._prefill_engine.shutdown()
                self._prefill_engine = None

    def submit_stream(self, prompt_ids, cfg, queue=None):
        """Board a streamed request on the engine under the replica lock,
        so that a weight swap never retires an engine a request is about
        to board."""
        with self._lock:
            return self._engine_locked().submit_stream(prompt_ids, cfg,
                                                       queue=queue)

    @property
    def engine(self) -> ContinuousBatchingEngine:
        """The streaming engine, built at first use, so that a deployment
        that never streams runs no decode thread.  With a prefix, streamed
        prompt_ids are suffixes over it, unless ``kv_paged`` and
        ``kv_prefix_reuse`` are on: the prefix is then warmed into the
        engine's block pool and requests send full prompts (any shared
        token prefix hits)."""
        with self._lock:
            return self._engine_locked()

    def _engine_locked(self) -> ContinuousBatchingEngine:
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

    @property
    def prefill_engine(self) -> "_disagg.PrefillEngine":
        """The prefill-only engine of the disaggregated prefill pool,
        built at first use.  Its admission is the streaming engine's (the
        same prompt bucket, the same prefix-hit path), so a handoff carries
        the KV the monolithic engine would compute in place.  A replica
        with a static ``PrefixHandle`` cannot serve the prefill pool."""
        with self._lock:
            if self._prefill_engine is None:
                if self.prefix is not None:
                    raise ServiceDegradedError(
                        "the replica runs a static PrefixHandle; the "
                        "disaggregated prefill pool needs paged KV "
                        "(kv_paged + kv_prefix_reuse)")
                self._prefill_engine = _disagg.PrefillEngine(
                    self.generator,
                    prompt_bucket=self.generator.prompt_buckets[-1],
                    scheduler=(self.scheduler_factory()
                               if self.scheduler_factory else None))
                if self.warm_prefix_ids is not None:
                    self._prefill_engine.pool.warm_prefix(
                        self.generator, self.warm_prefix_ids)
            return self._prefill_engine

    def shutdown(self):
        self.batcher.shutdown()
        with self._lock:
            if self._engine is not None:
                self._engine.shutdown()
            if self._prefill_engine is not None:
                self._prefill_engine.shutdown()


class Controller:
    """Model registry + dispatch.  ``device`` is the default device for
    models registered by name or config (``None`` -> CUDA)."""

    def __init__(self, device=None):
        self.device = device
        self._models: Dict[str, List[_Replica]] = {}
        self._rr: Dict[str, int] = {}
        self._prefix_ids: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # "ok" serves; "degraded" serves, but a replica lost its
        # admission policy (FIFO fallback); "shedding": recovery declared
        # the backend dead, and new work gets ServiceDegradedError (503)
        self._health = "ok"
        self._health_reason: Optional[str] = None
        # the bound RecoveryManager (attach_recovery), read by /healthz
        self._recovery = None
        # completed hot swaps, newest last
        self.reloads: List[Dict[str, Any]] = []
        # recent request latencies (seconds) behind load_report's p99: the
        # router's placement signal
        self._latencies = deque(maxlen=512)

    def set_health(self, state: str, reason: Optional[str] = None):
        if state not in ("ok", "degraded", "shedding"):
            raise ValueError(f"unknown health state {state!r}")
        with self._lock:
            self._health, self._health_reason = state, reason
        logger.warning("controller health -> %s (%s)", state, reason)

    def health_report(self) -> Dict[str, Any]:
        with self._lock:
            state, reason = self._health, self._health_reason
            degraded = sorted(name for name, reps in self._models.items()
                              if any(r.degraded for r in reps))
        if state == "ok" and degraded:
            state = "degraded"
            reason = f"replica scheduler fallback: {degraded}"
        report = {"status": state}
        if reason:
            report["reason"] = reason
        if degraded:
            report["degraded_models"] = degraded
        return report

    def load_report(self) -> Dict[str, Any]:
        """Load signals for the multi-replica router and ``/healthz``: the
        queued requests (batcher, engine and prefill-engine queues), the
        tokens held by live engine rows, and the p99 of the recent request
        latencies in ms (None before any traffic)."""
        depth = 0
        tokens_in_flight = 0
        with self._lock:
            replicas = [r for reps in self._models.values() for r in reps]
        for rep_ in replicas:
            depth += len(rep_.batcher._queue)
            pe = rep_._prefill_engine
            if pe is not None:
                depth += pe.queue_depth()
            eng = rep_._engine
            if eng is None:
                continue
            with eng._cv:
                depth += len(eng._queue)
                for it in eng._rows:
                    if it is not None:
                        tokens_in_flight += (len(it["prompt"]) +
                                             len(it["tokens"]))
        lat = sorted(self._latencies)
        p99 = lat[int(0.99 * (len(lat) - 1))] * 1e3 if lat else None
        return {"queue_depth": depth, "tokens_in_flight": tokens_in_flight,
                "ttft_p99_ms": p99}

    def attach_recovery(self, recovery) -> None:
        """Bind a ``fault.RecoveryManager``: entering DEGRADED sheds load
        here (503s), recovering restores service."""
        self._recovery = recovery
        recovery.on_degrade = (
            lambda reason=None: self.set_health(
                "shedding", reason or "mesh recovery failed"))
        recovery.on_recover = (
            lambda: self.set_health("ok", "recovered"))

    def _check_shedding(self):
        with self._lock:
            state, reason = self._health, self._health_reason
        if state == "shedding":
            raise ServiceDegradedError(
                f"service unavailable: {reason or 'backend recovering'}")

    def _on_degraded(self, name):
        return lambda e: logger.warning(
            "model %s replica degraded to FIFO: %s", name, e)

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
                    warm_prefix_ids=prefix_ids,
                    on_degraded=self._on_degraded(name)))
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
                scheduler_factory=scheduler_factory,
                on_degraded=self._on_degraded(name)))
            self._rr.setdefault(name, 0)
        logger.info("registered model %s (%d replicas)", name,
                    len(self._models[name]))
        return generator

    def list_models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def reload_model(self, name: str, checkpoint_source,
                     step: Optional[int] = None) -> Dict[str, Any]:
        """Zero-downtime weight reload (``POST /admin/reload``).  Per
        replica: stage the checkpoint step onto the replica's devices,
        hash-verifying every chunk, while requests flow on the old
        weights (a corrupt checkpoint fails here and touches nothing);
        then swap under the replica's drain barrier
        (``_Replica.swap_weights``).  Nothing queued is dropped.  A
        replica whose streams outlive the drain window keeps its weights
        and raises ``HotSwapBusyError``, which names the replicas swapped
        before it."""
        from alpa_tpu_torch.checkpoint.hot_swap import (
            HotSwapBusyError, stage_weights_from_checkpoint)
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}; "
                               f"registered: {sorted(self._models)}")
            replicas = list(self._models[name])
            prefix_ids = self._prefix_ids.get(name)
        loaded_step = None
        for i, replica in enumerate(replicas):
            new_params, loaded_step = stage_weights_from_checkpoint(
                checkpoint_source, replica.generator.params, step=step)
            try:
                replica.swap_weights(new_params, prefix_ids=prefix_ids)
            except HotSwapBusyError as e:
                raise HotSwapBusyError(
                    f"{name}: replica {i} of {len(replicas)}: {e} ({i} "
                    "swapped before it)") from e
        result = {"model": name, "step": loaded_step,
                  "replicas_swapped": len(replicas)}
        with self._lock:
            self.reloads.append(result)
        logger.info("hot-swapped model %s to checkpoint step %s "
                    "(%d replicas)", name, loaded_step, len(replicas))
        return result

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
        self._check_shedding()
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
        elapsed = time.monotonic() - tic
        _REQ_LATENCY.observe(elapsed)
        self._latencies.append(elapsed)
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
        return replica.submit_stream(prompt_ids.reshape(-1), cfg,
                                     queue=queue)

    # ---- disaggregated prefill/decode (serve.disagg) ----

    def disagg_prefill(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """The prefill half of a disaggregated request: the prompt's
        prefill on a replica's prefill engine; returns the (retained)
        handoff artifact's wire form."""
        tic = time.monotonic()
        replica, prompt_ids, cfg, queue = self._parse_request(request)
        if prompt_ids.ndim > 1 and prompt_ids.shape[0] != 1:
            raise ValueError(
                "disaggregated prefill takes exactly one prompt per "
                f"request; got {prompt_ids.shape[0]} rows")
        pe = replica.prefill_engine
        pe.model = request["model"]
        art = pe.prefill(prompt_ids.reshape(-1), cfg, queue=queue)
        self._latencies.append(time.monotonic() - tic)
        return art.to_wire()

    def disagg_ingest(self, wire: Dict[str, Any]):
        """The decode half: check the artifact (a hash mismatch raises
        ``ArtifactCorruptError``: corrupt KV is never decoded), land it on
        a replica's streaming engine and return the token stream of the
        request joining its decode batch."""
        self._check_shedding()
        art = _disagg.KVHandoffArtifact.from_wire(wire)   # checks
        replica = self._pick_replica(art.model)
        with replica._lock:
            return _disagg.ingest_stream(replica._engine_locked(), art)

    def disagg_fetch(self, request_id: str) -> Dict[str, Any]:
        """The retained artifact of ``request_id``: the router's re-ingest
        source after a decode-side failure."""
        with self._lock:
            replicas = [r for reps in self._models.values() for r in reps]
        for rep_ in replicas:
            pe = rep_._prefill_engine
            if pe is not None:
                art = pe.fetch(request_id)
                if art is not None:
                    return art.to_wire()
        raise KeyError(f"no retained artifact {request_id!r}")

    def disagg_ack(self, request_id: str) -> bool:
        """Drop the retained artifact: its decode stream finished."""
        with self._lock:
            replicas = [r for reps in self._models.values() for r in reps]
        return any(rep_._prefill_engine is not None and
                   rep_._prefill_engine.ack(request_id)
                   for rep_ in replicas)

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
        """The whole process registry as Prometheus text; the serving, KV
        and disaggregation families register when their modules load,
        which the controller's imports guarantee, and the router's are
        pulled in here."""
        import alpa_tpu_torch.serve.router  # noqa: F401  pylint: disable=unused-import
        self._send_text(200, _tmetrics.get_registry().to_prometheus_text())

    def _healthz(self):
        """Liveness wired to the recovery state machine: 200 while
        HEALTHY, SUSPECT or RECOVERING (the body names the state), 503
        once DEGRADED; without a RecoveryManager, the health report.
        ``last_flight_dump`` is where the flight recorder's last
        post-mortem landed (null for none), ``elastic`` the
        ``ElasticSupervisor``'s report (null without one), ``load`` the
        controller's ``load_report`` (the router's signals)."""
        from alpa_tpu_torch import elastic as _elastic
        from alpa_tpu_torch.telemetry import flight as _flight
        recovery = self.controller._recovery
        if recovery is not None:
            state = recovery.state.value
            self._send(503 if state == "degraded" else 200,
                       {"status": state,
                        "last_flight_dump": _flight.last_dump_path(),
                        "elastic": _elastic.status_report(),
                        "load": self.controller.load_report()})
            return
        report = self.controller.health_report()
        report["last_flight_dump"] = _flight.last_dump_path()
        report["elastic"] = _elastic.status_report()
        report["load"] = self.controller.load_report()
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
        if self.path == "/admin/reload":
            self._admin_reload()
            return
        if self.path.startswith("/disagg/"):
            self._disagg()
            return
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

    def _admin_reload(self):
        """``POST /admin/reload`` {"model", "ckpt_dir", "step"?}: stage and
        hash-verify the checkpoint in the background, then swap every
        replica of the model under a drain barrier; requests in flight
        are served throughout.  A corrupt checkpoint is refused (500,
        ``ChunkCorruptionError``) and serving goes on with the old
        weights; so is a reload whose streams outlive the drain window
        (409, ``HotSwapBusyError``)."""
        from alpa_tpu_torch.checkpoint.hot_swap import HotSwapBusyError
        try:
            length = int(self.headers.get("Content-Length", 0))
            request = json.loads(self.rfile.read(length) or b"{}")
            name = request.get("model")
            ckpt_dir = request.get("ckpt_dir")
            if not name or not ckpt_dir:
                raise ValueError(
                    "reload needs 'model' and 'ckpt_dir' fields")
            step = request.get("step")
            self._send(200, self.controller.reload_model(
                name, ckpt_dir, step=None if step is None else int(step)))
        except HotSwapBusyError as e:
            self._send(409, {"error": f"HotSwapBusyError: {e}"})
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except (json.JSONDecodeError, ValueError, TypeError,
                FileNotFoundError) as e:
            self._send(400, {"error": f"bad reload request: {e}"})
        except Exception as e:  # pylint: disable=broad-except
            logger.exception("hot reload failed")
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

    def _disagg(self):
        """``/disagg/prefill`` -> the artifact's wire JSON;
        ``/disagg/ingest`` -> the SSE token stream joining the decode
        batch; ``/disagg/fetch`` and ``/disagg/ack`` manage the prefill
        side's retained artifacts.  A corrupt artifact answers 422, so
        that the router re-fetches the retained copy."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            request = json.loads(self.rfile.read(length) or b"{}")
            if self.path == "/disagg/prefill":
                self._send(200, self.controller.disagg_prefill(request))
            elif self.path == "/disagg/ingest":
                it = self.controller.disagg_ingest(request)   # checks
                self._stream_body(it)
            elif self.path == "/disagg/fetch":
                self._send(200, self.controller.disagg_fetch(
                    str(request.get("request_id"))))
            elif self.path == "/disagg/ack":
                self._send(200, {"acked": self.controller.disagg_ack(
                    str(request.get("request_id")))})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})
        except ServiceDegradedError as e:
            self._send(503, {"error": str(e)})
        except _disagg.ArtifactCorruptError as e:
            self._send(422, {"error": str(e)})
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except (json.JSONDecodeError, ValueError, AssertionError,
                TypeError) as e:
            self._send(400, {"error": f"bad request: {e}"})
        except Exception as e:  # pylint: disable=broad-except
            logger.exception("disagg request failed")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

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
