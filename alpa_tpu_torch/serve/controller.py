"""HTTP serving controller (counterpart of ``alpa_tpu/serve/controller.py``).

A ``ThreadingHTTPServer`` front end, a registry of named models with
round-robin replica dispatch, and a per-replica ``RequestBatcher`` that
coalesces concurrent requests into one mixed-length ``Generator.generate``
call.  The batcher's single worker thread serializes device work, so the
model runs on one CUDA stream.

Endpoints:
  GET  /models       -> {"models": [...]}
  GET  /health       -> {"status": "ok" | "shedding"} (503 when shedding)
  POST /completions  -> {"model", "prompt_ids", "max_new_tokens"?,
        "temperature"?, "top_k"?, "do_sample"?, "eos_token_id"?}
        => {"output_ids": [[...]]}

Not ported yet: metrics, trace spans, fault sites, streaming, the
continuous-batching engine, paged KV, prefixes, disaggregation, hot swap
and the router.
"""
import dataclasses
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from alpa_tpu_torch.serve.generation import (GenerationConfig, Generator,
                                             get_model)
from alpa_tpu_torch.serve.scheduler import FIFOQueue

logger = logging.getLogger(__name__)


class ServiceDegradedError(RuntimeError):
    """The controller is shedding load; maps to HTTP 503."""


class RequestBatcher:
    """Groups concurrent completion requests into ONE mixed-length batched
    ``Generator.generate`` call.  Requests arriving while the device is
    busy queue up and ride the next batch.  Only requests with identical
    sampling settings share a batch; ``max_new_tokens`` may differ (the
    batch runs to the max, each request is truncated to its own)."""

    def __init__(self, generator: Generator, max_batch: int = 8,
                 max_wait_ms: float = 2.0):
        self.generator = generator
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue = FIFOQueue()
        self._cv = threading.Condition()
        self.batches_run = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, prompts: List[np.ndarray],
               cfg: GenerationConfig) -> List[np.ndarray]:
        item = {"prompts": prompts, "cfg": cfg,
                "done": threading.Event(), "result": None, "error": None}
        with self._cv:
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
                while len(self._queue) == 0:
                    self._cv.wait()
            # a small window lets concurrent arrivals coalesce
            time.sleep(self.max_wait_s)
            with self._cv:
                batch = self._take_batch()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[Dict]):
        try:
            prompts = [p for it in batch for p in it["prompts"]]
            run_cfg = dataclasses.replace(
                batch[0]["cfg"],
                max_new_tokens=max(it["cfg"].max_new_tokens
                                   for it in batch))
            outs = self.generator.generate(prompts, run_cfg)
            self.batches_run += 1
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


class Controller:
    """Model registry + dispatch.  ``device`` is the default device for
    models registered by name or config (``None`` -> CUDA)."""

    def __init__(self, device=None):
        self.device = device
        self._models: Dict[str, List[RequestBatcher]] = {}
        self._rr: Dict[str, int] = {}
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

    def register_model(self, name: str, generator,
                       device=None) -> Generator:
        """Add a replica of model ``name``.  ``generator`` is a
        ``Generator``, or a ladder name / ``GPTConfig`` built with random
        weights by ``get_model`` on ``device`` (default: the controller's
        device)."""
        if not isinstance(generator, Generator):
            generator = get_model(
                generator, device=self.device if device is None else device)
        batcher = RequestBatcher(generator)
        with self._lock:
            self._models.setdefault(name, []).append(batcher)
            self._rr.setdefault(name, 0)
        logger.info("registered model %s (%d replicas)", name,
                    len(self._models[name]))
        return generator

    def list_models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def _pick_replica(self, name: str) -> RequestBatcher:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model {name!r}; "
                               f"registered: {sorted(self._models)}")
            replicas = self._models[name]
            i = self._rr[name] % len(replicas)
            self._rr[name] += 1
        return replicas[i]

    def completions(self, request: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            state, reason = self._health, self._health_reason
        if state == "shedding":
            raise ServiceDegradedError(
                f"service unavailable: {reason or 'shedding load'}")
        batcher = self._pick_replica(request["model"])
        prompt_ids = np.asarray(request["prompt_ids"], np.int64)
        if prompt_ids.ndim == 1:
            prompt_ids = prompt_ids[None]
        cfg = GenerationConfig(
            max_new_tokens=int(request.get("max_new_tokens", 32)),
            temperature=float(request.get("temperature", 1.0)),
            top_k=int(request.get("top_k", 0)),
            do_sample=bool(request.get("do_sample", False)),
            eos_token_id=request.get("eos_token_id"))
        outs = batcher.submit(list(prompt_ids), cfg)
        return {"output_ids": [o.tolist() for o in outs]}


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

    def do_GET(self):
        if self.path == "/health":
            report = self.controller.health_report()
            self._send(503 if report["status"] == "shedding" else 200,
                       report)
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


class ControllerServer:
    """The running HTTP server."""

    def __init__(self, controller: Controller, host: str, port: int):
        handler = type("BoundHandler", (_Handler,),
                       {"controller": controller})
        self.httpd = ThreadingHTTPServer((host, port), handler)
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


def run_controller(host: str = "127.0.0.1", port: int = 8000,
                   device=None) -> ControllerServer:
    """Create and start a controller server.  ``device`` is the default
    device of models registered by name or config (``None`` -> CUDA)."""
    server = ControllerServer(Controller(device=device), host, port)
    server.start()
    return server
