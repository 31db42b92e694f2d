"""Row-level continuous batching engine (counterpart of
``alpa_tpu/serve/engine.py``).

A persistent decode loop over a fixed batch of KV-cache rows.  Finished
rows are refilled at once from the request queue by a one-row prefill
into the resident batch cache, so a long generation never blocks short
requests behind it.  The per-row cache indices of ``GPTModel`` are what
make this possible: every row decodes at its own position.

The JAX engine compiles its decode once for its lifetime; the port's
counterpart is one CUDA graph.  The resident caches (all layers in one
tensor), the per-row indices, the token buffer and the logits buffer are
allocated once, and every write into them is in place: an admission
prefills straight into its row of the resident caches (over a copy of the
shared prefix or the blocks gathered from the pool), the packed admission
copies its rows in, and the tick writes its K/V, its logits and its next
indices into the same tensors.  On CUDA the first tick captures the tick
as a CUDA graph (on a side stream, after one eager warm-up run of the same
tick) and every tick replays it; a capture that fails fails the live rows
and counts as a step failure, and the tick is never run uncaptured in its
place.  Sampling, the one device-to-host read of the sampled tokens per
tick and the row bookkeeping stay outside the graph, as does the pool's
``write_tokens`` (one stacked ``index_put_`` after the replay: the block
tables change on the host every tick).  On the CPU the tick runs
uncaptured.  The counters are JAX's ``alpa_serving_*`` families as well
as attributes; each tick runs in an ``engine.decode-tick`` span while
tracing is on.
"""
import dataclasses
import logging
import queue as queue_mod
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from alpa_tpu_torch import fault as _fault
from alpa_tpu_torch.platform import to_device
from alpa_tpu_torch.serve.generation import (GenerationConfig, Generator,
                                             _sample_logits)
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace
from alpa_tpu_torch.serve.kv_cache import (KVPoolExhaustedError,
                                           stacked_kv_caches)
from alpa_tpu_torch.serve.packed import PackedPrefill
from alpa_tpu_torch.serve.scheduler import FIFOQueue

logger = logging.getLogger(__name__)

_REG = _tmetrics.get_registry()
_ADMISSIONS = _REG.counter(
    "alpa_serving_admissions_total", "Requests admitted to a KV-cache row")
_DECODE_STEPS = _REG.counter(
    "alpa_serving_decode_steps_total", "Engine decode ticks executed")
_TOKENS = _REG.counter(
    "alpa_serving_tokens_total", "Tokens generated across all requests")
_STEP_FAILURES = _REG.counter(
    "alpa_serving_step_failures_total", "Engine decode ticks that raised")
_ACTIVE_ROWS = _REG.gauge(
    "alpa_serving_active_rows", "KV-cache rows currently decoding")
_TTFT = _REG.histogram(
    "alpa_serving_ttft_seconds",
    "Time from submit to first generated token")

_STREAM_END = object()


class _TokenStream:
    """Token iterator of ``submit_stream`` whose ``close()`` works at any
    point, before the first token too (``close()`` on a generator that
    never started is a no-op, which would make cancelling a queued request
    unreachable)."""

    def __init__(self, item, q):
        self._item = item
        self._q = q

    def __iter__(self):
        return self

    def __next__(self):
        t = self._q.get()
        if t is _STREAM_END:
            if self._item["error"] is not None:
                raise self._item["error"]
            raise StopIteration
        return int(t)

    def close(self):
        """Flag the request cancelled: a queued request is retired at
        admission, a live row is freed at the next tick."""
        self._item["cancelled"] = True

    def __del__(self):
        self.close()


class _DoneEvent(threading.Event):
    """Event with a completion hook (a stream pushes its end sentinel from
    whichever path finishes the item: success, eos or error)."""

    def __init__(self, hook=None):
        super().__init__()
        self._hook = hook

    def set(self):
        if self._hook is not None:
            try:
                self._hook()
            except Exception:  # pylint: disable=broad-except
                logger.exception("done hook failed")
        super().set()


class ContinuousBatchingEngine:
    """Persistent decode loop with immediate row refill.

    ``prompt_bucket`` caps the prompt length; a plain admission is padded
    to the generator's bucket ladder (the port is eager, so the one XLA
    shape that made the JAX controller pad every admission to ``seq_len``
    buys nothing here; right padding is masked, so greedy tokens do not
    change).

    ``packed_admission=True`` admits several queued prompts with one packed
    prefill (``serve.packed.PackedPrefill``) when two or more wait and fit
    ``packed_bucket`` tokens, else per-row prefills.

    ``prefix``: a ``Generator.cache_prefix`` handle shared by every request
    (a system prompt): each admission prefills only its suffix over a copy
    of the prefix K/V, so the handle is never written.  Needs the
    generator's chunked prefill; composes with ``packed_admission``.

    ``scheduler``: an admission policy speaking the queue protocol of
    ``serve.scheduler`` (``FIFOQueue`` by default); ``submit(...,
    queue=name)`` routes a request to a named queue.

    ``kv_pool``: a ``serve.kv_cache.KVBlockPool``.  Every admission
    reserves its block table up front (backpressure instead of
    over-admission), prompts sharing a cached token prefix skip those
    blocks (gather + chunked suffix prefill), and each tick mirrors the new
    K/V position into the row's block.  Decode runs on the dense resident
    caches.  Excludes ``prefix`` (warm prefixes into the pool instead) and
    turns ``packed_admission`` off.

    Counters: ``admissions``, ``packed_admissions``, ``decode_steps``,
    ``step_failures``, ``decode_captures`` and ``decode_replays``.
    """

    def __init__(self, generator: Generator, max_batch: int = 4,
                 prompt_bucket: Optional[int] = None,
                 packed_admission: bool = False,
                 packed_bucket: Optional[int] = None,
                 prefix: Optional[Any] = None,
                 scheduler: Optional[Any] = None,
                 kv_pool: Optional[Any] = None):
        self.gen = generator
        self.B = max_batch
        self.bucket = prompt_bucket or generator.prompt_buckets[0]
        cfgm = generator.config
        self.device = generator.device
        self._prefix = prefix
        self._pool = kv_pool
        self._tables: List[Optional[Any]] = [None] * max_batch
        self._pool_reuse = False
        if kv_pool is not None:
            if prefix is not None:
                raise ValueError(
                    "kv_pool supersedes the static PrefixHandle: warm "
                    "system prompts with pool.warm_prefix instead")
            if kv_pool.seq_len != cfgm.seq_len:
                raise ValueError(
                    f"kv_pool seq_len {kv_pool.seq_len} != generator "
                    f"seq_len {cfgm.seq_len}")
            self._pool_reuse = (kv_pool.prefix_reuse and
                                bool(generator.prefill_chunk))
            if kv_pool.prefix_reuse and not generator.prefill_chunk:
                logger.warning(
                    "kv prefix reuse needs Generator(prefill_chunk=...) "
                    "to prefill suffixes from the match offset; paging "
                    "stays on but every admission recomputes its prompt")
            if packed_admission:
                logger.warning(
                    "packed_admission is not block-aware; using per-row "
                    "prefill with the KV pool")
                packed_admission = False
        if prefix is not None:
            generator.check_prefix(prefix)
        self._packed = None
        if packed_admission:
            plen = prefix.length if prefix is not None else 0
            total = max(packed_bucket or 2 * self.bucket, self.bucket)
            self._packed = PackedPrefill(
                generator.model, cfgm,
                total_bucket=min(total, max(1, cfgm.seq_len - plen)),
                max_rows=self.B, prefix=prefix)
        self.packed_admissions = 0

        # resident state, allocated once: the decode graph reads these
        # addresses, so they are only ever written in place
        self._kv, caches = stacked_kv_caches(cfgm, self.B, self.device)
        self._index = torch.zeros((self.B,), dtype=torch.int64,
                                  device=self.device)
        self._caches = [(k, v, self._index) for (k, v, _i) in caches]
        self._tok = torch.zeros((self.B,), dtype=torch.int64,
                                device=self.device)
        self._logits = torch.zeros((self.B, cfgm.vocab_size),
                                   dtype=torch.float32, device=self.device)
        on_cuda = self.device.type == "cuda"
        self._tok_host = torch.zeros((self.B,), dtype=torch.int64,
                                     pin_memory=on_cuda)
        self._pos = np.zeros((self.B,), np.int64)   # host copy of _index
        self._active = np.zeros((self.B,), bool)
        self._rows: List[Optional[dict]] = [None] * self.B
        self._capture = on_cuda
        self._graph = None
        self.decode_captures = 0
        self.decode_replays = 0
        self._queue = FIFOQueue() if scheduler is None else scheduler
        self._cv = threading.Condition()
        self._rng = torch.Generator(device=self.device).manual_seed(0)
        self.admissions = 0
        self.decode_steps = 0
        self.step_failures = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- public API ----

    def submit(self, prompt: np.ndarray,
               cfg: Optional[GenerationConfig] = None,
               on_token=None, queue: Optional[str] = None) -> np.ndarray:
        """Blocking generate for one prompt; rides the shared batch.
        ``on_token(int)`` is called from the engine loop as each token
        lands (a streaming hook; it must not block).  ``queue`` names the
        scheduler queue the request rides."""
        item = self._make_item(prompt, cfg, on_token, queue=queue)
        self._enqueue(item)
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        row = np.asarray(item["tokens"], np.int32)
        return np.concatenate([item["prompt"], row])

    def submit_stream(self, prompt: np.ndarray,
                      cfg: Optional[GenerationConfig] = None,
                      queue: Optional[str] = None):
        """Iterator over generated tokens as they land.  Validates and
        enqueues eagerly, so a caller can still fail a request before it
        commits to a streamed response; raises where the engine failed.
        ``close()`` cancels, before admission too."""
        q: "queue_mod.Queue" = queue_mod.Queue()
        item = self._make_item(prompt, cfg, q.put,
                               on_done=lambda: q.put(_STREAM_END),
                               queue=queue)
        self._enqueue(item)
        return _TokenStream(item, q)

    def submit_prefilled(self, prompt: np.ndarray,
                         cfg: Optional[GenerationConfig], caches1, logits1,
                         on_token=None,
                         queue: Optional[str] = None) -> np.ndarray:
        """Blocking decode of a request whose prefill ran elsewhere (the
        decode half of ``serve.disagg``): ``caches1`` are one row's
        per-layer ``[(k, v, index)]``, ``(1, n, heads, head_dim)`` with
        ``n`` at least the prompt's length, and ``logits1`` its last-token
        logits, as this engine's own prefill would leave them.  The row
        joins the decode batch at the next admission point, between two
        ticks, by in-place copies into the resident buffers: the captured
        decode graph is replayed as it is."""
        item = self._make_item(prompt, cfg, on_token, queue=queue,
                               prefilled=(logits1, caches1))
        self._enqueue(item)
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        row = np.asarray(item["tokens"], np.int32)
        return np.concatenate([item["prompt"], row])

    def submit_prefilled_stream(self, prompt: np.ndarray,
                                cfg: Optional[GenerationConfig], caches1,
                                logits1, queue: Optional[str] = None):
        """``submit_prefilled`` as a token stream (``submit_stream``'s)."""
        q: "queue_mod.Queue" = queue_mod.Queue()
        item = self._make_item(prompt, cfg, q.put,
                               on_done=lambda: q.put(_STREAM_END),
                               queue=queue, prefilled=(logits1, caches1))
        self._enqueue(item)
        return _TokenStream(item, q)

    def _enqueue(self, item):
        with self._cv:
            if self._stop:
                raise RuntimeError("engine shut down")
            self._queue.append(item)
            self._cv.notify()

    def _make_item(self, prompt, cfg, on_token, on_done=None, queue=None,
                   prefilled=None):
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = cfg or GenerationConfig()
        seq_len = self.gen.config.seq_len
        plen = self._prefix.length if self._prefix is not None else 0
        if prefilled is not None and self._prefix is not None:
            raise ValueError(
                "prefilled admission is incompatible with a static "
                "PrefixHandle engine (ingested caches carry the whole "
                "prompt)")
        # a prefilled row never runs this engine's prefill, so the prefill
        # bucket does not bound it (seq_len does)
        if prefilled is None and len(prompt) > self.bucket:
            raise ValueError(
                f"prompt {len(prompt)} exceeds engine bucket {self.bucket}")
        if plen + len(prompt) + cfg.max_new_tokens > seq_len:
            raise ValueError(
                f"prefix {plen} + prompt {len(prompt)} + max_new_tokens "
                f"{cfg.max_new_tokens} exceeds seq_len {seq_len}")
        if self._pool is not None and not self._pool.fits(
                len(prompt) + cfg.max_new_tokens):
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens "
                f"{cfg.max_new_tokens} needs more KV blocks than the "
                f"pool holds ({self._pool.num_blocks} x "
                f"{self._pool.block_size} tokens)")
        if self._prefix is not None:
            # the suffix is prefilled in whole chunks from the prefix
            c = self.gen.prefill_chunk
            padded = max(1, -(-len(prompt) // c)) * c if len(prompt) else 0
            if plen + padded > seq_len:
                raise ValueError(
                    f"prompt {len(prompt)} pads to {padded} chunks past "
                    f"prefix {plen}, exceeding seq_len {seq_len}; use a "
                    "smaller chunk size or a shorter prompt")
        return {"prompt": prompt, "cfg": cfg, "tokens": [],
                "done": _DoneEvent(on_done), "error": None,
                "on_token": on_token, "cancelled": False,
                "queue": queue or "default", "prefilled": prefilled,
                "t_submit": time.monotonic()}

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()

    # ---- resident rows ----

    def _row(self, r: int, start: int):
        """Row ``r`` of the resident caches as B=1 caches at the int write
        index ``start``; a prefill into them writes the row in place."""
        row = self._kv[:, :, r:r + 1]
        return [(row[0, i], row[1, i], start) for i in range(row.shape[1])]

    def _ints(self, values) -> torch.Tensor:
        return to_device(torch.tensor(values, dtype=torch.int64),
                         self.device)

    def _scatter_row(self, r: int, logits1, length: int):
        self._logits[r].copy_(logits1[0])
        self._index[r] = length
        self._pos[r] = length

    def _scatter_packed(self, rows, slots, row_caches, last, lengths):
        """Copy packed row caches ``slots`` into resident rows ``rows``."""
        rows_t, slots_t = self._ints([rows, slots])
        for i, (rk, rv, rlen) in enumerate(row_caches):
            self._kv[0, i].index_copy_(0, rows_t, rk[slots_t])
            self._kv[1, i].index_copy_(0, rows_t, rv[slots_t])
        self._index.index_copy_(0, rows_t, rlen[slots_t])
        self._logits.index_copy_(0, rows_t, last[slots_t].float())
        self._pos[rows] = lengths

    # ---- engine loop ----

    def _next_live(self):
        """The policy head without popping it, retiring requests cancelled
        while still queued (a client gone before admission)."""
        while True:
            nxt = self._queue.peek()
            if nxt is None or not nxt.get("cancelled"):
                return nxt
            self._queue.popleft()["done"].set()

    def _admit_packed_locked(self):
        free = [r for r in range(self.B) if not self._active[r]]
        take, total = [], 0
        while len(take) < len(free):
            nxt = self._next_live()
            # a prefilled row is admitted alone: it has no prefill to pack
            if nxt is None or nxt.get("prefilled") is not None or \
                    total + len(nxt["prompt"]) > self._packed.total_bucket:
                break
            take.append(self._queue.popleft())
            total += len(take[-1]["prompt"])
        if len(take) < 2:
            # not enough for a pack: back to the front, per-row admission
            self._queue.pushback(take)
            return
        try:
            last, row_caches = self._packed([it["prompt"] for it in take])
            rows = free[:len(take)]
            plen = self._prefix.length if self._prefix is not None else 0
            self._scatter_packed(rows, list(range(len(take))), row_caches,
                                 last, [plen + len(it["prompt"])
                                        for it in take])
            for r, item in zip(rows, take):
                self._rows[r] = item
                self._active[r] = True
                self.admissions += 1
                _ADMISSIONS.inc()
            self.packed_admissions += 1
        except Exception as e:  # pylint: disable=broad-except
            logger.exception("packed admission failed")
            for item in take:
                item["error"] = e
                item["done"].set()

    def _admit_locked(self):
        """Fill free rows from the queue: one packed prefill when several
        prompts wait (and packing is on), else per-row prefills.  An
        admission failure fails only the requests being admitted: the loop
        and the live rows survive."""
        if self._packed is not None and len(self._queue) >= 2:
            self._admit_packed_locked()
        for r in range(self.B):
            if self._active[r]:
                continue
            nxt = self._next_live()
            if nxt is None:
                continue
            seq = None
            if self._pool is not None:
                try:
                    seq = self._pool.begin_sequence(
                        nxt["prompt"], nxt["cfg"].max_new_tokens)
                except Exception as e:  # pylint: disable=broad-except
                    self._queue.popleft()
                    nxt["error"] = e
                    nxt["done"].set()
                    continue
                if seq is None:
                    # backpressure: live sequences hold the blocks and a
                    # retirement frees them.  With no live row the pool is
                    # out of evictable blocks: fail instead of spinning
                    if not self._active.any():
                        item = self._queue.popleft()
                        item["error"] = KVPoolExhaustedError(
                            "KV pool exhausted with no live sequences "
                            "to wait on")
                        item["done"].set()
                    break
            item = self._queue.popleft()
            try:
                self._admit_row(r, item, seq)
            except Exception as e:  # pylint: disable=broad-except
                logger.exception("row admission failed")
                if seq is not None:
                    self._pool.release(seq, register=False)
                item["error"] = e
                item["done"].set()

    def _admit_row(self, r: int, item, seq):
        p = item["prompt"]
        gen = self.gen
        if item.get("prefilled") is not None:
            # a disaggregated handoff: the row as another replica's
            # prefill left it, copied in unchanged
            logits1, caches1 = item["prefilled"]
            item["prefilled"] = None          # drop the reference
            for i, (k1, v1, _i) in enumerate(caches1):
                n = k1.shape[1]
                self._kv[0, i, r, :n].copy_(k1[0])
                self._kv[1, i, r, :n].copy_(v1[0])
            length = len(p)
        elif seq is not None and seq.matched_tokens:
            # a prefix-reuse hit: the cached blocks into the row, then the
            # suffix alone from the match offset
            m = seq.matched_tokens
            caches = self._pool.gather_dense(
                seq, out=self._kv[:, :, r:r + 1])
            logits1, _ = gen._run_chunked_prefill(
                [p[m:]], self._ints([len(p)]), 1,
                caches=caches, start=m)
            length = len(p)
        elif self._prefix is not None:
            # the suffix over a copy of the shared prefix, layer by layer
            h = self._prefix
            for i, (k, v, _i) in enumerate(h.caches):
                self._kv[0, i, r:r + 1, :h.length].copy_(k[:, :h.length])
                self._kv[1, i, r:r + 1, :h.length].copy_(v[:, :h.length])
            length = h.length + len(p)
            logits1, _ = gen._run_chunked_prefill(
                [p], self._ints([length]), 1,
                caches=self._row(r, h.length), start=h.length,
                init_last=h.last_logits)
        else:
            length = len(p)
            logits1, _ = gen._run_bucketed_prefill(
                [p], self._ints([length]),
                caches=self._row(r, 0))
        self._scatter_row(r, logits1, length)
        if seq is not None:
            # publish the prompt's full blocks while the row is live, so
            # concurrent requests sharing the prefix hit at once
            self._pool.scatter_prompt(seq, self._kv[:, :, r:r + 1])
            if self._pool_reuse:
                self._pool.register_prompt(seq, p)
            self._tables[r] = seq
        self._rows[r] = item
        self._active[r] = True
        self.admissions += 1
        _ADMISSIONS.inc()

    def _release_table(self, r: int, item: Optional[dict]):
        """Return row ``r``'s blocks.  A cleanly finished request first
        publishes its full prompt + output blocks to the prefix index;
        cancelled and failed rows just free."""
        if self._pool is None or self._tables[r] is None:
            return
        seq = self._tables[r]
        self._tables[r] = None
        try:
            clean = (item is not None and item["error"] is None and
                     not item.get("cancelled"))
            toks = None
            if clean and self._pool_reuse:
                toks = np.concatenate(
                    [item["prompt"], np.asarray(item["tokens"], np.int32)])
            self._pool.release(seq, tokens=toks, register=toks is not None)
        except Exception:  # pylint: disable=broad-except
            logger.exception("KV pool release failed for row %d", r)

    def _fail_live_rows(self, err):
        for r in range(self.B):
            if self._active[r]:
                self._rows[r]["error"] = err
                self._release_table(r, self._rows[r])
                self._rows[r]["done"].set()
                self._active[r] = False
                self._rows[r] = None

    def _run(self):
        # inference mode is thread-local: the loop thread enters it itself
        with torch.inference_mode():
            self._loop()

    def _loop(self):
        while True:
            with self._cv:
                while not self._stop and (len(self._queue) == 0 and
                                          not self._active.any()):
                    self._cv.wait()
                if self._stop:
                    # fail pending work so that no submitter deadlocks
                    err = RuntimeError("engine shut down")
                    for item in self._queue.drain():
                        item["error"] = err
                        item["done"].set()
                    self._fail_live_rows(err)
                    return
                self._admit_locked()
            if not self._active.any():
                continue
            try:
                if _ttrace.enabled():
                    with _ttrace.get_recorder().span(
                            "engine.decode-tick", "serving",
                            {"active": int(self._active.sum())},
                            "serve-engine"):
                        self._step()
                else:
                    self._step()
            except Exception as e:  # pylint: disable=broad-except
                logger.exception("engine step failed")
                self.step_failures += 1
                _STEP_FAILURES.inc()
                with self._cv:
                    self._fail_live_rows(e)

    # ---- the decode tick ----

    def _tick_body(self):
        """One decode step of every row on the resident buffers: K/V
        written at each row's index, logits into ``_logits``, indices
        advanced.  A row past its last token is held at the last position
        (``seq_len - 1``) so that an idle row never writes out of range."""
        logits, _ = self.gen.model(self._tok[:, None], self._index[:, None],
                                   self._caches)
        self._logits.copy_(logits[:, 0])
        self._index.add_(1).clamp_(max=self.gen.config.seq_len - 1)

    def _capture_tick(self):
        """Capture ``_tick_body`` as a CUDA graph.  The warm-up runs this
        tick eagerly on the side stream (cuBLAS and allocator state), the
        indices are put back, and the capture records the same tick; the
        replay that follows writes the same K/V at the same positions."""
        stream = torch.cuda.Stream(self.device)
        saved = self._index.clone()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                self._tick_body()
                self._index.copy_(saved)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self._tick_body()
        except Exception as e:
            raise RuntimeError(
                "capturing the decode tick as a CUDA graph failed; the "
                "tick is not run uncaptured in its place") from e
        self.decode_captures += 1
        return graph

    def _tick(self):
        if not self._capture:
            self._tick_body()
            return
        if self._graph is None:
            self._graph = self._capture_tick()
        self._graph.replay()
        self.decode_replays += 1

    def _sample(self):
        """The next token of every row, on the device.  Sampling settings
        come from each row's cfg: one draw with the first live row's, and a
        draw of its own for each row whose settings differ."""
        cfgs = [self._rows[r]["cfg"] if self._active[r] else None
                for r in range(self.B)]
        base = next((c for c in cfgs if c is not None), GenerationConfig())
        nxt = _sample_logits(self._logits, self._rng, base)
        for r, c in enumerate(cfgs):
            if c is not None and dataclasses.astuple(c) != \
                    dataclasses.astuple(base):
                nxt[r] = _sample_logits(self._logits[r:r + 1], self._rng,
                                        c)[0]
        return nxt

    def _step(self):
        """One decode tick for every live row.  The ``scheduler_tick``
        fault site fires first, on the host, before the tick (or its
        captured graph) runs."""
        _fault.fire("scheduler_tick", step=self.decode_steps,
                    active=int(self._active.sum()))
        self._tok.copy_(self._sample())
        # the sampled tokens reach the host while the tick runs
        self._tok_host.copy_(self._tok, non_blocking=True)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._tick()
        self.decode_steps += 1
        _DECODE_STEPS.inc()
        if ready is not None:
            ready.synchronize()
        nxt = self._tok_host.numpy().copy()
        if self._pool is not None:
            # mirror the positions the tick wrote into the rows' blocks
            self._pool.write_tokens(self._kv, self._tables, self._pos)
        self._pos += self._active

        with self._cv:
            for r in range(self.B):
                if not self._active[r]:
                    continue
                item = self._rows[r]
                cfg = item["cfg"]
                t = int(nxt[r])
                item["tokens"].append(t)
                _TOKENS.inc()
                if len(item["tokens"]) == 1 and "t_submit" in item:
                    _TTFT.observe(time.monotonic() - item["t_submit"])
                if item.get("on_token") is not None:
                    try:
                        item["on_token"](t)
                    except Exception:  # pylint: disable=broad-except
                        logger.exception("on_token callback failed")
                hit_eos = (cfg.eos_token_id is not None and
                           t == cfg.eos_token_id)
                if (hit_eos or item.get("cancelled") or
                        len(item["tokens"]) >= cfg.max_new_tokens):
                    self._release_table(r, item)
                    item["done"].set()
                    self._active[r] = False
                    self._rows[r] = None
            # refill freed rows before the next tick
            self._admit_locked()
            _ACTIVE_ROWS.set(int(self._active.sum()))
