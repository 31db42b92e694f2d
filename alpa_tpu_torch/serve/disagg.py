"""Disaggregated prefill/decode serving (counterpart of
``alpa_tpu/serve/disagg.py``).

Long prefills stall a monolithic engine: every prefill runs between two
decode ticks, so one long prompt stretches the inter-token gap of every
decoding request.  This module splits the two phases over two pools of
replicas:

* a **prefill replica** runs admission and prefill only
  (``PrefillEngine``): it reserves a block table in its own
  ``KVBlockPool`` (a cached prefix skips recomputation, as in the
  monolithic engine), prefills the prompt and packages the table's blocks
  as a ``KVHandoffArtifact``: per-block K/V payload, a sha256 per block
  over the wire bytes, and the last-token logits that seed decode;
* the artifact lands on the decode replica through the cross-mesh
  transfer layer (``make_ingest_transfer``: the arrival half of a direct
  transfer whose source lives in another process), optionally quantized
  per block by the activation codec (``disagg_codec=int8|fp8``, within
  ``reshard_codec.ERROR_BOUND``; off by default, so the bits ship as
  they are);
* a **decode replica** ingests it (``ingest_stream``): the hashes are
  checked, the dense row is rebuilt and the request joins the continuous
  decode batch between two ticks
  (``ContinuousBatchingEngine.submit_prefilled_stream``).

The prefill replica runs the monolithic engine's own prefill (bucketed on
a miss, gather and chunked suffix on a prefix hit), the verbatim payload
moves bits unchanged and the decode admission and tick are the engine's,
so a disaggregated stream equals the monolithic engine's token for token.

The wire form is the JAX package's, field for field: blocks
``(num_blocks, block_size, heads, head_dim)`` per layer, dtype names as
numpy spells them (``bfloat16`` included), the same hashes over the same
bytes, so an artifact built by either package ingests in the other.  The
payload is held as host tensors, since numpy has no bf16.

No handoff is dropped: each artifact is retained by its prefill engine
until the router acks the finished stream, so a dead decode replica or a
corrupt copy (``ArtifactCorruptError``) is re-fetched and re-ingested,
never decoded.  Routing, SLOs and backpressure are in ``serve.router``;
the knobs are ``global_config.disagg_*``.
"""
import base64
import dataclasses
import hashlib
import logging
import threading
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.pipeline_parallel import reshard_codec
from alpa_tpu_torch.serve.generation import GenerationConfig
from alpa_tpu_torch.serve.kv_cache import KVBlockPool, stacked_kv_caches
from alpa_tpu_torch.serve.scheduler import FIFOQueue
from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

_REG = _tmetrics.get_registry()
_HANDOFF_BYTES = _REG.counter(
    "alpa_disagg_handoff_bytes_total",
    "KV handoff payload bytes shipped prefill -> decode")
_HANDOFF_SECONDS = _REG.histogram(
    "alpa_disagg_handoff_seconds",
    "Handoff latency: artifact produced -> decode replica admitted it")
_HANDOFFS_IN_FLIGHT = _REG.gauge(
    "alpa_disagg_handoffs_in_flight",
    "Handoff artifacts produced and not yet acked by the router")
_TTFT_H = _REG.histogram(
    "alpa_disagg_ttft_seconds",
    "Time to first token through the disaggregated path, by pool",
    labelnames=("pool",))
_ITL_H = _REG.histogram(
    "alpa_disagg_itl_seconds",
    "Inter-token gap through the disaggregated path, by pool",
    labelnames=("pool",))
_REINGESTS = _REG.counter(
    "alpa_disagg_reingests_total",
    "Handoffs re-ingested from the retained artifact, by reason",
    labelnames=("reason",))
_BACKPRESSURE_SHEDS = _REG.counter(
    "alpa_disagg_backpressure_sheds_total",
    "Prefill admissions shed by decode-pool backpressure")
_PREFILLS = _REG.counter(
    "alpa_disagg_prefills_total",
    "Prefill-phase requests completed into handoff artifacts")


class ArtifactCorruptError(RuntimeError):
    """A handoff artifact failed its per-block content check.  The router
    re-fetches the retained copy from the prefill side; corrupt KV is
    never decoded."""


def _dtype_name(dtype: torch.dtype) -> str:
    """A dtype as numpy names it (``float32``, ``bfloat16``, ``int8``,
    ``float8_e4m3fn``): the wire's spelling."""
    return str(dtype).replace("torch.", "")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"unknown payload dtype {name!r}")
    return dtype


def _bytes(t: torch.Tensor) -> bytes:
    """A host tensor's bytes in C order: what crosses the wire."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _arr_to_wire(t: torch.Tensor) -> Dict[str, Any]:
    return {"shape": list(t.shape), "dtype": _dtype_name(t.dtype),
            "data": base64.b64encode(_bytes(t)).decode("ascii")}


def _arr_from_wire(d: Dict[str, Any]) -> torch.Tensor:
    raw = bytearray(base64.b64decode(d["data"]))
    flat = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
        torch.empty(0, dtype=torch.uint8)
    return flat.view(_torch_dtype(d["dtype"])).reshape(tuple(d["shape"]))


def _host(x: torch.Tensor) -> torch.Tensor:
    """``x`` (on any device) as a contiguous host tensor."""
    return x.detach().to("cpu").contiguous()


def _codec_ok(mode: str, dtype: torch.dtype) -> bool:
    """Whether the activation codec can carry this KV dtype under ``mode``
    (``reshard_codec.eligible`` without its size floor: a handoff opts in
    explicitly)."""
    if mode == "off":
        return True
    return reshard_codec.eligible((1,), dtype, mode, min_bytes=0)


def _encode_blocks(blocks: torch.Tensor, mode: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's ``(num_blocks, block_size, ...)`` K or V quantized block
    by block (so that each block's hash covers its own wire bytes):
    ``(q, scales)`` stacked over the blocks."""
    qs, ss = zip(*(reshard_codec.encode(blocks[i], mode)
                   for i in range(blocks.shape[0])))
    return torch.stack(qs), torch.stack(ss)


def _decode_blocks(q: torch.Tensor, s: torch.Tensor, block_shape, dtype,
                   mode: str) -> torch.Tensor:
    return torch.stack([reshard_codec.decode(q[i], s[i], block_shape, dtype,
                                             mode)
                        for i in range(q.shape[0])])


@dataclasses.dataclass
class KVHandoffArtifact:
    """One request's prefilled KV state, packaged for the wire.

    ``layers[l]`` is ``{"k", "v"}`` (codec off: ``(num_blocks,
    block_size, heads, head_dim)`` in the model's KV dtype) or ``{"k_q",
    "k_s", "v_q", "v_s"}`` (codec on: per-block payload and scales), as
    host tensors.  ``block_hashes[i]`` is sha256 over block ``i``'s bytes
    in every layer (keys sorted); ``logits_hash`` covers the prompt and the
    seed logits.  The hashes cover what crosses the wire, so a check
    catches corruption in transit and a re-fetched artifact ingests bit
    for bit."""

    request_id: str
    model: str
    prompt: np.ndarray
    cfg: Dict[str, Any]
    queue: Optional[str]
    weights_tag: str
    block_size: int
    num_blocks: int
    codec: str
    kv_dtype: str
    layers: List[Dict[str, torch.Tensor]]
    last_logits: torch.Tensor
    block_hashes: List[str]
    logits_hash: str

    @classmethod
    def build(cls, request_id: str, model: str, prompt, cfg: Dict[str, Any],
              queue: Optional[str], weights_tag: str, block_size: int,
              layer_blocks, last_logits,
              codec: str = "off") -> "KVHandoffArtifact":
        """``layer_blocks``: per layer ``(k, v)`` tensors ``(num_blocks,
        block_size, ...)``; ``last_logits``: the seed logits (1, vocab)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        layer_blocks = [(_host(k), _host(v)) for k, v in layer_blocks]
        kv_dtype = _dtype_name(layer_blocks[0][0].dtype)
        num_blocks = int(layer_blocks[0][0].shape[0])
        layers = []
        for kb, vb in layer_blocks:
            if codec == "off":
                layers.append({"k": kb, "v": vb})
            else:
                kq, ks = _encode_blocks(kb, codec)
                vq, vs = _encode_blocks(vb, codec)
                layers.append({"k_q": kq, "k_s": ks, "v_q": vq, "v_s": vs})
        art = cls(request_id=request_id, model=model, prompt=prompt,
                  cfg=dict(cfg), queue=queue, weights_tag=weights_tag,
                  block_size=int(block_size), num_blocks=num_blocks,
                  codec=codec, kv_dtype=kv_dtype, layers=layers,
                  last_logits=_host(last_logits), block_hashes=[],
                  logits_hash="")
        art.block_hashes = art._hash_blocks()
        art.logits_hash = art._hash_logits()
        return art

    # ---- hashing ----

    def _block_hash(self, i: int) -> str:
        h = hashlib.sha256()
        for lay in self.layers:
            for key in sorted(lay):
                h.update(_bytes(lay[key][i]))
        return h.hexdigest()

    def _hash_blocks(self) -> List[str]:
        return [self._block_hash(i) for i in range(self.num_blocks)]

    def _hash_logits(self) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.prompt).tobytes())
        h.update(_bytes(self.last_logits))
        return h.hexdigest()

    def verify(self) -> None:
        """Recompute every block's hash and the logits' hash; a mismatch
        rejects the whole artifact before anything is scattered."""
        if len(self.block_hashes) != self.num_blocks:
            raise ArtifactCorruptError(
                f"artifact {self.request_id}: {len(self.block_hashes)} "
                f"hashes for {self.num_blocks} blocks")
        for i in range(self.num_blocks):
            if self._block_hash(i) != self.block_hashes[i]:
                raise ArtifactCorruptError(
                    f"artifact {self.request_id}: block {i} content hash "
                    "mismatch (corrupt handoff)")
        if self._hash_logits() != self.logits_hash:
            raise ArtifactCorruptError(
                f"artifact {self.request_id}: seed logits/prompt hash "
                "mismatch (corrupt handoff)")

    @property
    def payload_nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for lay in self.layers
                   for t in lay.values())

    # ---- wire form ----

    def to_wire(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id, "model": self.model,
            "prompt": self.prompt.tolist(), "cfg": dict(self.cfg),
            "queue": self.queue, "weights_tag": self.weights_tag,
            "block_size": self.block_size, "num_blocks": self.num_blocks,
            "codec": self.codec, "kv_dtype": self.kv_dtype,
            "layers": [{k: _arr_to_wire(v) for k, v in lay.items()}
                       for lay in self.layers],
            "last_logits": _arr_to_wire(self.last_logits),
            "block_hashes": list(self.block_hashes),
            "logits_hash": self.logits_hash,
            "payload_nbytes": self.payload_nbytes,
        }

    @classmethod
    def from_wire(cls, wire: Dict[str, Any],
                  verify: bool = True) -> "KVHandoffArtifact":
        try:
            art = cls(
                request_id=str(wire["request_id"]), model=str(wire["model"]),
                prompt=np.asarray(wire["prompt"], np.int32).reshape(-1),
                cfg=dict(wire["cfg"]), queue=wire.get("queue"),
                weights_tag=str(wire.get("weights_tag", "")),
                block_size=int(wire["block_size"]),
                num_blocks=int(wire["num_blocks"]),
                codec=str(wire["codec"]), kv_dtype=str(wire["kv_dtype"]),
                layers=[{k: _arr_from_wire(v) for k, v in lay.items()}
                        for lay in wire["layers"]],
                last_logits=_arr_from_wire(wire["last_logits"]),
                block_hashes=[str(h) for h in wire["block_hashes"]],
                logits_hash=str(wire.get("logits_hash", "")))
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise ArtifactCorruptError(
                f"malformed handoff artifact: {e}") from e
        if verify:
            art.verify()
        return art

    # ---- decode-side reconstruction ----

    def dense_rows(self, layer: int, tail: Tuple[int, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``layer``'s K and V as ``(num_blocks * block_size,) +
        tail`` host tensors in the KV dtype (the codec decoded, given the
        destination cache's per-token ``tail`` shape)."""
        lay = self.layers[layer]
        dtype = _torch_dtype(self.kv_dtype)
        if self.codec == "off":
            kb, vb = lay["k"], lay["v"]
        else:
            block_shape = (self.block_size,) + tuple(tail)
            kb = _decode_blocks(lay["k_q"], lay["k_s"], block_shape, dtype,
                                self.codec)
            vb = _decode_blocks(lay["v_q"], lay["v_s"], block_shape, dtype,
                                self.codec)
        n = self.num_blocks * self.block_size
        return (kb.reshape((n,) + tuple(tail)).to(dtype),
                vb.reshape((n,) + tuple(tail)).to(dtype))


class PrefillEngine:
    """Admission and prefill only: the prefill pool's half of a
    disaggregated deployment.  One worker thread drains a scheduler queue
    (``serve.scheduler``'s protocol, so per-tenant fairness holds here
    too), prefills each prompt against this replica's ``KVBlockPool``
    (prefix reuse included) and packages the table's blocks as a
    ``KVHandoffArtifact``.

    Every artifact is retained (LRU, ``disagg_retain_artifacts`` deep)
    until ``ack``; ``fetch`` hands it out again for a re-ingest."""

    def __init__(self, generator, kv_pool=None, scheduler=None,
                 prompt_bucket: Optional[int] = None, model: str = "",
                 weights_tag: str = "", codec: Optional[str] = None,
                 max_retained: Optional[int] = None):
        self.gen = generator
        self.model = model
        self.weights_tag = weights_tag
        self.bucket = prompt_bucket or generator.prompt_buckets[-1]
        self.pool = kv_pool or KVBlockPool.for_generator(generator)
        if self.pool.seq_len != generator.config.seq_len:
            raise ValueError(
                f"kv_pool seq_len {self.pool.seq_len} != generator seq_len "
                f"{generator.config.seq_len}")
        self._reuse = (self.pool.prefix_reuse and
                       bool(generator.prefill_chunk))
        codec = global_config.disagg_codec if codec is None else codec
        if codec != "off" and not _codec_ok(codec, generator.config.dtype):
            logger.warning("disagg_codec=%s unsupported for KV dtype %s; the "
                           "handoff ships verbatim", codec,
                           generator.config.dtype)
            codec = "off"
        self.codec = codec
        self._queue = FIFOQueue() if scheduler is None else scheduler
        self._cv = threading.Condition()
        self._retained: "OrderedDict[str, KVHandoffArtifact]" = OrderedDict()
        self._retain_cap = (global_config.disagg_retain_artifacts
                            if max_retained is None else max_retained)
        self.prefills = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- public API ----

    def prefill(self, prompt, cfg: Optional[GenerationConfig] = None,
                queue: Optional[str] = None,
                request_id: Optional[str] = None) -> KVHandoffArtifact:
        """Blocking: admit ``prompt``, prefill it, return (and retain) its
        handoff artifact."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cfg = cfg or GenerationConfig()
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.bucket:
            raise ValueError(f"prompt {len(prompt)} exceeds prefill bucket "
                             f"{self.bucket}")
        seq_len = self.gen.config.seq_len
        if len(prompt) + cfg.max_new_tokens > seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens "
                f"{cfg.max_new_tokens} exceeds seq_len {seq_len}")
        if not self.pool.fits(len(prompt)):
            raise ValueError(f"prompt {len(prompt)} needs more KV blocks "
                             "than the prefill pool holds")
        item = {"prompt": prompt, "cfg": cfg, "queue": queue or "default",
                "request_id": request_id or uuid.uuid4().hex,
                "done": threading.Event(), "artifact": None, "error": None}
        with self._cv:
            if self._stop:
                raise RuntimeError("prefill engine shut down")
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["artifact"]

    def fetch(self, request_id: str) -> Optional[KVHandoffArtifact]:
        """The retained artifact of ``request_id`` (None once acked or
        evicted): the router's re-ingest source."""
        with self._cv:
            return self._retained.get(request_id)

    def ack(self, request_id: str) -> bool:
        """Drop the retained artifact: its stream finished."""
        with self._cv:
            art = self._retained.pop(request_id, None)
        if art is not None:
            _HANDOFFS_IN_FLIGHT.dec()
        return art is not None

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()

    # ---- worker ----

    def _run(self):
        # inference mode is thread-local: the worker enters it itself
        with torch.inference_mode():
            while True:
                with self._cv:
                    while not self._stop and len(self._queue) == 0:
                        self._cv.wait()
                    if self._stop:
                        err = RuntimeError("prefill engine shut down")
                        for item in self._queue.drain():
                            item["error"] = err
                            item["done"].set()
                        return
                    item = self._queue.popleft()
                try:
                    item["artifact"] = self._prefill_one(item)
                except Exception as e:  # pylint: disable=broad-except
                    logger.exception("prefill failed")
                    item["error"] = e
                item["done"].set()

    def _prefill_one(self, item) -> KVHandoffArtifact:
        p = item["prompt"]
        gen = self.gen
        # max_new_tokens 0: this pool never decodes; it needs the prompt's
        # blocks only, released (into the prefix index) once gathered
        seq = self.pool.begin_sequence(p, 0)
        if seq is None:
            raise RuntimeError(
                "the prefill pool cannot free enough blocks (all held by "
                "the prefix index under concurrent prefills)")
        clean = False
        try:
            m = seq.matched_tokens
            lengths = gen._ints([len(p)])
            row, caches = stacked_kv_caches(gen.config, 1, gen.device)
            if m:
                # a prefix hit: the monolithic engine's hit path
                caches = self.pool.gather_dense(seq, out=row)
                logits1, _ = gen._run_chunked_prefill(
                    [p[m:]], lengths, 1, caches=caches, start=m)
            else:
                logits1, _ = gen._run_bucketed_prefill([p], lengths,
                                                       caches=caches)
            self.pool.scatter_prompt(seq, row)
            if self._reuse:
                self.pool.register_prompt(seq, p)
            nb = -(-len(p) // self.pool.block_size)
            art = KVHandoffArtifact.build(
                request_id=item["request_id"], model=self.model, prompt=p,
                cfg=dataclasses.asdict(item["cfg"]), queue=item["queue"],
                weights_tag=self.weights_tag,
                block_size=self.pool.block_size,
                layer_blocks=self.pool.gather_blocks(seq, nb),
                last_logits=logits1, codec=self.codec)
            clean = True
        finally:
            self.pool.release(seq, tokens=p if clean else None,
                              register=clean)
        self.prefills += 1
        _PREFILLS.inc()
        _HANDOFF_BYTES.inc(art.payload_nbytes)
        with self._cv:
            self._retained[art.request_id] = art
            _HANDOFFS_IN_FLIGHT.inc()
            while len(self._retained) > max(1, self._retain_cap):
                evicted, _ = self._retained.popitem(last=False)
                _HANDOFFS_IN_FLIGHT.dec()
                logger.warning(
                    "retained-artifact cap reached; dropped %s (raise "
                    "disagg_retain_artifacts if re-ingest matters more than "
                    "memory)", evicted)
        return art


# ---- decode-side ingest ----


def land_artifact(engine, artifact: KVHandoffArtifact):
    """Check and rebuild: the artifact as the one-row caches and seed
    logits the engine's prefilled admission takes.  The K/V of every layer
    cross as one host tensor, ``(2, layers, 1, span, heads, head_dim)``,
    landed on the engine's device by ``make_ingest_transfer``."""
    from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
        MeshSharding, make_ingest_transfer)
    artifact.verify()
    cfgm = engine.gen.config
    n_layers = engine._kv.shape[1]
    if len(artifact.layers) != n_layers:
        raise ValueError(f"artifact has {len(artifact.layers)} layers; the "
                         f"decode engine has {n_layers}")
    span = artifact.num_blocks * artifact.block_size
    if span > cfgm.seq_len:
        raise ValueError(f"artifact carries {span} token positions; the "
                         f"decode seq_len is {cfgm.seq_len}")
    tail = tuple(engine._kv.shape[4:])
    host = torch.empty((2, n_layers, 1, span) + tail, dtype=engine._kv.dtype)
    for i in range(n_layers):
        kb, vb = artifact.dense_rows(i, tail)
        if kb.dtype != engine._kv.dtype:
            raise ValueError(f"layer {i}: artifact KV {kb.dtype} does not "
                             f"match the decode caches' {engine._kv.dtype}")
        host[0, i, 0] = kb
        host[1, i, 0] = vb
    dst = MeshSharding(tuple(() for _ in host.shape), (1,), (0,))
    transfer = make_ingest_transfer(host.shape, host.dtype, dst,
                                    [engine.device])
    (kv,), _ = transfer([host])
    caches1 = [(kv[0, i], kv[1, i], len(artifact.prompt))
               for i in range(n_layers)]
    logits1 = artifact.last_logits.reshape(1, -1).to(engine.device)
    return caches1, logits1


def _ingest_cfg(artifact: KVHandoffArtifact) -> GenerationConfig:
    known = {f.name for f in dataclasses.fields(GenerationConfig)}
    return GenerationConfig(**{k: v for k, v in artifact.cfg.items()
                               if k in known})


def ingest_stream(engine, artifact: KVHandoffArtifact,
                  queue: Optional[str] = None):
    """The decode half of the handoff: check, land, and join the request
    to ``engine``'s decode batch between two ticks.  Returns the engine's
    token stream.  An engine with a pool scatters the prompt's blocks into
    its own pool, so prefix reuse keeps working on the decode side."""
    caches1, logits1 = land_artifact(engine, artifact)
    return engine.submit_prefilled_stream(
        artifact.prompt, _ingest_cfg(artifact), caches1, logits1,
        queue=queue or artifact.queue)


def ingest(engine, artifact: KVHandoffArtifact,
           queue: Optional[str] = None) -> np.ndarray:
    """``ingest_stream``, blocking: the prompt and its tokens."""
    caches1, logits1 = land_artifact(engine, artifact)
    return engine.submit_prefilled(
        artifact.prompt, _ingest_cfg(artifact), caches1, logits1,
        queue=queue or artifact.queue)


# ---- telemetry hooks shared with the router ----


def observe_handoff(seconds: float) -> None:
    _HANDOFF_SECONDS.observe(seconds)


def observe_ttft(pool: str, seconds: float) -> None:
    _TTFT_H.labels(pool).observe(seconds)


def observe_itl(pool: str, seconds: float) -> None:
    _ITL_H.labels(pool).observe(seconds)


def count_reingest(reason: str) -> None:
    _REINGESTS.labels(reason).inc()


def count_backpressure_shed() -> None:
    _BACKPRESSURE_SHEDS.inc()
