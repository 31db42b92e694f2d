"""Paged KV cache with cross-request prefix reuse (counterpart of
``alpa_tpu/serve/kv_cache.py``).

The serving engine decodes on its dense resident caches (``(B, seq_len,
heads, head_dim)`` per layer); this pool is the storage tier behind them.
KV lives in fixed-size token blocks, each sequence owns a block table,
blocks are refcounted with copy-on-write, and a hash-chain index over
full-block contents lets a request whose prompt shares a token prefix with
a live, finished or warmed one skip recomputing those blocks: they are
gathered back into the dense row and prefill resumes at the match offset.

The bookkeeping is the JAX package's, line for line, so block ids,
refcounts, hits, evictions and chain keys equal its own over the same calls.
The data movement differs in form only: the JAX pool's jitted, donated
functions are in-place ``index_put_``/``copy_`` here, on one store
allocated once, ``(2, layers, num_blocks + 1, block_size, heads,
head_dim)`` (``_kp[l]``/``_vp[l]`` are the per-layer views, shaped as the
JAX pool's arrays), so one indexing op moves a block set across every
layer.  Block 0 is the scratch block, never handed out.

Eviction only touches blocks whose sole reference is the prefix index
(refcount 1, leaf entries, not pinned), so dropping a cached prefix under
pressure never corrupts a live sequence.  Bookkeeping runs under an
internal lock so that readers on other threads (``stats``) stay
consistent; the engine loop is the one writer of the block data.
"""
import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.platform import get_device, to_device
from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

_REG = _tmetrics.get_registry()
_BLOCKS_IN_USE = _REG.gauge(
    "alpa_kv_blocks_in_use",
    "KV pool blocks held by live sequences or the prefix index")
_PREFIX_HITS = _REG.counter(
    "alpa_kv_prefix_hits_total",
    "Admissions that reused at least one cached prefix block")
_BYTES_SAVED = _REG.counter(
    "alpa_kv_bytes_saved_total",
    "KV bytes served from the prefix index instead of recomputed")
_EVICTIONS = _REG.counter(
    "alpa_kv_evictions_total",
    "Prefix-index blocks evicted under pool pressure")

_ROOT = b"alpa-kv-root"


class KVPoolExhaustedError(RuntimeError):
    """A single request needs more blocks than the pool can ever free."""


def stacked_kv_caches(config, batch_size: int, device=None):
    """Zeroed KV caches of all layers in one tensor, ``(2, layers, batch,
    seq_len, heads, head_dim)``, and the per-layer ``(k, v, 0)`` list of
    views into it that ``GPTModel`` takes."""
    hd = config.hidden_size // config.num_heads
    kv = torch.zeros((2, config.num_layers, batch_size, config.seq_len,
                      config.num_heads, hd), dtype=config.dtype,
                     device=device)
    return kv, [(kv[0, i], kv[1, i], 0) for i in range(config.num_layers)]


class PagedSequence:
    """One sequence's block table: ``ids[i]`` backs token positions
    ``[i*block_size, (i+1)*block_size)``.  Capacity is reserved up front
    (prompt + max_new_tokens), so admission is the only backpressure
    point: a decoding sequence never runs out of blocks."""

    __slots__ = ("ids", "block_size", "prompt_len", "matched_tokens",
                 "capacity_tokens")

    def __init__(self, ids: List[int], block_size: int, prompt_len: int,
                 matched_tokens: int, capacity_tokens: int):
        self.ids = ids
        self.block_size = block_size
        self.prompt_len = prompt_len
        self.matched_tokens = matched_tokens
        self.capacity_tokens = capacity_tokens

    def block_of(self, pos: int) -> int:
        return self.ids[pos // self.block_size]


class _Entry:
    """One cached full block in the prefix index.  ``key`` is the chain
    hash H(parent_key, block_tokens): equal keys mean equal token paths
    from the sequence start, so the cached KV is what recomputation would
    give."""

    __slots__ = ("key", "parent", "block", "pinned")

    def __init__(self, key: bytes, parent: bytes, block: int,
                 pinned: bool):
        self.key = key
        self.parent = parent
        self.block = block
        self.pinned = pinned


def _chain_key(parent: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.sha256(parent)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


class KVBlockPool:
    """Refcounted block pool + prefix index for one engine.

    A pool is bound to one model's weights (cached KV is valid only for
    the weights that produced it).  ``device`` defaults to CUDA and raises
    without it.  ``write_seconds``/``write_calls``: host time and calls of
    ``write_tokens``, the per-tick mirror of decode K/V into the blocks.
    """

    def __init__(self, config, num_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 prefix_reuse: Optional[bool] = None, device=None):
        bs = block_size or global_config.kv_block_size
        if bs <= 0:
            raise ValueError(f"kv_block_size must be positive, got {bs}")
        if config.seq_len % bs:
            raise ValueError(
                f"kv_block_size {bs} must divide seq_len "
                f"{config.seq_len} (block tables tile the cache exactly)")
        n = (num_blocks if num_blocks is not None else
             global_config.kv_cache_blocks)
        self.blocks_per_seq = config.seq_len // bs
        if not n:
            # standalone default: two sequences' worth (for_generator
            # sizes the pool for an engine batch)
            n = 2 * self.blocks_per_seq
        self.block_size = bs
        self.num_blocks = int(n)
        self.seq_len = config.seq_len
        self.prefix_reuse = (global_config.kv_prefix_reuse
                             if prefix_reuse is None else prefix_reuse)
        self.config = config
        self.device = get_device(device)

        hd = config.hidden_size // config.num_heads
        self._kv = torch.zeros(
            (2, config.num_layers, self.num_blocks + 1, bs,
             config.num_heads, hd), dtype=config.dtype, device=self.device)
        self._kp = list(self._kv[0])
        self._vp = list(self._kv[1])
        self.token_bytes = (2 * config.num_layers * config.num_heads * hd *
                            self._kv.element_size())
        self.block_bytes = self.token_bytes * bs

        self._lock = threading.RLock()
        self._rc = np.zeros(self.num_blocks + 1, np.int64)
        self._rc[0] = 1  # scratch: permanently reserved
        self._free = list(range(self.num_blocks, 0, -1))
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._children: Dict[bytes, set] = {}
        self.prefix_hits = 0
        self.bytes_saved = 0
        self.evictions = 0
        self.write_seconds = 0.0
        self.write_calls = 0

    @classmethod
    def for_generator(cls, generator, max_batch: int = 4,
                      **kwargs) -> "KVBlockPool":
        """A pool for an engine over ``generator``, on its device: knob
        ``kv_cache_blocks`` when set, else one full batch of sequences
        plus one batch's worth of headroom for cached prefixes."""
        cfg = generator.config
        bs = kwargs.get("block_size") or global_config.kv_block_size
        n = global_config.kv_cache_blocks or \
            (2 * max_batch * (cfg.seq_len // max(1, bs)))
        if kwargs.get("num_blocks") is None:
            kwargs["num_blocks"] = n
        kwargs.setdefault("device", generator.device)
        return cls(cfg, **kwargs)

    # ---- capacity ---------------------------------------------------

    def _pinned_blocks(self) -> int:
        return sum(1 for e in self._entries.values() if e.pinned)

    def fits(self, total_tokens: int) -> bool:
        """Whether a request of ``total_tokens`` (prompt + max new) can
        ever be admitted: pinned prefix blocks are unreclaimable."""
        need = -(-total_tokens // self.block_size)
        with self._lock:
            return need <= self.num_blocks - self._pinned_blocks()

    def blocks_in_use(self) -> int:
        with self._lock:
            return self.num_blocks - len(self._free)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "blocks_in_use": self.num_blocks - len(self._free),
                "cached_entries": len(self._entries),
                "pinned_entries": self._pinned_blocks(),
                "prefix_hits": self.prefix_hits,
                "bytes_saved": self.bytes_saved,
                "evictions": self.evictions,
            }

    # ---- refcounting ------------------------------------------------

    def _decref(self, block: int):
        self._rc[block] -= 1
        if self._rc[block] < 0:
            raise AssertionError(f"block {block} refcount underflow")
        if self._rc[block] == 0:
            self._free.append(block)
            _BLOCKS_IN_USE.set(self.num_blocks - len(self._free))

    def _evict_one(self) -> bool:
        """Drop the least recently used evictable index entry (leaf, not
        pinned, no other holders).  Parents are touched at least as
        recently as their children on a match walk, so LRU order visits
        children first: eviction peels chains from the tail."""
        for key in list(self._entries):
            e = self._entries[key]
            if e.pinned or self._children.get(key):
                continue
            if self._rc[e.block] != 1:
                continue  # a live sequence still shares this block
            del self._entries[key]
            sibs = self._children.get(e.parent)
            if sibs is not None:
                sibs.discard(key)
                if not sibs:
                    del self._children[e.parent]
            self._decref(e.block)
            self.evictions += 1
            _EVICTIONS.inc()
            return True
        return False

    def _allocate(self, n: int) -> Optional[List[int]]:
        while len(self._free) < n:
            if not self._evict_one():
                return None
        got = [self._free.pop() for _ in range(n)]
        for b in got:
            self._rc[b] = 1
        _BLOCKS_IN_USE.set(self.num_blocks - len(self._free))
        return got

    # ---- prefix index -----------------------------------------------

    def _match_and_ref(self, tokens: np.ndarray) -> List[int]:
        """Walk the hash chain over full prompt blocks, taking a reference
        on every hit.  Capped so that at least the final prompt token is
        recomputed: its logits seed decode."""
        bs = self.block_size
        cap = (len(tokens) - 1) // bs
        matched, parent = [], _ROOT
        for i in range(cap):
            key = _chain_key(parent, tokens[i * bs:(i + 1) * bs])
            e = self._entries.get(key)
            if e is None:
                break
            self._rc[e.block] += 1
            self._entries.move_to_end(key)
            matched.append(e.block)
            parent = key
        return matched

    def _register_chain(self, tokens: np.ndarray, ids: List[int],
                        pinned: bool = False) -> int:
        """Insert every full block of ``tokens`` into the index (the index
        holds its own reference).  Existing entries win: keys are
        path-unique, so a duplicate block is not indexed twice."""
        bs = self.block_size
        parent, added = _ROOT, 0
        for i in range(len(tokens) // bs):
            key = _chain_key(parent, tokens[i * bs:(i + 1) * bs])
            e = self._entries.get(key)
            if e is None:
                e = _Entry(key, parent, ids[i], pinned)
                self._entries[key] = e
                self._children.setdefault(parent, set()).add(key)
                self._rc[ids[i]] += 1
                added += 1
            elif pinned:
                e.pinned = True
            self._entries.move_to_end(key)
            parent = key
        return added

    # ---- sequence lifecycle -----------------------------------------

    def begin_sequence(self, tokens, max_new_tokens: int
                       ) -> Optional[PagedSequence]:
        """Reserve a block table for prompt + max_new_tokens, reusing
        cached prefix blocks where the index matches.  Returns ``None``
        when the pool cannot free enough blocks now (live sequences hold
        them: the caller waits for a decode tick); raises
        ``KVPoolExhaustedError`` when the request can never fit."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        total = len(tokens) + int(max_new_tokens)
        need = -(-total // self.block_size)
        with self._lock:
            if need > self.num_blocks - self._pinned_blocks():
                raise KVPoolExhaustedError(
                    f"request needs {need} blocks; pool has "
                    f"{self.num_blocks} ({self._pinned_blocks()} pinned)")
            matched: List[int] = []
            if self.prefix_reuse:
                matched = self._match_and_ref(tokens)
            got = self._allocate(need - len(matched))
            if got is None:
                for b in matched:
                    self._decref(b)
                return None
            seq = PagedSequence(
                ids=matched + got, block_size=self.block_size,
                prompt_len=len(tokens),
                matched_tokens=len(matched) * self.block_size,
                capacity_tokens=need * self.block_size)
            if matched:
                self.prefix_hits += 1
                self.bytes_saved += len(matched) * self.block_bytes
                _PREFIX_HITS.inc()
                _BYTES_SAVED.inc(len(matched) * self.block_bytes)
            return seq

    def release(self, seq: PagedSequence, tokens=None,
                register: bool = True):
        """Return a sequence's blocks.  With ``register`` (and reuse on),
        every full block of ``tokens`` (prompt + generated) is first
        published to the prefix index, whose reference keeps it alive."""
        with self._lock:
            if register and self.prefix_reuse and tokens is not None:
                tokens = np.asarray(tokens, np.int32).reshape(-1)
                self._register_chain(tokens, seq.ids)
            for b in seq.ids:
                self._decref(b)
            seq.ids = []

    def register_prompt(self, seq: PagedSequence, tokens):
        """Publish a live sequence's full prompt blocks right after its
        admission, so concurrent requests sharing the prefix hit while it
        still decodes."""
        if not self.prefix_reuse:
            return
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        nfull = (len(tokens) // self.block_size) * self.block_size
        with self._lock:
            self._register_chain(tokens[:nfull], seq.ids)

    # ---- copy-on-write ----------------------------------------------

    def fork(self, seq: PagedSequence) -> PagedSequence:
        """A second table over the same blocks (shared until written)."""
        with self._lock:
            for b in seq.ids:
                self._rc[b] += 1
            return PagedSequence(
                ids=list(seq.ids), block_size=seq.block_size,
                prompt_len=seq.prompt_len,
                matched_tokens=seq.matched_tokens,
                capacity_tokens=seq.capacity_tokens)

    def ensure_writable(self, seq: PagedSequence, block_idx: int) -> int:
        """Copy-on-write: before writing into ``seq.ids[block_idx]``, give
        the sequence a private copy if another table or the index holds
        the block."""
        with self._lock:
            b = seq.ids[block_idx]
            if self._rc[b] <= 1:
                return b
            got = self._allocate(1)
            if got is None:
                raise KVPoolExhaustedError(
                    "no free block for copy-on-write")
            dst = got[0]
            self._kv[:, :, dst] = self._kv[:, :, b]
            self._decref(b)
            seq.ids[block_idx] = dst
            return dst

    # ---- device data movement ---------------------------------------

    def _ids(self, ids: List[int]) -> torch.Tensor:
        return to_device(torch.tensor(ids, dtype=torch.int64), self.device)

    def gather_dense(self, seq: PagedSequence, out: torch.Tensor):
        """The matched prefix region of ``seq`` written into ``out``, a
        stacked ``(2, layers, 1, seq_len, heads, head_dim)`` row (an engine
        row, written in place), and returned as the dense per-layer caches
        ``[(k, v, matched_tokens)]`` with the int write index at the match
        offset, as ``Generator._run_chunked_prefill`` resumes from them.
        Positions past the match keep what ``out`` held: the causal mask
        gives them weight 0."""
        m = seq.matched_tokens // self.block_size
        if m:
            ids = self._ids(seq.ids[:m])
            with self._lock:
                out[:, :, 0, :m * self.block_size] = \
                    self._kv[:, :, ids].flatten(2, 3)
        return [(out[0, i], out[1, i], seq.matched_tokens)
                for i in range(out.shape[1])]

    def gather_blocks(self, seq: PagedSequence, num_blocks: int):
        """The first ``num_blocks`` blocks of ``seq`` as host tensors
        ``[(k, v)]`` per layer, each ``(num_blocks, block_size, heads,
        head_dim)`` in the pool's dtype (bf16 included): gather moves the
        bits unchanged."""
        ids = self._ids(seq.ids[:num_blocks])
        with self._lock:
            blocks = self._kv[:, :, ids].cpu()
        return [(blocks[0, i], blocks[1, i]) for i in range(blocks.shape[1])]

    def scatter_prompt(self, seq: PagedSequence, dense: torch.Tensor):
        """Store the freshly prefilled prompt region of one dense row (a
        stacked ``(2, layers, 1, seq_len, heads, head_dim)`` tensor) into
        the sequence's new blocks; matched blocks already hold the same
        bits and are skipped."""
        m = seq.matched_tokens // self.block_size
        nprompt = -(-seq.prompt_len // self.block_size)
        if nprompt <= m:
            return
        bs = self.block_size
        ids = self._ids(seq.ids[m:nprompt])
        src = dense[:, :, 0, m * bs:nprompt * bs].unflatten(
            2, (nprompt - m, bs))
        with self._lock:
            self._kv[:, :, ids] = src

    def write_tokens(self, batch_kv: torch.Tensor,
                     tables: List[Optional[PagedSequence]], positions):
        """Per decode tick: copy each row's just-written K/V position from
        the dense batch caches (stacked, ``(2, layers, B, seq_len, heads,
        head_dim)``) into its table's block, all layers and rows in one
        ``index_put_``.  Rows without a table are
        skipped (the JAX pool writes them into scratch: one shape for its
        one compile)."""
        tic = time.perf_counter()
        rows, blocks, offs, pos = [], [], [], []
        for r, t in enumerate(tables):
            if t is None:
                continue
            p = int(positions[r])
            if p >= t.capacity_tokens:
                raise AssertionError(
                    f"row {r} wrote past its reserved blocks "
                    f"({p} >= {t.capacity_tokens})")
            rows.append(r)
            blocks.append(t.block_of(p))
            offs.append(p % self.block_size)
            pos.append(p)
        if rows:
            idx = self._ids([rows, pos, blocks, offs])
            with self._lock:
                self._kv[:, :, idx[2], idx[3]] = \
                    batch_kv[:, :, idx[0], idx[1]]
        self.write_seconds += time.perf_counter() - tic
        self.write_calls += 1

    # ---- warmed (registered) prefixes -------------------------------

    def warm_prefix(self, generator, prefix_ids) -> int:
        """Precompute a system prompt's KV into pinned index entries
        (requests then send full prompts and match any number of warmed
        prefixes).  Returns the number of tokens warmed."""
        ids = np.asarray(prefix_ids, np.int32).reshape(-1)
        nfull = len(ids) // self.block_size
        if nfull == 0 or not self.prefix_reuse:
            return 0
        span = nfull * self.block_size
        with torch.inference_mode():
            lengths = torch.tensor([span], device=generator.device)
            dense, caches = stacked_kv_caches(self.config, 1,
                                              generator.device)
            if generator.prefill_chunk:
                generator._run_chunked_prefill([ids[:span]], lengths, 1,
                                               caches=caches)
            else:
                generator._run_bucketed_prefill([ids[:span]], lengths,
                                                caches=caches)
            with self._lock:
                got = self._allocate(nfull)
                if got is None:
                    raise KVPoolExhaustedError(
                        f"cannot pin {nfull} blocks for a warmed prefix")
            seq = PagedSequence(ids=got, block_size=self.block_size,
                                prompt_len=span, matched_tokens=0,
                                capacity_tokens=span)
            self.scatter_prompt(seq, dense)
        with self._lock:
            self._register_chain(ids[:span], got, pinned=True)
            # drop the bootstrap references; the pinned entries keep the
            # blocks alive
            for b in got:
                self._decref(b)
        logger.info("warmed %d prefix tokens (%d pinned blocks)", span,
                    nfull)
        return span
