"""Content-addressed chunked shard store (the port of
``alpa_tpu/checkpoint/store.py``, with its on-disk layout byte for byte).

On-disk layout (one store holds EVERY step of one training run):

  root/
    chunks/<hh>/<sha256-hex>          # raw C-order bytes of one slice
    manifests/step_<%012d>.json       # one manifest per step

A *chunk* is one contiguous slice of one leaf's global array, named by
the sha256 of its bytes — identical slices across steps (frozen
embeddings, optimizer zeros) are stored once.  A *manifest* records,
per leaf, the global shape/dtype and the index-map: which global slice
each chunk covers and its hash.  "Memory-efficient array redistribution"
(PAPERS.md) motivates the slice-granular layout: restore reads only the
chunks overlapping each device's slice, so a checkpoint saved on one
mesh shape loads onto any other (resharding-on-read).

Crash atomicity: chunks are written tmp-then-rename, and the manifest is
committed (tmp + fsync + rename) strictly LAST — a ``kill -9`` at any
point mid-save leaves either no manifest for the step (the step simply
does not exist; ``latest_step()`` returns the prior one) or a fully
verifiable step.  There is no state in between.

Chunks are hashed and written, and ``verify_step`` re-hashes them, on a
pool of threads (``hashlib`` and file writes release the GIL), in the
same order and with the same dedupe counts as one thread would: the
store and its manifests are the JAX package's byte for byte.

bf16 has no numpy dtype without ``ml_dtypes``: its raw bytes are stored
(a ``uint16`` view), under the dtype name ``"bfloat16"`` as the JAX
package records it, so manifests and chunk hashes are the JAX package's;
``read_leaf_slice`` returns such a leaf as ``uint16`` (``np_dtype``).
"""
import concurrent.futures
import hashlib
import json
import logging
import os
import re
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from alpa_tpu_torch.checkpoint import metrics

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1

_MANIFEST_RE = re.compile(r"^step_(\d{12})\.json$")


class CheckpointNotFoundError(FileNotFoundError):
    """No committed manifest for the requested step (or no steps at
    all).  A save that died before manifest commit lands here — by
    design it is indistinguishable from a save that never started."""


class ChunkCorruptionError(RuntimeError):
    """A chunk's bytes do not hash to its manifest-recorded name (or the
    chunk file is missing): the step failed verification."""


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are read as: ``uint16`` for
    ``"bfloat16"`` (its raw bits), else the named dtype."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _hash_bytes(data) -> str:
    return hashlib.sha256(data).hexdigest()


_POOL = None
_POOL_LOCK = threading.Lock()


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's chunk-I/O threads (one per core, at most 8)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=max(1, min(8, os.cpu_count() or 1)),
                thread_name_prefix="ckpt-chunk")
    return _POOL


def _buffer(arr: np.ndarray) -> memoryview:
    """A C-contiguous array's bytes without a copy (``tobytes()``'s)."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def _norm_index(index) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(a), int(b)) for a, b in index)


def _index_shape(index) -> Tuple[int, ...]:
    return tuple(b - a for a, b in index)


def _overlap(a, b):
    """Intersection of two index-maps (same rank); None if empty."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


class ShardStore:
    """Content-addressed chunk + manifest store rooted at ``root``."""

    def __init__(self, root: str):
        self.root = str(root)
        self.chunk_root = os.path.join(self.root, "chunks")
        self.manifest_root = os.path.join(self.root, "manifests")
        os.makedirs(self.chunk_root, exist_ok=True)
        os.makedirs(self.manifest_root, exist_ok=True)
        self._lock = threading.Lock()

    # ---- chunks ------------------------------------------------------

    def chunk_path(self, h: str) -> str:
        return os.path.join(self.chunk_root, h[:2], h)

    def has_chunk(self, h: str) -> bool:
        return os.path.exists(self.chunk_path(h))

    def _write_chunk(self, h: str, data) -> None:
        path = self.chunk_path(h)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp_chunk_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.rename(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put_chunk(self, data: bytes) -> str:
        """Write ``data`` as a content-addressed chunk; returns its
        hash.  Idempotent: an existing chunk is never rewritten (the
        content address guarantees it is byte-identical), which is both
        the dedupe fast path and what makes retried saves safe."""
        h = _hash_bytes(data)
        path = self.chunk_path(h)
        if os.path.exists(path):
            metrics.incr("chunks_deduped")
            return h
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp_chunk_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.rename(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        metrics.incr("chunks_written")
        metrics.incr("bytes_written", len(data))
        return h

    def read_chunk(self, h: str, verify: bool = True) -> bytes:
        path = self.chunk_path(h)
        if not os.path.exists(path):
            metrics.incr("verify_failures")
            raise ChunkCorruptionError(f"chunk {h} missing from {path}")
        with open(path, "rb") as f:
            data = f.read()
        metrics.incr("bytes_read", len(data))
        if verify and _hash_bytes(data) != h:
            metrics.incr("verify_failures")
            raise ChunkCorruptionError(
                f"chunk {h} failed hash verification ({path}): the file "
                "was truncated or bit-flipped on disk")
        return data

    # ---- manifests ---------------------------------------------------

    def manifest_path(self, step: int) -> str:
        return os.path.join(self.manifest_root, f"step_{step:012d}.json")

    def commit_manifest(self, step: int, manifest: Dict[str, Any]) -> str:
        """Atomically publish the manifest: this is THE commit point of
        a step.  tmp + fsync + rename; a crash before the rename leaves
        no manifest and therefore no step."""
        path = self.manifest_path(step)
        fd, tmp = tempfile.mkstemp(dir=self.manifest_root,
                                   prefix=".tmp_manifest_")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def read_manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise CheckpointNotFoundError(
                    f"no committed checkpoint steps in {self.root}")
        path = self.manifest_path(step)
        if not os.path.exists(path):
            raise CheckpointNotFoundError(
                f"no committed manifest for step {step} in {self.root} "
                f"(committed steps: {self.all_steps()})")
        with open(path, encoding="utf-8") as f:
            manifest = json.load(f)
        version = manifest.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"manifest {path} has format_version {version}; this "
                f"build reads version {FORMAT_VERSION}")
        return manifest

    def all_steps(self) -> List[int]:
        """Committed steps only (ascending) — a mid-save crash's
        orphan chunks never surface here."""
        steps = []
        for name in os.listdir(self.manifest_root):
            m = _MANIFEST_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- tree save ---------------------------------------------------

    def write_step(self, step: int,
                   leaves: Dict[str, Dict[str, Any]],
                   plan_fingerprint: Optional[str] = None,
                   meta: Optional[Dict[str, Any]] = None,
                   chunk_bytes: int = 64 * 1024 * 1024) -> Dict[str, Any]:
        """Write one step: all chunks first, manifest commit LAST.

        ``leaves``: ``{name: {"shape", "dtype", "pieces": [(index,
        ndarray), ...]}}`` where ``index`` is the global slice the piece
        covers (``()`` for scalars).  Pieces larger than ``chunk_bytes``
        are split along their first nontrivial axis so restore I/O and
        dedupe stay slice-granular.
        """
        manifest = {
            "format_version": FORMAT_VERSION,
            "step": int(step),
            "plan_fingerprint": plan_fingerprint,
            "meta": meta or {},
            "leaves": {},
        }
        jobs = []       # (leaf name, chunk index, bytes), in order
        for name, info in leaves.items():
            for index, arr in info["pieces"]:
                arr = np.ascontiguousarray(arr)
                for sub_index, sub in self._split(index, arr, chunk_bytes):
                    jobs.append((name, sub_index, _buffer(sub)))
        pool = _pool()
        hashes = list(pool.map(lambda job: _hash_bytes(job[2]), jobs))
        # put_chunk's accounting in order: a chunk on disk, or one this
        # step already writes, is a dedupe
        writes, queued = [], set()
        for (_n, _i, data), h in zip(jobs, hashes):
            if h in queued or self.has_chunk(h):
                metrics.incr("chunks_deduped")
                continue
            queued.add(h)
            writes.append(pool.submit(self._write_chunk, h, data))
            metrics.incr("chunks_written")
            metrics.incr("bytes_written", data.nbytes)
        for fut in writes:
            fut.result()
        for name, info in leaves.items():
            manifest["leaves"][name] = {
                "shape": [int(d) for d in info["shape"]],
                "dtype": str(info["dtype"]),
                "chunks": [],
            }
        for (name, sub_index, data), h in zip(jobs, hashes):
            manifest["leaves"][name]["chunks"].append(
                {"index": [list(x) for x in sub_index], "hash": h,
                 "nbytes": data.nbytes})
        self.commit_manifest(step, manifest)
        metrics.incr("steps_committed")
        return manifest

    @staticmethod
    def _split(index, arr: np.ndarray, chunk_bytes: int):
        """Split one piece into <= chunk_bytes sub-slices along the
        first axis whose stride allows it (row-granular; never splits
        scalars or rows bigger than the target)."""
        index = _norm_index(index) if index else ()
        if arr.nbytes <= chunk_bytes or arr.ndim == 0 or arr.shape[0] <= 1:
            yield index, arr
            return
        row_bytes = arr.nbytes // arr.shape[0]
        rows = max(1, chunk_bytes // max(1, row_bytes))
        a0 = index[0][0]
        for start in range(0, arr.shape[0], rows):
            stop = min(arr.shape[0], start + rows)
            sub_index = ((a0 + start, a0 + stop),) + index[1:]
            yield sub_index, arr[start:stop]

    # ---- tree restore (resharding-on-read) ---------------------------

    def read_leaf_slice(self, leaf: Dict[str, Any], index,
                        verify: bool = True) -> np.ndarray:
        """Assemble one requested global slice of a leaf from every
        overlapping chunk — the resharding-on-read core: the requested
        slice need not match any slice the save wrote."""
        index = _norm_index(index) if index else ()
        dtype = np_dtype(leaf["dtype"])
        out = np.empty(_index_shape(index), dtype)
        filled = np.zeros(out.shape, bool) if out.ndim else None
        for ent in leaf["chunks"]:
            cidx = _norm_index(ent["index"]) if ent["index"] else ()
            if not index:
                # scalar leaf: the single chunk IS the value
                data = self.read_chunk(ent["hash"], verify)
                return np.frombuffer(data, dtype).reshape(())
            ov = _overlap(index, cidx)
            if ov is None:
                continue
            data = self.read_chunk(ent["hash"], verify)
            chunk = np.frombuffer(data, dtype).reshape(_index_shape(cidx))
            src = tuple(slice(lo - c0, hi - c0)
                        for (lo, hi), (c0, _c1) in zip(ov, cidx))
            dst = tuple(slice(lo - r0, hi - r0)
                        for (lo, hi), (r0, _r1) in zip(ov, index))
            out[dst] = chunk[src]
            filled[dst] = True
        if filled is not None and not filled.all():
            raise ChunkCorruptionError(
                "checkpoint does not cover the requested slice "
                f"{index}: the manifest's index-map has holes (truncated "
                "save or mismatched leaf)")
        return out

    # ---- verification / retention ------------------------------------

    def verify_step(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Re-hash every chunk the step references.  Returns a report;
        ``report["ok"]`` is False when anything is missing/corrupt."""
        manifest = self.read_manifest(step)
        bad: List[Dict[str, str]] = []
        ents = [(name, ent) for name, leaf in manifest["leaves"].items()
                for ent in leaf["chunks"]]
        n_chunks = len(ents)
        n_bytes = sum(ent["nbytes"] for _n, ent in ents)

        def check(item):
            name, ent = item
            try:
                self.read_chunk(ent["hash"], verify=True)
            except ChunkCorruptionError as e:
                return {"leaf": name, "hash": ent["hash"], "error": str(e)}
            return None
        bad = [b for b in _pool().map(check, ents) if b is not None]
        return {"step": manifest["step"], "ok": not bad,
                "n_chunks": n_chunks, "n_bytes": n_bytes, "bad": bad}

    def last_verified_step(self) -> Optional[int]:
        """Newest step whose every chunk passes hash verification —
        the restore target after a crash or partial disk loss."""
        for step in reversed(self.all_steps()):
            try:
                if self.verify_step(step)["ok"]:
                    return step
            except (ValueError, OSError, json.JSONDecodeError):
                continue
        return None

    def delete_step(self, step: int) -> None:
        """Drop the step's manifest (its chunks stay until ``gc`` —
        other manifests may reference them)."""
        path = self.manifest_path(step)
        if os.path.exists(path):
            os.unlink(path)

    def referenced_hashes(self) -> set:
        refs = set()
        for step in self.all_steps():
            manifest = self.read_manifest(step)
            for leaf in manifest["leaves"].values():
                for ent in leaf["chunks"]:
                    refs.add(ent["hash"])
        return refs

    def gc(self) -> Dict[str, int]:
        """Delete every chunk not referenced by a surviving manifest
        (run after retention deletes manifests, or to reclaim a crashed
        save's orphans).  Concurrency note: the single-writer
        CheckpointManager serializes gc against saves; do not run an
        external gc while a save is in flight."""
        with self._lock:
            refs = self.referenced_hashes()
            removed = 0
            freed = 0
            for sub in os.listdir(self.chunk_root):
                subdir = os.path.join(self.chunk_root, sub)
                if not os.path.isdir(subdir):
                    continue
                for name in os.listdir(subdir):
                    if name.startswith(".tmp_"):
                        # abandoned tmp file from a crashed writer
                        pass
                    elif name in refs:
                        continue
                    path = os.path.join(subdir, name)
                    freed += os.path.getsize(path)
                    os.unlink(path)
                    removed += 1
        metrics.incr("gc_chunks_removed", removed)
        metrics.incr("gc_bytes_freed", freed)
        return {"chunks_removed": removed, "bytes_freed": freed}
