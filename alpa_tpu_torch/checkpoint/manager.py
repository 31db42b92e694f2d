"""Asynchronous distributed checkpoint manager (the port of
``alpa_tpu/checkpoint/manager.py``).

``CheckpointManager`` is the training loop's API over
:class:`~alpa_tpu_torch.checkpoint.store.ShardStore`:

* **Asynchronous saves** — ``save(step, state)`` blocks only for the
  previous step's disk write (at most one in flight) and for the
  device-to-host copies of the new state.  Those copies finish before
  ``save`` returns: a train step writes its donated state in place, so a
  copy still in flight would read the next step's values.  Hashing,
  chunk writes, the manifest commit and retention run on a background
  thread.  ``last_blocking_seconds`` is how long the loop was stalled.
* **Save failures surface** — a background write that fails re-raises
  (as :class:`CheckpointSaveError`) from the next ``save()`` or
  ``wait()``; the failed step has no manifest.
* **Resume safety** — ``restore`` checks the manifest's
  ``plan_fingerprint`` against the caller's (``executable.
  get_plan_fingerprint()``) and raises :class:`PlanFingerprintMismatch`
  rather than load a state into a differently parallelized program.
* **Resharding on read** — each leaf is placed as the target's leaf is (a
  ``DistributedArray`` reads only its blocks' slices through
  ``ShardStore.read_leaf_slice``), or as ``shardings`` says; the saving
  plan's degree does not matter.  ``in_place=True`` writes into the live
  state's own tensors (``copy_``), so CUDA graphs that read those
  addresses replay with no recapture.

``RecoveryCheckpointer`` plugs a manager into
:class:`alpa_tpu_torch.fault.RecoveryManager`: a durable snapshot on
entry to RECOVERING, and a restore of the last verified step when
recovery brings the mesh back.
"""
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from alpa_tpu_torch import serialization as _ser
from alpa_tpu_torch.checkpoint import metrics
from alpa_tpu_torch.checkpoint.policy import RetentionPolicy
from alpa_tpu_torch.checkpoint.store import (CheckpointNotFoundError,
                                             ShardStore)
from alpa_tpu_torch.checkpoint.store import _pool as _store_pool
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)


class CheckpointSaveError(RuntimeError):
    """A background checkpoint write failed.  ``step`` is the step that
    was lost; the store holds no manifest for it."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(
            f"checkpoint save of step {step} failed: "
            f"{type(cause).__name__}: {cause}")
        self.step = step
        self.cause = cause


class PlanFingerprintMismatch(RuntimeError):
    """The checkpoint was saved under a different parallel plan than the
    one resuming: loading it would scatter a state into executables
    compiled for other shardings.  Re-solve or pass the saved plan."""


def _first_error_cancels(fn, items):
    """``fn`` over ``items`` on the store's threads, results in order; the
    first error cancels the reads not yet started and is raised (a
    corrupt chunk fails a restore without reading the rest)."""
    import concurrent.futures
    futures = [_store_pool().submit(fn, item) for item in items]
    done, _ = concurrent.futures.wait(
        futures, return_when=concurrent.futures.FIRST_EXCEPTION)
    for fut in done:
        if fut.exception() is not None:
            for other in futures:
                other.cancel()
            raise fut.exception()
    return [fut.result() for fut in futures]


def _key(index):
    return tuple(tuple(x) for x in index)


def _sync_leaves(flat) -> None:
    """Order the copies after the work that wrote the leaves: each card's
    current stream is synchronised once (an event on it, waited for)."""
    devices = set()
    for _path, leaf in flat.values():
        tensors = leaf.shards if isinstance(leaf, DistributedArray) else \
            [leaf] if isinstance(leaf, torch.Tensor) else []
        devices.update(t.device for t in tensors if t.device.type == "cuda")
    for d in devices:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(d))
        done.synchronize()


class CheckpointManager:
    """See the module docstring.  Single-process: every block of every
    leaf is addressable here."""

    def __init__(self, root: str,
                 policy: Optional[RetentionPolicy] = None,
                 async_save: bool = True,
                 chunk_bytes: int = 64 * 1024 * 1024):
        self.store = ShardStore(root)
        self.policy = policy
        self.async_save = async_save
        self.chunk_bytes = chunk_bytes
        self._pending: Optional[threading.Thread] = None
        self._pending_step: Optional[int] = None
        self._errors: List[CheckpointSaveError] = []
        self._err_lock = threading.Lock()
        self.last_staging_seconds = 0.0
        self.last_write_seconds = 0.0
        self.last_blocking_seconds = 0.0
        self.last_restore_seconds = 0.0
        self.last_bytes = 0

    # ---- save --------------------------------------------------------

    def save(self, step: int, state: Any,
             plan_fingerprint: Optional[str] = None,
             executable: Any = None,
             meta: Optional[Dict[str, Any]] = None,
             sync: Optional[bool] = None) -> None:
        """Checkpoint ``state`` (a ``TrainState`` or any tree of tensors)
        as ``step``.  ``executable`` (anything with
        ``get_plan_fingerprint()``) or ``plan_fingerprint`` stamps the
        manifest for resume validation.  ``sync=True`` writes inline;
        the default follows ``async_save``."""
        self._raise_pending_error()
        if plan_fingerprint is None and executable is not None:
            plan_fingerprint = executable.get_plan_fingerprint()

        t0 = time.monotonic()
        save_span = _ttrace.begin(
            "checkpoint.save", "checkpoint",
            {"step": step} if _ttrace.enabled() else None)
        # at most one write in flight: step N's write lands (or fails)
        # before step N+1's chunks reach the store, which also keeps
        # retention's gc from racing fresh chunk files
        self._join_pending()
        t_joined = time.monotonic()

        flat = _ser.flat_leaves(state)
        _sync_leaves(flat)
        leaves: Dict[str, Dict[str, Any]] = {}
        staged_bytes = 0
        for name, (_path, leaf) in flat.items():
            # the device-to-host copies: the part of a save that waits
            shape, dtype, pieces = _ser.leaf_pieces(leaf)
            staged_bytes += sum(p.nbytes for _i, p in pieces)
            leaves[name] = {"shape": shape, "dtype": dtype,
                            "pieces": pieces}
        t_staged = time.monotonic()
        self.last_staging_seconds = t_staged - t_joined
        self.last_bytes = staged_bytes
        metrics.incr("staging_seconds", self.last_staging_seconds)
        metrics.incr("staged_bytes", staged_bytes)

        def write():
            w0 = time.monotonic()
            wtok = (_ttrace.begin("checkpoint.write", "checkpoint",
                                  {"step": step}, "ckpt-writer")
                    if _ttrace.enabled() else None)
            try:
                self.store.write_step(
                    step, leaves, plan_fingerprint=plan_fingerprint,
                    meta=meta, chunk_bytes=self.chunk_bytes)
                self._apply_retention()
            except BaseException as e:  # pylint: disable=broad-except
                logger.exception("async checkpoint write of step %d "
                                 "failed", step)
                with self._err_lock:
                    self._errors.append(CheckpointSaveError(step, e))
                metrics.incr("save_failures")
                return
            finally:
                self.last_write_seconds = time.monotonic() - w0
                metrics.incr("write_seconds", self.last_write_seconds)
                _ttrace.end(wtok)
            metrics.incr("saves")

        if sync if sync is not None else not self.async_save:
            write()
            self.last_blocking_seconds = time.monotonic() - t0
            self._raise_pending_error()
        else:
            t = threading.Thread(target=write, daemon=True,
                                 name=f"ckpt-write-{step}")
            self._pending = t
            self._pending_step = step
            t.start()
            self.last_blocking_seconds = time.monotonic() - t0
        metrics.incr("blocking_seconds", self.last_blocking_seconds)
        _ttrace.end(save_span)

    def _apply_retention(self):
        if self.policy is None:
            return
        doomed = self.policy.to_delete(self.store.all_steps())
        for s in doomed:
            self.store.delete_step(s)
        if doomed:
            self.store.gc()
            logger.info("retention dropped steps %s", doomed)

    def _join_pending(self):
        t = self._pending
        if t is not None:
            t.join()
            self._pending = None
            self._pending_step = None

    def _raise_pending_error(self):
        with self._err_lock:
            if self._errors:
                raise self._errors.pop(0)

    def wait(self) -> None:
        """Block until the write in flight lands; re-raise the first
        background failure (``CheckpointSaveError``)."""
        self._join_pending()
        self._raise_pending_error()

    # ---- introspection ----------------------------------------------

    def latest_step(self) -> Optional[int]:
        return self.store.latest_step()

    def all_steps(self) -> List[int]:
        return self.store.all_steps()

    def last_verified_step(self) -> Optional[int]:
        return self.store.last_verified_step()

    # ---- restore -----------------------------------------------------

    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Any = None,
                expected_plan_fingerprint: Optional[str] = None,
                executable: Any = None,
                verify: bool = True,
                in_place: bool = False) -> Any:
        """Restore ``target``'s structure from ``step`` (default: the
        latest committed).  Each leaf is placed as ``target``'s leaf is,
        or as the leaf of ``shardings`` (a tree matching ``target``: a
        ``serialization.ShardLayout`` or a ``DistributedArray``) says, reading only the chunks that cover
        each block.  ``in_place`` copies into ``target``'s own tensors
        and returns the target's structure holding them.  ``verify``
        re-hashes every chunk read, so a bit-flipped or truncated chunk
        raises ``ChunkCorruptionError`` before anything is written
        (an in-place restore reads every leaf first)."""
        t0 = time.monotonic()
        restore_span = _ttrace.begin(
            "checkpoint.restore", "checkpoint",
            {"step": step} if _ttrace.enabled() else None)
        if expected_plan_fingerprint is None and executable is not None:
            expected_plan_fingerprint = executable.get_plan_fingerprint()
        manifest = self.store.read_manifest(step)
        saved_fp = manifest.get("plan_fingerprint")
        if expected_plan_fingerprint is not None:
            if saved_fp is None:
                logger.warning(
                    "checkpoint step %s carries no plan fingerprint; "
                    "cannot validate resume plan", manifest["step"])
            elif saved_fp != expected_plan_fingerprint:
                raise PlanFingerprintMismatch(
                    f"checkpoint step {manifest['step']} was saved under "
                    f"plan {saved_fp[:12]}… but this run compiled plan "
                    f"{expected_plan_fingerprint[:12]}…; restore with "
                    "the saved parallel plan (parallel_plan.plan_to_"
                    "method) or re-checkpoint under the new plan")

        flat = _ser.flat_leaves(target)
        layouts = {}
        if shardings is not None:
            layouts = {path: lay for _n, (path, lay) in
                       _ser.flat_leaves(shardings).items()}
        readers = {}
        for name, (path, _leaf) in flat.items():
            info = manifest["leaves"].get(name)
            if info is None:
                raise KeyError(
                    f"checkpoint step {manifest['step']} has no leaf "
                    f"{name!r}; saved leaves: "
                    f"{sorted(manifest['leaves'])[:8]}…")

            def read(index, _info=info):
                return self.store.read_leaf_slice(_info, index,
                                                  verify=verify)
            readers[name] = (info, read)
        # every leaf read (and hash-verified) on the store's threads; an
        # in-place restore reads everything before its first write, so
        # that a corrupt step leaves the live state untouched
        def read_leaf(item):
            name, (path, leaf) = item
            info, read = readers[name]
            shape, dtype = tuple(info["shape"]), info["dtype"]
            if in_place and _ser.is_tensor_leaf(leaf):
                return name, {_key(index): read(index) for index in
                              _ser.leaf_indices(leaf, shape)}
            return name, _ser.place_leaf(leaf, read, shape, dtype,
                                         layouts.get(path))
        read_back = dict(_first_error_cancels(read_leaf, flat.items()))
        new_flat = {}
        for name, (path, leaf) in flat.items():
            got = read_back[name]
            if in_place and _ser.is_tensor_leaf(leaf):
                info = readers[name][0]
                _ser.copy_leaf_(leaf, lambda index, _g=got: _g[_key(index)],
                                tuple(info["shape"]), info["dtype"])
                got = leaf
            new_flat[path] = got
        restored = _ser.rebuild(target, new_flat)
        self.last_restore_seconds = time.monotonic() - t0
        metrics.incr("restores")
        metrics.incr("restore_seconds", self.last_restore_seconds)
        _ttrace.end(restore_span)
        return restored


class RecoveryCheckpointer:
    """Durable backend for :class:`alpa_tpu_torch.fault.RecoveryManager`.

    * ``snapshot_hook`` — on entry to RECOVERING the recovery manager
      quiesces the work in flight, then this hook writes a synchronous
      snapshot: durability before the re-probe gamble.
    * restore on recover — when the state machine goes RECOVERING or
      DEGRADED -> HEALTHY, the last *verified* step is restored and
      handed to ``state_setter`` before the resume hook runs.

    ``state_provider()`` returns the live state to snapshot (and the
    restore target); ``step_provider()`` the step to save under (default:
    one past the newest committed step).  ``plan_fingerprint`` or
    ``executable`` makes resume refuse checkpoints of another plan.
    """

    def __init__(self, manager: CheckpointManager, recovery,
                 state_provider: Callable[[], Any],
                 state_setter: Optional[Callable[[Any], Any]] = None,
                 step_provider: Optional[Callable[[], int]] = None,
                 shardings_provider: Optional[Callable[[], Any]] = None,
                 plan_fingerprint: Optional[str] = None,
                 executable: Any = None):
        from alpa_tpu_torch.fault import MeshHealth
        self.manager = manager
        self.recovery = recovery
        self.state_provider = state_provider
        self.state_setter = state_setter
        self.step_provider = step_provider or (
            lambda: (manager.latest_step() or 0) + 1)
        self.shardings_provider = shardings_provider
        if plan_fingerprint is None and executable is not None:
            plan_fingerprint = executable.get_plan_fingerprint()
        self.plan_fingerprint = plan_fingerprint
        self.snapshots_saved = 0
        self.restores_done = 0
        self._needs_restore = False
        self._mesh_health = MeshHealth

        recovery.snapshot_hook = self.snapshot
        self._chain_state_change()
        self._chain_resume()

    def _chain_state_change(self):
        prev = self.recovery.on_state_change
        health = self._mesh_health

        def on_state_change(old, new):
            if new is health.HEALTHY and old in (health.RECOVERING,
                                                 health.DEGRADED):
                self._needs_restore = True
            if prev is not None:
                prev(old, new)

        self.recovery.on_state_change = on_state_change

    def _chain_resume(self):
        prev = self.recovery.resume_hook

        def resume():
            if self._needs_restore:
                self._needs_restore = False
                self.restore_latest_verified()
            if prev is not None:
                prev()

        self.recovery.resume_hook = resume

    def snapshot(self) -> Optional[int]:
        """Durable snapshot of the live state (the recovery manager's
        ``snapshot_hook``), synchronous."""
        step = self.step_provider()
        self.manager.save(step, self.state_provider(),
                          plan_fingerprint=self.plan_fingerprint,
                          meta={"reason": "recovery_snapshot"},
                          sync=True)
        self.manager.wait()
        self.snapshots_saved += 1
        logger.info("recovery snapshot committed as step %d", step)
        return step

    def restore_latest_verified(self) -> Optional[Any]:
        """Restore the newest step whose chunks all pass hash
        verification (a half-written or bit-rotted newest step falls
        back to the one before it)."""
        step = self.manager.last_verified_step()
        if step is None:
            logger.warning("recovery restore requested but the store "
                           "has no verified steps")
            return None
        shardings = (self.shardings_provider()
                     if self.shardings_provider else None)
        restored = self.manager.restore(
            self.state_provider(), step=step, shardings=shardings,
            expected_plan_fingerprint=self.plan_fingerprint)
        if self.state_setter is not None:
            self.state_setter(restored)
        self.restores_done += 1
        logger.info("recovery restored verified step %d", step)
        return restored


def get_checkpoint_stats() -> Dict[str, float]:
    """Process-global checkpoint counters (bytes, timings, failures), as
    ``alpa_tpu_torch.monitoring.get_checkpoint_stats`` reports them."""
    return metrics.snapshot()


__all__ = [
    "CheckpointManager", "CheckpointSaveError", "CheckpointNotFoundError",
    "PlanFingerprintMismatch", "RecoveryCheckpointer",
    "get_checkpoint_stats",
]
