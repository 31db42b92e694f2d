"""Zero-downtime serving weight swap (the port of
``alpa_tpu/checkpoint/hot_swap.py``).

Two phases, so that serving never waits on disk:

1. **Stage** (:func:`stage_weights_from_checkpoint`) — read a step from
   the content-addressed store, verifying every chunk hash, into fresh
   tensors placed as the replica's current weights are.  Requests keep
   flowing on the old weights meanwhile, and a corrupt checkpoint fails
   here, before any replica is touched.
2. **Swap** (``serve.controller._Replica.swap_weights``) — a drain
   barrier: the streaming engine is drained and retired
   (``drain_engine``), the batcher's batch in flight finishes on the
   old weights, the staged weights are copied into the model's own
   tensors (every address stays), the prefix KV is recomputed, and the
   engine is rebuilt with its KV pool at the next streamed request.
   Because the copy is in place, no tick of a live engine may run
   during it: an engine whose streams outlive the drain window keeps
   serving on the old weights, and the swap raises
   :class:`HotSwapBusyError` (HTTP 409) with nothing changed.

``POST /admin/reload`` on the serving controller drives both phases.
"""
import logging
import time
from typing import Any, Optional, Tuple

from alpa_tpu_torch.checkpoint import metrics
from alpa_tpu_torch.checkpoint.manager import CheckpointManager

logger = logging.getLogger(__name__)


class HotSwapBusyError(RuntimeError):
    """The streaming engine's requests outlived the swap's drain window.
    The replica keeps its old weights and its engine; retry the reload
    when the streams have finished."""


def _as_manager(source) -> CheckpointManager:
    if isinstance(source, CheckpointManager):
        return source
    from alpa_tpu_torch.checkpoint.store import ShardStore
    if isinstance(source, ShardStore):
        mgr = CheckpointManager(source.root)
        mgr.store = source
        return mgr
    return CheckpointManager(str(source))


def stage_weights_from_checkpoint(source,
                                  target_params: Any,
                                  step: Optional[int] = None,
                                  verify: bool = True,
                                  expected_plan_fingerprint:
                                  Optional[str] = None) -> Tuple[Any, int]:
    """The staging phase: load ``step`` (default the latest) from
    ``source`` (a CheckpointManager, a ShardStore or a store path) into
    fresh tensors with ``target_params``'s structure, devices and
    layouts.  Every chunk read is hash-verified (``verify=True``).
    Returns ``(new_params, step_loaded)``."""
    t0 = time.monotonic()
    mgr = _as_manager(source)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            from alpa_tpu_torch.checkpoint.store import \
                CheckpointNotFoundError
            raise CheckpointNotFoundError(
                f"no committed checkpoint steps in {mgr.store.root}")
    new_params = mgr.restore(
        target_params, step=step,
        expected_plan_fingerprint=expected_plan_fingerprint,
        verify=verify)
    staged = time.monotonic() - t0
    metrics.incr("hot_swap_staged")
    metrics.incr("hot_swap_stage_seconds", staged)
    logger.info("staged weights from step %d in %.3fs (hash-verified)",
                step, staged)
    return new_params, step


def drain_engine(engine, timeout: float = 30.0,
                 poll: float = 0.01) -> bool:
    """Wait until a ContinuousBatchingEngine has no active rows and an
    empty queue, shut it down in the same critical section that sees it
    idle, and join its loop thread, so that after True no request boards
    it and no decode tick of it runs (JAX's leaves the engine running: its
    swap rebinds immutable weights, the port's copies them in place).
    False when its streams outlive ``timeout`` (the engine is left
    running), or when its loop thread, stopped, has not ended by then."""
    deadline = time.monotonic() + timeout
    while True:
        with engine._cv:
            if (not engine._active.any()) and len(engine._queue) == 0:
                engine._stop = True
                engine._cv.notify_all()
                break
        if time.monotonic() >= deadline:
            return False
        time.sleep(poll)
    engine._thread.join(max(0.0, deadline - time.monotonic()))
    return not engine._thread.is_alive()
