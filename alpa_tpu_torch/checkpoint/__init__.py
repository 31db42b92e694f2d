"""Asynchronous distributed checkpointing (the port of
``alpa_tpu/checkpoint/``).

Modules:
  * :mod:`~alpa_tpu_torch.checkpoint.store` — content-addressed chunked
    shard store: sha256-named chunks and one manifest per step with each
    leaf's shape, dtype, index map and chunk hashes; the manifest commit
    is atomic and last.
  * :mod:`~alpa_tpu_torch.checkpoint.manager` — :class:`CheckpointManager`
    with asynchronous saves (the device-to-host copies finish before
    ``save`` returns), save-failure surfacing, plan-fingerprint checks on
    resume, restores into a live state, and retention.
  * :mod:`~alpa_tpu_torch.checkpoint.policy` — retention policies
    (keep-last-K plus keep-every-N).
  * :mod:`~alpa_tpu_torch.checkpoint.hot_swap` — serving weight swap:
    stage and hash-verify new weights in the background, then swap each
    replica under a drain barrier.
"""
from alpa_tpu_torch.checkpoint.manager import (CheckpointManager,
                                               PlanFingerprintMismatch,
                                               RecoveryCheckpointer)
from alpa_tpu_torch.checkpoint.policy import RetentionPolicy
from alpa_tpu_torch.checkpoint.store import (ChunkCorruptionError,
                                             CheckpointNotFoundError,
                                             ShardStore)
from alpa_tpu_torch.checkpoint.hot_swap import stage_weights_from_checkpoint

__all__ = [
    "CheckpointManager", "RecoveryCheckpointer", "PlanFingerprintMismatch",
    "RetentionPolicy", "ShardStore", "ChunkCorruptionError",
    "CheckpointNotFoundError", "stage_weights_from_checkpoint",
]
