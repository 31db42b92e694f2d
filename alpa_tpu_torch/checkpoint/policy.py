"""Checkpoint retention policies (the port of
``alpa_tpu/checkpoint/policy.py``).

A policy decides which committed steps survive after each save;
:class:`~alpa_tpu_torch.checkpoint.manager.CheckpointManager` deletes the
rest and garbage-collects unreferenced chunks.
"""
import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """Keep-last-K plus keep-every-N.

    ``keep_last_k``: the newest K steps always survive (0 = keep all).
    ``keep_every_n``: additionally keep every step divisible by N
    (0 = none) — the long-horizon "milestone" ladder, so a run keeps
    e.g. its last 3 steps for crash recovery AND every 1000th for
    post-hoc evals, without the two goals fighting.
    """
    keep_last_k: int = 3
    keep_every_n: int = 0

    def __post_init__(self):
        if self.keep_last_k < 0 or self.keep_every_n < 0:
            raise ValueError("retention counts must be >= 0")

    def surviving(self, steps: Sequence[int]) -> List[int]:
        steps = sorted(steps)
        keep = set()
        if self.keep_last_k == 0:
            keep.update(steps)
        else:
            keep.update(steps[-self.keep_last_k:])
        if self.keep_every_n > 0:
            keep.update(s for s in steps if s % self.keep_every_n == 0)
        return sorted(keep)

    def to_delete(self, steps: Sequence[int]) -> List[int]:
        surviving = set(self.surviving(steps))
        return sorted(s for s in steps if s not in surviving)


#: Keep everything — the manager's default when no policy is given.
KEEP_ALL = RetentionPolicy(keep_last_k=0, keep_every_n=0)
