"""Request queue for the serving batcher (counterpart of
``alpa_tpu/serve/scheduler.py``; pure Python, kept as the port's own copy).

The queue protocol the batcher speaks:

* ``append(item)`` — enqueue;
* ``take(selector)`` — selective service in arrival order:
  ``selector(item)`` returns ``"take"`` (remove and return), ``"skip"``
  (leave in place) or ``"stop"``;
* ``drain()`` — destructive empty-out in order (shutdown);
* ``__len__``.

The weighted-fair and nested policies of the JAX package are not ported
yet.
"""
from collections import deque
from typing import List

__all__ = ["FIFOQueue"]


class FIFOQueue:
    """One global arrival-order queue."""

    def __init__(self):
        self._q = deque()

    def append(self, item):
        self._q.append(item)

    def take(self, selector) -> List:
        """Pop items in arrival order under ``selector`` decisions.

        Exception safety: if the selector raises, the items taken so far
        return to the front, the rest keep their order, and the error
        propagates; no item is lost."""
        taken, kept = [], deque()
        try:
            while self._q:
                item = self._q.popleft()
                kept.append(item)
                decision = selector(item)
                if decision == "take":
                    taken.append(kept.pop())
                elif decision != "skip":
                    break
        except Exception:
            kept.extend(self._q)
            self._q = deque(taken)
            self._q.extend(kept)
            raise
        kept.extend(self._q)
        self._q = kept
        return taken

    def drain(self) -> List:
        out = list(self._q)
        self._q.clear()
        return out

    def __len__(self):
        return len(self._q)
