"""Request scheduling policies for the serving batcher and engine
(counterpart of ``alpa_tpu/serve/scheduler.py``; pure Python, kept as the
port's own copy).

Start-time fair queueing: each item is tagged ``max(V, last_tag(queue)) +
1/weight`` at arrival and pops in tag order, so backlogged queues share
throughput in weight ratio and an idle queue neither starves others nor
banks credit.

All schedulers speak one queue protocol:

* ``append(item)`` — enqueue (policy key: ``item.get("queue")``);
* ``popleft()`` / ``peek()`` — serve / inspect the policy head;
* ``take(selector)`` — selective service in policy order:
  ``selector(item)`` returns ``"take"`` (remove and return), ``"skip"``
  (leave in place, priority untouched) or ``"stop"``; skipped items keep
  their virtual-time tags, and only taken items advance service;
* ``pushback(items)`` — return items popped moments ago to the front (the
  engine's packed admission, when too few prompts wait for a pack);
* ``drain()`` — destructive empty-out in policy order (shutdown);
* ``__len__``.
"""
import heapq
from collections import deque
from typing import Dict, Iterable, List, Optional

__all__ = ["FIFOQueue", "WeightedFairQueue", "NestedScheduler"]

# a WeightedFairQueue's per-queue tag dict is pruned when it outgrows
# this (entries at or below virtual time are semantically dead weight)
_TAG_PRUNE_THRESHOLD = 1024


def _queue_name(item) -> str:
    return item.get("queue", "default") if isinstance(item, dict) \
        else "default"


class _FrontedQueue:
    """Shared protocol shell: a front deque for pushed-back items ahead
    of whatever ordering the policy implements via ``_pop_policy`` /
    ``_peek_policy`` / ``_take_policy`` / ``_drain_policy`` /
    ``_len_policy``."""

    def __init__(self):
        self._front = deque()

    def pushback(self, items: Iterable):
        """Return borrowed items to the FRONT, preserving their order,
        ahead of all policy-ordered work."""
        for item in reversed(list(items)):
            self._front.appendleft(item)

    def popleft(self):
        if self._front:
            return self._front.popleft()
        return self._pop_policy()

    def peek(self):
        if self._front:
            return self._front[0]
        return self._peek_policy()

    @staticmethod
    def _take_from_deque(q: deque, selector, taken: List) -> deque:
        """Run the selector loop over a deque; returns the kept deque
        (original order) and appends taken items.  Shared by the front
        pass and FIFO's policy pass so stop/skip semantics cannot
        drift.  A selector exception keeps the in-flight item in the
        kept deque (nothing is lost)."""
        kept = deque()
        while q:
            item = q.popleft()
            try:
                decision = selector(item)
            except Exception:
                # restore IN PLACE: the caller's reference to q (whose
                # reassignment never happens on a raise) must still
                # hold every non-taken item
                kept.append(item)
                kept.extend(q)
                q.clear()
                q.extend(kept)
                raise
            if decision == "take":
                taken.append(item)
            elif decision == "skip":
                kept.append(item)
            else:
                kept.append(item)
                break
        kept.extend(q)
        return kept

    def take(self, selector) -> List:
        """Pop items in policy order under ``selector`` decisions (see
        module docstring).  Front items are offered first.

        Exception safety: if the selector raises, items taken so far
        return to the FRONT and no item is lost — a faulty policy
        callback must never strand a request outside the queue."""
        taken = []
        stopped = [False]

        def wrapped(item):
            decision = selector(item)
            if decision == "stop":
                stopped[0] = True
            return decision

        try:
            self._front = self._take_from_deque(self._front, wrapped,
                                                taken)
            if not stopped[0]:
                # _take_policy appends into the SHARED list so a raise
                # mid-policy still leaves every taken item reachable
                # for the pushback below
                self._take_policy(wrapped, taken)
        except Exception:
            self.pushback(taken)
            raise
        return taken

    def drain(self) -> List:
        out = list(self._front)
        self._front.clear()
        out.extend(self._drain_policy())
        return out

    def __len__(self):
        return len(self._front) + self._len_policy()


class FIFOQueue(_FrontedQueue):
    """The engine's default policy: one global arrival-order queue."""

    def __init__(self):
        super().__init__()
        self._q = deque()

    def append(self, item):
        self._q.append(item)

    def _pop_policy(self):
        return self._q.popleft()

    def _peek_policy(self):
        return self._q[0] if self._q else None

    def _take_policy(self, selector, taken: List):
        self._q = self._take_from_deque(self._q, selector, taken)

    def _drain_policy(self) -> List:
        out = list(self._q)
        self._q.clear()
        return out

    def _len_policy(self):
        return len(self._q)


class WeightedFairQueue(_FrontedQueue):
    """Start-time fair queueing across named queues.

    ``weights``: queue name -> positive weight; unknown queues get
    ``default_weight``.  Under backlog, queue throughput converges to
    the weight ratio; within a queue, FIFO order is preserved.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0):
        super().__init__()
        self.weights = dict(weights or {})
        self.default_weight = float(default_weight)
        if any(w <= 0 for w in self.weights.values()) or \
                default_weight <= 0:
            raise ValueError("weights must be positive")
        self._heap: List = []         # (tag, seq, item)
        self._seq = 0                 # FIFO tie-break + within-queue order
        self._vtime = 0.0             # virtual time of last SERVICE
        self._last_tag: Dict[str, float] = {}

    def append(self, item):
        name = _queue_name(item)
        start = max(self._vtime, self._last_tag.get(name, 0.0))
        tag = start + 1.0 / self.weights.get(name, self.default_weight)
        self._last_tag[name] = tag
        heapq.heappush(self._heap, (tag, self._seq, item))
        self._seq += 1

    def _advance(self, tag):
        self._vtime = max(self._vtime, tag)
        if len(self._last_tag) > _TAG_PRUNE_THRESHOLD:
            # entries at/below vtime cannot affect any future tag
            # (start = max(vtime, last_tag)); pruning them bounds
            # memory against clients inventing unique queue names
            self._last_tag = {k: v for k, v in self._last_tag.items()
                              if v > self._vtime}

    def _pop_policy(self):
        tag, _seq, item = heapq.heappop(self._heap)
        self._advance(tag)
        return item

    def _peek_policy(self):
        return self._heap[0][2] if self._heap else None

    def _take_policy(self, selector, taken: List):
        # Lazy pops: peek the heap head, decide, then pop — entries are
        # visited in tag order straight off the heap, so the common
        # take (head batch, then "stop" once full) costs O(k log n)
        # against an n-item backlog instead of the full O(n log n)
        # sort-and-rebuild.  The unvisited tail is never touched.
        skipped = []
        try:
            while self._heap:
                entry = self._heap[0]
                tag, _seq, item = entry
                decision = selector(item)
                if decision == "take":
                    heapq.heappop(self._heap)
                    taken.append(item)
                    self._advance(tag)
                elif decision == "skip":
                    heapq.heappop(self._heap)
                    skipped.append(entry)
                else:
                    break
        finally:
            # also the raise path: the in-flight entry (peeked, never
            # popped) and the unvisited tail stay put; skipped entries
            # return with their original tags; entries taken so far are
            # off the heap (take() pushes the taken ITEMS back to the
            # front)
            for entry in skipped:
                heapq.heappush(self._heap, entry)
        return taken

    def _drain_policy(self) -> List:
        out = [it for _, _, it in sorted(self._heap)]
        self._heap.clear()
        return out

    def _len_policy(self):
        return len(self._heap)


class NestedScheduler(_FrontedQueue):
    """Two-level policy (ref NestedScheduler): an outer scheduler picks
    the GROUP, a per-group inner scheduler picks within it.

    The group key is ``item["group"]`` when present, else the prefix of
    the queue name before "/" — so the engine/controller API (which
    only carries ``queue``) drives both levels with composite names
    like ``"paid/alice"``: outer fairness across ``paid`` vs ``free``,
    inner policy (default FIFO) across the full names within a group.
    """

    def __init__(self, outer: Optional[WeightedFairQueue] = None,
                 inner_factory=FIFOQueue):
        super().__init__()
        self._outer = outer or WeightedFairQueue()
        self._inner: Dict[str, object] = {}
        self._inner_factory = inner_factory

    @staticmethod
    def _group(item) -> str:
        if isinstance(item, dict) and "group" in item:
            return item["group"]
        return _queue_name(item).split("/", 1)[0]

    def append(self, item):
        g = self._group(item)
        if g not in self._inner:
            self._inner[g] = self._inner_factory()
        self._inner[g].append(item)
        # the outer queue holds one token per queued item, tagged with
        # the group name so fair service applies across groups
        self._outer.append({"queue": g})

    def _pop_from_group(self, g: str):
        item = self._inner[g].popleft()
        if len(self._inner[g]) == 0:
            # drop drained inner queues: group names come from
            # untrusted queue fields, and an entry per ever-seen name
            # would grow forever (same threat WeightedFairQueue prunes
            # _last_tag against)
            del self._inner[g]
        return item

    def _pop_policy(self):
        token = self._outer.popleft()
        return self._pop_from_group(token["queue"])

    def _peek_policy(self):
        token = self._outer.peek()
        if token is None:
            return None
        return self._inner[token["queue"]].peek()

    def _take_policy(self, selector, taken: List):
        """Offer each group's inner HEAD in outer policy order.  A
        'skip' on a group's head skips the whole group for this take
        (deeper inner items are unreachable without consuming the
        head); taken heads consume their outer token (real service),
        skipped groups' tokens stay untouched.

        A selector exception is captured so the outer take completes
        cleanly (tokens for already-taken items are consumed, matching
        the inner pops), the popped items return to the front, and the
        error re-raises — nothing is lost."""
        skip_groups = set()
        stop = [False]
        err: List = []

        def outer_selector(token):
            if err or stop[0]:
                return "stop"
            g = token["queue"]
            if g in skip_groups:
                return "skip"
            head = self._inner[g].peek()
            try:
                decision = selector(head)
            except Exception as e:  # pylint: disable=broad-except
                err.append(e)
                return "stop"
            if decision == "take":
                taken.append(self._pop_from_group(g))
                return "take"
            if decision == "skip":
                skip_groups.add(g)
                return "skip"
            stop[0] = True
            return "stop"

        self._outer.take(outer_selector)
        if err:
            # taken items are in the SHARED list; the caller's except
            # path pushes them back — just surface the error
            raise err[0]

    def _drain_policy(self) -> List:
        out = []
        for token in self._outer.drain():
            out.append(self._pop_from_group(token["queue"]))
        return out

    def _len_policy(self):
        return len(self._outer)
