"""Flight recorder: a fixed-size lock-free ring of instruction events.

Counterpart of ``alpa_tpu/telemetry/flight.py``.  The pipeshard driver's
register-file replay appends one event per replayed op -- ``(node id,
mesh, opcode, slot set, t_start/t_end, outcome)`` -- into a preallocated
ring.  Recording is one ``itertools.count`` bump (atomic under the GIL,
no lock on the hot path) and one list-slot store, cheap enough to leave
on; the ring holds the last ``capacity`` events, so its memory is fixed.
The timestamps are the host's (the trace's epoch), for ordering only:
the recorder never synchronises a card.

When a pipeshard step raises (``PipeshardDriverExecutable.
launch_on_driver``) the ring is dumped: ``auto_dump`` writes a JSON
post-mortem into ``global_config.flight_dump_dir`` (else the system temp
dir), records the path for the serving controller's ``/healthz``, and
de-duplicates -- a trigger with no new events since the last dump writes
nothing.  Read a dump with ``load_dump``.

Knobs: ``ALPA_TPU_FLIGHT`` (default on) / ``global_config.
flight_recorder``, ``ALPA_TPU_FLIGHT_CAPACITY`` (ring size, rounded up
to a power of two), ``ALPA_TPU_FLIGHT_DIR``.
"""
import itertools
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry.trace import _now_us

logger = logging.getLogger(__name__)

__all__ = [
    "FlightRecorder", "get_recorder", "set_recorder", "enabled",
    "auto_dump", "last_dump_path", "load_dump", "annotate",
    "get_annotations", "clear_annotations",
]

#: on-disk dump schema version (bump on breaking change)
DUMP_VERSION = 1

# event tuple layout: (seq, kind, name, mesh, node, slots, t0_us,
# t1_us, outcome) — kept positional so record() allocates one tuple
_FIELDS = ("seq", "kind", "name", "mesh", "node", "slots",
           "t_start_us", "t_end_us", "outcome")


class FlightRecorder:
    """Fixed-size ring of the last N instruction events.

    Lock-free recording: the sequence counter is an ``itertools.count``
    (a single C-level increment, atomic under the GIL) and each event is
    one store into a preallocated list slot — concurrent recorders from
    the driver and transfer-pool threads never block each other.  A
    racing pair of writers can at worst overwrite one ring slot, which
    is exactly the ring's semantic anyway.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = int(getattr(global_config,
                                   "flight_recorder_capacity", 4096))
        cap = 1
        while cap < max(2, int(capacity)):
            cap <<= 1
        self.capacity = cap
        self._mask = cap - 1
        self._buf: List[Optional[tuple]] = [None] * cap
        self._seq = itertools.count()
        # highest seq included in the last auto_dump (dedupe marker)
        self._last_dumped_seq = -1

    # ---- recording (hot path) ---------------------------------------

    def record(self, kind: str, name: str, mesh: int, node: int,
               slots: Tuple[int, ...], t0_us: float, t1_us: float,
               outcome: str):
        i = next(self._seq)
        self._buf[i & self._mask] = (i, kind, name, mesh, node, slots,
                                     t0_us, t1_us, outcome)

    # ---- introspection ----------------------------------------------

    def snapshot(self) -> List[tuple]:
        """Surviving events, oldest first (stable under concurrent
        recording: a torn read only drops/duplicates ring-edge events)."""
        events = [e for e in list(self._buf) if e is not None]
        events.sort(key=lambda e: e[0])
        return events

    @property
    def n_events(self) -> int:
        return sum(1 for e in self._buf if e is not None)

    def clear(self):
        self._buf = [None] * self.capacity
        self._seq = itertools.count()
        self._last_dumped_seq = -1

    # ---- dumping ----------------------------------------------------

    def dump(self, path: Optional[str] = None,
             reason: str = "") -> Optional[str]:
        """Write the ring as JSON; returns the path (None when empty).
        Sets the module-level last-dump pointer."""
        events = self.snapshot()
        if not events:
            return None
        if path is None:
            path = os.path.join(
                _dump_dir(),
                f"alpa_flight_{os.getpid()}_{events[-1][0]}.json")
        payload = {
            "version": DUMP_VERSION,
            "reason": reason,
            "capacity": self.capacity,
            "n_events": len(events),
            "first_seq": events[0][0],
            "last_seq": events[-1][0],
            "written_at": time.time(),
            # compile-time notes (``annotate``), e.g. a planner's
            "annotations": dict(_ANNOTATIONS),
            "events": [dict(zip(_FIELDS, e)) for e in events],
        }
        for ev in payload["events"]:
            ev["slots"] = list(ev["slots"] or ())
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        global _LAST_DUMP_PATH
        _LAST_DUMP_PATH = path
        self._last_dumped_seq = events[-1][0]
        return path


# ---- module-level recorder + trigger front door ----------------------

_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()
_LAST_DUMP_PATH: Optional[str] = None

# sticky analysis annotations included in every dump (survive recorder
# swaps: the verifier runs at compile time, dumps happen much later)
_ANNOTATIONS: Dict[str, Any] = {}


def annotate(key: str, value: Any) -> None:
    """Attach a compile-time note to every subsequent flight dump.
    Values must be JSON-able."""
    _ANNOTATIONS[key] = value


def get_annotations() -> Dict[str, Any]:
    return dict(_ANNOTATIONS)


def clear_annotations() -> None:
    _ANNOTATIONS.clear()


def _dump_dir() -> str:
    d = (getattr(global_config, "flight_dump_dir", None) or
         tempfile.gettempdir())
    os.makedirs(d, exist_ok=True)
    return d


def get_recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        with _LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def set_recorder(rec: Optional[FlightRecorder]
                 ) -> Optional[FlightRecorder]:
    """Swap the process recorder (tests install a fresh one); returns
    the previous recorder."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


def enabled() -> bool:
    return bool(getattr(global_config, "flight_recorder", True))


def now_us() -> float:
    """Timestamp on the same axis as the span trace (shared epoch)."""
    return _now_us()


def last_dump_path() -> Optional[str]:
    return _LAST_DUMP_PATH


def auto_dump(reason: str) -> Optional[str]:
    """Failure-triggered dump (a pipeshard step raised).  Never raises; returns the dump path, or None when the
    recorder is disabled, empty, or has nothing new since the last dump
    (so stacked triggers from one failure produce one file)."""
    try:
        if not enabled() or _RECORDER is None:
            return None
        rec = _RECORDER
        events = rec.snapshot()
        if not events or events[-1][0] <= rec._last_dumped_seq:
            return None
        path = rec.dump(reason=reason)
        if path:
            logger.warning(
                "flight recorder: dumped %d instruction events to %s "
                "(%s); read it with telemetry.flight.load_dump",
                len(events), path, reason)
        return path
    except Exception:  # pylint: disable=broad-except
        logger.exception("flight recorder auto-dump failed")
        return None


def load_dump(path: str) -> Dict[str, Any]:
    """Read a dump file back; validates the shape."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if "events" not in payload or "capacity" not in payload:
        raise ValueError(f"{path}: not a flight recorder dump")
    return payload
