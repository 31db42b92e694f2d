"""Health checking, failure detection, recovery, and debug dumps.

The port of ``alpa_tpu/monitoring.py``.  Liveness is a tiny program on
each device of a mesh completing within a timeout: on a CUDA device a
one-element add launched on a side stream, whose event a worker thread
polls, so that a card that never answers leaves only that thread waiting
(the caller's thread never synchronises a card without a bound).
``FailureWatchdog`` drives the ``fault.RecoveryManager`` state machine
(HEALTHY -> SUSPECT -> RECOVERING -> DEGRADED).  ``dump_debug_info``
writes every report an executable has, under the JAX package's file
names; ``get_compile_cache_stats``, ``get_checkpoint_stats`` and
``get_overlap_stats`` are the process counters, with their ``format_*``
reports.
"""
import concurrent.futures
import logging
import os
import threading
import time
from typing import List, Optional, Sequence

import torch

from alpa_tpu_torch import fault
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace

logger = logging.getLogger(__name__)

_WATCHDOG_LAST_OK = _tmetrics.get_registry().gauge(
    "alpa_watchdog_last_ok_timestamp",
    "Unix time of each mesh's last successful liveness probe",
    labelnames=("mesh",))
_WATCHDOG_FAILS = _tmetrics.get_registry().gauge(
    "alpa_watchdog_consecutive_failures",
    "Consecutive failed liveness probes per mesh",
    labelnames=("mesh",))


def mesh_devices(mesh) -> List[torch.device]:
    """The devices of ``mesh``: a ``PhysicalDeviceMesh`` (its
    ``flat_devices``), a sequence of devices, or one device."""
    if isinstance(mesh, (str, torch.device)):
        return [torch.device(mesh)]
    devices = getattr(mesh, "flat_devices", None)
    if callable(devices):
        devices = devices()
    if devices is None:
        devices = mesh
    return [torch.device(d) for d in devices]


def probe_devices(devices: Sequence[torch.device],
                  timeout: Optional[float] = None) -> bool:
    """The liveness program: ``zeros(()) + 1`` on every device, checked.
    On a CUDA device it runs on a side stream and this thread polls its
    event (never a blocking synchronise); past ``timeout`` seconds of
    polling it raises ``concurrent.futures.TimeoutError``."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for device in devices:
        if device.type != "cuda":
            if float(torch.zeros((), device=device) + 1) != 1.0:
                return False
            continue
        with torch.cuda.device(device):
            stream = torch.cuda.Stream(device)
            with torch.cuda.stream(stream):
                val = torch.zeros((), device=device) + 1
                host = torch.empty((), pin_memory=True)
                host.copy_(val, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        while not done.query():
            if deadline is not None and time.monotonic() > deadline:
                raise concurrent.futures.TimeoutError(
                    f"{device} did not finish the liveness probe")
            time.sleep(0.0005)
        if float(host) != 1.0:
            return False
    return True


def check_alive(mesh, timeout: float = 10.0,
                retry_policy: Optional["fault.RetryPolicy"] = None) -> bool:
    """True iff every device of the mesh completes a trivial program within
    ``timeout`` seconds (the reference's ``check_alive`` no-op RPC).

    ``retry_policy`` (default: the installed policy for site ``probe``,
    no retry out of the box) re-probes with jittered backoff before
    declaring the mesh dead: one slow tick must not trip recovery.
    """
    devices = mesh_devices(mesh)

    def probe():
        fault.fire("probe", mesh=mesh)
        return probe_devices(devices, timeout)

    def probe_once():
        # no context manager: pool.__exit__ would join a probe thread
        # that waits on a hung device (it gives up at its own deadline,
        # ``probe_devices``'s timeout)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(probe)
        try:
            return bool(fut.result(timeout=timeout))
        finally:
            pool.shutdown(wait=False)

    policy = retry_policy or fault.get_retry_policy("probe")
    try:
        return bool(fault.call_with_retry(
            probe_once, policy=policy, site="probe",
            retry_on=(concurrent.futures.TimeoutError, Exception)))
    except concurrent.futures.TimeoutError:
        logger.error("mesh %s failed liveness probe (%.1fs timeout)",
                     mesh, timeout)
        return False
    except Exception as e:  # pylint: disable=broad-except
        logger.error("mesh %s liveness probe raised: %s", mesh, e)
        return False


def check_mesh_group_alive(mesh_group, timeout: float = 10.0) -> List[bool]:
    return [check_alive(m, timeout) for m in mesh_group]


class FailureWatchdog:
    """Periodic liveness checking driving the recovery state machine.

    ``on_failure(dead_indices)`` fires on every failed probe round; each
    round's verdict drives ``recovery`` (a ``fault.RecoveryManager``,
    built plain when not given): HEALTHY -> SUSPECT -> RECOVERING ->
    DEGRADED with its quiesce, snapshot and degrade hooks.  The current
    state is ``watchdog.state``.
    """

    def __init__(self, mesh_group, interval: float = 60.0,
                 on_failure=None, recovery: Optional[
                     "fault.RecoveryManager"] = None,
                 probe_timeout: float = 10.0):
        self.mesh_group = mesh_group
        self.interval = interval
        self.on_failure = on_failure or (lambda dead: None)
        self.probe_timeout = probe_timeout
        if recovery is None:
            recovery = fault.RecoveryManager(mesh_group,
                                             probe_timeout=probe_timeout)
        elif recovery.mesh_group is None:
            recovery.mesh_group = mesh_group
        self.recovery = recovery
        self._stop = threading.Event()
        self._thread = None

    @property
    def state(self) -> "fault.MeshHealth":
        return self.recovery.state

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            alive = check_mesh_group_alive(self.mesh_group,
                                           self.probe_timeout)
            if self._stop.is_set():
                return  # stopped during the probe: no callbacks
            dead = [i for i, a in enumerate(alive) if not a]
            now = time.time()
            for i, ok in enumerate(alive):
                if ok:
                    _WATCHDOG_LAST_OK.labels(str(i)).set(now)
                    _WATCHDOG_FAILS.labels(str(i)).set(0)
                else:
                    _WATCHDOG_FAILS.labels(str(i)).inc()
            if dead:
                try:
                    self.on_failure(dead)
                except Exception:  # pylint: disable=broad-except
                    logger.exception("on_failure callback failed")
            try:
                self.recovery.observe(dead)
            except Exception:  # pylint: disable=broad-except
                logger.exception("recovery state machine raised")
            self._stop.wait(self.interval)

    def stop(self):
        """Takes effect at once: the loop wakes from its wait and no
        further probes or callbacks run."""
        self._stop.set()


def dump_debug_info(executable, dump_dir: str):
    """Write every plan and report of a compiled executable to
    ``dump_dir`` under the JAX package's file names (its
    ``dump_debug_info``): the schedule, the instructions, the resharding
    stats and plan, the step's perf report, the calibration report, the
    compile-cache, checkpoint and overlap counters, the metrics registry,
    the trace (when tracing) and the flight recorder's ring; for a
    pipeshard executable also the plan analyses' reports:
    ``plan_verdict.txt``, ``model_check.txt``, ``numerics.txt``,
    ``equiv.txt`` and ``superopt.txt``."""
    os.makedirs(dump_dir, exist_ok=True)

    def write(name, text):
        with open(os.path.join(dump_dir, name), "w",
                  encoding="utf-8") as f:
            f.write(text)

    if hasattr(executable, "get_hlo_text"):
        write("compiled_hlo.txt", executable.get_hlo_text())
    if hasattr(executable, "get_schedule_text"):
        write("schedule.txt", executable.get_schedule_text())
    if hasattr(executable, "get_instruction_text"):
        write("instructions.txt", executable.get_instruction_text())
    for name, getter in (("plan_verdict.txt", "get_plan_verdict_text"),
                         ("model_check.txt", "get_model_check_text"),
                         ("numerics.txt", "get_numerics_text"),
                         ("equiv.txt", "get_equiv_text"),
                         ("superopt.txt", "get_superopt_text")):
        if hasattr(executable, getter):
            write(name, getattr(executable, getter)())
    if hasattr(executable, "get_resharding_stats"):
        stats = executable.get_resharding_stats()
        write("resharding.txt", "\n".join(
            f"{k}: {stats[k]}" for k in sorted(stats)))
    if hasattr(executable, "get_perf_report_text"):
        write("perf_report.txt", executable.get_perf_report_text() or
              "(no measured step: trace a step first)")
    from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
        format_resharding_plan)
    write("resharding_plan.txt", format_resharding_plan())
    from alpa_tpu_torch.telemetry.calibration import (
        format_calibration_report)
    write("calibration.txt", format_calibration_report())
    write("compile_cache.txt", format_compile_cache_report())
    write("checkpoint.txt", format_checkpoint_report())
    write("overlap.txt", format_overlap_report())
    write("metrics.txt", _tmetrics.get_registry().to_prometheus_text())
    if _ttrace.enabled():
        rec = _ttrace.get_recorder()
        if rec.n_events:
            rec.save(os.path.join(dump_dir, "trace.json"))
    from alpa_tpu_torch.telemetry import flight as _flight
    if _flight.enabled():
        frec = _flight.get_recorder()
        if frec.n_events:
            frec.dump(os.path.join(dump_dir, "flight.json"),
                      reason="dump_debug_info")
    logger.info("debug info dumped to %s", dump_dir)


def get_compile_cache_stats() -> dict:
    """Hit/miss/solve-time counters of the compile cache, per namespace
    (``alpa_tpu_torch/compile_cache.py``)."""
    from alpa_tpu_torch.compile_cache import get_compile_cache
    return get_compile_cache().stats()


def get_checkpoint_stats() -> dict:
    """Process-global checkpoint counters: save/restore latency and byte
    totals, chunk dedupe, verify failures, hot-swap staging
    (``checkpoint/metrics.py``)."""
    from alpa_tpu_torch.checkpoint import metrics
    return metrics.snapshot()


def format_checkpoint_report() -> str:
    """Human-readable checkpoint counter report (debug dumps)."""
    stats = get_checkpoint_stats()
    if not stats:
        return "checkpoint: (no traffic yet)"
    lines = ["checkpoint counters:"]
    for key in sorted(stats):
        v = stats[key]
        val = f"{v:.4f}" if v != int(v) else str(int(v))
        lines.append(f"  {key:<24} {val}")
    return "\n".join(lines)


def get_overlap_stats() -> dict:
    """Process-global overlap-dispatch counters (per-step transfer pool
    busy and blocked time, hoisted launches, the last step's overlap
    fraction) and the resharding planner's link-load aggregates."""
    from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
        get_planner_stats)
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
        get_overlap_runtime_stats)
    return {"runtime": get_overlap_runtime_stats(),
            "planner": get_planner_stats()}


def format_overlap_report() -> str:
    """Human-readable overlap-dispatch report (debug dumps)."""
    stats = get_overlap_stats()
    rt, pl = stats["runtime"], stats["planner"]
    lines = ["overlap dispatch (runtime):"]
    if rt["steps"] == 0:
        lines.append("  (no overlap-mode steps yet)")
    else:
        busy, blocked = rt["transfer_busy_s"], rt["wait_blocked_s"]
        lines.append(f"  steps={rt['steps']} launches={rt['n_launches']} "
                     f"hoisted={rt['n_hoisted']} "
                     f"window={rt['last_window']}")
        lines.append(f"  transfer_busy={busy:.4f}s "
                     f"wait_blocked={blocked:.4f}s "
                     f"last_overlap_fraction="
                     f"{rt['last_overlap_fraction']:.3f}")
    lines.append("resharding planner (link loads):")
    if pl["plans"] == 0:
        lines.append("  (no plans yet)")
    else:
        lines.append(f"  plans={pl['plans']} "
                     f"total_bytes={pl['total_bytes']:.0f} "
                     f"broadcast_bytes={pl['broadcast_bytes']:.0f}")
        lines.append(f"  max_link_bytes={pl['max_link_bytes']:.0f} "
                     f"(naive {pl['max_link_bytes_naive']:.0f})")
    return "\n".join(lines)


def format_compile_cache_report() -> str:
    """Human-readable one-namespace-per-line cache report (debug
    dumps)."""
    stats = get_compile_cache_stats()
    lines = [f"compile cache dir: {stats['cache_dir'] or '(memory only)'}",
             f"memory entries: {stats['memory_entries']}"]
    for ns, s in stats["namespaces"].items():
        lines.append(
            f"  {ns:<14} hits={s['hits']} (disk={s['disk_hits']}) "
            f"misses={s['misses']} puts={s['puts']} "
            f"solve={s['solve_seconds']}s saved={s['saved_seconds']}s")
    if not stats["namespaces"]:
        lines.append("  (no cache traffic yet)")
    return "\n".join(lines)
