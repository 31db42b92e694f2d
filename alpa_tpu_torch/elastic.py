"""Elastic training: detect -> quiesce -> snapshot -> re-solve -> resume.

The port of ``alpa_tpu/elastic.py``.  :class:`ElasticSupervisor` owns a
training loop's failure lifecycle, composed of the pieces that exist on
their own:

1. **Detect** — an exception out of the supervised step, an injected or
   real signal at the elastic fault sites ``worker_lost`` /
   ``preemption_notice`` (polled at every step boundary), a
   :class:`WedgeDetector` probe sweep, or a watchdog escalation
   (``fault.set_escalation_manager``).
2. **Quiesce** — the executable's ``quiesce()``: the pipeshard launch
   gate closes and the launches in flight drain (bounded by
   ``global_config.elastic_quiesce_timeout_s``).
3. **Snapshot** — through the checkpoint manager, synchronously.  On a
   preemption notice the write must land inside the grace window
   (``elastic_grace_period_s``).  A failure in the middle of a step never
   snapshots: a step writes its donated state in place, so the live
   state is torn; the episode falls back to the last verified step.
4. **Re-solve** — ``solve(survivors)`` builds a step for the surviving
   device set, gated on the plan verdict: the candidate plan is verified
   before it launches (``get_plan_verdict``) and swapped in only when its
   findings add none to the old plan's.  A pipeshard episode records
   ``"verdict": "checked"``; a ``ShardParallel`` executable has no
   verdict, in either package, and records ``"unavailable"``.
5. **Resume** — restore the last hash-verified step, reopen the launch
   gate, and replay.  A step whose plan is reused is restored into the
   live state in place (CUDA graphs replay on the same addresses); a new
   plan gets the state placed as its executable takes its inputs
   (``in_specs`` over its logical mesh), each block read through
   ``ShardStore.read_leaf_slice``.  The episode is annotated into the
   flight ring and exported as ``alpa_elastic_*`` metrics; the replay
   distance and wall clock are checked against ``elastic_step_budget``
   and ``elastic_time_budget_s``.

:class:`WedgeDetector` classes each mesh ``ok`` / ``wedged`` (the probe
neither answered nor raised within ``wedge_probe_timeout_s``) / ``dead``
(it raised), stopping at the first sign of a wedge; the probe is
``monitoring.probe_devices`` (a side-stream program whose event a worker
thread polls).
"""
import concurrent.futures
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from alpa_tpu_torch import fault
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import flight as _flight
from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

__all__ = [
    "WorkerLost", "PreemptionNotice", "WedgeDetector",
    "ElasticSupervisor", "status_report", "get_supervisor",
]

_EPISODES = _tmetrics.get_registry().counter(
    "alpa_elastic_episodes_total",
    "Elastic recovery episodes by trigger "
    "(worker_lost/preemption_notice/wedge_detected/step_failure)",
    labelnames=("reason",))
_RECOVERY_SECONDS = _tmetrics.get_registry().histogram(
    "alpa_elastic_recovery_seconds",
    "Wall-clock seconds per episode, detect through resume")
_REPLAY_STEPS = _tmetrics.get_registry().histogram(
    "alpa_elastic_replay_steps",
    "Committed steps lost per episode (failure step minus restored step)")
_SNAPSHOTS = _tmetrics.get_registry().counter(
    "alpa_elastic_snapshots_total",
    "Episode snapshots by outcome (grace=landed inside the preemption "
    "window, late, boundary, skipped=mid-step state was torn, failed)",
    labelnames=("outcome",))
_REPLANS = _tmetrics.get_registry().counter(
    "alpa_elastic_replans_total",
    "Episode re-solve outcomes (accepted/rejected/reused/failed)",
    labelnames=("outcome",))
_BUDGET_VIOLATIONS = _tmetrics.get_registry().counter(
    "alpa_elastic_budget_violations_total",
    "Episodes exceeding the configured recovery budget, by kind "
    "(steps/seconds)",
    labelnames=("kind",))
_ELASTIC_STATE = _tmetrics.get_registry().gauge(
    "alpa_elastic_state",
    "Supervisor position (0=idle/training 1=inside a recovery episode)")


class WorkerLost(RuntimeError):
    """A mesh's workers died.  ``survivors`` (optional device list)
    names the device set to re-solve for; None keeps the current set
    (e.g. the scheduler will replace the host in place)."""

    def __init__(self, msg: str = "worker lost",
                 survivors: Optional[Sequence[Any]] = None):
        super().__init__(msg)
        self.survivors = list(survivors) if survivors is not None else None


class PreemptionNotice(RuntimeError):
    """Eviction warning: the kill lands after ``grace_s`` seconds
    (default ``global_config.elastic_grace_period_s``).  The supervisor
    snapshots synchronously inside the window, then re-solves for
    ``survivors``."""

    def __init__(self, msg: str = "preemption notice",
                 grace_s: Optional[float] = None,
                 survivors: Optional[Sequence[Any]] = None):
        super().__init__(msg)
        self.grace_s = grace_s
        self.survivors = list(survivors) if survivors is not None else None


class WedgeDetector:
    """A probe per mesh, classed three ways:

    * ``"ok"``     — the probe program completed inside the timeout.
    * ``"wedged"`` — the probe neither answered nor errored (the
      hung case): the device is alive enough to
      accept work but will never finish it.  Killing/retrying on it
      wedges harder; reset and restore instead.
    * ``"dead"``   — the probe raised or returned falsy: the device (or
      its runtime) is gone and says so.

    ``check()`` short-circuits at the first non-``ok`` mesh (remaining
    meshes report ``"skipped"``) — probing past a wedge is how failed
    legs get mistaken for successes.
    """

    def __init__(self, mesh_group=None,
                 probe: Optional[Callable[[Any], bool]] = None,
                 probe_timeout_s: Optional[float] = None):
        self.mesh_group = mesh_group
        self.probe_timeout_s = probe_timeout_s
        self._probe = probe

    def _timeout(self) -> float:
        if self.probe_timeout_s is not None:
            return self.probe_timeout_s
        return float(getattr(global_config, "wedge_probe_timeout_s", 120.0))

    def _default_probe(self, mesh) -> bool:
        from alpa_tpu_torch.monitoring import mesh_devices, probe_devices
        fault.fire("probe", mesh=mesh)
        return probe_devices(mesh_devices(mesh), self._timeout())

    def probe_one(self, mesh) -> str:
        """One mesh's verdict: ``ok`` / ``wedged`` / ``dead``."""
        probe = self._probe or self._default_probe
        # No context manager: a wedged device never finishes the probe
        # and pool.__exit__ would join it forever; the abandoned daemon
        # thread is the wedge signal (as in monitoring.check_alive).
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(probe, mesh)
        try:
            ok = bool(fut.result(timeout=self._timeout()))
        except concurrent.futures.TimeoutError:
            return "wedged"
        except Exception:  # pylint: disable=broad-except
            return "dead"
        finally:
            pool.shutdown(wait=False)
        return "ok" if ok else "dead"

    def check(self) -> Dict[int, str]:
        """Probe the mesh group, stopping at the first wedge sign.
        ``fault.fire("wedge_detected")`` at entry is the injection
        point: an active FaultSpec raises here to simulate a wedge."""
        group = list(self.mesh_group or [])
        fault.fire("wedge_detected", n_meshes=len(group))
        statuses: Dict[int, str] = {}
        tripped = False
        for i, mesh in enumerate(group):
            if tripped:
                statuses[i] = "skipped"
                continue
            statuses[i] = self.probe_one(mesh)
            if statuses[i] != "ok":
                tripped = True
                logger.warning("wedge detector: mesh %d is %s — "
                               "stopping the sweep (never probe past a "
                               "wedge)", i,
                               statuses[i])
        return statuses

    def healthy(self) -> bool:
        return all(s == "ok" for s in self.check().values())


#: the process's supervisor (set by ElasticSupervisor unless
#: ``register_globally=False``) — serve/healthz reads it
_ACTIVE: Optional["ElasticSupervisor"] = None


def get_supervisor() -> Optional["ElasticSupervisor"]:
    return _ACTIVE


def status_report() -> Optional[Dict[str, Any]]:
    """Elastic episode state for ``/healthz`` (None when no supervisor
    is registered in this process)."""
    sup = _ACTIVE
    if sup is None:
        return None
    last = sup.episodes[-1] if sup.episodes else None
    return {
        "step": sup.step_index,
        "devices": len(sup.devices),
        "episodes": len(sup.episodes),
        "recovering": bool(sup._in_episode),
        "last_episode": dict(last) if last else None,
    }


class ElasticSupervisor:
    """Owns a training loop's failure lifecycle (module docstring).

    ``solve(devices)`` is the re-solve hook: given a device list it
    returns a compiled-on-demand step callable (typically an
    ``@alpa_tpu_torch.parallelize`` function over a ``ParallelMethod``
    built for those devices) with the convention ``fn(state, *args) ->
    (new_state, *aux)``.  It is called once at construction for the
    full device set and once per episode for the survivors; returning a
    cached function for a device set it has already solved is
    encouraged (the acceptance gate then records a ``reused`` replan).

    ``manager`` is a :class:`~alpa_tpu_torch.checkpoint.manager
    .CheckpointManager` (built over ``checkpoint_root`` when omitted,
    synchronous — elastic durability must not gamble on a write in
    flight).  A step-0 restore point is committed at construction so
    even a first-step failure has a verified floor to fall back to.

    Thread model: episodes run only on the training thread, inside
    :meth:`step`.  Cross-thread signals — ``notify_worker_lost``,
    ``notify_preemption``, watchdog ``escalate`` — enqueue and are
    drained at the next step boundary.
    """

    def __init__(self, solve: Callable[[Sequence[Any]], Callable],
                 state: Any,
                 checkpoint_root: Optional[str] = None,
                 devices: Optional[Sequence[Any]] = None,
                 manager: Optional[Any] = None,
                 wedge_detector: Optional[WedgeDetector] = None,
                 step_budget: Optional[int] = None,
                 time_budget_s: Optional[float] = None,
                 grace_period_s: Optional[float] = None,
                 quiesce_timeout_s: Optional[float] = None,
                 snapshot_interval: Optional[int] = None,
                 max_step_attempts: int = 3,
                 register_globally: bool = True):
        if manager is None:
            if checkpoint_root is None:
                raise ValueError(
                    "ElasticSupervisor needs a CheckpointManager or a "
                    "checkpoint_root to build one")
            from alpa_tpu_torch.checkpoint.manager import CheckpointManager
            manager = CheckpointManager(checkpoint_root, async_save=False)
        if devices is None:
            import torch
            from alpa_tpu_torch.platform import get_device
            get_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.solve = solve
        self.state = state
        self.manager = manager
        self.devices: List[Any] = list(devices)
        self.wedge_detector = wedge_detector
        self.step_budget = (step_budget if step_budget is not None else
                            global_config.elastic_step_budget)
        self.time_budget_s = (time_budget_s if time_budget_s is not None
                              else global_config.elastic_time_budget_s)
        self.grace_period_s = (grace_period_s if grace_period_s is not None
                               else global_config.elastic_grace_period_s)
        self.quiesce_timeout_s = (
            quiesce_timeout_s if quiesce_timeout_s is not None
            else global_config.elastic_quiesce_timeout_s)
        self.snapshot_interval = max(1, (
            snapshot_interval if snapshot_interval is not None
            else global_config.elastic_snapshot_interval))
        self.max_step_attempts = max(1, max_step_attempts)

        self.step_index = 0
        #: completed episode records, oldest first (JSON-able dicts)
        self.episodes: List[Dict[str, Any]] = []
        self._step_fn = solve(self.devices)
        self._baseline_findings: Optional[frozenset] = None
        self._mid_step = False
        self._in_episode = False
        self._last_args: Optional[tuple] = None
        self._signals: List[Dict[str, Any]] = []
        self._signal_lock = threading.Lock()

        # step-0 restore point: a failure before the first periodic
        # snapshot still has a verified floor
        if self.manager.latest_step() is None:
            self.manager.save(0, self.state,
                              plan_fingerprint=self._fingerprint(),
                              meta={"reason": "elastic_initial"},
                              sync=True)
            self.manager.wait()

        if register_globally:
            global _ACTIVE
            _ACTIVE = self
            fault.set_escalation_manager(self)
        _ELASTIC_STATE.set(0)

    # -- plumbing ------------------------------------------------------

    def _executable(self):
        get = getattr(self._step_fn, "get_last_executable", None)
        return get() if get is not None else None

    def _fingerprint(self) -> Optional[str]:
        ex = self._executable()
        get = getattr(ex, "get_plan_fingerprint", None)
        try:
            return get() if get is not None else None
        except Exception:  # pylint: disable=broad-except
            return None

    @staticmethod
    def _findings_of(ex) -> frozenset:
        """The plan verdict's findings as comparable (analysis, code)
        pairs; empty for executables without a verifier (shard-parallel
        paths) or with verification off."""
        get = getattr(ex, "get_plan_verdict", None)
        if get is None:
            return frozenset()
        try:
            verdict = get()
        except Exception:  # pylint: disable=broad-except
            logger.exception("elastic: plan verdict unavailable")
            return frozenset()
        if verdict is None:
            return frozenset()
        return frozenset((f.analysis, f.code) for f in verdict.findings())

    # -- external signals ---------------------------------------------

    def notify_worker_lost(self,
                           survivors: Optional[Sequence[Any]] = None):
        """Queue a worker-loss event (thread-safe); the episode runs at
        the next step boundary."""
        self._signal("worker_lost", WorkerLost(survivors=survivors))

    def notify_preemption(self, grace_s: Optional[float] = None,
                          survivors: Optional[Sequence[Any]] = None):
        """Queue a preemption notice (thread-safe)."""
        self._signal("preemption_notice",
                     PreemptionNotice(grace_s=grace_s, survivors=survivors))

    def escalate(self, site: str, error: BaseException):
        """``fault.set_escalation_manager`` target: elastic-site retry
        exhaustion becomes a queued lifecycle event."""
        self._signal(site if site in fault.ELASTIC_SITES
                     else "step_failure", error)

    def _signal(self, reason: str, error: BaseException):
        with self._signal_lock:
            self._signals.append({"reason": reason, "error": error})
        logger.warning("elastic: queued %s signal (%s)", reason, error)

    def _drain_signals(self):
        while True:
            with self._signal_lock:
                if not self._signals:
                    return
                sig = self._signals.pop(0)
            self._run_episode(sig["reason"], error=sig["error"])

    def _poll_sites(self):
        """The step-boundary instrumentation for the elastic fault
        sites: with no active FaultPlan both fire() calls are near-zero
        no-ops; an injected spec raises and becomes a queued signal —
        exactly how a real preemption notice or scheduler callback
        arrives."""
        for site in ("preemption_notice", "worker_lost"):
            try:
                fault.fire(site, step=self.step_index,
                           devices=len(self.devices))
            except Exception as e:  # pylint: disable=broad-except
                self._signal(site, e)

    # -- the supervised step ------------------------------------------

    def step(self, *args):
        """Run one training step under supervision: polls the elastic
        sites, drains queued signals (running their episodes), executes
        ``step_fn(state, *args)``, advances ``state``/``step_index``,
        and snapshots every ``snapshot_interval`` steps.  A failing
        step triggers an episode and is replayed (bounded by
        ``max_step_attempts``).  Returns the step's aux outputs (the
        loss for the usual ``(state, loss)`` convention)."""
        self._last_args = args
        self._poll_sites()
        self._drain_signals()
        attempts = 0
        while True:
            attempts += 1
            try:
                self._mid_step = True
                out = self._step_fn(self.state, *args)
                self._mid_step = False
                break
            except Exception as e:  # pylint: disable=broad-except
                if attempts >= self.max_step_attempts:
                    self._mid_step = False
                    raise
                reason, error = self._classify(e)
                self._run_episode(reason, error=error)
        if not (isinstance(out, tuple) and len(out) >= 1):
            raise TypeError(
                "elastic step functions must return (new_state, *aux); "
                f"got {type(out).__name__}")
        self.state = out[0]
        aux = out[1:]
        self.step_index += 1
        if self._baseline_findings is None:
            self._baseline_findings = self._findings_of(self._executable())
        if self.step_index % self.snapshot_interval == 0:
            self.manager.save(self.step_index, self.state,
                              plan_fingerprint=self._fingerprint(),
                              sync=True)
            self.manager.wait()
        return aux[0] if len(aux) == 1 else aux

    def _classify(self, e: BaseException):
        """Map a step failure to an episode reason.  Typed elastic
        errors name themselves; anything else consults the wedge
        detector (probe timeout taxonomy) before falling back to the
        generic ``step_failure``."""
        if isinstance(e, WorkerLost):
            return "worker_lost", e
        if isinstance(e, PreemptionNotice):
            return "preemption_notice", e
        if self.wedge_detector is not None:
            try:
                statuses = self.wedge_detector.check()
            except Exception as we:  # pylint: disable=broad-except
                # the wedge_detected injection point fired
                return "wedge_detected", we
            if any(s != "ok" for s in statuses.values()):
                return "wedge_detected", e
        return "step_failure", e

    # -- the episode ---------------------------------------------------

    def _run_episode(self, reason: str, error: Optional[BaseException]
                     = None) -> Dict[str, Any]:
        """Quiesce -> snapshot -> re-solve (gated) -> restore -> resume.
        Never raises: a failed phase degrades to the rollback path (old
        plan + last verified checkpoint)."""
        t0 = time.monotonic()
        self._in_episode = True
        _ELASTIC_STATE.set(1)
        _EPISODES.labels(reason).inc()
        survivors = getattr(error, "survivors", None)
        grace_s = getattr(error, "grace_s", None)
        ep: Dict[str, Any] = {
            "reason": reason,
            "error": f"{type(error).__name__}: {error}" if error else None,
            "step_at_failure": self.step_index,
            "mid_step": self._mid_step,
        }
        _flight.annotate("elastic_episode", {
            "reason": reason, "step": self.step_index,
            "phase": "detected"})
        _flight.auto_dump(f"elastic episode: {reason}")
        old_ex = self._executable()
        try:
            ep.update(self._episode_body(reason, survivors, grace_s))
        except Exception:  # pylint: disable=broad-except
            logger.exception("elastic episode body failed; resuming on "
                             "the old plan")
            ep["episode_error"] = True
        finally:
            # reopen the old executable's launch gate whatever happened:
            # a rolled-back (or crashed) episode keeps training on it
            if old_ex is not None and hasattr(old_ex, "resume"):
                try:
                    old_ex.resume()
                except Exception:  # pylint: disable=broad-except
                    logger.exception("elastic: resume of old "
                                     "executable failed")
            self._mid_step = False
            self._in_episode = False
            _ELASTIC_STATE.set(0)
        ep["seconds"] = round(time.monotonic() - t0, 6)
        ep["within_time_budget"] = ep["seconds"] <= self.time_budget_s
        if not ep["within_time_budget"]:
            _BUDGET_VIOLATIONS.labels("seconds").inc()
        _RECOVERY_SECONDS.observe(ep["seconds"])
        self.episodes.append(ep)
        _flight.annotate("elastic_episode", dict(ep))
        logger.warning(
            "elastic episode done: %s at step %d -> restored step %s, "
            "replan %s, %.3fs (budgets: steps %s, time %s)", reason,
            ep["step_at_failure"], ep.get("restored_step"),
            ep.get("replan"), ep["seconds"],
            "ok" if ep.get("within_step_budget", True) else "EXCEEDED",
            "ok" if ep["within_time_budget"] else "EXCEEDED")
        return ep

    def _episode_body(self, reason: str,
                      survivors: Optional[Sequence[Any]],
                      grace_s: Optional[float]) -> Dict[str, Any]:
        ep: Dict[str, Any] = {}
        # 1. quiesce: close the launch gate, drain in-flight work
        old_ex = self._executable()
        if old_ex is not None and hasattr(old_ex, "quiesce"):
            ep["quiesced"] = bool(old_ex.quiesce(self.quiesce_timeout_s))
        else:
            ep["quiesced"] = None
        _flight.annotate("elastic_episode", {
            "reason": reason, "phase": "quiesced"})

        # 2. snapshot
        ep["snapshot"] = self._snapshot_phase(reason, grace_s, ep)

        # 3. restore target: the last hash-verified step (a torn or
        # bit-rotted newest step falls through to the one before it)
        restored_step = self.manager.last_verified_step()
        ep["restored_step"] = restored_step

        # 4. re-solve for the survivors, gated on the plan verdict (the
        # candidate compiles against the live state's shapes)
        new_devices = (list(survivors) if survivors is not None
                       else list(self.devices))
        ep["devices_before"] = len(self.devices)
        ep["devices_after"] = len(new_devices)
        ep["replan"] = self._resolve_phase(new_devices, self.state)
        ep["verdict"] = ("unavailable" if getattr(
            self._executable(), "get_plan_verdict", None) is None
            else "checked")

        restored = None
        if restored_step is not None:
            # cross-plan restore by design: no expected fingerprint;
            # ShardStore.read_leaf_slice reassembles the saved blocks
            # into the layout the plan that resumes takes.  A reused
            # plan is restored into the live state in place, so that
            # its CUDA graphs replay on the same addresses; after a
            # failure mid-step the live state may have released its
            # donated buffers, so it gets fresh ones.
            if ep["replan"] == "reused" and not self._mid_step:
                restored = self.manager.restore(self.state,
                                                step=restored_step,
                                                in_place=True)
            else:
                restored = self.manager.restore(
                    self.state, step=restored_step,
                    shardings=self._layouts(self.state))

        # 5. resume position: roll the loop back to the restored step
        if restored is not None:
            replay = max(0, self.step_index - restored_step)
            self.state = restored
            self.step_index = restored_step
        else:
            logger.warning("elastic: no verified checkpoint to restore "
                           "— continuing with the live state")
            replay = 0
        ep["replay_steps"] = replay
        ep["within_step_budget"] = replay <= self.step_budget
        if not ep["within_step_budget"]:
            _BUDGET_VIOLATIONS.labels("steps").inc()
        _REPLAY_STEPS.observe(float(replay))
        return ep

    def _snapshot_phase(self, reason: str, grace_s: Optional[float],
                        ep: Dict[str, Any]) -> str:
        """Durable snapshot of the live state — unless the failure was
        mid-step, in which case the state is torn (donated buffers may
        already be freed) and the episode falls back to the last
        verified checkpoint."""
        if self._mid_step:
            _SNAPSHOTS.labels("skipped").inc()
            return "skipped"
        grace = grace_s if grace_s is not None else self.grace_period_s
        t0 = time.monotonic()
        try:
            if self.manager.latest_step() != self.step_index:
                self.manager.save(self.step_index, self.state,
                                  plan_fingerprint=self._fingerprint(),
                                  meta={"reason": f"elastic_{reason}"},
                                  sync=True)
                self.manager.wait()
        except Exception:  # pylint: disable=broad-except
            logger.exception("elastic snapshot failed; falling back to "
                             "the last verified checkpoint")
            _SNAPSHOTS.labels("failed").inc()
            return "failed"
        took = time.monotonic() - t0
        if reason == "preemption_notice":
            hit = took <= grace
            ep["snapshot_before_kill"] = hit
            ep["snapshot_seconds"] = round(took, 6)
            outcome = "grace" if hit else "late"
        else:
            outcome = "boundary"
        _SNAPSHOTS.labels(outcome).inc()
        return outcome

    def _layouts(self, template) -> Optional[Any]:
        """Where the current step's executable takes each leaf of the
        state: a ``serialization.ShardLayout`` per tensor leaf of an
        executable with ``in_specs`` over one ``logical_mesh`` (the
        state's flat leaves come first among its inputs); None (each
        leaf placed as the template's) otherwise."""
        from torch.utils import _pytree as pytree
        from alpa_tpu_torch import serialization as _ser
        ex = self._executable()
        specs = getattr(ex, "in_specs", None)
        mesh = getattr(ex, "logical_mesh", None)
        if specs is None or mesh is None:
            return None
        leaves = pytree.tree_leaves(template)
        if len(specs) < len(leaves):
            return None
        by_id = {id(leaf): _ser.ShardLayout(tuple(specs[i]), mesh)
                 for i, leaf in enumerate(leaves)
                 if _ser.is_tensor_leaf(leaf)}
        return _ser.rebuild(template, {
            path: by_id.get(id(leaf))
            for _n, (path, leaf) in _ser.flat_leaves(template).items()})

    def _resolve_phase(self, new_devices: List[Any],
                       template: Any) -> str:
        """Re-solve + acceptance gate.  Compiles the candidate plan
        (no launch), compares its full verdict findings against the old
        plan's baseline, and hot-swaps only when nothing new appeared;
        otherwise rolls back to the old plan."""
        try:
            candidate = self.solve(new_devices)
        except Exception:  # pylint: disable=broad-except
            logger.exception("elastic re-solve failed; keeping the "
                             "old plan")
            _REPLANS.labels("failed").inc()
            return "failed"
        if candidate is self._step_fn:
            # solve() memoizes per device set: same plan, nothing to gate
            self.devices = new_devices
            _REPLANS.labels("reused").inc()
            return "reused"
        cand_ex = None
        if self._last_args is not None:
            try:
                candidate.get_executable(template, *self._last_args)
                cand_ex = candidate.get_last_executable()
            except Exception:  # pylint: disable=broad-except
                logger.exception("elastic: candidate plan failed to "
                                 "compile; rolling back")
                _REPLANS.labels("rejected").inc()
                return "rejected"
        baseline = (self._baseline_findings
                    if self._baseline_findings is not None
                    else self._findings_of(self._executable()))
        fresh = self._findings_of(cand_ex) - baseline
        if fresh:
            logger.warning(
                "elastic: candidate plan REJECTED — %d new verifier "
                "finding(s) vs the old plan: %s; rolling back to the "
                "old plan + last verified checkpoint", len(fresh),
                sorted(f"{a}:{c}" for a, c in fresh))
            _REPLANS.labels("rejected").inc()
            return "rejected"
        self._step_fn = candidate
        self.devices = new_devices
        self._baseline_findings = self._findings_of(cand_ex)
        _REPLANS.labels("accepted").inc()
        return "accepted"
