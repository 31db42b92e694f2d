"""Fault-tolerance layer: fault injection, retry/backoff, recovery.

The port of ``alpa_tpu/fault.py``, with its names, sites, policies and
state machine:

1. **Fault injection** (``FaultPlan`` / ``FaultSpec``): deterministic,
   context-managed injection of hangs, errors and slowdowns at named
   *sites*.  Code calls ``fault.fire("<site>", **info)`` at instrumented
   points; with no active plan it is one list check.  Sites:

   =====================  ==================================================
   site                   where
   =====================  ==================================================
   ``probe``              ``monitoring.check_alive``'s device probe
   ``stage_launch``       pipeshard RUN (register-file op or instruction)
   ``cross_mesh_send``    pipeshard RESHARD (op, group or instruction)
   ``cross_mesh_recv``    ``ReshardingTask`` in "tiled" or "broadcast" mode
   ``scheduler_take``     ``serve.controller.RequestBatcher`` batch formation
   ``scheduler_tick``     ``serve.engine.ContinuousBatchingEngine`` decode
                          tick, before the tick (or its CUDA graph) runs
   ``distributed_init``   reserved: ``distributed.py`` is not ported
                          (ROADMAP A.1)
   ``worker_lost``        ``elastic.ElasticSupervisor`` step-boundary poll
                          (a mesh's workers died; re-solve for survivors)
   ``preemption_notice``  ``elastic.ElasticSupervisor`` step-boundary poll
                          (eviction warning; snapshot inside the grace
                          window before the kill lands)
   ``wedge_detected``     ``elastic.WedgeDetector.check`` probe sweep (a
                          device answers nothing, not even an error)
   =====================  ==================================================

   Recovery re-probes fire at sites ``probe`` and ``recovery_probe``.
   The three elastic sites (``ELASTIC_SITES``) escalate: retry
   exhaustion there goes to the installed ``RecoveryManager``
   (``set_escalation_manager``) instead of raising a raw
   ``RetryExhaustedError``.  A fire runs on the host before the op it
   guards; it is never captured into a CUDA graph, so a retried op
   replays the same graph.

2. **Retry policy** (``RetryPolicy`` + ``call_with_retry``): jittered
   exponential backoff with deadline budgets and per-site overrides.
   ``InjectedFault`` is always retried (it fires before the real
   operation); other errors only where the caller declares the operation
   idempotent (a transfer is; a stage run that donates its inputs is
   not).  The jitter draws from ``random`` as JAX's does, so one seed
   gives one backoff schedule in both packages.  The plan model checker
   installs its static retry classification of every site
   (``install_retry_classification``, from each verified plan, cache hits
   included); under ``verify_plans="error"`` a real failure at a site it
   classed unsafe is not retried, whatever the caller declared.

3. **Recovery state machine** (``MeshHealth`` / ``RecoveryManager``):
   HEALTHY -> SUSPECT -> RECOVERING -> DEGRADED with bounded re-probes,
   quiesce and snapshot hooks; ``monitoring.FailureWatchdog`` drives it,
   and the serving controller sheds load (HTTP 503) while DEGRADED.
"""
import dataclasses
import enum
import logging
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from alpa_tpu_torch.telemetry import metrics as _tmetrics

logger = logging.getLogger(__name__)

_RETRIES_TOTAL = _tmetrics.get_registry().counter(
    "alpa_fault_retries_total",
    "Total extra retry attempts per instrumented site",
    labelnames=("site",))
_HEALTH_STATE = _tmetrics.get_registry().gauge(
    "alpa_fault_health_state",
    "Recovery state machine position "
    "(0=healthy 1=suspect 2=recovering 3=degraded)")
_STATE_TRANSITIONS = _tmetrics.get_registry().counter(
    "alpa_fault_state_transitions_total",
    "Recovery state machine transitions by destination state",
    labelnames=("to",))

__all__ = [
    "FaultSpec", "FaultPlan", "InjectedFault", "fire", "active_plan",
    "KNOWN_SITES", "ELASTIC_SITES",
    "set_escalation_manager", "get_escalation_manager",
    "install_retry_classification", "get_retry_classification",
    "RetryPolicy", "RetryExhaustedError", "call_with_retry",
    "set_retry_policy", "get_retry_policy", "retry_stats",
    "MeshHealth", "RecoveryManager", "ServiceDegradedError",
    "make_snapshotter",
]

#: Registry of instrumented fault sites (the table in the module
#: docstring, machine-readable).  Adding a site = instrument the call
#: point, add it here AND to the docstring table above.
KNOWN_SITES = frozenset({
    "probe", "stage_launch", "cross_mesh_send", "cross_mesh_recv",
    "scheduler_take", "scheduler_tick", "distributed_init",
    "recovery_probe",
    "worker_lost", "preemption_notice", "wedge_detected",
})

#: Elastic-lifecycle sites: failures here are cluster
#: membership events, not transient RPC errors.  ``call_with_retry``
#: exhaustion at these sites escalates into the installed
#: RecoveryManager (``set_escalation_manager``) rather than propagating
#: a raw ``RetryExhaustedError`` to the caller.
ELASTIC_SITES = frozenset({
    "worker_lost", "preemption_notice", "wedge_detected",
})


class InjectedFault(RuntimeError):
    """Error raised by an ``error``-kind FaultSpec.  Retry wrappers treat
    these as always safe to retry (the injection fired *before* the real
    operation ran), which lets tests exercise retry loops around
    non-idempotent operations without risking double execution."""


class ServiceDegradedError(RuntimeError):
    """Load-shed rejection: the serving stack is in DEGRADED mode and
    refuses new work instead of crashing on it (mapped to HTTP 503 by
    ``serve.controller``)."""


########################################
# fault injection
########################################


@dataclasses.dataclass
class FaultSpec:
    """One injected fault at a named site.

    ``kind``:
      * ``"error"`` — raise (``exc`` factory, default ``InjectedFault``).
      * ``"hang"``  — sleep ``delay`` seconds (simulates a wedged device:
        make it longer than the caller's timeout).
      * ``"slow"``  — sleep ``delay`` seconds, then continue normally.

    ``times``: how many matching hits fire this spec (-1 = every hit).
    ``after``: skip the first N matching hits (fire on hit N+1 onward) —
    lets a test fail the first attempt and let the retry succeed.
    ``match``: optional predicate over the site's keyword info (e.g.
    ``lambda info: info.get("mesh_id") == 1``) to target one mesh/stage.
    """
    site: str
    kind: str = "error"
    times: int = 1
    after: int = 0
    delay: float = 0.0
    exc: Optional[Callable[[], BaseException]] = None
    match: Optional[Callable[[Dict[str, Any]], bool]] = None

    def __post_init__(self):
        if self.kind not in ("error", "hang", "slow"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("hang", "slow") and self.delay <= 0.0:
            raise ValueError(f"{self.kind} fault needs a positive delay")


class _SpecState:
    """Mutable firing counters for one FaultSpec inside one plan."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self.hits = 0       # matching fire() calls seen
        self.fired = 0      # times the fault actually triggered


class FaultPlan:
    """Context manager installing a set of FaultSpecs for the duration
    of a ``with`` block (process-global; nested plans stack, innermost
    consulted first).  Thread-safe: ``fire`` may be called from worker
    threads while the plan is active.

    Introspection for tests:
      * ``plan.events`` — every triggered fault as ``(site, kind, info)``.
      * ``plan.hits(site)`` — matching ``fire`` calls (triggered or not).
      * ``plan.retries`` — per-site retry-attempt counts recorded by
        ``call_with_retry`` while this plan was active.
    """

    def __init__(self, *specs: FaultSpec):
        self._states = [_SpecState(s) for s in specs]
        self._lock = threading.Lock()
        self.events: List[Tuple[str, str, Dict[str, Any]]] = []
        self.retries: Dict[str, int] = {}
        self.backoffs: Dict[str, List[float]] = {}

    # -- context management -------------------------------------------

    def __enter__(self):
        with _PLANS_LOCK:
            _ACTIVE_PLANS.append(self)
        return self

    def __exit__(self, *exc_info):
        with _PLANS_LOCK:
            if self in _ACTIVE_PLANS:
                _ACTIVE_PLANS.remove(self)
        return False

    # -- firing --------------------------------------------------------

    def hits(self, site: str) -> int:
        with self._lock:
            return sum(st.hits for st in self._states
                       if st.spec.site == site)

    def fired(self, site: str) -> int:
        with self._lock:
            return sum(st.fired for st in self._states
                       if st.spec.site == site)

    def _consume(self, site: str, info: Dict[str, Any]):
        """Return the FaultSpec to trigger for this hit, if any."""
        with self._lock:
            for st in self._states:
                spec = st.spec
                if spec.site != site:
                    continue
                if spec.match is not None and not spec.match(info):
                    continue
                st.hits += 1
                if st.hits <= spec.after:
                    continue
                if spec.times >= 0 and st.fired >= spec.times:
                    continue
                st.fired += 1
                self.events.append((site, spec.kind, dict(info)))
                return spec
        return None

    def _record_retry(self, site: str, attempts: int,
                      delays: Sequence[float]):
        with self._lock:
            self.retries[site] = self.retries.get(site, 0) + attempts
            self.backoffs.setdefault(site, []).extend(delays)


_ACTIVE_PLANS: List[FaultPlan] = []
_PLANS_LOCK = threading.Lock()


def active_plan() -> Optional[FaultPlan]:
    """Innermost active plan (None outside any ``with FaultPlan(...)``)."""
    with _PLANS_LOCK:
        return _ACTIVE_PLANS[-1] if _ACTIVE_PLANS else None


def instrumented() -> bool:
    """True when any fault plan or retry policy is installed.  Hot
    dispatch paths may skip their retry-wrapper overhead when False —
    with nothing installed the wrapper could only ever make one
    attempt anyway."""
    return bool(_ACTIVE_PLANS or _SITE_POLICIES
                or _DEFAULT_POLICY is not None)


def fire(site: str, **info):
    """Fault-injection hook: no-op unless an active FaultPlan has a
    matching spec.  Call at every instrumented site; the fast path is a
    single list check."""
    if not _ACTIVE_PLANS:  # fast path: no plan installed
        return
    with _PLANS_LOCK:
        plans = list(reversed(_ACTIVE_PLANS))
    for plan in plans:
        spec = plan._consume(site, info)
        if spec is None:
            continue
        # a firing site is one of the flight recorder's auto-dump
        # triggers: capture the instruction timeline leading up to the
        # injection before the failure propagates
        from alpa_tpu_torch.telemetry import flight as _flight
        _flight.auto_dump(f"fault site fired: {site} ({spec.kind})")
        if spec.kind == "error":
            exc = spec.exc() if spec.exc is not None else InjectedFault(
                f"injected fault at {site} ({info})")
            raise exc
        # hang / slow both sleep; "hang" is expected to exceed the
        # caller's timeout, "slow" to stay under it
        time.sleep(spec.delay)
        return


########################################
# retry / timeout / backoff
########################################


class RetryExhaustedError(RuntimeError):
    """All retry attempts failed.  ``last`` is the final exception;
    ``attempts`` the number of calls made."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"{site}: {attempts} attempt(s) failed; last error: "
            f"{type(last).__name__}: {last}")
        self.site = site
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass
class RetryPolicy:
    """Jittered exponential backoff with a deadline budget.

    ``max_attempts`` total calls (1 = no retry); sleep between attempts
    is ``min(max_delay, base_delay * multiplier**k)`` plus uniform
    jitter of up to ``jitter`` fraction of the delay.  ``deadline``
    (seconds, measured from the first attempt) bounds the whole loop:
    no retry is started once the budget is spent.  ``site_overrides``
    maps site names to replacement policies — one policy object can be
    threaded through the stack and still treat probes differently from
    transfers.
    """
    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    site_overrides: Dict[str, "RetryPolicy"] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay < 0 or self.max_delay < 0 or self.jitter < 0:
            raise ValueError("delays and jitter must be non-negative")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def for_site(self, site: Optional[str]) -> "RetryPolicy":
        if site is not None and site in self.site_overrides:
            return self.site_overrides[site]
        return self

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Sleep before attempt ``attempt`` (attempt 1 is the second
        call).  Deterministic when ``jitter == 0``."""
        base = min(self.max_delay,
                   self.base_delay * self.multiplier ** (attempt - 1))
        if self.jitter > 0:
            base += (rng or random).uniform(0, self.jitter * base)
        return base


#: No-retry default: production paths pay zero behavior change unless a
#: policy is installed (``set_retry_policy``) or passed explicitly.
NO_RETRY = RetryPolicy(max_attempts=1)

_SITE_POLICIES: Dict[str, RetryPolicy] = {}
_DEFAULT_POLICY: Optional[RetryPolicy] = None
_POLICY_LOCK = threading.Lock()

#: Process-global retry accounting: site -> total extra attempts.
retry_stats: Dict[str, int] = {}

#: Process-global escalation target for ELASTIC_SITES retry exhaustion:
#: a RecoveryManager (or anything with ``escalate(site, error)``).
_ESCALATION_MANAGER: Optional[Any] = None


#: the plan model checker's static retry classification of the most
#: recently verified plan: site -> {"classification": "safe" | "unsafe" |
#: "unreachable", "reasons": [...], "hooks": n}
_RETRY_CLASSIFICATION: Dict[str, Dict[str, Any]] = {}


def install_retry_classification(
        sites: Optional[Dict[str, Dict[str, Any]]]) -> None:
    """Install (or, with ``None`` or ``{}``, clear) the model checker's
    per-site retry classification; ``plan_verifier.verify_program`` calls
    it for every verified plan, cache hits included, so a warm restart
    refuses what the cold compile refused."""
    with _POLICY_LOCK:
        _RETRY_CLASSIFICATION.clear()
        if sites:
            _RETRY_CLASSIFICATION.update(
                {s: dict(e) for s, e in sites.items()})


def get_retry_classification() -> Dict[str, Dict[str, Any]]:
    """The installed static retry classification (a copy)."""
    with _POLICY_LOCK:
        return {s: dict(e) for s, e in _RETRY_CLASSIFICATION.items()}


def _refuse_statically_unsafe(site: str) -> bool:
    """Whether the model checker classed retrying ``site`` unsafe for the
    verified plan and ``verify_plans`` is "error": there the static proof
    overrides the caller's idempotent flag."""
    with _POLICY_LOCK:
        ent = _RETRY_CLASSIFICATION.get(site)
    if not ent or ent.get("classification") != "unsafe":
        return False
    from alpa_tpu_torch.global_env import global_config
    return global_config.verify_plans == "error"


def set_escalation_manager(manager: Optional[Any]) -> Optional[Any]:
    """Install (``None`` clears) the RecoveryManager that absorbs retry
    exhaustion at ``ELASTIC_SITES``.  Returns the previous target so
    tests and nested supervisors can restore it."""
    global _ESCALATION_MANAGER
    with _POLICY_LOCK:
        prev = _ESCALATION_MANAGER
        _ESCALATION_MANAGER = manager
    return prev


def get_escalation_manager() -> Optional[Any]:
    with _POLICY_LOCK:
        return _ESCALATION_MANAGER


def _escalate_exhaustion(site: str, attempts: int,
                         error: BaseException) -> bool:
    """Route elastic-site retry exhaustion into the recovery state
    machine.  True when a manager absorbed it (the caller then raises
    ``ServiceDegradedError`` instead of the raw error)."""
    if site not in ELASTIC_SITES:
        return False
    manager = get_escalation_manager()
    if manager is None:
        return False
    try:
        manager.escalate(site, error)
        return True
    except Exception:  # pylint: disable=broad-except
        logger.exception("elastic escalation of %s failed", site)
        return False


def set_retry_policy(policy: Optional[RetryPolicy],
                     site: Optional[str] = None):
    """Install ``policy`` for ``site`` (or as the process default when
    site is None).  ``None`` removes the entry."""
    global _DEFAULT_POLICY
    with _POLICY_LOCK:
        if site is None:
            _DEFAULT_POLICY = policy
        elif policy is None:
            _SITE_POLICIES.pop(site, None)
        else:
            _SITE_POLICIES[site] = policy


def get_retry_policy(site: Optional[str] = None) -> RetryPolicy:
    """Effective policy for a site: explicit site entry, else the
    process default's ``for_site`` view, else NO_RETRY."""
    with _POLICY_LOCK:
        if site is not None and site in _SITE_POLICIES:
            return _SITE_POLICIES[site]
        if _DEFAULT_POLICY is not None:
            return _DEFAULT_POLICY.for_site(site)
    return NO_RETRY


def call_with_retry(fn: Callable[[], Any],
                    policy: Optional[RetryPolicy] = None,
                    site: str = "call",
                    retry_on: Tuple = (Exception,),
                    idempotent: bool = True,
                    on_retry: Optional[Callable[[int, BaseException],
                                                Any]] = None,
                    rng: Optional[random.Random] = None) -> Any:
    """Run ``fn()`` under ``policy`` (default: the installed policy for
    ``site``).

    * ``InjectedFault`` is always retryable (the injection preempted the
      real operation); other ``retry_on`` errors are retried only when
      ``idempotent`` and, under ``verify_plans="error"``, the site is not
      classed unsafe by the plan model checker — re-running a donated-buffer execution would read
      freed inputs, so non-idempotent callers get detection + the
      original error, never a blind re-run.
    * Exhaustion re-raises the LAST error (callers' existing error paths
      keep working); wrap in ``RetryExhaustedError`` only when asked via
      ``policy.deadline``-style introspection — attempts are recorded in
      ``retry_stats`` and the active ``FaultPlan`` either way.
    """
    pol = (policy or get_retry_policy(site)).for_site(site)
    start = time.monotonic()
    attempts = 0
    delays: List[float] = []
    while True:
        attempts += 1
        try:
            result = fn()
            break
        except retry_on as e:  # pylint: disable=broad-except
            retryable = idempotent or isinstance(e, InjectedFault)
            if retryable and not isinstance(e, InjectedFault) and \
                    _refuse_statically_unsafe(site):
                # the model checker proved that a real failure in the
                # middle of this site cannot be retried without applying
                # state twice (donation, a partial group, a FIFO reorder)
                logger.warning(
                    "%s: retry refused — classified unsafe by the plan "
                    "model checker (%s) under verify_plans=error", site,
                    ",".join(get_retry_classification()
                             .get(site, {}).get("reasons", ())))
                retryable = False
            out_of_attempts = attempts >= pol.max_attempts
            out_of_budget = (
                pol.deadline is not None and
                time.monotonic() - start >= pol.deadline)
            if not retryable or out_of_attempts or out_of_budget:
                _account_retries(site, attempts - 1, delays)
                if _escalate_exhaustion(site, attempts, e):
                    # elastic lifecycle event: the recovery manager now
                    # owns it (quiesce/snapshot/degrade); callers see a
                    # typed degradation signal, never the raw
                    # RetryExhaustedError / transport error
                    raise ServiceDegradedError(
                        f"{site}: {attempts} attempt(s) failed; "
                        "escalated to the recovery manager "
                        f"(last error: {type(e).__name__}: {e})") from e
                raise
            delay = pol.backoff(attempts, rng)
            if pol.deadline is not None:
                delay = min(delay, max(
                    0.0, pol.deadline - (time.monotonic() - start)))
            delays.append(delay)
            if on_retry is not None:
                try:
                    on_retry(attempts, e)
                except Exception:  # pylint: disable=broad-except
                    logger.exception("on_retry callback failed")
            logger.warning("%s failed (attempt %d/%d): %s — retrying "
                           "in %.3fs", site, attempts, pol.max_attempts,
                           e, delay)
            if delay > 0:
                time.sleep(delay)
    _account_retries(site, attempts - 1, delays)
    return result


def _account_retries(site: str, extra_attempts: int,
                     delays: Sequence[float]):
    if extra_attempts <= 0:
        return
    with _POLICY_LOCK:
        retry_stats[site] = retry_stats.get(site, 0) + extra_attempts
    _RETRIES_TOTAL.labels(site).inc(extra_attempts)
    plan = active_plan()
    if plan is not None:
        plan._record_retry(site, extra_attempts, delays)


########################################
# recovery state machine
########################################


class MeshHealth(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    RECOVERING = "recovering"
    DEGRADED = "degraded"


#: numeric encoding for the alpa_fault_health_state gauge
_HEALTH_LEVEL = {
    MeshHealth.HEALTHY: 0,
    MeshHealth.SUSPECT: 1,
    MeshHealth.RECOVERING: 2,
    MeshHealth.DEGRADED: 3,
}


class RecoveryManager:
    """Watchdog-driven recovery: HEALTHY -> SUSPECT -> RECOVERING ->
    (HEALTHY | DEGRADED).

    Transitions (driven by ``observe(alive)`` per watchdog round):

    * HEALTHY, probe fails        -> SUSPECT (one immediate re-probe
      round with the retry policy — transient blips recover here).
    * SUSPECT, re-probe succeeds  -> HEALTHY.
    * SUSPECT, re-probe fails     -> RECOVERING: ``quiesce()`` in-flight
      pipeshard work, ``snapshot()`` host-side state (serialization
      hooks), then re-probe with bounded retries.
    * RECOVERING, probe succeeds  -> HEALTHY (``on_recover`` fires;
      load-shedding lifts).
    * RECOVERING, retries exhaust -> DEGRADED (``on_degrade`` fires;
      the serving stack sheds load with 503s instead of crashing).
    * DEGRADED, probe succeeds    -> HEALTHY (meshes un-wedge on their
      own).

    All callbacks are best-effort: a raising hook is logged, never
    allowed to kill the watchdog thread.
    """

    def __init__(self, mesh_group=None,
                 retry_policy: Optional[RetryPolicy] = None,
                 probe: Optional[Callable[[Any], bool]] = None,
                 quiesce: Optional[Callable[[], Any]] = None,
                 resume: Optional[Callable[[], Any]] = None,
                 snapshot: Optional[Callable[[], Any]] = None,
                 on_degrade: Optional[Callable[[str], Any]] = None,
                 on_recover: Optional[Callable[[], Any]] = None,
                 on_state_change: Optional[
                     Callable[[MeshHealth, MeshHealth], Any]] = None,
                 probe_timeout: float = 10.0):
        if probe is None:
            from alpa_tpu_torch.monitoring import check_alive

            def probe(mesh, _t=probe_timeout):
                return check_alive(mesh, timeout=_t)

        self.mesh_group = mesh_group
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=3, base_delay=0.05, max_delay=1.0)
        self._probe = probe
        # public, reassignable after construction (e.g.
        # Controller.attach_recovery rebinds the degrade/recover hooks)
        self.quiesce_hook = quiesce
        self.resume_hook = resume
        self.snapshot_hook = snapshot
        self.on_degrade = on_degrade
        self.on_recover = on_recover
        self.on_state_change = on_state_change
        self._lock = threading.Lock()
        self._state = MeshHealth.HEALTHY
        #: every transition as (old, new, reason) — test introspection
        self.transitions: List[Tuple[MeshHealth, MeshHealth, str]] = []
        self.snapshots_taken = 0
        self.last_dead: List[int] = []

    # -- state ---------------------------------------------------------

    @property
    def state(self) -> MeshHealth:
        with self._lock:
            return self._state

    def _transition(self, new: MeshHealth, reason: str):
        with self._lock:
            old = self._state
            if old is new:
                return
            self._state = new
            self.transitions.append((old, new, reason))
        _HEALTH_STATE.set(_HEALTH_LEVEL[new])
        _STATE_TRANSITIONS.labels(new.value).inc()
        logger.warning("mesh health: %s -> %s (%s)", old.value,
                       new.value, reason)
        if new is MeshHealth.SUSPECT:
            # watchdog declared a mesh SUSPECT: dump the flight ring —
            # the last instructions dispatched before liveness broke are
            # exactly the post-mortem a hang needs
            from alpa_tpu_torch.telemetry import flight as _flight
            _flight.auto_dump(f"mesh SUSPECT: {reason}")
        self._call(self.on_state_change, old, new)

    @staticmethod
    def _call(hook, *args):
        if hook is None:
            return None
        try:
            return hook(*args)
        except Exception:  # pylint: disable=broad-except
            logger.exception("recovery hook %r failed", hook)
            return None

    # -- probing -------------------------------------------------------

    def _probe_all(self) -> List[int]:
        """Indices of dead meshes (empty list = all healthy)."""
        if self.mesh_group is None:
            return []
        dead = []
        for i, mesh in enumerate(self.mesh_group):
            ok = False
            try:
                ok = bool(self._probe(mesh))
            except Exception:  # pylint: disable=broad-except
                logger.exception("probe of mesh %d raised", i)
            if not ok:
                dead.append(i)
        return dead

    def _reprobe_with_retries(self, site: str) -> bool:
        """Bounded re-probe loop: True once every mesh answers."""

        def attempt():
            dead = self._probe_all()
            if dead:
                self.last_dead = dead
                raise InjectedFault(f"meshes still dead: {dead}")
            return True

        try:
            return bool(call_with_retry(
                attempt, policy=self.retry_policy, site=site))
        except Exception:  # pylint: disable=broad-except
            return False

    # -- the state machine ---------------------------------------------

    def observe(self, dead: Sequence[int]) -> MeshHealth:
        """One watchdog round's verdict: ``dead`` mesh indices (empty =
        all probes passed).  Drives the state machine; returns the state
        after handling.  Callable from FailureWatchdog's thread or
        directly from tests."""
        dead = list(dead)
        state = self.state
        if not dead:
            if state is not MeshHealth.HEALTHY:
                self._recover(f"probe clean from {state.value}")
            return self.state

        self.last_dead = dead
        if state is MeshHealth.HEALTHY:
            self._transition(MeshHealth.SUSPECT,
                             f"probe failed for meshes {dead}")
            # one immediate retried re-probe: transient blips end here
            if self._reprobe_with_retries("probe"):
                self._recover("re-probe clean")
                return self.state
            self._begin_recovery()
        elif state is MeshHealth.SUSPECT:
            self._begin_recovery()
        elif state is MeshHealth.RECOVERING:
            self._transition(MeshHealth.DEGRADED,
                             f"still dead in recovery: {dead}")
            self._call(self.on_degrade,
                       f"meshes {dead} unrecovered")
        # DEGRADED + dead: stay degraded (watchdog keeps probing; a
        # clean round recovers via the branch above)
        return self.state

    def _begin_recovery(self):
        self._transition(MeshHealth.RECOVERING,
                         f"quiescing; dead meshes {self.last_dead}")
        self._call(self.quiesce_hook)
        if self.snapshot_hook is not None:
            self._call(self.snapshot_hook)
            self.snapshots_taken += 1
        if self._reprobe_with_retries("recovery_probe"):
            self._recover("recovered after quiesce")
        else:
            self._transition(
                MeshHealth.DEGRADED,
                f"recovery retries exhausted; dead {self.last_dead}")
            self._call(self.on_degrade,
                       f"meshes {self.last_dead} unrecovered")

    def _recover(self, reason: str):
        was_degraded = self.state is MeshHealth.DEGRADED
        self._transition(MeshHealth.HEALTHY, reason)
        self._call(self.resume_hook)
        self._call(self.on_recover)
        if was_degraded:
            logger.warning("mesh group recovered from DEGRADED (%s)",
                           reason)

    def escalate(self, site: str, error: BaseException) -> MeshHealth:
        """Absorb an elastic-site retry exhaustion (``worker_lost`` /
        ``preemption_notice`` / ``wedge_detected``; see
        ``set_escalation_manager``): the failure is treated as a failed
        watchdog round — SUSPECT, then the quiesce → snapshot →
        re-probe recovery path — instead of propagating to the caller.
        """
        logger.warning("elastic site %s exhausted retries (%s: %s); "
                       "escalating into recovery", site,
                       type(error).__name__, error)
        state = self.state
        if state is MeshHealth.HEALTHY:
            self._transition(MeshHealth.SUSPECT,
                             f"elastic escalation from {site}")
            self._begin_recovery()
        elif state is MeshHealth.SUSPECT:
            self._begin_recovery()
        # RECOVERING / DEGRADED: recovery already owns the failure
        return self.state

    def tick(self) -> MeshHealth:
        """Probe every mesh once and feed the result to the state
        machine (the watchdog's per-interval body)."""
        return self.observe(self._probe_all())


def make_snapshotter(snapshot_dir: str,
                     state_provider: Callable[[], Any],
                     step: int = 0) -> Callable[[], str]:
    """Driver-side state snapshot hook for ``RecoveryManager``: dumps
    ``state_provider()`` (a pytree of arrays) via
    ``serialization.save_checkpoint`` and blocks until the write lands —
    a recovery that later fails over to a fresh cluster restores from
    here.

    Prefer :class:`alpa_tpu_torch.checkpoint.RecoveryCheckpointer` for new
    code: it snapshots into the content-addressed store (verifiable,
    retained, atomically committed) AND auto-restores the last verified
    step when recovery brings the mesh back; this helper remains for
    flat-directory snapshots with no retention."""

    def snapshot():
        from alpa_tpu_torch.serialization import (checkpoint_wait,
                                                  save_checkpoint)
        target = state_provider()
        save_checkpoint(snapshot_dir, target, step=step)
        checkpoint_wait()
        logger.info("state snapshot written to %s", snapshot_dir)
        return snapshot_dir

    return snapshot
