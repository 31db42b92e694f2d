"""The port's fault layer (``alpa_tpu_torch/fault.py``) against the JAX
package's, after ``tests/runtime/test_fault_injection.py`` and
``test_fault_tolerance.py``.

The same ``FaultPlan`` script fires the same hit counts and events; the
same seeded ``RetryPolicy`` gives the same backoff schedule; the same
probe results walk ``RecoveryManager`` through the same states.  On the
pipeshard runtime (the 4-stage MLP of the dispatch tests, CPU devices)
faults injected at ``stage_launch``, ``cross_mesh_send`` and
``cross_mesh_recv`` are retried in every dispatch mode and the step stays
bit-identical to the step without faults; a real error at a donating RUN
is not retried; with nothing installed the raw op list runs.  Sleeps are
patched out: no test waits on a clock.
"""
import random
import threading

import jax

import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import fault as jfault
from alpa_tpu import testing as jtesting
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu_torch import (AutoLayerOption, PipeshardParallel,
                            UniformStageOption)
from alpa_tpu_torch import fault as tfault
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import flight as tflight
from test_torch_dispatch import fake_cuda_graphs  # noqa: F401 (fixture)

MODES = ("sequential", "registers", "threaded", "overlap")
SITES = ("stage_launch", "cross_mesh_send", "cross_mesh_recv")
PKGS = {"jax": jfault, "port": tfault}


def _clear(mod):
    mod.set_retry_policy(None)
    for site in list(mod._SITE_POLICIES):
        mod.set_retry_policy(None, site=site)
    mod.retry_stats.clear()
    mod.set_escalation_manager(None)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch, tmp_path):
    """torch's RNG restored, both packages' retry state and the dispatch
    knobs reset, sleeps patched out, flight dumps under ``tmp_path``."""
    saved = dict(vars(global_config))
    jsaved = (jconfig.pipeline_dispatch_mode, jconfig.resharding_execution)
    for mod in PKGS.values():
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    monkeypatch.setattr(global_config, "flight_dump_dir", str(tmp_path))
    monkeypatch.setattr(jconfig, "flight_dump_dir", str(tmp_path))
    with torch.random.fork_rng():
        yield
    for mod in PKGS.values():
        _clear(mod)
    vars(global_config).update(saved)
    jconfig.pipeline_dispatch_mode, jconfig.resharding_execution = jsaved
    alpa_tpu_torch.shutdown()


# ---- fault plans, retry, recovery: the same script in both packages ----

def _plan_script(mod):
    """One script of fires against a plan of every spec kind the sites
    use: ``after``, ``times``, ``match``, an exception factory."""
    specs = [mod.FaultSpec("a", times=2, after=1),
             mod.FaultSpec("b", times=-1,
                           match=lambda info: info.get("mesh_id") == 1),
             mod.FaultSpec("c", times=1, exc=lambda: OSError("wire"))]
    raised = []
    with mod.FaultPlan(*specs) as plan:
        for i in range(5):
            for site, info in (("a", {"i": i}), ("b", {"mesh_id": i % 2}),
                               ("c", {"i": i})):
                try:
                    mod.fire(site, **info)
                    raised.append(None)
                except Exception as e:  # noqa: BLE001 -- recorded
                    raised.append(type(e).__name__)
        instrumented = mod.instrumented()
    return ({s: (plan.hits(s), plan.fired(s)) for s in "abc"},
            [(s, k, i) for s, k, i in plan.events], raised, instrumented,
            mod.instrumented())


def test_fault_plan_fires_as_jax():
    assert _plan_script(tfault) == _plan_script(jfault)


def _retry_script(mod, seed):
    """Backoffs drawn from one seeded generator, and a retried call's
    recorded attempts and delays."""
    pol = mod.RetryPolicy(max_attempts=6, base_delay=0.01, max_delay=0.05,
                          multiplier=2.0, jitter=0.3)
    rng = random.Random(seed)
    schedule = [pol.backoff(k, rng) for k in range(1, 6)]
    calls = []

    def flaky():
        calls.append(1)
        mod.fire("cross_mesh_send")
        return len(calls)

    with mod.FaultPlan(mod.FaultSpec("cross_mesh_send", times=3)) as plan:
        out = mod.call_with_retry(flaky, policy=pol, site="cross_mesh_send",
                                  rng=random.Random(seed))
    exhausted = None
    try:
        with mod.FaultPlan(mod.FaultSpec("probe", times=-1)):
            mod.call_with_retry(lambda: mod.fire("probe"),
                                policy=mod.RetryPolicy(max_attempts=3,
                                                       jitter=0.0),
                                site="probe")
    except mod.InjectedFault as e:
        exhausted = str(e)
    return (schedule, out, plan.retries, plan.backoffs,
            dict(mod.retry_stats), exhausted)


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_policy_backoff_schedule_as_jax(seed):
    assert _retry_script(tfault, seed) == _retry_script(jfault, seed)


def test_retry_classification_and_non_idempotent_errors_as_jax():
    """A real error at a non-idempotent call is not retried; an injected
    one is; a deadline stops the loop; elastic sites escalate."""
    def run(mod):
        out = []
        pol = mod.RetryPolicy(max_attempts=4, base_delay=0.0, jitter=0.0)
        n = []

        def real():
            n.append(1)
            raise RuntimeError("donated buffer")
        with pytest.raises(RuntimeError):
            mod.call_with_retry(real, policy=pol, site="stage_launch",
                                idempotent=False)
        out.append(len(n))
        with mod.FaultPlan(mod.FaultSpec("stage_launch", times=2)) as plan:
            mod.call_with_retry(lambda: mod.fire("stage_launch"),
                                policy=pol, site="stage_launch",
                                idempotent=False)
        out.append(plan.retries)

        class Manager:
            seen = []

            def escalate(self, site, error):
                self.seen.append((site, type(error).__name__))
        mod.set_escalation_manager(Manager())
        with pytest.raises(mod.ServiceDegradedError):
            with mod.FaultPlan(mod.FaultSpec("worker_lost", times=-1)):
                mod.call_with_retry(lambda: mod.fire("worker_lost"),
                                    policy=pol, site="worker_lost")
        out.append(Manager.seen)
        mod.set_escalation_manager(None)
        out.append(mod.get_retry_policy("probe").max_attempts)
        mod.set_retry_policy(mod.RetryPolicy(max_attempts=5, site_overrides={
            "probe": mod.RetryPolicy(max_attempts=2)}))
        out.append((mod.get_retry_policy("probe").max_attempts,
                    mod.get_retry_policy("x").max_attempts,
                    mod.instrumented()))
        return out
    assert run(tfault) == run(jfault)


PROBE_SCRIPTS = {
    # watchdog rounds' probe results, one per probe call
    "blip": [False, True],
    "recover_after_quiesce": [False, False, False, True],
    "degrade_then_heal": [False] * 8 + [True],
    "flap": [False, True, False, False, False, True, True],
}


def _recovery_script(mod, name):
    results = list(PROBE_SCRIPTS[name])
    calls = {"quiesce": 0, "snapshot": 0, "resume": 0, "recover": 0,
             "degrade": 0}

    def probe(_mesh):
        return results.pop(0) if results else True

    def bump(key):
        def hook(*_a):
            calls[key] += 1
        return hook
    rm = mod.RecoveryManager(
        ["mesh0"], retry_policy=mod.RetryPolicy(max_attempts=2,
                                                base_delay=0.0, jitter=0.0),
        probe=probe, quiesce=bump("quiesce"), resume=bump("resume"),
        snapshot=bump("snapshot"), on_degrade=bump("degrade"),
        on_recover=bump("recover"))
    states = [rm.tick().value for _ in range(4)]
    rm2 = mod.RecoveryManager(None, probe=lambda m: True,
                              retry_policy=mod.RetryPolicy(
                                  max_attempts=1, jitter=0.0))
    escalated = rm2.escalate("worker_lost", RuntimeError("gone")).value
    return (states, [(o.value, n.value) for o, n, _ in rm.transitions],
            calls, rm.snapshots_taken, rm.last_dead, escalated,
            [(o.value, n.value) for o, n, _ in rm2.transitions])


@pytest.mark.parametrize("name", sorted(PROBE_SCRIPTS))
def test_recovery_manager_walks_jax_states(name):
    assert _recovery_script(tfault, name) == _recovery_script(jfault, name)


def test_snapshotter_writes_a_restorable_checkpoint(tmp_path):
    from alpa_tpu_torch.serialization import restore_checkpoint
    state = {"w": torch.arange(4.0), "step": torch.tensor(7)}
    snap = tfault.make_snapshotter(str(tmp_path), lambda: state)
    rm = tfault.RecoveryManager(
        ["mesh0"], retry_policy=tfault.RetryPolicy(max_attempts=2,
                                                   base_delay=0.0),
        probe=lambda m, _r=iter([False, False, False]): next(_r, True),
        snapshot=snap)
    assert rm.tick() is tfault.MeshHealth.HEALTHY
    assert rm.snapshots_taken == 1
    restored = restore_checkpoint(str(tmp_path),
                                  {"w": torch.zeros(4), "step": torch.tensor(0)})
    assert torch.equal(restored["w"], state["w"])
    assert int(restored["step"]) == 7


# ---- the pipeshard runtime ----------------------------------------------

def _jax_hits(mode, planned=False):
    """The JAX package's 4-stage MLP step under a plan that counts every
    hit of the pipeshard sites and fires none."""
    alpa_tpu.init("local")
    jconfig.pipeline_dispatch_mode = mode
    jconfig.resharding_execution = "planned" if planned else "device_put"
    state, batch = jtesting.create_mlp_train_state_and_batch(
        batch_size=8, input_dim=8, hidden_dim=8, output_dim=8, num_layers=4,
        manual_pipeline_layer=False)
    method = alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=jlc.AutoLayerOption(layer_num=4),
        stage_option=jstage.ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(4)],
            submesh_physical_shapes=[(1, 1)] * 4))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    batch_np = {k: np.asarray(v) for k, v in batch.items()}
    step = jtesting.get_mlp_train_step(method, use_value_and_grad=True)
    state, _ = step(state, batch)
    sites = ("stage_launch", "cross_mesh_send", "cross_mesh_recv")
    with jfault.FaultPlan(*[jfault.FaultSpec(s, times=0)
                            for s in sites]) as plan:
        step(state, batch)
    alpa_tpu.shutdown()
    return {s: plan.hits(s) for s in sites}, params, batch_np


def _port_fixture(params, batch):
    state, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=8, input_dim=8, hidden_dim=8, output_dim=8, num_layers=4,
        params=params, x=batch["x"], y=batch["y"])
    method = PipeshardParallel(
        devices=["cpu"] * 4, num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=4),
        stage_option=UniformStageOption(4))
    return state, tbatch, ttesting.get_mlp_train_step(
        method, use_value_and_grad=True)


def _port_run(params, batch, mode, specs=(), planned=False, steps=3):
    """Three steps of the port's 4-stage MLP in ``mode``, the second under
    a plan of ``specs`` with a retry policy installed: (losses,
    parameters, the plan's hits and retries, executable)."""
    global_config._pipeline_dispatch_mode = mode
    global_config.resharding_execution = "planned" if planned else \
        "device_put"
    state, tbatch, step = _port_fixture(params, batch)
    losses, plan = [], None
    for i in range(steps):
        if i == 1:
            tfault.set_retry_policy(tfault.RetryPolicy(
                max_attempts=3, base_delay=0.0, jitter=0.0))
            # the outer plan counts every fire the inner one lets pass
            with tfault.FaultPlan(*[tfault.FaultSpec(s, times=0)
                                    for s in SITES]) as counter, \
                    tfault.FaultPlan(*specs) as plan:
                state, loss = step(state, tbatch)
            plan.total = {s: counter.hits(s) + plan.fired(s)
                          for s in SITES}
            prog = step.get_last_executable()._last_program
            plan.hooks = prog.last_hooks if prog is not None else ()
            tfault.set_retry_policy(None)
        else:
            state, loss = step(state, tbatch)
        losses.append(float(loss))
    return losses, state.params, plan, step.get_last_executable()


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_pipeshard_faults_are_retried_bit_identically(mode, planned):
    """Faults at ``stage_launch`` (a forward RUN and, later, a donating
    apply-grad RUN: injected, so retried), ``cross_mesh_send`` and (under
    planned execution) ``cross_mesh_recv`` are retried once each; losses
    and parameters equal the steps without faults bit for bit; each RUN
    and RESHARD hits its site once (plus its retry), as in the JAX
    package's step, whose ``cross_mesh_recv`` hits under planned
    execution are one per cross-mesh RESHARD as the port's."""
    hits, params, batch = _jax_hits("registers", planned)
    specs = [tfault.FaultSpec("stage_launch", times=1),
             tfault.FaultSpec("stage_launch", times=1, match=lambda info:
                              "apply_grad" in str(info.get("stage"))),
             tfault.FaultSpec("cross_mesh_send", times=1, after=2)]
    if planned:
        specs.append(tfault.FaultSpec("cross_mesh_recv", times=1))
    ref_losses, ref_params, _, _ = _port_run(params, batch, mode, planned=planned)
    losses, got, plan, ex = _port_run(params, batch, mode, specs, planned)
    assert losses == ref_losses
    for k, p in got.items():
        assert torch.equal(p, ref_params[k]), k
    # a RESHARD's transfer (its tile task, where cross_mesh_recv fires)
    # is retried under cross_mesh_send, as the JAX executable accounts it
    assert plan.retries == {"stage_launch": 2,
                            "cross_mesh_send": 2 if planned else 1}
    assert ex.last_dispatch_stats["mode"] == mode
    counts = ex.get_instruction_counts()
    cross = sum(i.opcode.name == "RESHARD" and i.src_mesh != i.dst_mesh
                for i in ex.instructions)
    assert plan.total == {
        "stage_launch": counts["RUN"] + 2,    # each retried RUN again
        # a transfer retried after its tile task's fault fires its
        # RESHARD's site again, but for an overlap launch, whose pool
        # worker retries the transfer alone
        "cross_mesh_send": counts["RESHARD"] + 1 + (
            planned and mode != "overlap"),
        "cross_mesh_recv": cross + 1 if planned else 0}
    assert hits["cross_mesh_recv"] == (hits["cross_mesh_send"]
                                       if planned else 0)
    if mode in ("registers", "overlap"):
        assert "fault" in plan.hooks


def test_real_error_at_a_donating_run_is_not_retried():
    """An error that is not injected (a factory raising ``RuntimeError``)
    at a donating apply-grad RUN propagates at once; at a forward RUN,
    which donates nothing, the same error is retried."""
    _, params, batch = _jax_hits("registers")
    for mode in ("registers", "sequential"):
        state, tbatch, step = _port_fixture(params, batch)
        global_config._pipeline_dispatch_mode = mode
        state, _ = step(state, tbatch)
        ex = step.get_last_executable()
        donating = {e.name for e in ex.apply_execs if e is not None and
                    getattr(e, "donate_idx", ())}
        assert donating, "the apply-grad RUNs donate the state"
        tfault.set_retry_policy(tfault.RetryPolicy(max_attempts=3,
                                                   base_delay=0.0))
        real = [tfault.FaultSpec(
            "stage_launch", times=1, exc=lambda: RuntimeError("real"),
            match=lambda info: info.get("stage") in donating)]
        with tfault.FaultPlan(*real) as plan:
            with pytest.raises(RuntimeError, match="real"):
                step(state, tbatch)
        assert plan.retries == {}
        state, tbatch, step = _port_fixture(params, batch)
        fwd = [tfault.FaultSpec("stage_launch", times=1,
                                exc=lambda: RuntimeError("real"))]
        with tfault.FaultPlan(*fwd) as plan:
            step(state, tbatch)
        assert plan.retries == {"stage_launch": 1}
        tfault.set_retry_policy(None)


def test_raw_op_list_without_a_plan(monkeypatch):
    """Nothing installed and the flight recorder off: the register-file
    replay runs its raw closures (no hook signature); with the recorder
    on the fault wrapper is not compiled in; with a plan it is."""
    _, params, batch = _jax_hits("registers")
    state, tbatch, step = _port_fixture(params, batch)
    global_config._pipeline_dispatch_mode = "registers"
    monkeypatch.setattr(global_config, "flight_recorder", False)
    state, _ = step(state, tbatch)
    prog = step.get_last_executable()._last_program
    assert not tfault.instrumented()
    assert prog._active_hook_signature() is None and prog.last_hooks == ()
    monkeypatch.setattr(global_config, "flight_recorder", True)
    if not tflight.enabled():
        pytest.skip("flight recorder switched off in this process")
    state, _ = step(state, tbatch)
    assert prog.last_hooks == ("flight",)
    with tfault.FaultPlan():
        state, _ = step(state, tbatch)
    assert prog.last_hooks == ("flight", "fault")


class _RecordingLock:
    """A lock that sets ``knocked`` when the thread named ``name`` starts a
    blocking acquire, so a test can wait until that thread stands at it.
    After ``hand_over()`` the next release by another thread waits until
    the named thread has released the lock in its turn: the waiting thread
    goes on only once the other has taken the lock and let it go."""

    def __init__(self, name):
        self._lock = threading.Lock()
        self.name = name
        self.knocked = threading.Event()
        self.released = threading.Event()
        self._hand_over = False

    def hand_over(self):
        self._hand_over = True

    def acquire(self, blocking=True, timeout=-1):
        if blocking and threading.current_thread().name == self.name:
            self.knocked.set()
        return self._lock.acquire(blocking, timeout)

    def release(self):
        self._lock.release()
        if threading.current_thread().name == self.name:
            self.released.set()
        elif self._hand_over:
            self._hand_over = False
            assert self.released.wait(60.0)

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()


class _GateHook(threading.Condition):
    """The executable's quiesce condition with a hook run on the thread
    named ``launch`` just after its gate check returned (the lock still
    held, as the launch holds it)."""

    def __init__(self, lock, hook):
        super().__init__(lock)
        self.hook = hook

    def wait_for(self, predicate, timeout=None):
        ok = super().wait_for(predicate, timeout)
        if threading.current_thread().name == "launch":
            self.hook()
        return ok


def test_quiesce_blocks_new_launches_until_resume():
    """``quiesce()`` closes the launch gate once nothing is in flight; a
    launch then waits at the gate (seen entering it) and runs only after
    ``resume()``."""
    _, params, batch = _jax_hits("registers")
    state, tbatch, step = _port_fixture(params, batch)
    state, _ = step(state, tbatch)
    ex = step.get_last_executable()
    assert ex.quiesce(timeout=60.0)
    assert not ex._gate_open and ex._inflight_launches == 0
    done, out = threading.Event(), {}
    lock = _RecordingLock("launch")
    ex._quiesce_cv = threading.Condition(lock)

    def launch():
        out["r"] = step(state, tbatch)
        done.set()
    t = threading.Thread(target=launch, name="launch", daemon=True)
    t.start()
    assert lock.knocked.wait(60.0)
    assert not done.is_set()
    ex.resume()
    t.join(60.0)
    assert done.is_set() and np.isfinite(float(out["r"][1]))


def test_quiesce_never_passes_a_launch_between_gate_and_count():
    """A quiesce that arrives just after a launch saw the gate open, before
    the launch counted itself in flight, must wait for that launch to
    finish: it may not report a quiescent point while the step is about
    to dispatch (an in-place restore would then write into the tensors the
    step reads).  The gate check and the count are one critical section,
    so the quiesce thread stands at the lock until the launch is counted,
    and returns only after the launch has dispatched and drained.  The
    launch lets the quiesce thread take the lock at its next release
    (``hand_over``): were the check and the count two sections, that
    release would fall between them."""
    _, params, batch = _jax_hits("registers")
    state, tbatch, step = _port_fixture(params, batch)
    state, _ = step(state, tbatch)
    ex = step.get_last_executable()
    order, out = [], {}

    def quiesce():
        out["q"] = ex.quiesce(timeout=60.0)
        order.append("quiesced")
    quiescer = threading.Thread(target=quiesce, name="quiesce",
                                daemon=True)
    lock = _RecordingLock("quiesce")

    def after_gate_check():
        if "gate seen open" in order:
            return
        order.append("gate seen open")
        quiescer.start()
        assert lock.knocked.wait(60.0)
        lock.hand_over()
    ex._quiesce_cv = _GateHook(lock, after_gate_check)
    counted = ex._launch_counted

    def launch_counted(*args):
        order.append("dispatch")
        try:
            return counted(*args)
        finally:
            order.append("dispatched")
    ex._launch_counted = launch_counted

    def launch():
        out["r"] = step(state, tbatch)
    t = threading.Thread(target=launch, name="launch", daemon=True)
    t.start()
    t.join(120.0)
    quiescer.join(120.0)
    assert order == ["gate seen open", "dispatch", "dispatched",
                     "quiesced"]
    assert out["q"] is True and np.isfinite(float(out["r"][1]))
    assert not ex._gate_open and ex._inflight_launches == 0
    ex.resume()
    assert ex._gate_open


def test_faults_on_replayed_cuda_graphs_never_recapture(fake_cuda_graphs):
    """The graph path on the CPU (``test_torch_dispatch``'s mocked CUDA
    calls): a 4-layer GPT with Adam, 2 stages x 4 microbatches.  After
    the warm-up and the capture, a step with one fault at ``stage_launch``
    and one at ``cross_mesh_send`` in each of "registers", "sequential"
    and "threaded" retries both on the replays, recaptures nothing, and
    its losses and parameters equal the same steps without faults bit for
    bit."""
    from test_torch_dispatch import _gpt_pipeshard_fixture
    batch, make_state, make_step = _gpt_pipeshard_fixture()
    runs = []
    for faults in (False, True):
        pstep, state = make_step(), make_state()
        ex, _ = pstep.get_executable(state, batch)
        ex._use_graphs = True
        losses, retries = [], []
        for mode in ("auto", "auto", "registers", "sequential", "threaded"):
            global_config._pipeline_dispatch_mode = mode
            if faults and len(losses) >= 2:
                tfault.set_retry_policy(tfault.RetryPolicy(
                    max_attempts=3, base_delay=0.0, jitter=0.0))
                with tfault.FaultPlan(
                        tfault.FaultSpec("stage_launch", times=1, after=3),
                        tfault.FaultSpec("cross_mesh_send", times=1)) as plan:
                    state, loss = pstep(state, batch)
                tfault.set_retry_policy(None)
                retries.append(plan.retries)
            else:
                state, loss = pstep(state, batch)
            losses.append(float(loss))
        runs.append((losses, state.params, ex, retries))
    (ref_losses, ref_params, _, _), (losses, params, ex, retries) = runs
    assert ex.capture_count == 1 and ex.recapture_count == 0
    assert retries == [{"stage_launch": 1, "cross_mesh_send": 1}] * 3
    assert losses == ref_losses
    for k, p in params.items():
        assert torch.equal(p, ref_params[k]), k
