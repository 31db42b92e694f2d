"""The port's elastic supervisor (``alpa_tpu_torch/elastic.py``) against
the JAX package's, after ``tests/runtime/test_elastic.py`` and
``test_elastic_fuzz.py``.

Both supervisors drive their package's 2-stage pipeshard MLP (JAX on the
test process's virtual CPU devices, the port on the CPU named as often) under
the same injection script: a worker loss re-solved for the surviving
half, a preemption inside its grace window, a wedge after a failing
step, a raising step, the escalation of a watchdog, and a few seeds of
the kill-schedule fuzz.  Each episode reports JAX's phases (quiesce,
snapshot, re-solve, restore, replay distance, budgets) and moves the same
``alpa_elastic_*`` counters; every committed loss equals the port's own
uninterrupted run bit for bit (and JAX's at fp32 tolerance).  The
ZeRO-2 degree change 4 -> 2 resumes bit for bit through
``read_leaf_slice``.  A wedged probe is classed under a patched
timeout.  Checkpoints go under ``tmp_path``.
"""
import random
import threading

import jax
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.checkpoint.manager import CheckpointManager as JManager
from alpa_tpu.telemetry import flight as jflight
from alpa_tpu.telemetry import metrics as jm
from alpa_tpu import elastic as jelastic
from alpa_tpu import fault as jfault
from alpa_tpu.checkpoint import metrics as jmetrics
from alpa_tpu.device_mesh import VirtualPhysicalMesh
from alpa_tpu.pipeline_parallel.layer_construction import \
    ManualLayerOption as JManualLayerOption
from alpa_tpu.pipeline_parallel.stage_construction import \
    UniformStageOption as JUniformStageOption
from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                            UniformStageOption, Zero2Parallel)
from alpa_tpu_torch import elastic as telastic
from alpa_tpu_torch import fault as tfault
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.checkpoint import CheckpointManager
from alpa_tpu_torch.checkpoint import metrics as tmetrics
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.telemetry import flight as tflight
from alpa_tpu_torch.telemetry import metrics as tm

ELASTIC_FAMILIES = ("alpa_elastic_episodes_total",
                    "alpa_elastic_snapshots_total",
                    "alpa_elastic_replans_total",
                    "alpa_elastic_budget_violations_total")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setattr(global_config, "flight_dump_dir", str(tmp_path))
    from alpa_tpu.global_env import global_config as jconfig
    monkeypatch.setattr(jconfig, "flight_dump_dir", str(tmp_path))
    with torch.random.fork_rng():
        yield
    for mod, el in ((tfault, telastic), (jfault, jelastic)):
        mod.set_escalation_manager(None)
        el._ACTIVE = None
    tmetrics.reset()
    jmetrics.reset()
    # an episode annotates its package's flight dumps process-wide
    tflight.clear_annotations()
    jflight.clear_annotations()
    alpa_tpu_torch.shutdown()
    alpa_tpu.shutdown()


# ---- the two packages' fixtures -------------------------------------------

def _jax_side():
    alpa_tpu.init(cluster="local")
    cache = {}

    def solve(devices):
        key = tuple(id(d) for d in devices)
        if key not in cache:
            n = len(devices)
            vm = VirtualPhysicalMesh(
                1, n, np.array(list(devices), dtype=object).reshape(1, n))
            method = alpa_tpu.PipeshardParallel(
                devices=vm, num_micro_batches=2,
                layer_option=JManualLayerOption(),
                stage_option=JUniformStageOption(num_stages=2))
            cache[key] = jtesting.get_mlp_train_step(
                method, use_value_and_grad=True)
        return cache[key]

    def fresh():
        return jtesting.create_mlp_train_state_and_batch(
            batch_size=64, num_layers=4, manual_pipeline_layer=True)
    return solve, fresh, list(jax.devices()), jfault, jelastic


def _port_side():
    cache = {}

    def solve(devices):
        key = tuple(str(d) for d in devices)
        if key not in cache:
            method = PipeshardParallel(
                devices=list(devices), num_micro_batches=2,
                layer_option=ManualLayerOption(),
                stage_option=UniformStageOption(num_stages=2))
            cache[key] = ttesting.get_mlp_train_step(
                method, use_value_and_grad=True)
        return cache[key]

    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=64, num_layers=4, manual_pipeline_layer=True)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    batch = {k: np.asarray(v) for k, v in jbatch.items()}

    def fresh():
        return ttesting.create_mlp_train_state_and_batch(
            batch_size=64, num_layers=4, manual_pipeline_layer=True,
            params=params, x=batch["x"], y=batch["y"])
    return solve, fresh, ["cpu"] * 8, tfault, telastic


# a probe that never answers until the test's end: the abandoned probe
# thread must finish before the interpreter can exit
_UNHANG = threading.Event()


def _hung_probe(_mesh):
    _UNHANG.wait()
    return True


@pytest.fixture(autouse=True)
def _release_hung_probes():
    _UNHANG.clear()
    yield
    _UNHANG.set()


def _family_values(registry):
    out = {}
    for name in ELASTIC_FAMILIES:
        fam = registry.get_registry()._families.get(name)
        if fam is not None:
            out[name] = {k: c.value for k, c in fam.children()}
    return out


def _run(side, script, tmp, until, wedge=False):
    """One supervised run of ``side`` under ``script(mod, elastic,
    devices)`` (the FaultSpecs to inject): (losses by committed step,
    episodes, baseline losses of the same plan, survivors)."""
    solve, fresh, devices, mod, el = side()
    state, batch = fresh()
    det = None
    if wedge:
        det = el.WedgeDetector(mesh_group=["m0"], probe=_hung_probe,
                               probe_timeout_s=0.01)
    sup = el.ElasticSupervisor(solve, state, checkpoint_root=str(tmp),
                               devices=devices, wedge_detector=det)
    specs, survivors = script(mod, el, devices)
    losses = {}
    with mod.FaultPlan(*specs):
        for _ in range(40):
            if sup.step_index >= until:
                break
            loss = sup.step(batch)
            losses[sup.step_index] = np.asarray(loss)
    base_state, _ = fresh()
    base_step = solve(survivors or devices)
    if survivors:
        r = sup.episodes[0]["restored_step"]
        mgr_cls = CheckpointManager if mod is tfault else JManager
        base_state = mgr_cls(str(tmp), async_save=False).restore(
            base_state, step=r)
        start = r + 1
    else:
        start = 1
    base = {}
    for i in range(start, until + 1):
        base_state, bl = base_step(base_state, batch)
        base[i] = np.asarray(bl)
    return losses, sup, base, el.status_report()


def _ep_view(ep):
    """An episode report without its host-clock seconds and error text
    (which names each package's own stages); the port's extra
    ``verdict`` field checked apart."""
    skip = {"seconds", "snapshot_seconds", "error", "verdict"}
    view = {k: v for k, v in ep.items() if k not in skip}
    view["error"] = (ep.get("error") or "").split(":")[0]
    return view


SCRIPTS = {
    # a worker loss at the third step boundary, re-solved for half
    "worker_lost": (5, False, lambda mod, el, devices: (
        [mod.FaultSpec("worker_lost", after=2,
                       exc=lambda: el.WorkerLost(survivors=devices[:4]))],
        devices[:4])),
    # a preemption notice inside its grace window, then a failing RUN
    # classed a wedge by the hung probe
    "preempt_then_wedge": (4, True, lambda mod, el, devices: (
        [mod.FaultSpec("preemption_notice", after=1,
                       exc=lambda: el.PreemptionNotice(grace_s=30.0)),
         mod.FaultSpec("stage_launch", times=1, after=20)], None)),
    # a raising step with no wedge detector: a step_failure episode
    "step_failure": (3, False, lambda mod, el, devices: (
        [mod.FaultSpec("stage_launch", times=1, after=9)], None)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_episodes_as_jax_and_resume_bitwise(tmp_path, name):
    until, wedge, script = SCRIPTS[name]
    results = {}
    for label, side in (("jax", _jax_side), ("port", _port_side)):
        reg = tm if label == "port" else jm
        before = _family_values(reg)
        losses, sup, base, report = _run(side, script, tmp_path / label,
                                         until, wedge)
        after = _family_values(reg)
        delta = {f: {k: v - before.get(f, {}).get(k, 0.0)
                     for k, v in vals.items()
                     if v != before.get(f, {}).get(k, 0.0)}
                 for f, vals in after.items()}
        results[label] = (losses, sup, base, report, delta)
    (jl, jsup, _, jrep, jdelta), (tl, tsup, tbase, trep, tdelta) = (
        results["jax"], results["port"])
    assert [_ep_view(e) for e in tsup.episodes] == \
        [_ep_view(e) for e in jsup.episodes]
    # the pipeshard plan gate reads a real verdict (the plan analyses)
    assert all(e["verdict"] == "checked" for e in tsup.episodes)
    assert tdelta == jdelta
    assert trep["episodes"] == jrep["episodes"] and \
        trep["devices"] == jrep["devices"] and not trep["recovering"]
    assert sorted(tl) == sorted(jl)
    for i, loss in tbase.items():
        assert np.array_equal(tl[i], loss), (name, i)
        np.testing.assert_allclose(tl[i], jl[i], rtol=1e-5)


def test_escalation_queues_an_episode_as_jax(tmp_path):
    """Retry exhaustion at an elastic site escalates into the installed
    supervisor (a typed ServiceDegradedError to the caller) and runs a
    worker_lost episode at the next boundary, the plan reused."""
    eps = {}
    for label, side in (("jax", _jax_side), ("port", _port_side)):
        solve, fresh, devices, mod, el = side()
        state, batch = fresh()
        sup = el.ElasticSupervisor(solve, state,
                                   checkpoint_root=str(tmp_path / label),
                                   devices=devices)
        assert mod.get_escalation_manager() is sup
        sup.step(batch)
        with mod.FaultPlan(mod.FaultSpec("worker_lost", times=-1)):
            with pytest.raises(mod.ServiceDegradedError):
                mod.call_with_retry(lambda: mod.fire("worker_lost"),
                                    policy=mod.RetryPolicy(max_attempts=2,
                                                           base_delay=0.0),
                                    site="worker_lost")
        sup.step(batch)
        eps[label] = [_ep_view(e) for e in sup.episodes]
        mod.set_escalation_manager(None)
    assert eps["port"] == eps["jax"]
    assert [e["reason"] for e in eps["port"]] == ["worker_lost"]
    assert eps["port"][0]["replan"] == "reused"


@pytest.mark.parametrize("seed", range(4))
def test_kill_schedule_fuzz_resumes_bitwise(tmp_path, seed):
    """``test_elastic_fuzz.py``'s schedules on the port (a few seeds):
    one kill or preemption at a random boundary, or a failing RUN at a
    random instruction; one episode within the step budget, the plan
    reused, every committed loss equal to the uninterrupted run."""
    solve, fresh, devices, mod, el = _port_side()
    state, batch = fresh()
    base_step = solve(devices)
    base = []
    for _ in range(4):
        state, loss = base_step(state, batch)
        base.append(np.asarray(loss))
    rng = random.Random(seed)
    kind = rng.choice(["kill_boundary", "preempt_boundary",
                       "kill_instruction"])
    if kind == "kill_boundary":
        spec = mod.FaultSpec("worker_lost", times=1, after=rng.randrange(4),
                             exc=lambda: el.WorkerLost())
    elif kind == "preempt_boundary":
        spec = mod.FaultSpec("preemption_notice", times=1,
                             after=rng.randrange(4),
                             exc=lambda: el.PreemptionNotice(grace_s=30.0))
    else:
        spec = mod.FaultSpec("stage_launch", times=1,
                             after=rng.randrange(24))
    state, _ = fresh()
    sup = el.ElasticSupervisor(solve, state,
                               checkpoint_root=str(tmp_path / "s"),
                               devices=devices, register_globally=False)
    losses = {}
    with mod.FaultPlan(spec) as plan:
        for _ in range(40):
            if sup.step_index >= 4:
                break
            loss = sup.step(batch)
            losses[sup.step_index] = np.asarray(loss)
    assert plan.fired(spec.site) == 1
    assert len(sup.episodes) == 1
    ep = sup.episodes[0]
    assert ep["within_step_budget"] and ep["replan"] == "reused"
    if kind == "kill_instruction":
        assert ep["mid_step"] is True and ep["snapshot"] == "skipped"
    for i in range(1, 5):
        assert np.array_equal(losses[i], base[i - 1]), (seed, kind, i)


def _gather(params):
    return {k: (v.gather("cpu") if isinstance(v, DistributedArray) else v)
            for k, v in params.items()}


def test_zero2_degree_change_resumes_bitwise(tmp_path):
    """``test_fuzz_includes_dp4_to_dp2_rescale`` on the port: ZeRO-2 at
    degree 4 on CPU devices, a worker lost down to degree 2; the episode
    accepts the new plan, restores the state into its layout (each block
    through ``read_leaf_slice``) and every later loss equals a direct
    restore of the same step at degree 2."""
    cache = {}

    def solve(devices):
        key = len(devices)
        if key not in cache:
            cache[key] = ttesting.get_mlp_train_step(
                Zero2Parallel(devices=list(devices)),
                use_value_and_grad=True)
        return cache[key]

    state, batch = ttesting.create_mlp_train_state_and_batch(
        16, hidden_dim=64)
    devices = ["cpu"] * 4
    sup = telastic.ElasticSupervisor(solve, state,
                                     checkpoint_root=str(tmp_path),
                                     devices=devices,
                                     register_globally=False)
    with tfault.FaultPlan(tfault.FaultSpec(
            "worker_lost", times=1, after=2,
            exc=lambda: telastic.WorkerLost(survivors=devices[:2]))):
        losses = {}
        for _ in range(40):
            if sup.step_index >= 5:
                break
            loss = sup.step(batch)
            losses[sup.step_index] = np.asarray(loss)
    ep = sup.episodes[0]
    assert ep["replan"] == "accepted" and ep["verdict"] == "unavailable"
    assert ep["devices_before"] == 4 and ep["devices_after"] == 2
    r = ep["restored_step"]
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    c_state, _ = ttesting.create_mlp_train_state_and_batch(16, hidden_dim=64)
    c_state = mgr.restore(c_state, step=r)
    c_step = solve(devices[:2])
    for i in range(r + 1, 6):
        c_state, c_loss = c_step(c_state, batch)
        assert np.array_equal(losses[i], np.asarray(c_loss)), i


def test_wedge_detector_classes_as_jax():
    """ok / wedged (a probe that never returns, under a patched timeout)
    / dead (a probe that raises or answers falsy), and the sweep stops at
    the first wedge, in both packages."""
    def classes(el):
        det = el.WedgeDetector(probe_timeout_s=0.01)
        out = []
        for probe in (lambda m: True, _hung_probe, lambda m: 1 / 0,
                      lambda m: False):
            det._probe = probe
            out.append(det.probe_one("m"))
        probed = []

        def sweep_probe(m):
            probed.append(m)
            if m == "m1":
                _UNHANG.wait()
            return True
        det = el.WedgeDetector(mesh_group=["m0", "m1", "m2"],
                               probe=sweep_probe, probe_timeout_s=0.01)
        return out, det.check(), list(probed)
    assert classes(telastic) == classes(jelastic)
    assert classes(telastic)[0] == ["ok", "wedged", "dead", "dead"]
