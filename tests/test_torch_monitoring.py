"""The port's monitoring (``alpa_tpu_torch/monitoring.py``) against the
JAX package's.

``check_alive`` probes CPU devices; a probe that hangs is classed dead
under a patched timeout (as is ``WedgeDetector``'s ``wedged``); a probe
fault is ridden out by the probe retry policy as in JAX.
``FailureWatchdog`` drives a ``RecoveryManager`` through JAX's states
from its own thread.  ``dump_debug_info`` writes the JAX package's file
names for a pipeshard executable (perf report, calibration, flight dump,
resharding, counters), and the counter reports read as JAX's for the
same counts.  Files go under ``tmp_path``.
"""
import os
import threading

import jax
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import fault as jfault
from alpa_tpu import monitoring as jmon
from alpa_tpu.checkpoint import metrics as jmetrics
from alpa_tpu_torch import fault as tfault
from alpa_tpu_torch import monitoring as tmon
from alpa_tpu_torch.checkpoint import metrics as tmetrics
from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
from alpa_tpu_torch.global_env import global_config

_UNHANG = threading.Event()


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setattr(global_config, "flight_dump_dir", str(tmp_path))
    for mod in (jfault, tfault):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    _UNHANG.clear()
    with torch.random.fork_rng():
        yield
    _UNHANG.set()
    for mod in (jfault, tfault):
        mod.set_retry_policy(None)
        for site in list(mod._SITE_POLICIES):
            mod.set_retry_policy(None, site=site)
        mod.retry_stats.clear()
    tmetrics.reset()
    jmetrics.reset()
    alpa_tpu_torch.shutdown()


class _JaxMesh:
    def __init__(self):
        self.flat_devices = [jax.devices("cpu")[0]]


def _alive_script(mod, mon, mesh):
    """check_alive: healthy; a probe fault with no retry; the same fault
    ridden out by a retry policy; a fault on every attempt."""
    out = [mon.check_alive(mesh, timeout=30.0)]
    with mod.FaultPlan(mod.FaultSpec("probe", times=1)):
        out.append(mon.check_alive(mesh, timeout=30.0))
    pol = mod.RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
    with mod.FaultPlan(mod.FaultSpec("probe", times=1)) as plan:
        out.append(mon.check_alive(mesh, timeout=30.0, retry_policy=pol))
    out.append(plan.retries)
    with mod.FaultPlan(mod.FaultSpec("probe", times=-1)):
        out.append(mon.check_alive(mesh, timeout=30.0, retry_policy=pol))
    out.append(mon.check_mesh_group_alive([mesh, mesh], timeout=30.0))
    return out


def test_check_alive_as_jax_on_cpu_devices():
    mesh = PhysicalDeviceMesh(["cpu"] * 2)
    got = _alive_script(tfault, tmon, mesh)
    assert got == _alive_script(jfault, jmon, _JaxMesh())
    assert got[0] is True and got[1] is False and got[2] is True
    assert tmon.probe_devices(tmon.mesh_devices(mesh)) is True
    assert tmon.mesh_devices("cpu") == [torch.device("cpu")]


def test_hung_probe_is_dead_and_wedged_under_a_patched_timeout(monkeypatch):
    """A probe program that never finishes: ``check_alive`` gives False
    within its (patched) timeout, ``WedgeDetector`` classes the mesh
    ``wedged`` through its default probe."""
    from alpa_tpu_torch.elastic import WedgeDetector

    def hang(devices, timeout=None):
        _UNHANG.wait()
        return True
    monkeypatch.setattr(tmon, "probe_devices", hang)
    mesh = PhysicalDeviceMesh(["cpu"])
    assert tmon.check_alive(mesh, timeout=0.01) is False
    det = WedgeDetector(mesh_group=[mesh], probe_timeout_s=0.01)
    assert det.check() == {0: "wedged"} and not det.healthy()
    monkeypatch.setattr(tmon, "probe_devices",
                        lambda devices, timeout=None: True)
    assert WedgeDetector(mesh_group=[mesh, mesh],
                         probe_timeout_s=30.0).check() == {0: "ok",
                                                            1: "ok"}


def _watchdog_walk(mod, mon, mesh):
    """A watchdog over one mesh whose probe fails until released: it
    reaches DEGRADED from its thread, ``on_failure`` sees mesh 0, and a
    clean round brings it back to HEALTHY.  Waits on events, not on a
    clock."""
    states, reached = [], {}
    for name in ("degraded", "healthy"):
        reached[name] = threading.Event()

    def on_change(old, new):
        states.append((old.value, new.value))
        if new.value in reached:
            reached[new.value].set()
    rm = mod.RecoveryManager(
        None, retry_policy=mod.RetryPolicy(max_attempts=2, base_delay=0.0,
                                           jitter=0.0),
        on_state_change=on_change)
    wd = mon.FailureWatchdog([mesh], interval=0.001, recovery=rm,
                             probe_timeout=30.0)
    failures = []
    wd.on_failure = lambda dead: failures.append(list(dead))
    with mod.FaultPlan(mod.FaultSpec("probe", times=-1)):
        wd.start()
        assert reached["degraded"].wait(120)
    assert reached["healthy"].wait(120)
    wd.stop()
    wd._thread.join(120)
    return states[:4], failures[0], wd.state.value


def test_failure_watchdog_drives_recovery_as_jax():
    got = _watchdog_walk(tfault, tmon, PhysicalDeviceMesh(["cpu"]))
    assert got == _watchdog_walk(jfault, jmon, _JaxMesh())
    assert got[0][:3] == [("healthy", "suspect"), ("suspect", "recovering"),
                          ("recovering", "degraded")]


def test_dump_debug_info_writes_jax_file_names(tmp_path, monkeypatch):
    """A traced step of the port's 2-stage pipeshard MLP, then
    ``dump_debug_info``: its files carry JAX's names for the same
    reports, among them the step's perf report, calibration, flight
    dump, resharding, checkpoint, compile-cache, overlap and metrics."""
    from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                                UniformStageOption)
    from alpa_tpu_torch import testing as ttesting
    monkeypatch.setattr(global_config, "collect_trace", True)
    state, batch = ttesting.create_mlp_train_state_and_batch(
        batch_size=8, num_layers=4, manual_pipeline_layer=True)
    step = ttesting.get_mlp_train_step(PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=ManualLayerOption(),
        stage_option=UniformStageOption(2)), use_value_and_grad=True)
    for _ in range(2):
        state, _ = step(state, batch)
    tmetrics.incr("saves")
    tmon.dump_debug_info(step.get_last_executable(),
                         str(tmp_path / "port"))
    names = set(os.listdir(tmp_path / "port"))
    required = {"schedule.txt", "instructions.txt", "resharding.txt",
                "perf_report.txt", "resharding_plan.txt", "calibration.txt",
                "compile_cache.txt", "checkpoint.txt", "overlap.txt",
                "metrics.txt", "flight.json"}
    assert required <= names
    # JAX's dump of its own pipeshard executable names every one of them
    alpa_tpu.init("local")
    from alpa_tpu import testing as jtesting
    from alpa_tpu.pipeline_parallel.layer_construction import \
        ManualLayerOption as JML
    from alpa_tpu.pipeline_parallel.stage_construction import \
        UniformStageOption as JUS
    from alpa_tpu.global_env import global_config as jconfig
    monkeypatch.setattr(jconfig, "collect_trace", True)
    monkeypatch.setattr(jconfig, "flight_dump_dir", str(tmp_path))
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=8, num_layers=4, manual_pipeline_layer=True)
    jstep = jtesting.get_mlp_train_step(alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=JML(),
        stage_option=JUS(num_stages=2)), use_value_and_grad=True)
    for _ in range(2):
        jstate, _ = jstep(jstate, jbatch)
    jmon.dump_debug_info(jstep.get_last_executable(), str(tmp_path / "jax"))
    alpa_tpu.shutdown()
    assert names <= set(os.listdir(tmp_path / "jax"))
    report = (tmp_path / "port" / "perf_report.txt").read_text()
    assert "critical path" in report.lower()
    assert "saves" in (tmp_path / "port" / "checkpoint.txt").read_text()


def test_counter_reports_as_jax():
    """The checkpoint report of the same counts reads as JAX's; the
    overlap and compile-cache reports have JAX's lines."""
    for m in (tmetrics, jmetrics):
        m.incr("saves", 2)
        m.incr("bytes_written", 4096)
        m.incr("restore_seconds", 0.25)
    assert tmon.format_checkpoint_report() == jmon.format_checkpoint_report()
    assert tmon.get_checkpoint_stats() == jmon.get_checkpoint_stats()
    tm_lines = tmon.format_overlap_report().splitlines()
    assert tm_lines[0] == "overlap dispatch (runtime):"
    assert set(tmon.get_overlap_stats()["runtime"]) == set(
        jmon.get_overlap_stats()["runtime"])
    assert set(tmon.get_overlap_stats()["planner"]) == set(
        jmon.get_overlap_stats()["planner"])
    assert tmon.format_compile_cache_report().startswith(
        "compile cache dir: ")
