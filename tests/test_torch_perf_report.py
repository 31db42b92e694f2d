"""The step performance report (``alpa_tpu_torch.telemetry.perf``,
``analysis.critical_path``) held to the JAX package's on the same data.

Seeded synthetic timelines and Chrome traces go through both packages'
critical-path walk, DAG re-simulation and ``report_from_trace``, which
must agree exactly.  A traced two-stage pipeshard step on the CPU gives a
report that names JAX's stages and meshes, and its calibration ingest
keys JAX's.
"""
import dataclasses

import numpy as np
import optax
import jax
import jax.numpy as jnp
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu.analysis import critical_path as jcp
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.telemetry import perf as jperf
from alpa_tpu.telemetry import trace as jtrace
from alpa_tpu_torch.analysis import critical_path as tcp
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.telemetry import calibration as tcal
from alpa_tpu_torch.telemetry import perf as tperf
from alpa_tpu_torch.telemetry import trace as ttrace

import test_torch_pipeshard as tp


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _plain(x):
    """Dataclasses of either package as plain dicts, to compare them."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _timeline(seed: int, n: int = 40, tracks: int = 3):
    """Ops on ``tracks`` meshes, each after its track's previous op and
    after up to two random earlier ops, with seeded durations."""
    rng = np.random.default_rng(seed)
    ops, preds, finish = [], [], []
    last = {}
    for i in range(n):
        track = int(rng.integers(tracks))
        dep = {int(j) for j in rng.integers(0, i, size=2)} if i else set()
        start = max([finish[j] for j in dep] +
                    [finish[last[track]] if track in last else 0.0])
        start += float(rng.uniform(0, 5))
        dur = float(rng.exponential(20.0))
        kind = ("exec", "launch", "wait")[int(rng.integers(3))]
        name = ("RUN stage_%d" % track if kind == "exec" else
                f"{kind.upper()} RESHARD {track}->{(track + 1) % tracks}")
        ops.append((i, name, kind, f"mesh {track}", start, start + dur))
        preds.append(dep)
        finish.append(start + dur)
        last[track] = i
    return ops, preds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_critical_path_and_simulation_equal_jax(seed):
    ops, preds = _timeline(seed)
    jops = [jcp.TimedOp(*o) for o in ops]
    tops = [tcp.TimedOp(*o) for o in ops]
    causal = {i: p for i, p in enumerate(preds)}
    env = max(o[5] for o in ops) - min(o[4] for o in ops)
    assert _plain(tcp.measured_critical_path(tops, causal, env)) == \
        _plain(jcp.measured_critical_path(jops, causal, env))
    assert _plain(tcp.measured_critical_path(tops)) == \
        _plain(jcp.measured_critical_path(jops))
    durs = [o[5] - o[4] for o in ops]
    assert tcp.simulate_dag(durs, preds) == jcp.simulate_dag(durs, preds)
    assert tcp.longest_path(durs, preds) == jcp.longest_path(durs, preds)
    zeroed = {i for i, o in enumerate(ops) if o[2] != "exec"}
    assert tcp.whatif(durs, preds, zeroed) == \
        jcp.whatif(durs, preds, zeroed)
    mem = dict(writes=[(i % 8,) for i in range(len(ops))],
               kills=[((i - 3) % 8,) if i > 3 else () for i in
                      range(len(ops))],
               nbytes={i: 10.0 * (i + 1) for i in range(8)},
               mesh_of={i: i % 3 for i in range(8)}, num_meshes=3)
    assert tcp.simulate_dag(durs, preds, tcp.MemSpec(**mem)) == \
        jcp.simulate_dag(durs, preds, jcp.MemSpec(**mem))


def _chrome_trace(seed: int):
    """A recorder's Chrome trace of one seeded step: the step span, op
    spans on mesh tracks and pool-side transfer spans."""
    ops, _ = _timeline(seed, n=30)
    rec = jtrace.TraceRecorder()
    t0 = min(o[4] for o in ops) - 1.0
    t1 = max(o[5] for o in ops) + 1.0
    rec.complete("pipeshard.step", "runtime", t0, t1 - t0, None, "driver")
    rng = np.random.default_rng(seed + 100)
    for _, name, kind, track, a, b in ops:
        cat = "instruction" if kind == "exec" else "transfer"
        rec.complete(name, cat, a, b - a, None, track)
        if kind == "launch":
            w = float(rng.uniform(0, 3))
            pool = "alpa-overlap_0"
            rec.complete(name[len("LAUNCH "):], "transfer", a, b - a + w,
                         None, pool)
            rec.complete("reshard.wait", "transfer", a, w, None, pool)
            rec.complete("reshard.wire", "transfer", a + w, b - a, None,
                         pool)
    return rec.to_chrome_trace()


@pytest.mark.parametrize("seed", [0, 3])
def test_report_from_trace_equal_jax(seed):
    trace = _chrome_trace(seed)
    theirs = jperf.report_from_trace(trace, peak_tflops=100.0)
    ours = tperf.report_from_trace(trace, peak_tflops=100.0)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.format_text() == theirs.format_text()
    for zero in ("reshard", "run"):
        assert ours.whatif(zero) == theirs.whatif(zero)
    assert tperf.spans_from_chrome(trace) == jperf.spans_from_chrome(trace)


def test_mfu_formula_and_peak_knob(monkeypatch):
    assert tperf.mfu_from_time(2e12, 1.0, 2, peak_tflops=10.0) == \
        jperf.mfu_from_time(2e12, 1.0, 2, peak_tflops=10.0) == 0.1
    monkeypatch.setattr(tconfig, "device_peak_tflops", 123.0)
    assert tperf.device_peak_tflops() == 123.0
    monkeypatch.setattr(tconfig, "device_peak_tflops", 0.0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert tperf.peak_flops_info() == {
        "generation": "h100-sxm",
        "peak_bf16_tflops": tperf.GPU_SPECS["h100-sxm"]["peak_bf16_tflops"]}


def test_traced_step_report_names_jax_stages_and_meshes(monkeypatch):
    """The same two-stage MLP step traced in both packages ("registers"
    dispatch): the reports name the same stages and meshes and run the
    same ops per stage; the port's report is joined to its program's
    dataflow graph, its critical path within the step envelope; its
    ingest into a calibration store keys JAX's signatures."""
    monkeypatch.setattr(jconfig, "pipeline_dispatch_mode", "registers")
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", "registers")
    monkeypatch.setattr(tconfig, "device_peak_tflops", 1.0)
    monkeypatch.setattr(jconfig, "device_peak_tflops", 1.0)
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = tp._mlp_pair(2, optax.sgd(1e-2),
                                           tmu.sgd(1e-2))
    jstep = alpa_tpu.parallelize(tp._jax_step,
                                 method=tp._jax_method(2, 2, "1f1b"))
    tstep = alpa_tpu_torch.parallelize(tp._port_step,
                                       method=tp._port_method(2, 2, "1f1b"))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    j_state, _ = jstep(j_state, jb)
    t_state, _ = tstep(t_state, batch)
    reports = []
    for step, state, b, mod in ((jstep, j_state, jb, jtrace),
                                (tstep, t_state, batch, ttrace)):
        old = mod.set_recorder(mod.TraceRecorder())
        prev = mod.set_enabled(True)
        try:
            step(state, b)
            reports.append(step.get_last_executable().get_perf_report())
        finally:
            mod.set_enabled(prev)
            mod.set_recorder(old)
    theirs, ours = reports
    assert sorted(ours.stages) == sorted(theirs.stages)
    assert sorted(ours.bubbles) == sorted(theirs.bubbles) == \
        ["mesh 0", "mesh 1"]
    assert {k: s.n_runs for k, s in ours.stages.items()} == \
        {k: s.n_runs for k, s in theirs.stages.items()}
    assert ours.aligned and ours.source == "trace"
    assert ours.critical_path.total_us <= ours.envelope_us + 1e-6
    assert all(s.flops_per_run > 0 and s.mfu > 0
               for s in ours.stages.values())
    assert "stage MFU" in ours.format_text()
    store = tcal.CalibrationStore()
    joined = tstep.get_last_executable()._last_joined_step
    got = tcal.ingest_joined(joined, store=store)
    # "registers" dispatch has no transfer waits, so only stage samples
    assert set(got) == {tcal.stage_signature(k) for k in ours.stages}
    assert got == {tcal.stage_signature(k): s.n_runs
                   for k, s in ours.stages.items()}


def test_flight_fallback_when_tracing_off(monkeypatch):
    """Tracing off: the report joins the last step from the flight ring,
    in op order against the program's hooks."""
    from alpa_tpu_torch.telemetry import flight as tflight
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", "registers")
    old_rec = ttrace.set_recorder(ttrace.TraceRecorder())
    old_ring = tflight.set_recorder(tflight.FlightRecorder(1024))
    try:
        _, t_state, batch = tp._mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
        tstep = alpa_tpu_torch.parallelize(
            tp._port_step, method=tp._port_method(2, 2, "1f1b"))
        tp._run(tstep, t_state, batch, steps=2)
        ex = tstep.get_last_executable()
        report = ex.get_perf_report()
    finally:
        ttrace.set_recorder(old_rec)
        tflight.set_recorder(old_ring)
    assert report.source == "flight" and report.aligned
    assert report.n_ops == len(ex._last_program.ops)
    assert ex.get_plan_fingerprint() == ex.get_plan_fingerprint()


class _HostClock:
    """A stand-in for the driver's ``_DeviceClock`` on the CPU: the same
    interface, each op's span read on the host clock."""

    def __init__(self, op_devices, baked=False):
        del op_devices, baked
        self.pending = []

    def wrap(self, op, k, name, cat, track):
        def timed(regs, _op=op):
            t0 = ttrace.now_us()
            _op(regs)
            self.pending.append((k, name, cat, track, t0, ttrace.now_us()))
        return timed

    @staticmethod
    def anchor(devices):
        del devices
        return {}

    def spans(self, anchors):
        del anchors
        out = [(k, name, cat, track, t0, t1 - t0, t1 - t0) for
               k, name, cat, track, t0, t1 in sorted(self.pending)]
        self.pending.clear()
        return out


def test_device_clocked_report_needs_a_traced_step(monkeypatch):
    """Where ops are timed on the device clock (CUDA; a stand-in clock
    here), only a traced step gives a report: an untraced step gives none
    although the flight ring holds it, a traced one feeds the calibration
    store once however often it is read, and an untraced step after it
    gives none again and leaves the store as it was."""
    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    from alpa_tpu_torch.telemetry import flight as tflight
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", "registers")
    monkeypatch.setattr(tconfig, "device_peak_tflops", 1.0)
    monkeypatch.setattr(pe, "_DeviceClock", _HostClock)
    monkeypatch.setattr(pe.PipeshardDriverExecutable, "_device_timed",
                        lambda self: True)
    store = tcal.CalibrationStore()
    tcal.reset_calibration_store(store)
    old_rec = ttrace.set_recorder(ttrace.TraceRecorder())
    old_ring = tflight.set_recorder(tflight.FlightRecorder(1024))

    def entries():
        return [e.to_json() for e in store.entries()]

    try:
        _, t_state, batch = tp._mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
        tstep = alpa_tpu_torch.parallelize(
            tp._port_step, method=tp._port_method(2, 2, "1f1b"))
        t_state, _ = tstep(t_state, batch)
        ex = tstep.get_last_executable()
        assert len(tflight.get_recorder().snapshot()) > 0
        assert ex.get_perf_report() is None and len(store) == 0
        prev = ttrace.set_enabled(True)
        try:
            t_state, _ = tstep(t_state, batch)
        finally:
            ttrace.set_enabled(prev)
        report = ex.get_perf_report()
        assert report.source == "trace" and report.aligned
        assert report.n_ops == len(ex._last_program.ops)
        after_traced = entries()
        assert after_traced
        assert ex.get_perf_report() is not None
        assert entries() == after_traced
        t_state, _ = tstep(t_state, batch)
        assert ex.get_perf_report() is None
        assert "not traced" in ex.get_perf_report_text()
        assert entries() == after_traced
    finally:
        ttrace.set_recorder(old_rec)
        tflight.set_recorder(old_ring)
        tcal.reset_calibration_store()


def test_consider_replan_suggests_and_refuses_auto(monkeypatch):
    """``replan_mode``: "off" gives None, "suggest" a verdict that applies
    nothing, "auto" raises (the port's strategy chooser does not read the
    calibration store)."""
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", "registers")
    tcal.reset_calibration_store(tcal.CalibrationStore())
    old_rec = ttrace.set_recorder(ttrace.TraceRecorder())
    prev = ttrace.set_enabled(True)
    try:
        _, t_state, batch = tp._mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
        tstep = alpa_tpu_torch.parallelize(
            tp._port_step, method=tp._port_method(2, 2, "1f1b"))
        tp._run(tstep, t_state, batch, steps=2)
        ex = tstep.get_last_executable()
        report = ex.get_perf_report()
        monkeypatch.setattr(tconfig, "replan_mode", "off")
        assert ex.consider_replan(report) is None
        monkeypatch.setattr(tconfig, "replan_mode", "suggest")
        verdict = ex.consider_replan(report)
        assert verdict["mode"] == "suggest" and not verdict["applied"]
        assert verdict["predicted_critical_path_us"] > 0
        monkeypatch.setattr(tconfig, "replan_mode", "auto")
        with pytest.raises(NotImplementedError, match="ROADMAP A.6"):
            ex.consider_replan(report)
    finally:
        ttrace.set_enabled(prev)
        ttrace.set_recorder(old_rec)
        tcal.reset_calibration_store()
