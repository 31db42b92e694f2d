"""The port's measurement layer (``alpa_tpu_torch.telemetry``, ``timer``)
held to the JAX package's modules on the same operations.

Both packages' clocks are patched to one shared counter, so the same
sequence of calls gives the same timestamps in each: the Prometheus text
of the same family operations is byte-equal, the Chrome trace of the same
span sequence (from one thread or two) is equal, the flight dump of the
same events is equal and ``auto_dump`` de-duplicates alike.  A traced
CPU pipeshard step records one span per replayed op under JAX's names
and ``"mesh N"`` tracks, and the step is bit-identical with the hooks on
and off.
"""
import itertools
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import timer as jtimer
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.telemetry import flight as jflight
from alpa_tpu.telemetry import metrics as jmetrics
from alpa_tpu.telemetry import trace as jtrace
from alpa_tpu_torch import timer as ttimer
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.telemetry import flight as tflight
from alpa_tpu_torch.telemetry import metrics as tmetrics
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


class _Clock:
    """A counter stepping 1.5 us per read; ``restart()`` before each
    package's run of a sequence."""

    def __init__(self):
        self.restart()

    def restart(self):
        self._ticks = itertools.count()

    def __call__(self):
        return next(self._ticks) * 1.5


@pytest.fixture
def one_clock(monkeypatch):
    """Both packages' trace and flight clocks read one ``_Clock``."""
    clock = _Clock()
    for mod in (jtrace, ttrace, jflight, tflight):
        monkeypatch.setattr(mod, "_now_us", clock)
    return clock


def _family_ops(reg):
    """The same family operations on a registry of either package."""
    c = reg.counter("alpa_test_requests_total", "Requests by outcome",
                    labelnames=("outcome",))
    c.labels("ok").inc()
    c.labels("ok").inc(2.5)
    c.labels('we"ird\\').inc()
    g = reg.gauge("alpa_test_depth", "Queue depth")
    g.set(3)
    g.set_max(2)
    g.inc(0.25)
    h = reg.histogram("alpa_test_seconds", "Latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.05, 200):
        h.observe(float(v))
    lh = reg.histogram("alpa_test_sizes", "Sizes", labelnames=("kind",),
                       buckets=(1, 2, 4, 8))
    for i in range(20):
        lh.labels("a" if i % 3 else "b").observe(i % 9)
    collected = reg.gauge("alpa_test_collections", "Collector runs")

    def collect(_reg):
        collected.inc()

    reg.register_collector(collect)
    return h


def test_prometheus_text_and_percentiles_equal_jax():
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jh, th = _family_ops(jreg), _family_ops(treg)
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()
    for p in (50, 90, 99):
        assert th.percentile(p) == jh.percentile(p)
    assert th.summary() == jh.summary()
    jreg.reset("alpa_test_depth")
    treg.reset("alpa_test_depth")
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()


def _span_sequence(mod, rec):
    """One span sequence: nested spans, an instant, a counter, an async
    begin/end, a completed span and spans of a second thread (run after
    the first, so both packages see the same clock reads)."""
    with rec.span("outer", "runtime", {"k": 1}):
        with rec.span("inner", "compile"):
            rec.instant("mark", "runtime", {"note": "x"})
        rec.counter("transfers_in_flight", 2)
    tok = rec.begin("async", "transfer", None, "mesh 1")
    rec.complete("done", "transfer", mod.now_us(), 4.0, None, "mesh 0")
    rec.end(tok)

    def worker():
        with rec.span("in-thread", "instruction", None, "mesh 2"):
            rec.instant("thread-mark")
    t = threading.Thread(target=worker, name="alpa-worker-1")
    t.start()
    t.join()


@pytest.mark.parametrize("max_events", [200000, 3])
def test_chrome_trace_equal_jax(one_clock, max_events):
    jrec = jtrace.TraceRecorder(max_events=max_events)
    trec = ttrace.TraceRecorder(max_events=max_events)
    _span_sequence(jtrace, jrec)
    one_clock.restart()
    _span_sequence(ttrace, trec)
    assert trec.to_chrome_trace() == jrec.to_chrome_trace()
    assert trec.spans() == jrec.spans()
    merged = (ttrace.merge_chrome_traces([trec.to_chrome_trace()] * 2),
              jtrace.merge_chrome_traces([jrec.to_chrome_trace()] * 2))
    assert merged[0] == merged[1]


def test_module_front_door_is_free_when_off():
    prev = ttrace.set_enabled(False)
    try:
        assert ttrace.span("a") is ttrace.span("b")
        assert ttrace.begin("a") is None
        assert tconfig.telemetry_enabled is False
    finally:
        ttrace.set_enabled(prev)


def _flight_events(rec):
    for i in range(13):
        rec.record("exec", f"RUN stage_{i % 2}", i % 2, i, (i, i + 1),
                   float(i), float(i) + 0.5, "ok" if i % 5 else "error:X")


def test_flight_dump_and_auto_dump_equal_jax(tmp_path, one_clock,
                                             monkeypatch):
    jrec, trec = jflight.FlightRecorder(6), tflight.FlightRecorder(6)
    assert trec.capacity == jrec.capacity == 8
    _flight_events(jrec)
    _flight_events(trec)
    assert trec.snapshot() == jrec.snapshot()
    jpath = jrec.dump(str(tmp_path / "j.json"), reason="test")
    tpath = trec.dump(str(tmp_path / "t.json"), reason="test")
    jd, td = jflight.load_dump(jpath), tflight.load_dump(tpath)
    for d in (jd, td):
        d.pop("written_at")
    assert td == jd
    # auto_dump: once, then nothing until a new event
    monkeypatch.setattr(jconfig, "flight_dump_dir", str(tmp_path / "j"))
    monkeypatch.setattr(tconfig, "flight_dump_dir", str(tmp_path / "t"))
    jold = jflight.set_recorder(jflight.FlightRecorder(8))
    told = tflight.set_recorder(tflight.FlightRecorder(8))
    try:
        for mod in (jflight, tflight):
            assert mod.auto_dump("empty") is None
            one_clock.restart()
            _flight_events(mod.get_recorder())
        paths = [mod.auto_dump("step raised") for mod in (jflight, tflight)]
        assert all(paths)
        assert [mod.auto_dump("again") for mod in (jflight, tflight)] == \
            [None, None]
        loaded = [mod.load_dump(p) for mod, p in zip((jflight, tflight),
                                                      paths)]
        for d in loaded:
            d.pop("written_at")
        assert loaded[1] == loaded[0]
        assert tflight.last_dump_path() == paths[1]
    finally:
        jflight.set_recorder(jold)
        tflight.set_recorder(told)


def test_timer_bridge_equal_jax(monkeypatch, one_clock):
    ticks = itertools.count()
    monkeypatch.setattr(jtimer.time, "perf_counter",
                        lambda: next(ticks) * 0.25)
    jreg = jmetrics.MetricsRegistry()
    treg = tmetrics.MetricsRegistry()
    monkeypatch.setattr(jmetrics, "_REGISTRY", jreg)
    monkeypatch.setattr(tmetrics, "_REGISTRY", treg)
    out = []
    for mod in (jtimer, ttimer):
        ticks = itertools.count()
        timers = mod.Timers()
        for _ in range(3):
            timers("step").start()
            timers("step").stop()
        out.append((timers("step").costs, timers("step").elapsed("sum")))
    assert out[1] == out[0]
    assert treg.to_prometheus_text() == jreg.to_prometheus_text()
    jrec, trec = jtrace.TraceRecorder(), ttrace.TraceRecorder()
    for mod, tmod, rec in ((jtimer, jtrace, jrec), (ttimer, ttrace, trec)):
        one_clock.restart()
        old, prev = tmod.set_recorder(rec), tmod.set_enabled(True)
        try:
            mod.Tracer().log("legacy-event", "info")
        finally:
            tmod.set_enabled(prev)
            tmod.set_recorder(old)
    assert trec.to_chrome_trace() == jrec.to_chrome_trace()


def _mlp_steps():
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = tp._mlp_pair(2, optax.sgd(1e-2),
                                           tmu.sgd(1e-2))
    jstep = alpa_tpu.parallelize(tp._jax_step,
                                 method=tp._jax_method(2, 2, "1f1b"))
    tstep = alpa_tpu_torch.parallelize(tp._port_step,
                                       method=tp._port_method(2, 2, "1f1b"))
    return j_state, t_state, batch, jstep, tstep


def _op_spans(rec):
    return sorted((s["name"], s["track"]) for s in rec.spans()
                  if (s["track"] or "").startswith("mesh"))


@pytest.mark.parametrize("mode", ["registers", "overlap"])
def test_traced_pipeshard_step_spans_match_jax(mode, monkeypatch):
    """One span per replayed op on its mesh's track, JAX's names; a FREE
    span per FREE op (the port frees a value after its last use, JAX at
    other points, so their counts differ); the step span on the driver."""
    monkeypatch.setattr(jconfig, "pipeline_dispatch_mode", mode)
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", mode)
    j_state, t_state, batch, jstep, tstep = _mlp_steps()
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    j_state, _ = jstep(j_state, jb)
    t_state, _ = tstep(t_state, batch)
    jrec, trec = jtrace.TraceRecorder(), ttrace.TraceRecorder()
    jold, told = jtrace.set_recorder(jrec), ttrace.set_recorder(trec)
    jprev, tprev = jtrace.set_enabled(True), ttrace.set_enabled(True)
    try:
        jstep(j_state, jb)
        tstep(t_state, batch)
    finally:
        jtrace.set_enabled(jprev)
        ttrace.set_enabled(tprev)
        jtrace.set_recorder(jold)
        ttrace.set_recorder(told)
    ex = tstep.get_last_executable()
    prog = ex._last_program
    assert ex.last_dispatch_stats["mode"] == mode
    theirs = [s for s in _op_spans(jrec) if s[0] != "FREE"]
    ours = _op_spans(trec)
    assert [s for s in ours if s[0] != "FREE"] == theirs
    assert len(ours) == len(prog.ops)
    assert sorted((h.name, f"mesh {h.mesh}") for h in prog.hooks) == ours
    assert [s["name"] for s in trec.spans()
            if s["track"] == "driver"].count("pipeshard.step") == 1
    assert "flight" in prog.last_hooks and "trace" in prog.last_hooks


@pytest.mark.parametrize("mode", ["sequential", "threaded"])
def test_interpreter_modes_record_per_mesh_tracks(mode, monkeypatch):
    monkeypatch.setattr(tconfig, "_pipeline_dispatch_mode", mode)
    _, t_state, batch, _, tstep = _mlp_steps()
    t_state, _ = tstep(t_state, batch)
    rec = ttrace.TraceRecorder()
    old, prev = ttrace.set_recorder(rec), ttrace.set_enabled(True)
    try:
        tstep(t_state, batch)
    finally:
        ttrace.set_enabled(prev)
        ttrace.set_recorder(old)
    ex = tstep.get_last_executable()
    names = ex._inst_names()
    assert _op_spans(rec) == sorted((n, f"mesh {m}") for n, m in names)


def test_hooks_on_and_off_are_bit_identical(monkeypatch, tmp_path):
    """Flight recorder, tracing and the slot hazard checker on against all
    of them off: the same losses and parameters bit for bit; a raising
    step dumps the ring once."""
    results = []
    for on in (False, True):
        monkeypatch.setattr(tconfig, "flight_recorder", on)
        monkeypatch.setattr(tconfig, "debug_dispatch_races", on)
        _, t_state, batch, _, tstep = _mlp_steps()
        prev = ttrace.set_enabled(on)
        try:
            t_state, losses = tp._run(tstep, t_state, batch, steps=3)
        finally:
            ttrace.set_enabled(prev)
        prog = tstep.get_last_executable()._last_program
        assert bool(prog.last_hooks) == on
        results.append((losses, {k: v.clone() for k, v in
                                 t_state.params.items()}))
        alpa_tpu_torch.shutdown()
    assert results[1][0] == results[0][0]
    for k, v in results[0][1].items():
        assert torch.equal(results[1][1][k], v)
    # a raising step: one dump, with the op that raised last
    monkeypatch.setattr(tconfig, "flight_recorder", True)
    monkeypatch.setattr(tconfig, "flight_dump_dir", str(tmp_path))
    old = tflight.set_recorder(tflight.FlightRecorder(64))
    try:
        _, t_state, batch, _, tstep = _mlp_steps()
        t_state, _ = tstep(t_state, batch)
        ex = tstep.get_last_executable()
        run0 = next(i for i in ex.instructions if i.opcode.name == "RUN")
        broken = run0.executable.module

        def fail(*args):
            raise RuntimeError("injected")
        monkeypatch.setattr(run0.executable, "module", fail)
        with pytest.raises(RuntimeError, match="injected"):
            tstep(t_state, batch)
        path = tflight.last_dump_path()
        dump = tflight.load_dump(path)
        assert dump["reason"] == "pipeshard step raised"
        assert dump["events"][-1]["outcome"] == "error:RuntimeError"
        assert dump["events"][-1]["name"] == f"RUN {run0.info}"
        assert tflight.auto_dump("again") is None
        monkeypatch.setattr(run0.executable, "module", broken)
    finally:
        tflight.set_recorder(old)


def test_dispatch_histograms_and_overlap_families():
    reg = tmetrics.get_registry()
    before = reg.histogram("alpa_pipeshard_dispatch_seconds", "").count
    steps = reg.counter("alpa_overlap_steps_total", "").value
    _, t_state, batch, _, tstep = _mlp_steps()
    tp._run(tstep, t_state, batch, steps=2)
    assert reg.histogram("alpa_pipeshard_dispatch_seconds",
                         "").count == before + 2
    assert tstep.get_last_executable().last_dispatch_stats["mode"] == \
        "overlap"
    assert reg.counter("alpa_overlap_steps_total", "").value == steps + 2
    text = reg.to_prometheus_text()
    for family in ("alpa_resharding_plans_total",
                   "alpa_reshard_strategy_total",
                   "alpa_mesh_dispatch_seconds",
                   "alpa_compile_cache_hits"):
        assert f"# TYPE {family} " in text
    assert json.loads(json.dumps(ttrace.get_recorder().to_chrome_trace()))
