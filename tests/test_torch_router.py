"""The port's multi-replica router (``serve/router.py``) against the JAX
package's ``Router``: the same stub replicas and load scripts must give
the same placements, sheds, health drops and restores and autoscale
firings (the stubs have the shape of ``tests/serve/test_router.py``'s
``StubHandle``).  Then the router over live port controllers on the CPU
(a 2-layer OPT-style model at hidden 64, fp32, random weights from a
seed): a rolling reload under traffic with zero errors, and
``RouterServer`` over HTTP with SSE pass-through, an
``HTTPReplicaHandle`` and the disaggregated ``/disagg/*`` routes.  Token
comparisons are exact."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from alpa_tpu import fault as jfault
from alpa_tpu.serve import router as jrouter
from alpa_tpu_torch import fault as tfault
from alpa_tpu_torch.checkpoint import CheckpointManager
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.serve import disagg
from alpa_tpu_torch.serve import router as trouter
from alpa_tpu_torch.serve.controller import Controller, run_controller
from alpa_tpu_torch.serve.generation import GenerationConfig, Generator

PROMPT = [3, 1, 4, 1, 5]
REQ = {"model": "m", "prompt_ids": PROMPT, "max_new_tokens": 4}
CFG = tgm.GPTConfig(hidden_size=64, num_layers=2, num_heads=4, seq_len=32,
                    vocab_size=64, activation="relu", pos_offset=2)
IDLE = {"queue_depth": 0, "tokens_in_flight": 0, "ttft_p99_ms": None}


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


PACKAGES = {"jax": (jrouter, jfault), "port": (trouter, tfault)}


class StubHandle:
    """A scriptable replica: its load report, health and completion
    behaviour; ``fail`` names the failure ("shed", "transport",
    "request"), raised as the package's own exception."""

    def __init__(self, fault_mod, load=None, health_code=200, fail=None):
        self.fault = fault_mod
        self.load_report = dict(load or IDLE)
        self.health_code = health_code
        self.fail = fail
        self.calls = 0

    def _maybe_fail(self):
        if self.fail == "shed":
            raise self.fault.ServiceDegradedError("backend down")
        if self.fail == "transport":
            raise ConnectionRefusedError("down")
        if self.fail == "request":
            raise KeyError("unknown model")

    def completions(self, request):
        self.calls += 1
        self._maybe_fail()
        return {"output_ids": [request["prompt_ids"] + [0]]}

    def completions_stream(self, request):
        self.calls += 1
        self._maybe_fail()
        return iter([0, 1])

    def healthz(self):
        return self.health_code, {"load": self.load_report}

    def load(self):
        return self.load_report

    def reload(self, model, ckpt_dir, step=None):
        return {"model": model, "step": step}


def _submit(r, fault_mod, trace, n=1):
    for _ in range(n):
        try:
            out = r.submit(dict(REQ))
            trace.append(("ok", out["output_ids"][0][-1]))
        except fault_mod.ServiceDegradedError:
            trace.append(("503", r.sheds))
        except KeyError:
            trace.append(("KeyError",))


def _scenario(name, pkg):
    """Run scenario ``name`` against package ``pkg``'s router and stubs;
    the trace of every observable decision."""
    router_mod, fault_mod = PACKAGES[pkg]

    def stub(**kw):
        return StubHandle(fault_mod, **kw)
    trace = []
    if name == "least_loaded":
        r = router_mod.Router(policy="least_loaded")
        busy = stub(load={"queue_depth": 10, "tokens_in_flight": 500,
                          "ttft_p99_ms": 50.0})
        idle = stub()
        r.add_replica("busy", busy)
        r.add_replica("idle", idle)
        _submit(r, fault_mod, trace, 8)
        trace.append((busy.calls, idle.calls))
    elif name == "round_robin":
        r = router_mod.Router(policy="round_robin")
        stubs = [stub() for _ in range(3)]
        for i, s in enumerate(stubs):
            r.add_replica(f"r{i}", s)
        _submit(r, fault_mod, trace, 8)
        trace.append(tuple(s.calls for s in stubs))
    elif name == "load_script":
        # loads that change between requests, under both policies
        for policy in ("least_loaded", "round_robin"):
            r = router_mod.Router(policy=policy, shed_queue_depth=6,
                                  shed_ttft_ms=80.0)
            stubs = [stub() for _ in range(3)]
            for i, s in enumerate(stubs):
                r.add_replica(f"r{i}", s)
            rng = np.random.default_rng(11)
            for _ in range(24):
                for s in stubs:
                    s.load_report = {
                        "queue_depth": int(rng.integers(0, 9)),
                        "tokens_in_flight": int(rng.integers(0, 2000)),
                        "ttft_p99_ms": (None if rng.random() < 0.2 else
                                        float(rng.integers(1, 120)))}
                before = [s.calls for s in stubs]
                _submit(r, fault_mod, trace)
                trace.append([s.calls - b for s, b in zip(stubs, before)])
            trace.append(r.snapshot()["sheds"])
    elif name == "streams_count_in_flight":
        r = router_mod.Router(policy="least_loaded")
        a, b = stub(), stub()
        r.add_replica("a", a)
        r.add_replica("b", b)
        held = [r.submit_stream(dict(REQ)) for _ in range(3)]
        trace.append((a.calls, b.calls))
        trace.append({n: v["inflight"] for n, v in
                      r.snapshot()["replicas"].items()})
        for s in held:
            trace.append(list(s))
        trace.append({n: v["inflight"] for n, v in
                      r.snapshot()["replicas"].items()})
    elif name == "saturated_routed_around":
        r = router_mod.Router(policy="least_loaded", shed_queue_depth=4)
        sat = stub(load={"queue_depth": 50, "tokens_in_flight": 0,
                         "ttft_p99_ms": None})
        ok = stub()
        r.add_replica("sat", sat)
        r.add_replica("ok", ok)
        _submit(r, fault_mod, trace, 4)
        trace.append((sat.calls, ok.calls))
    elif name == "503_only_when_all_saturated":
        r = router_mod.Router(policy="least_loaded", shed_queue_depth=4)
        load = {"queue_depth": 50, "tokens_in_flight": 0,
                "ttft_p99_ms": None}
        a = stub(load=dict(load))
        r.add_replica("a", a)
        r.add_replica("b", stub(load=dict(load)))
        _submit(r, fault_mod, trace)
        a.load_report = dict(IDLE)
        _submit(r, fault_mod, trace)
        trace.append(r.sheds)
    elif name == "replica_shed_fails_over":
        r = router_mod.Router(policy="round_robin")
        shedding, ok = stub(fail="shed"), stub()
        r.add_replica("shedding", shedding)
        r.add_replica("ok", ok)
        _submit(r, fault_mod, trace, 4)
        trace.append((shedding.calls, ok.calls, r.sheds))
    elif name == "health_drop_and_restore":
        r = router_mod.Router(health_fail_threshold=3)
        flaky, ok = stub(health_code=503), stub()
        r.add_replica("flaky", flaky)
        r.add_replica("ok", ok)
        for _ in range(3):
            trace.append(r.probe())
        trace.append(r.snapshot()["replicas"]["flaky"]["healthy"])
        _submit(r, fault_mod, trace, 2)
        flaky.health_code = 200
        trace.append(r.probe())
        _submit(r, fault_mod, trace, 2)
        trace.append((flaky.calls, ok.calls))
        trace.append(r.snapshot()["status"])
    elif name == "transport_error_fails_over":
        r = router_mod.Router(health_fail_threshold=1)
        dead, ok = stub(fail="transport"), stub()
        r.add_replica("dead", dead)
        r.add_replica("ok", ok)
        _submit(r, fault_mod, trace, 2)
        trace.append(r.snapshot()["replicas"]["dead"]["healthy"])
        trace.append((dead.calls, ok.calls))
    elif name == "request_error_propagates":
        r = router_mod.Router()
        bad, other = stub(fail="request"), stub()
        r.add_replica("bad", bad)
        r.add_replica("other", other)
        _submit(r, fault_mod, trace, 4)
        trace.append((bad.calls, other.calls))
    elif name == "draining_not_picked":
        r = router_mod.Router()
        a, b = stub(), stub()
        r.add_replica("a", a)
        r.add_replica("b", b)
        r._replicas["a"].draining = True
        _submit(r, fault_mod, trace, 4)
        trace.append((a.calls, b.calls))
        trace.append(r.rolling_reload("m", "/nowhere"))
    elif name.startswith("autoscale"):
        now = [1000.0]
        r = router_mod.Router(autoscale_window_s=10.0,
                              autoscale_hi_queue=4.0,
                              autoscale_lo_queue=1.0, clock=lambda: now[0])
        fired = []
        r.on_want_more = lambda router, mean: fired.append(("more", mean))
        r.on_want_fewer = lambda router, mean: fired.append(("fewer", mean))
        depth = {"autoscale_high": lambda i: 8.0,
                 "autoscale_low": lambda i: 0.2,
                 "autoscale_mixed": lambda i: 8.0 if i % 2 else 0.2}[name]
        for i in range(30):
            r._as_samples.append((now[0], depth(i)))
            trace.append(r.evaluate_autoscale())
            now[0] += 1.0
        trace.append((r.want_more_signals, r.want_fewer_signals, fired))
    else:
        raise KeyError(name)
    return trace


SCENARIOS = ["least_loaded", "round_robin", "load_script",
             "streams_count_in_flight", "saturated_routed_around",
             "503_only_when_all_saturated", "replica_shed_fails_over",
             "health_drop_and_restore", "transport_error_fails_over",
             "request_error_propagates", "draining_not_picked",
             "autoscale_high", "autoscale_low", "autoscale_mixed"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_router_decisions_equal_jax(name):
    port = _scenario(name, "port")
    assert port == _scenario(name, "jax")
    # and what each scenario is about
    if name == "least_loaded":
        assert port[-1] == (0, 8)
    elif name == "503_only_when_all_saturated":
        assert port == [("503", 1), ("ok", 0), 1]
    elif name == "health_drop_and_restore":
        assert [p["flaky"] for p in port[:3]] == [True, True, False]
        assert port[3] is False and port[6]["flaky"] is True
    elif name == "autoscale_high":
        assert port[-1][:2] == (2, 0)
    elif name == "autoscale_low":
        assert port[-1][:2] == (0, 2)
    elif name == "autoscale_mixed":
        assert port[-1][:2] == (0, 0)


def test_unknown_policy_and_phase_rejected():
    with pytest.raises(ValueError):
        trouter.Router(policy="coin_flip")
    with pytest.raises(ValueError):
        trouter.Router(disagg_mode="sometimes")
    with pytest.raises(ValueError):
        trouter.Router().add_replica("x", StubHandle(tfault), phase="both")


# ---- live controllers on the CPU ----


def _generator(seed=0):
    model = tgm.GPTModel(CFG, device="cpu")
    tgm.init_random_(model, seed)
    return Generator(model, CFG, device="cpu")


def _tokens(gen, prompt=PROMPT, n=4):
    return gen.generate(np.array([prompt]), GenerationConfig(
        max_new_tokens=n))[0].tolist()


def test_rolling_reload_over_two_replicas_has_zero_errors(tmp_path):
    ctrls = []
    r = trouter.Router(policy="least_loaded")
    for i in range(2):
        ctrl = Controller(device="cpu")
        ctrl.register_model("m", _generator())
        r.add_replica(f"r{i}", trouter.LocalReplicaHandle(ctrl))
        ctrls.append(ctrl)
    new = _generator(seed=1)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, new.params)
    want_old, want_new = _tokens(_generator()), _tokens(new)
    assert want_old != want_new
    errors, outputs = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                outputs.append(r.submit(dict(REQ))["output_ids"][0])
            except Exception as e:  # noqa: BLE001 -- recorded
                errors.append(e)
                return

    def hammer_stream():
        while not stop.is_set():
            try:
                toks = list(r.submit_stream(dict(REQ)))
                assert len(toks) == 4
                outputs.append(PROMPT + toks)
            except Exception as e:  # noqa: BLE001 -- recorded
                errors.append(e)
                return

    threads = ([threading.Thread(target=hammer) for _ in range(2)] +
               [threading.Thread(target=hammer_stream)])
    for t in threads:
        t.start()
    try:
        while len(outputs) < 4 and not errors:
            stop.wait(0.01)
        results = r.rolling_reload("m", str(tmp_path / "ck"))
        seen = len(outputs)
        while len(outputs) < seen + 4 and not errors:
            stop.wait(0.01)
        after = [c.completions(dict(REQ))["output_ids"][0] for c in ctrls]
    finally:
        stop.set()
        for t in threads:
            t.join()
        for c in ctrls:
            c.shutdown()
    assert not errors, errors
    assert [res["replica"] for res in results] == ["r0", "r1"]
    assert all(o in (want_old, want_new) for o in outputs)
    assert after == [want_new, want_new]


def _read_sse(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    tokens, final = [], None
    with urllib.request.urlopen(req, timeout=60) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                event = json.loads(line[len("data: "):])
                if "token" in event:
                    tokens.append(event["token"])
                else:
                    final = event
    return tokens, final


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_router_server_over_http_with_sse_and_a_remote_replica(tmp_path):
    local = Controller(device="cpu")
    local.register_model("m", _generator())
    remote = run_controller(port=0, device="cpu")
    remote.controller.register_model("m", _generator())
    r = trouter.Router(policy="round_robin")
    r.add_replica("local", trouter.LocalReplicaHandle(local))
    r.add_replica("remote", trouter.HTTPReplicaHandle(
        f"http://127.0.0.1:{remote.port}"))
    server = trouter.RouterServer(r, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    want = _tokens(_generator())
    try:
        with urllib.request.urlopen(base + "/healthz") as resp:
            body = json.loads(resp.read())
        assert body["status"] == "ok" and set(body["replicas"]) == \
            {"local", "remote"}
        assert r.probe() == {"local": True, "remote": True}
        for _ in range(2):      # one request to each replica
            assert _post(base + "/completions", REQ)["output_ids"][0] == want
            tokens, final = _read_sse(base + "/completions", REQ)
            assert final == {"done": True} and PROMPT + tokens == want
        snap = r.snapshot()["replicas"]
        assert snap["remote"]["queue_depth"] == 0
        with urllib.request.urlopen(base + "/metrics") as resp:
            text = resp.read().decode()
        for family in ("alpa_router_requests_total",
                       "alpa_router_replica_queue_depth",
                       "alpa_kv_blocks_in_use", "alpa_disagg_prefills_total"):
            assert family in text, family
        # a rolling reload through the router's HTTP route, over both
        new = _generator(seed=1)
        mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
        mgr.save(1, new.params)
        out = _post(base + "/admin/rolling_reload",
                    {"model": "m", "ckpt_dir": str(tmp_path / "ck")})
        assert [x["replica"] for x in out["reloads"]] == ["local", "remote"]
        for _ in range(2):
            assert _post(base + "/completions", REQ)["output_ids"][0] == \
                _tokens(new)
    finally:
        server.shutdown()
        remote.shutdown()
        local.shutdown()


def test_router_server_healthz_503_without_a_routable_replica():
    server = trouter.RouterServer(trouter.Router(), port=0)
    server.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz")
        assert exc.value.code == 503
    finally:
        server.shutdown()


def test_disaggregated_routing_over_http():
    """A prefill and a decode controller reached over HTTP: the handoff
    crosses ``/disagg/prefill`` and ``/disagg/ingest`` (SSE), the tokens
    equal the monolithic ones, the artifact is acked, a corrupt copy is
    refused with 422 and ``/healthz`` carries the load report."""
    servers = [run_controller(port=0, device="cpu") for _ in range(2)]
    for s in servers:
        s.controller.register_model("m", _generator())
    handles = [trouter.HTTPReplicaHandle(f"http://127.0.0.1:{s.port}")
               for s in servers]
    r = trouter.Router(disagg_mode="forced")
    r.add_replica("p0", handles[0], phase="prefill")
    r.add_replica("d0", handles[1], phase="decode")
    want = _tokens(_generator())
    try:
        assert r.submit(dict(REQ))["output_ids"][0] == want
        stream = r.submit_stream(dict(REQ))
        assert PROMPT + list(stream) == want
        assert r.disagg_handoffs == 2
        pe = servers[0].controller._models["m"][0]._prefill_engine
        with pe._cv:
            assert not pe._retained
        wire = handles[0].prefill(dict(REQ))
        wire["block_hashes"][0] = "0" * 64
        with pytest.raises(disagg.ArtifactCorruptError):
            handles[1].ingest(wire)
        code, body = handles[1].healthz()
        assert code == 200 and set(body["load"]) == {
            "queue_depth", "tokens_in_flight", "ttft_p99_ms"}
    finally:
        for s in servers:
            s.shutdown()
