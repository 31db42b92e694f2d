"""The port's serving path against the JAX package's, greedy, from the same
weights: ``Generator.generate`` with bucketed and chunked prefill, and
``POST /completions`` through the port's HTTP controller.  Tokens must be
identical; the test asserts that every greedy choice it compares was won
by a top-2 logit margin above 1e-3, far above the fp32 logit error
(< 1e-5 at this size), so the comparison cannot hinge on a near-tie.
"""
import copy
import functools
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve import Generator as JaxGenerator
from alpa_tpu.serve import GenerationConfig as JaxGenerationConfig
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import (GenerationConfig, Generator, get_model,
                                  run_controller)

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=128,
             vocab_size=256, activation="relu", pos_offset=2)
NEW_TOKENS = 8
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jgm.GPTConfig(attention_impl="flash", **SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE)
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    return jmodel, params, jcfg, tmodel, tcfg


def _generators(prefill_chunk=None):
    """Each call gets its own copy of the port's model: a weight swap
    writes into the model's tensors, and must not reach other tests."""
    jmodel, params, jcfg, tmodel, tcfg = _models()
    return (JaxGenerator(jmodel, params, jcfg, prefill_chunk=prefill_chunk),
            Generator(copy.deepcopy(tmodel), tcfg,
                      prefill_chunk=prefill_chunk, device="cpu"))


def _prompts(lengths=(5, 17, 30), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SHAPE["vocab_size"], n).astype(np.int32)
            for n in lengths]


def _assert_clear_margins(rows, prompts):
    """Re-run each output row without a cache: every generated token is
    the argmax at its position, won by a margin above MARGIN."""
    _, _, _, tmodel, _ = _models()
    for row, p in zip(rows, prompts):
        with torch.inference_mode():
            logits = tmodel(torch.from_numpy(np.array(row[None, :-1])).long())
        step = logits[0, len(p) - 1:].float()
        top2 = torch.topk(step, 2, dim=-1).values
        np.testing.assert_array_equal(step.argmax(-1).numpy(), row[len(p):])
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


@pytest.mark.parametrize("prefill_chunk", [None, 16],
                         ids=["bucketed", "chunked"])
def test_generate_matches_jax_mixed_lengths(prefill_chunk):
    jgen, tgen = _generators(prefill_chunk)
    prompts = _prompts()
    ref = jgen.generate(prompts, JaxGenerationConfig(
        max_new_tokens=NEW_TOKENS))
    out = tgen.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    _assert_clear_margins(out, prompts)
    assert tgen.decode_calls == NEW_TOKENS
    assert tgen.prefill_calls == (1 if prefill_chunk is None else 2)


def test_generate_matches_jax_uniform_batch_with_eos():
    jgen, tgen = _generators()
    prompts = np.stack(_prompts((12, 12), seed=1))
    free = tgen.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS))
    assert free.shape == (2, 12 + NEW_TOKENS)
    _assert_clear_margins(free, list(prompts))
    eos = int(free[0, 12 + 2])     # row 0 stops at its third token
    out = tgen.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS,
                                                  eos_token_id=eos))
    ref = jgen.generate(prompts, JaxGenerationConfig(
        max_new_tokens=NEW_TOKENS, eos_token_id=eos))
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert (out[0, 12 + 2:] == eos).all()


def test_sampling_reproducible_under_one_seed():
    _, tgen = _generators()
    cfg = GenerationConfig(max_new_tokens=6, do_sample=True,
                           temperature=0.8, top_k=10)
    prompt = np.array([[5, 6, 7]], np.int32)

    def draw(seed):
        return tgen.generate(prompt, cfg,
                             rng=torch.Generator().manual_seed(seed))

    np.testing.assert_array_equal(draw(7), draw(7))
    assert draw(7).shape == (1, 9)


def _post(port, body, path="/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_completions_over_http_match_jax():
    jgen, tgen = _generators()
    prompts = _prompts(seed=2)
    ref = jgen.generate(prompts, JaxGenerationConfig(
        max_new_tokens=NEW_TOKENS))
    server = run_controller(port=0, device="cpu")
    try:
        server.controller.register_model("opt-tiny", tgen)
        assert _get(server.port, "/models") == (200, {"models": ["opt-tiny"]})
        results = [None] * len(prompts)

        def call(i):
            results[i] = _post(server.port, {
                "model": "opt-tiny", "prompt_ids": prompts[i].tolist(),
                "max_new_tokens": NEW_TOKENS})["output_ids"][0]

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for got, want in zip(results, ref):
            np.testing.assert_array_equal(np.array(got), want)
    finally:
        server.shutdown()


def test_http_error_codes():
    _, tgen = _generators()
    server = run_controller(port=0, device="cpu")
    try:
        server.controller.register_model("m", tgen)
        assert _get(server.port, "/health") == (200, {"status": "ok"})
        for body, code in [({"model": "nope", "prompt_ids": [1]}, 404),
                           ({"model": "m", "prompt_ids": [1],
                             "max_new_tokens": 1000}, 400)]:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server.port, body)
            assert e.value.code == code
        server.controller.set_health("shedding", "test")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, {"model": "m", "prompt_ids": [1]})
        assert e.value.code == 503
    finally:
        server.shutdown()


def test_register_model_by_config_on_requested_device():
    server = run_controller(port=0, device="cpu")
    try:
        cfg = tgm.GPTConfig(**SHAPE)
        gen = server.controller.register_model("r", cfg)
        assert gen.device.type == "cpu" and gen.config == cfg
        assert server.controller.list_models() == ["r"]
    finally:
        server.shutdown()
    assert get_model(cfg, device="cpu").prompt_buckets == [32, 64, 128]


def _families(text):
    """{family: (type, label names)} of Prometheus text; label names from
    its samples, ``le`` left out."""
    import re
    types, labels = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
            labels.setdefault(name, set())
        elif line and not line.startswith("#"):
            sample = line.split("{")[0].split()[0]
            fam = re.sub(r"_(bucket|sum|count)$", "", sample) \
                if sample not in types else sample
            keys = re.findall(r'(\w+)="', line.split("}")[0]) \
                if "{" in line else []
            labels.setdefault(fam, set()).update(k for k in keys
                                                 if k != "le")
    return {n: (t, frozenset(labels.get(n, ()))) for n, t in types.items()}


def _sample(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def _sse(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    tokens = []
    with urllib.request.urlopen(req, timeout=60) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: ") and "token" in line:
                tokens.append(json.loads(line[len("data: "):])["token"])
    return tokens


def test_metrics_families_and_counts_equal_jax():
    """After the same batched and streamed requests, ``GET /metrics`` of
    the port's controller has the serving and KV families of JAX's (names,
    types, label names), and the same request, token and TTFT counts;
    ``GET /healthz`` carries ``last_flight_dump``."""
    from alpa_tpu.serve import run_controller as jax_run_controller
    jgen, tgen = _generators()
    prompts = _prompts(seed=4)
    servers = {"jax": jax_run_controller(port=0),
               "port": run_controller(port=0, device="cpu")}
    texts = {}
    try:
        servers["jax"].controller.register_model("m", jgen)
        servers["port"].controller.register_model("m", tgen)
        for side, server in servers.items():
            port = server.port
            before = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=60).read()
            outs = [_post(port, {"model": "m", "prompt_ids": p.tolist(),
                                 "max_new_tokens": NEW_TOKENS})
                    for p in prompts]
            streams = [_sse(port, {"model": "m", "prompt_ids": p.tolist(),
                                   "max_new_tokens": NEW_TOKENS})
                       for p in prompts[:2]]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=60) as resp:
                assert resp.headers["Content-Type"].startswith("text/plain")
                texts[side] = (before.decode(), resp.read().decode())
            assert all(len(o["output_ids"][0]) > len(p)
                       for o, p in zip(outs, prompts))
            assert all(len(s) == NEW_TOKENS for s in streams)
        status, health = _get(servers["port"].port, "/healthz")
        assert status == 200 and "last_flight_dump" in health
    finally:
        for server in servers.values():
            server.shutdown()
    fams = {side: {n: v for n, v in _families(after).items()
                   if n.startswith(("alpa_serving_", "alpa_kv_"))}
            for side, (_, after) in texts.items()}
    assert fams["port"] == fams["jax"]

    def delta(side, name):
        before, after = texts[side]
        return _sample(after, name) - _sample(before, name)
    for name in ('alpa_serving_requests_total{outcome="ok"}',
                 "alpa_serving_batches_total",
                 "alpa_serving_tokens_total",
                 "alpa_serving_ttft_seconds_count",
                 "alpa_serving_admissions_total"):
        assert delta("port", name) == delta("jax", name), name
    assert delta("port", 'alpa_serving_requests_total{outcome="ok"}') == \
        len(prompts)
    assert delta("port", "alpa_serving_ttft_seconds_count") == 2


# ---- faults, degraded mode and hot swap (after tests/serve/
# test_degraded_mode.py and test_hot_swap.py) ------------------------------

def _status(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_status(port, body):
    try:
        return 200, _post(port, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _degraded_walk(pkg, gen, tmp_path):
    """One script on a package's controller: a scheduler fault demotes
    the batcher to FIFO (queued requests all served); a RecoveryManager
    that loses its mesh sheds load (503 on /completions, /health,
    /healthz) and recovers.  Returns every (code, status) it saw."""
    if pkg == "jax":
        from alpa_tpu import fault
        from alpa_tpu.global_env import global_config as cfg
        from alpa_tpu.serve import run_controller as run
        from alpa_tpu.serve.scheduler import WeightedFairQueue
        server = run(port=0)
    else:
        from alpa_tpu_torch import fault
        from alpa_tpu_torch.global_env import global_config as cfg
        from alpa_tpu_torch.serve.scheduler import WeightedFairQueue
        server = run_controller(port=0, device="cpu")
    saved_dir = cfg.flight_dump_dir
    cfg.flight_dump_dir = str(tmp_path / pkg)
    seen = []
    body = {"model": "m", "prompt_ids": [1, 2, 3], "max_new_tokens": 2}
    try:
        ctl = server.controller
        ctl.register_model("m", gen, scheduler_factory=WeightedFairQueue)
        batcher = ctl._models["m"][0].batcher
        with fault.FaultPlan(fault.FaultSpec("scheduler_take", times=1)):
            outs, errors = [None] * 3, []

            def call(i):
                try:
                    outs[i] = batcher.submit(
                        [np.array([1 + i, 2, 3], np.int32)],
                        (GenerationConfig if pkg == "port" else
                         JaxGenerationConfig)(max_new_tokens=2))
                except Exception as e:  # noqa: BLE001 -- recorded
                    errors.append(e)
            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        seen.append(("served", len(errors), all(o is not None for o in outs),
                     type(batcher._queue).__name__, batcher.degraded))
        code, health = _status(server.port, "/health")
        seen.append(("health", code, health["status"],
                     health.get("degraded_models")))
        alive = {"ok": False}
        rm = fault.RecoveryManager(
            ["mesh0"], retry_policy=fault.RetryPolicy(
                max_attempts=2, base_delay=0.0, jitter=0.0),
            probe=lambda mesh: alive["ok"])
        ctl.attach_recovery(rm)
        seen.append(("tick", rm.tick().value))
        for path in ("/health", "/healthz"):
            code, rep = _status(server.port, path)
            seen.append((path, code, rep["status"],
                         "last_flight_dump" in rep and
                         "elastic" in rep))
        code, rep = _post_status(server.port, body)
        seen.append(("shed", code, "unavailable" in rep.get("error", "")))
        alive["ok"] = True
        seen.append(("tick", rm.tick().value))
        code, _ = _post_status(server.port, body)
        seen.append(("served again", code, _status(server.port,
                                                   "/healthz")[0]))
    finally:
        server.shutdown()
        cfg.flight_dump_dir = saved_dir
    return seen


def test_degraded_fallback_and_shedding_codes_as_jax(tmp_path):
    """The same script on both controllers gives the same HTTP codes and
    health fields: FIFO fallback with every queued request served
    ("degraded"), 503 while the recovery manager is DEGRADED (with
    ``last_flight_dump`` and ``elastic`` in ``/healthz``), 200 after."""
    jgen, tgen = _generators()
    port = _degraded_walk("port", tgen, tmp_path)
    assert port == _degraded_walk("jax", jgen, tmp_path)
    assert port[0] == ("served", 0, True, "FIFOQueue", True)
    assert port[3][:3] == ("/health", 503, "shedding")
    assert port[4][:3] == ("/healthz", 503, "degraded")
    assert port[-1] == ("served again", 200, 200)


def test_engine_tick_fault_fails_the_rows_and_serves_on(tmp_path,
                                                        monkeypatch):
    from alpa_tpu_torch import fault
    from alpa_tpu_torch.global_env import global_config as cfg
    from alpa_tpu_torch.serve import ContinuousBatchingEngine
    monkeypatch.setattr(cfg, "flight_dump_dir", str(tmp_path))
    _, tgen = _generators()
    eng = ContinuousBatchingEngine(tgen, max_batch=1)
    try:
        with fault.FaultPlan(fault.FaultSpec("scheduler_tick",
                                             times=1)) as plan:
            with pytest.raises(fault.InjectedFault):
                eng.submit(np.array([1, 2], np.int32),
                           GenerationConfig(max_new_tokens=3))
        assert plan.fired("scheduler_tick") == 1 and eng.step_failures == 1
        assert len(eng.submit(np.array([3, 4], np.int32),
                              GenerationConfig(max_new_tokens=3))) == 5
    finally:
        eng.shutdown()


def _perturbed():
    """The JAX tiny model's weights x 0.5 + 0.25 (JAX's hot-swap
    perturbation), as flax params and as the port's state dict."""
    _, params, _, _, tcfg = _models()
    new = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.25, params)
    return new, gpt_params_from_flax(new, tcfg, "cpu")


def test_reload_under_requests_gives_jax_swapped_tokens(tmp_path):
    """``POST /admin/reload`` while batched and streamed requests run on
    the port's controller: none fails, each batched answer is the old or
    the new weights' greedy output, and requests after the swap give the
    tokens of a fresh Generator on the new weights and of JAX's controller
    swapped to the same weights (saved by each package's manager)."""
    from alpa_tpu.checkpoint.manager import CheckpointManager as JManager
    from alpa_tpu.serve import run_controller as jax_run_controller
    from alpa_tpu_torch.checkpoint import CheckpointManager
    jgen, tgen = _generators()
    jnew, tnew = _perturbed()
    jm = JManager(str(tmp_path / "jax"), async_save=False)
    jm.save(1, jnew)
    tm = CheckpointManager(str(tmp_path / "port"), async_save=False)
    tm.save(1, tnew)
    jmodel, _, jcfg, _, tcfg = _models()
    fresh_model = tgm.GPTModel(tcfg)
    fresh_model.load_state_dict(tnew)
    fresh = Generator(fresh_model, tcfg, device="cpu")
    prompt = _prompts(lengths=(9,), seed=5)[0]
    cfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    want_old = tgen.generate([prompt], cfg)[0].tolist()
    want_new = fresh.generate([prompt], cfg)[0].tolist()
    assert want_old != want_new
    body = {"model": "m", "prompt_ids": prompt.tolist(),
            "max_new_tokens": NEW_TOKENS}
    server = run_controller(port=0, device="cpu")
    jserver = jax_run_controller(port=0)
    try:
        server.controller.register_model("m", tgen)
        jserver.controller.register_model("m", jgen)
        outputs, errors, streams = [], [], []
        started, stop = threading.Event(), threading.Event()

        def hammer():
            try:
                while not stop.is_set():
                    outputs.append(_post(server.port, body)["output_ids"][0])
                    started.set()
            except Exception as e:  # noqa: BLE001 -- recorded
                errors.append(e)

        def stream():
            try:
                streams.append(_sse(server.port, {**body,
                                                  "max_new_tokens": 24}))
            except Exception as e:  # noqa: BLE001 -- recorded
                errors.append(e)
        threads = [threading.Thread(target=hammer) for _ in range(3)] + [
            threading.Thread(target=stream) for _ in range(2)]
        for t in threads:
            t.start()
        assert started.wait(120)
        result = _post(server.port, {"model": "m",
                                     "ckpt_dir": str(tmp_path / "port")},
                       path="/admin/reload")
        stop.set()
        for t in threads:
            t.join(120)
        assert result == {"model": "m", "step": 1, "replicas_swapped": 1}
        assert not errors and len(streams) == 2
        assert all(len(s) == 24 for s in streams)
        assert outputs and all(o in (want_old, want_new) for o in outputs)
        after = _post(server.port, body)["output_ids"][0]
        _post(jserver.port, {"model": "m",
                             "ckpt_dir": str(tmp_path / "jax")},
              path="/admin/reload")
        jafter = _post(jserver.port, body)["output_ids"][0]
        assert after == want_new == jafter
        assert _sse(server.port, body) == want_new[len(prompt):]
    finally:
        server.shutdown()
        jserver.shutdown()


def test_corrupt_checkpoint_never_touches_serving(tmp_path):
    from alpa_tpu_torch.checkpoint import CheckpointManager
    _, tgen = _generators()
    _, tnew = _perturbed()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, tnew)
    leaf = next(iter(mgr.store.read_manifest(1)["leaves"].values()))
    with open(mgr.store.chunk_path(leaf["chunks"][0]["hash"]), "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    prompt = _prompts(lengths=(7,), seed=6)[0]
    body = {"model": "m", "prompt_ids": prompt.tolist(),
            "max_new_tokens": NEW_TOKENS}
    want_old = tgen.generate([prompt], GenerationConfig(
        max_new_tokens=NEW_TOKENS))[0].tolist()
    server = run_controller(port=0, device="cpu")
    try:
        server.controller.register_model("m", tgen)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/admin/reload",
            data=json.dumps({"model": "m",
                             "ckpt_dir": str(tmp_path / "ck")}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500
        assert "ChunkCorruptionError" in json.loads(e.value.read())["error"]
        assert server.controller.reloads == []
        assert _post(server.port, body)["output_ids"][0] == want_old
    finally:
        server.shutdown()


def test_swap_waits_out_no_stream_and_no_tick_sees_mixed_weights(
        tmp_path, monkeypatch):
    """The swap copies the new weights into the model's own tensors, so it
    may not overlap a tick of a live engine.  With a row active and a
    drain window of 0, ``swap_weights`` raises ``HotSwapBusyError`` and
    changes nothing, and ``POST /admin/reload`` answers 409; the stream
    then finishes on the old weights, every tick of it reading the old
    weights whole.  Once the stream is done the swap goes through, the
    old engine's thread has ended, and a new stream reads the new weights
    whole."""
    from alpa_tpu_torch.checkpoint import CheckpointManager
    from alpa_tpu_torch.checkpoint import hot_swap
    _, gen = _generators()
    tcfg = _models()[4]
    _, tnew = _perturbed()
    old = {k: v.clone() for k, v in gen.params.items()}
    prompt = _prompts(lengths=(9,), seed=5)[0]
    cfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    want_old = gen.generate([prompt], cfg)[0].tolist()[len(prompt):]
    fresh_model = tgm.GPTModel(tcfg)
    fresh_model.load_state_dict(tnew)
    want_new = Generator(fresh_model, tcfg, device="cpu").generate(
        [prompt], cfg)[0].tolist()[len(prompt):]
    assert want_old != want_new

    def weights():
        now = gen.params
        if all(torch.equal(now[k], old[k]) for k in now):
            return "old"
        if all(torch.equal(now[k], tnew[k]) for k in now):
            return "new"
        return "mixed"

    def watch(engine, seen, gate=None):
        tick = engine._tick

        def watched():
            if gate is not None and not seen:
                gate[0].set()
                assert gate[1].wait(60.0)
            seen.append(weights())
            tick()
        engine._tick = watched

    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    mgr.save(1, tnew)
    server = run_controller(port=0, device="cpu")
    try:
        server.controller.register_model("m", gen)
        replica = server.controller._models["m"][0]
        engine = replica.engine
        in_tick, release = threading.Event(), threading.Event()
        seen_old = []
        watch(engine, seen_old, (in_tick, release))
        stream = replica.submit_stream(prompt, cfg)
        assert in_tick.wait(60.0)
        with pytest.raises(hot_swap.HotSwapBusyError):
            replica.swap_weights(tnew, drain_timeout=0.0)
        assert weights() == "old" and replica._engine is engine
        drain = hot_swap.drain_engine
        monkeypatch.setattr(hot_swap, "drain_engine",
                            lambda e, timeout, poll=0.01:
                            drain(e, timeout=0.0, poll=poll))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server.port, {"model": "m",
                                "ckpt_dir": str(tmp_path / "ck")},
                  path="/admin/reload")
        assert e.value.code == 409
        assert "HotSwapBusyError" in json.loads(e.value.read())["error"]
        assert server.controller.reloads == [] and weights() == "old"
        monkeypatch.setattr(hot_swap, "drain_engine", drain)
        release.set()
        assert list(stream) == want_old
        assert seen_old and set(seen_old) == {"old"}
        replica.swap_weights(tnew)
        assert weights() == "new" and replica._engine is None
        assert not engine._thread.is_alive()
        seen_new = []
        watch(replica.engine, seen_new)
        assert list(replica.submit_stream(prompt, cfg)) == want_new
        assert seen_new and set(seen_new) == {"new"}
    finally:
        server.shutdown()
