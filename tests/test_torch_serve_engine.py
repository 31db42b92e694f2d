"""The port's continuous-batching engine against the JAX package's, greedy,
from the same weights: unpaged, paged with prefix hits, over a static
prefix, and with packed admission.  Tokens must be identical; every greedy
choice compared is checked to have been won by a top-2 logit margin above
1e-3, far above the fp32 logit error at this size (< 1e-5), so that no
comparison hinges on a near-tie.  The port's paged engine must give the
tokens of its unpaged one; cancellation, backpressure, pool exhaustion,
failure semantics, the decode graph's bookkeeping and SSE over HTTP are
checked on the port.
"""
import dataclasses
import functools
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve.engine import \
    ContinuousBatchingEngine as JaxEngine
from alpa_tpu.serve.generation import GenerationConfig as JaxGenConfig
from alpa_tpu.serve.generation import Generator as JaxGenerator
from alpa_tpu.serve.kv_cache import KVBlockPool as JaxPool
from alpa_tpu.serve.kv_cache import KVPoolExhaustedError as JaxExhausted
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                                  Generator, KVBlockPool,
                                  KVPoolExhaustedError, run_controller)

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=64,
             vocab_size=256, activation="relu", pos_offset=2)
BS = 8          # KV block size and prefill chunk
NEW = 6
MARGIN = 1e-3
GCFG = GenerationConfig(max_new_tokens=NEW)
JGCFG = JaxGenConfig(max_new_tokens=NEW)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jgm.GPTConfig(**SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE)
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    return jmodel, params, jcfg, tmodel, tcfg


@functools.lru_cache(maxsize=None)
def _jax_gen():
    jmodel, params, jcfg, _, _ = _models()
    return JaxGenerator(jmodel, params, jcfg, prefill_chunk=BS)


def _gen(prefill_chunk=BS):
    _, _, _, tmodel, tcfg = _models()
    return Generator(tmodel, tcfg, prefill_chunk=prefill_chunk, device="cpu")


def _prompts(lengths, seed=0, lo=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, SHAPE["vocab_size"], n).astype(np.int32)
            for n in lengths]


def _assert_clear_margins(rows, contexts):
    """Every generated token of each row is the argmax of a cache-free
    forward over its context, won by a margin above MARGIN."""
    _, _, _, tmodel, _ = _models()
    for row, ctx in zip(rows, contexts):
        full = np.concatenate([ctx, row[-NEW:]])
        with torch.inference_mode():
            logits = tmodel(torch.from_numpy(full[None, :-1]).long())
        step = logits[0, len(ctx) - 1:].float()
        top2 = torch.topk(step, 2, dim=-1).values
        np.testing.assert_array_equal(step.argmax(-1).numpy(), row[-NEW:])
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


def _submit_all(engine, prompts, cfg):
    """Enqueue every prompt before the loop can admit one (the loop admits
    under the engine's condition lock), then collect the streams."""
    with engine._cv:
        streams = [engine.submit_stream(p, cfg) for p in prompts]
    return [np.concatenate([p, np.array(list(s), np.int32)])
            for p, s in zip(prompts, streams)]


SHARED = _prompts((16,), seed=5)[0]      # two blocks


def _case_prompts(case):
    if case == "paged":
        # a miss, then hits on the shared two blocks and on a whole prompt
        tails = _prompts((3, 9, 4, 1), seed=6)
        first = np.concatenate([SHARED, tails[0]])
        return [first] + [np.concatenate([SHARED, t]) for t in tails[1:]] + \
            [first]
    return _prompts((5, 17, 30, 9, 3, 12), seed=1)


def _run_case(case, jax_side):
    prompts = _case_prompts(case)
    plen = 0
    if jax_side:
        gen, cfg = _jax_gen(), JGCFG
        engine_cls, pool_cls = JaxEngine, JaxPool
    else:
        gen, cfg = _gen(), GCFG
        engine_cls, pool_cls = ContinuousBatchingEngine, KVBlockPool
    kw, pool = {}, None
    if case == "paged":
        pool_kw = dict(max_batch=2, block_size=BS)
        if not jax_side:
            pool_kw["device"] = "cpu"
        pool = pool_cls.for_generator(gen, **pool_kw)
        kw["kv_pool"] = pool
    if case in ("static_prefix", "packed_prefix"):
        kw["prefix"] = gen.cache_prefix(SHARED)
        plen = len(SHARED)
    if case.startswith("packed"):
        kw.update(packed_admission=True, packed_bucket=40)
    engine = engine_cls(gen, max_batch=4 if case.startswith("packed") else 2,
                        prompt_bucket=32, **kw)
    try:
        if case.startswith("packed"):
            outs = _submit_all(engine, prompts, cfg)
        else:
            outs = [engine.submit(p, cfg) for p in prompts]
        stats = pool.stats() if pool is not None else None
        return prompts, plen, outs, stats, engine.packed_admissions
    finally:
        engine.shutdown()


@pytest.mark.parametrize("case", ["unpaged", "paged", "static_prefix",
                                  "packed", "packed_prefix"])
def test_engine_matches_jax(case):
    prompts, plen, outs, stats, packed = _run_case(case, jax_side=False)
    _, _, ref, ref_stats, ref_packed = _run_case(case, jax_side=True)
    for o, r in zip(outs, ref):
        np.testing.assert_array_equal(o, np.asarray(r))
    contexts = [np.concatenate([SHARED[:plen], p]) for p in prompts]
    _assert_clear_margins(outs, contexts)
    assert stats == ref_stats
    assert packed == ref_packed
    if case == "paged":
        assert stats["prefix_hits"] == 4
    if case.startswith("packed"):
        assert packed >= 1


def test_paged_tokens_equal_unpaged():
    """Miss, full-prompt hit and partial hit: the paged engine's tokens are
    the unpaged engine's."""
    gen = _gen()
    unpaged = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32)
    pool = KVBlockPool.for_generator(gen, max_batch=2, block_size=BS,
                                     device="cpu")
    paged = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32,
                                     kv_pool=pool)
    p1 = _prompts((12,), seed=3)[0]
    p2 = np.concatenate([p1[:8], np.array([20, 21, 22], np.int32)])
    try:
        for p, hits in ((p1, 0), (p1, 1), (p2, 2)):
            np.testing.assert_array_equal(paged.submit(p, GCFG),
                                          unpaged.submit(p, GCFG))
            assert pool.stats()["prefix_hits"] == hits
    finally:
        unpaged.shutdown()
        paged.shutdown()


def test_cache_prefix_and_generate_with_prefix_match_jax():
    jgen, gen = _jax_gen(), _gen()
    suffixes = _prompts((4, 11, 0), seed=7)
    ref = jgen.generate(suffixes, JGCFG, prefix=jgen.cache_prefix(SHARED))
    handle = gen.cache_prefix(SHARED)
    out = gen.generate(suffixes, GCFG, prefix=handle)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, np.asarray(r))
    _assert_clear_margins(out, [np.concatenate([SHARED, s])
                                for s in suffixes])
    assert handle.length == len(SHARED)
    assert all(isinstance(c[2], int) for c in handle.caches)
    with pytest.raises(ValueError, match="another model"):
        gen.generate(suffixes, GCFG,
                     prefix=dataclasses.replace(handle, model=object()))


def test_prefix_handle_unchanged_after_two_admissions():
    gen = _gen()
    handle = gen.cache_prefix(SHARED)
    before = [(k.clone(), v.clone()) for (k, v, _i) in handle.caches]
    last = handle.last_logits.clone()
    engine = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32,
                                      prefix=handle)
    try:
        for p in _prompts((5, 13), seed=8):
            engine.submit(p, GCFG)
        assert engine.admissions == 2
    finally:
        engine.shutdown()
    for (k0, v0), (k, v, idx) in zip(before, handle.caches):
        assert torch.equal(k0, k) and torch.equal(v0, v)
        assert idx == len(SHARED)
    assert torch.equal(last, handle.last_logits)


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_queued_cancelled_request_is_never_admitted():
    engine = ContinuousBatchingEngine(_gen(), max_batch=1, prompt_bucket=8)
    try:
        done = []
        t = threading.Thread(target=lambda: done.append(engine.submit(
            np.array([1, 2], np.int32),
            GenerationConfig(max_new_tokens=40))))
        t.start()
        assert _wait(lambda: engine.admissions >= 1)
        it = engine.submit_stream(np.array([3, 4], np.int32),
                                  GenerationConfig(max_new_tokens=40))
        it.close()
        assert it._item["cancelled"] is True
        assert _wait(lambda: it._item["done"].is_set() and
                     len(engine._queue) == 0)
        t.join(timeout=120)
        assert not t.is_alive() and len(done[0]) == 42
        assert engine.admissions == 1, "a cancelled request was admitted"
        assert list(it) == []
    finally:
        engine.shutdown()


def test_mid_stream_close_frees_the_row():
    engine = ContinuousBatchingEngine(_gen(), max_batch=1, prompt_bucket=8)
    try:
        it = engine.submit_stream(np.array([5, 6], np.int32),
                                  GenerationConfig(max_new_tokens=50))
        assert isinstance(next(it), int)
        it.close()
        assert _wait(lambda: not engine._active.any())
        assert engine.decode_steps < 50
    finally:
        engine.shutdown()


def test_backpressure_on_a_tiny_pool_serializes_admissions():
    """One sequence's worth of blocks: concurrent submits wait for each
    other instead of failing, and give the unpaged engine's tokens."""
    gen = _gen()
    pool = KVBlockPool.for_generator(gen, max_batch=2, block_size=BS,
                                     num_blocks=2, prefix_reuse=False,
                                     device="cpu")
    engine = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32,
                                      kv_pool=pool)
    unpaged = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32)
    prompts = _prompts((3, 4, 5, 6), seed=9)
    try:
        want = [unpaged.submit(p, GCFG) for p in prompts]
        got = _submit_all(engine, prompts, GCFG)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
        assert pool.blocks_in_use() == 0
        assert engine.admissions == 4
    finally:
        engine.shutdown()
        unpaged.shutdown()


@pytest.mark.parametrize("jax_side", [False, True], ids=["port", "jax"])
def test_pool_exhausted_with_no_live_row_raises(jax_side):
    """Blocks held outside the engine, none by a live row: the engine
    cannot wait for a retirement and fails the request."""
    if jax_side:
        gen, cfg, eng_cls = _jax_gen(), JGCFG, JaxEngine
        pool = JaxPool.for_generator(gen, max_batch=1, block_size=BS,
                                     num_blocks=4, prefix_reuse=False)
        exhausted = JaxExhausted
    else:
        gen, cfg, eng_cls = _gen(), GCFG, ContinuousBatchingEngine
        pool = KVBlockPool.for_generator(gen, max_batch=1, block_size=BS,
                                         num_blocks=4, prefix_reuse=False,
                                         device="cpu")
        exhausted = KVPoolExhaustedError
    holder = pool.begin_sequence(np.arange(20, dtype=np.int32), 4)
    engine = eng_cls(gen, max_batch=1, prompt_bucket=32, kv_pool=pool)
    try:
        with pytest.raises(exhausted):
            engine.submit(np.array([1, 2, 3], np.int32), cfg)
        pool.release(holder, register=False)
        assert len(engine.submit(np.array([1, 2, 3], np.int32), cfg)) == \
            3 + NEW
    finally:
        engine.shutdown()


def test_admission_failure_fails_only_its_request(monkeypatch):
    gen = _gen()
    engine = ContinuousBatchingEngine(gen, max_batch=2, prompt_bucket=32)
    real = gen._run_bucketed_prefill

    def flaky(prompts, lengths, caches=None):
        if len(prompts[0]) == 7:
            raise RuntimeError("admission fault")
        return real(prompts, lengths, caches)

    monkeypatch.setattr(gen, "_run_bucketed_prefill", flaky)
    try:
        with pytest.raises(RuntimeError, match="admission fault"):
            engine.submit(np.arange(1, 8, dtype=np.int32), GCFG)
        out = engine.submit(np.arange(1, 5, dtype=np.int32), GCFG)
        assert len(out) == 4 + NEW
        assert engine.step_failures == 0
    finally:
        engine.shutdown()


def test_failed_tick_fails_the_live_rows(monkeypatch):
    engine = ContinuousBatchingEngine(_gen(), max_batch=2, prompt_bucket=32)

    def fault():
        raise RuntimeError("tick fault")

    monkeypatch.setattr(engine, "_tick_body", fault)
    try:
        with pytest.raises(RuntimeError, match="tick fault"):
            engine.submit(np.arange(1, 6, dtype=np.int32), GCFG)
        assert engine.step_failures == 1
        assert not engine._active.any()
    finally:
        engine.shutdown()


class _FakeGraph:
    """Stands in for a CUDA graph on the CPU: a replay runs the body it
    recorded."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body()


def test_decode_graph_is_captured_once_and_replayed_every_tick(monkeypatch):
    engine = ContinuousBatchingEngine(_gen(), max_batch=2, prompt_bucket=32)
    captured = []

    def capture():
        engine.decode_captures += 1
        captured.append(_FakeGraph(engine._tick_body))
        return captured[-1]

    monkeypatch.setattr(engine, "_capture", True)
    monkeypatch.setattr(engine, "_capture_tick", capture)
    ref = ContinuousBatchingEngine(_gen(), max_batch=2, prompt_bucket=32)
    prompts = _prompts((5, 9, 14, 3), seed=10)
    try:
        got = _submit_all(engine, prompts, GCFG)
        for g, p in zip(got, prompts):
            np.testing.assert_array_equal(g, ref.submit(p, GCFG))
        assert engine.decode_captures == 1 and len(captured) == 1
        assert engine.decode_replays == engine.decode_steps == \
            captured[0].replays
        assert engine.admissions == 4
    finally:
        engine.shutdown()
        ref.shutdown()


def test_failed_capture_fails_the_rows_and_never_runs_uncaptured(
        monkeypatch):
    engine = ContinuousBatchingEngine(_gen(), max_batch=2, prompt_bucket=32)
    ran = []
    monkeypatch.setattr(engine, "_capture", True)
    monkeypatch.setattr(engine, "_tick_body", lambda: ran.append(1))

    def fail():
        raise RuntimeError("capturing the decode tick as a CUDA graph "
                           "failed")

    monkeypatch.setattr(engine, "_capture_tick", fail)
    try:
        with pytest.raises(RuntimeError, match="CUDA graph failed"):
            engine.submit(np.arange(1, 6, dtype=np.int32), GCFG)
        assert engine.step_failures == 1 and not ran
        assert engine.decode_replays == 0
    finally:
        engine.shutdown()


def _read_sse(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    tokens, final = [], None
    with urllib.request.urlopen(req, timeout=60) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            event = json.loads(line[len("data: "):])
            if "token" in event:
                tokens.append(event["token"])
            else:
                final = event
    return tokens, final


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["output_ids"][0]


@pytest.mark.parametrize("paged", [False, True], ids=["prefix", "paged"])
def test_sse_over_http_equals_the_non_streamed_answer(paged, monkeypatch):
    """A system prompt registered with the model: as a static prefix
    (requests send suffixes) or warmed into the block pool (requests send
    full prompts).  Each streamed answer equals the non-streamed one and
    the JAX engine's."""
    monkeypatch.setattr(global_config, "kv_paged", paged)
    monkeypatch.setattr(global_config, "kv_block_size", BS)
    suffixes = _prompts((4, 9, 13), seed=11)
    bodies = [{"model": "m", "max_new_tokens": NEW,
               "prompt_ids": (np.concatenate([SHARED, s]) if paged else s
                              ).tolist()} for s in suffixes]
    jgen = _jax_gen()
    jengine = JaxEngine(jgen, max_batch=2, prompt_bucket=64,
                        prefix=jgen.cache_prefix(SHARED))
    try:
        ref = [np.asarray(jengine.submit(s, JGCFG))[-NEW:]
               for s in suffixes]
    finally:
        jengine.shutdown()
    server = run_controller(port=0, device="cpu")
    try:
        gen = server.controller.register_model("m", _gen(),
                                               prefix_ids=SHARED)
        streamed = [None] * len(bodies)

        def call(i):
            streamed[i] = _read_sse(server.port, bodies[i])

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for (tokens, final), body, want in zip(streamed, bodies, ref):
            assert final == {"done": True}
            assert tokens == want.tolist()
            assert _post(server.port, body) == body["prompt_ids"] + tokens
        _assert_clear_margins(
            [np.asarray(b["prompt_ids"] + t) for (t, _), b in
             zip(streamed, bodies)],
            [np.concatenate([SHARED, s]) for s in suffixes])
        engine = server.controller._models["m"][0].engine
        assert engine.admissions == 3 and engine.step_failures == 0
        if paged:
            assert engine._pool.stats()["prefix_hits"] == 3
            assert engine._pool.stats()["pinned_entries"] == 2
        else:
            assert engine._prefix is not None and gen.prefill_chunk == BS
    finally:
        server.shutdown()


def test_server_shutdown_stops_the_batcher_and_engine_threads():
    """The worker threads hold the generator and its weights: shutting the
    server down ends them, and a later request fails instead of waiting
    for a thread that is gone."""
    server = run_controller(port=0, device="cpu")
    server.controller.register_model("m", _gen())
    replica = server.controller._models["m"][0]
    engine = replica.engine
    assert _post(server.port, {"model": "m", "prompt_ids": [1, 2, 3],
                               "max_new_tokens": 2})[:3] == [1, 2, 3]
    server.shutdown()
    for thread in (replica.batcher._thread, engine._thread):
        thread.join(timeout=30)
        assert not thread.is_alive()
    with pytest.raises(RuntimeError, match="engine shut down"):
        engine.submit(np.array([1, 2], np.int32), GCFG)
    with pytest.raises(RuntimeError, match="batcher shut down"):
        replica.batcher.submit([np.array([1, 2])], GCFG)
