"""Disaggregated prefill/decode in the port (``serve/disagg.py``, the
engine's prefilled admission, the controller's ``/disagg/*`` surface and
the router's disaggregated path), on a 2-layer OPT-style model at hidden
64 in fp32 whose weights come from the JAX package (scaled by 8 so that
greedy tokens vary; ``model/convert.py``).

Exact comparisons: a disaggregated stream equals the port's monolithic
engine token for token on a miss, a full hit and a shared prefix; an
artifact built by the JAX package's ``PrefillEngine`` ingests in the port
and gives the JAX monolithic engine's tokens; a re-ingest after a decode
replica dies gives the same tokens.  The int8 handoff is held to 4 x
``reshard_codec.ERROR_BOUND["int8"]`` of each layer's largest magnitude
(per-block scales and a bf16/fp32 round trip, as the JAX test holds it).
"""
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve import disagg as jdisagg
from alpa_tpu.serve.engine import ContinuousBatchingEngine as JaxEngine
from alpa_tpu.serve.generation import GenerationConfig as JaxGenCfg
from alpa_tpu.serve.generation import Generator as JaxGenerator
from alpa_tpu_torch import fault
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.pipeline_parallel import reshard_codec
from alpa_tpu_torch.serve import disagg
from alpa_tpu_torch.serve.controller import Controller
from alpa_tpu_torch.serve.engine import ContinuousBatchingEngine
from alpa_tpu_torch.serve.generation import GenerationConfig, Generator
from alpa_tpu_torch.serve.kv_cache import KVBlockPool
from alpa_tpu_torch.serve.router import LocalReplicaHandle, Router
from alpa_tpu_torch.serve.scheduler import WeightedFairQueue

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=64,
             vocab_size=128, activation="relu", pos_offset=2)
BS = 8
PROMPT = np.array([5, 9, 3, 7, 1, 2, 8, 4, 6, 11, 13, 2], np.int32)
GCFG = GenerationConfig(max_new_tokens=6)
REQ = {"model": "m", "prompt_ids": PROMPT.tolist(), "max_new_tokens": 6}


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = jgm.GPTConfig(attention_impl="flash", **SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x, np.float32) if "ln" in
        jax.tree_util.keystr(path) else np.asarray(x, np.float32) * 8.0,
        params)
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE)
    sd = gpt_params_from_flax(params, tcfg, "cpu")
    return jmodel, params, jcfg, tcfg, sd


def _gen(prefill_chunk=BS):
    """A port generator of its own (a hot swap writes in place)."""
    _, _, _, tcfg, sd = _weights()
    model = tgm.GPTModel(tcfg)
    model.load_state_dict(sd)
    return Generator(model, tcfg, prefill_chunk=prefill_chunk, device="cpu")


def _paged_engine(block_size=BS):
    gen = _gen()
    pool = KVBlockPool.for_generator(gen, max_batch=2, block_size=block_size)
    return ContinuousBatchingEngine(gen, max_batch=2, kv_pool=pool)


@pytest.fixture
def paged():
    saved = (global_config.kv_paged, global_config.kv_prefix_reuse,
             global_config.kv_block_size)
    global_config.kv_paged = global_config.kv_prefix_reuse = True
    global_config.kv_block_size = BS
    yield
    (global_config.kv_paged, global_config.kv_prefix_reuse,
     global_config.kv_block_size) = saved


def _artifact(codec="off", prompt=PROMPT):
    pe = disagg.PrefillEngine(_gen(), model="m", codec=codec)
    try:
        return pe.prefill(prompt, GCFG)
    finally:
        pe.shutdown()


class TestArtifact:

    def test_wire_round_trip_identical(self):
        art = _artifact()
        wire = art.to_wire()
        back = disagg.KVHandoffArtifact.from_wire(wire)
        assert back.request_id == art.request_id
        np.testing.assert_array_equal(back.prompt, art.prompt)
        assert torch.equal(back.last_logits, art.last_logits)
        for lay_a, lay_b in zip(art.layers, back.layers):
            for key in lay_a:
                assert torch.equal(lay_a[key], lay_b[key])
        assert back.block_hashes == art.block_hashes
        assert back.to_wire() == wire
        # the JAX package reads the port's wire form and checks its hashes
        jart = jdisagg.KVHandoffArtifact.from_wire(wire)
        assert jart.block_hashes == art.block_hashes
        bs = art.block_size
        assert wire["layers"][0]["k"]["shape"] == [-(-len(PROMPT) // bs), bs,
                                                   4, 16]

    def test_bf16_payload_crosses_the_wire(self):
        kb = torch.randn(2, BS, 4, 16, generator=torch.Generator()
                         .manual_seed(0)).to(torch.bfloat16)
        art = disagg.KVHandoffArtifact.build(
            "r", "m", PROMPT, {}, None, "", BS, [(kb, kb + 1)],
            torch.zeros(1, 8))
        wire = art.to_wire()
        assert wire["kv_dtype"] == "bfloat16"
        back = disagg.KVHandoffArtifact.from_wire(wire)
        assert back.layers[0]["k"].dtype == torch.bfloat16
        assert torch.equal(back.layers[0]["v"], kb + 1)

    def test_flipped_block_hash_rejected(self):
        wire = _artifact().to_wire()
        wire["block_hashes"][0] = "0" * 64
        with pytest.raises(disagg.ArtifactCorruptError):
            disagg.KVHandoffArtifact.from_wire(wire)

    def test_corrupt_payload_rejected(self):
        wire = _artifact().to_wire()
        data = wire["layers"][0]["k"]["data"]
        wire["layers"][0]["k"]["data"] = \
            ("A" if data[0] != "A" else "B") + data[1:]
        with pytest.raises(disagg.ArtifactCorruptError):
            disagg.KVHandoffArtifact.from_wire(wire)

    def test_malformed_wire_rejected(self):
        wire = _artifact().to_wire()
        del wire["layers"]
        with pytest.raises(disagg.ArtifactCorruptError):
            disagg.KVHandoffArtifact.from_wire(wire)

    def test_codec_int8_round_trip_within_bound(self):
        raw = _artifact("off")
        art = _artifact("int8")
        assert "k_q" in art.layers[0] and art.codec == "int8"
        assert art.payload_nbytes < raw.payload_nbytes / 3
        back = disagg.KVHandoffArtifact.from_wire(art.to_wire())
        for i, lay in enumerate(raw.layers):
            tail = tuple(lay["k"].shape[2:])
            kq, vq = back.dense_rows(i, tail)
            for got, want in ((kq, lay["k"]), (vq, lay["v"])):
                want = want.reshape((-1,) + tail)
                scale = float(want.abs().max()) or 1.0
                err = float((got - want).abs().max()) / scale
                assert err <= reshard_codec.ERROR_BOUND["int8"] * 4
        back.verify()


class TestBitExact:

    def test_miss_full_hit_shared_prefix(self):
        mono = _paged_engine()
        dec = _paged_engine()
        gen = _gen()
        # block size 4: the 8-token shared prefix spans whole blocks, so
        # the later prefills take the gather + chunked-suffix hit path
        pool = KVBlockPool.for_generator(gen, block_size=4, prefix_reuse=True)
        pe = disagg.PrefillEngine(gen, model="m", kv_pool=pool)
        try:
            p2 = np.concatenate([PROMPT[:8], np.array([21, 22, 23, 24],
                                                      np.int32)])
            for label, p in (("miss", PROMPT), ("shared-prefix", p2),
                             ("full-hit", PROMPT)):
                ref = mono.submit(p, GCFG)
                art = disagg.KVHandoffArtifact.from_wire(
                    pe.prefill(p, GCFG).to_wire())
                np.testing.assert_array_equal(disagg.ingest(dec, art), ref,
                                              err_msg=label)
            assert pool.stats()["prefix_hits"] == 2
        finally:
            pe.shutdown()
            mono.shutdown()
            dec.shutdown()

    def test_decode_side_registers_prefix_chain(self):
        dec = _paged_engine()
        pe = disagg.PrefillEngine(_gen(), model="m")
        try:
            disagg.ingest(dec, pe.prefill(PROMPT, GCFG))
            hits = dec._pool.stats()["prefix_hits"]
            dec.submit(PROMPT, GCFG)
            assert dec._pool.stats()["prefix_hits"] > hits
        finally:
            pe.shutdown()
            dec.shutdown()

    def test_jax_artifact_ingests_in_the_port(self):
        jmodel, params, jcfg, _, _ = _weights()
        jgen = JaxGenerator(jmodel, params, jcfg, prefill_chunk=BS)
        jpe = jdisagg.PrefillEngine(jgen, model="m")
        jmono = JaxEngine(jgen, max_batch=2)
        dec = ContinuousBatchingEngine(_gen(), max_batch=2)
        try:
            jcfg_gen = JaxGenCfg(max_new_tokens=6)
            wire = jpe.prefill(PROMPT, jcfg_gen).to_wire()
            ref = np.asarray(jmono.submit(PROMPT, jcfg_gen))
            art = disagg.KVHandoffArtifact.from_wire(wire)
            assert art.block_size == jpe.pool.block_size
            np.testing.assert_array_equal(disagg.ingest(dec, art), ref)
            np.testing.assert_array_equal(dec.submit(PROMPT, GCFG), ref)
        finally:
            jpe.shutdown()
            jmono.shutdown()
            dec.shutdown()

    def test_prefilled_row_joins_without_a_new_capture(self):
        """The prefilled admission writes the resident buffers in place:
        an engine mid-stream admits it between two ticks, and the other
        rows' tokens do not change."""
        dec = ContinuousBatchingEngine(_gen(), max_batch=2)
        other = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
        try:
            ref_other = dec.submit(other, GenerationConfig(max_new_tokens=12))
            stream = dec.submit_stream(other, GenerationConfig(
                max_new_tokens=12))
            first = [next(stream) for _ in range(3)]
            art = _artifact()
            tokens = list(disagg.ingest_stream(dec, art))
            rest = list(stream)
            np.testing.assert_array_equal(
                np.concatenate([other, first + rest]), ref_other)
            np.testing.assert_array_equal(
                np.concatenate([PROMPT, tokens]), dec.submit(PROMPT, GCFG))
            assert dec.decode_captures == 0 and dec.step_failures == 0
        finally:
            dec.shutdown()


def _fleet(n_decode=2, **router_kw):
    """One prefill and ``n_decode`` decode controllers behind a router."""
    cp = Controller(device="cpu")
    cp.register_model("m", _gen())
    r = Router(disagg_mode="auto", **router_kw)
    r.add_replica("p0", LocalReplicaHandle(cp), phase="prefill")
    decs = []
    for i in range(n_decode):
        cd = Controller(device="cpu")
        cd.register_model("m", _gen())
        r.add_replica(f"d{i}", LocalReplicaHandle(cd), phase="decode")
        decs.append(cd)
    return r, cp, decs


def _monolithic_answer():
    c0 = Controller(device="cpu")
    c0.register_model("m", _gen())
    r0 = Router(disagg_mode="off")
    r0.add_replica("solo", LocalReplicaHandle(c0))
    return r0.submit(dict(REQ))


class TestRouterDisagg:

    def test_router_disagg_matches_monolithic(self, paged):
        ref = _monolithic_answer()
        r, _, _ = _fleet()
        assert r.snapshot()["disagg"]["active"]
        assert r.submit(dict(REQ)) == ref
        assert r.disagg_handoffs == 1

    def test_mode_off_is_the_monolithic_path(self, paged):
        c0 = Controller(device="cpu")
        c0.register_model("m", _gen())
        r = Router(disagg_mode="off")
        r.add_replica("a", LocalReplicaHandle(c0), phase="prefill")
        assert not r._disagg_active()
        out = r.submit(dict(REQ))
        assert out["output_ids"][0][:len(PROMPT)] == PROMPT.tolist()
        assert r.disagg_handoffs == 0

    def test_auto_needs_both_pools(self, paged):
        c0 = Controller(device="cpu")
        c0.register_model("m", _gen())
        r = Router(disagg_mode="auto")
        r.add_replica("p0", LocalReplicaHandle(c0), phase="prefill")
        assert not r._disagg_active()

    def test_ack_releases_the_retained_artifact(self, paged):
        r, cp, _ = _fleet()
        r.submit(dict(REQ))
        pe = cp._models["m"][0]._prefill_engine
        with pe._cv:
            assert len(pe._retained) == 0

    def test_backpressure_throttles_prefill_admission(self, paged):
        r, _, _ = _fleet(disagg_backpressure_depth=1)
        for name in ("d0", "d1"):
            r._replicas[name].inflight = 5
        with pytest.raises(fault.ServiceDegradedError, match="backpressure"):
            r.submit(dict(REQ))
        assert r.disagg_backpressure_sheds == 1
        for name in ("d0", "d1"):
            r._replicas[name].inflight = 0
        assert r.submit(dict(REQ))["output_ids"]


class _DyingIter:
    def __next__(self):
        raise ConnectionError("decode replica died mid-stream")

    def __iter__(self):
        return self

    def close(self):
        pass


class TestFailover:

    def test_decode_death_at_ingest_reingests(self, paged):
        ref = _monolithic_answer()
        r, _, _ = _fleet()
        st = r._replicas["d0"]
        real = st.handle

        class DeadIngest:
            def __getattr__(self, k):
                if k == "ingest":
                    def boom(wire):
                        raise ConnectionError("decode replica down")
                    return boom
                return getattr(real, k)
        st.handle = DeadIngest()
        assert r.submit(dict(REQ)) == ref
        assert r.disagg_reingests == 1 and st.fails == 1

    def test_decode_death_mid_stream_reingests(self, paged):
        ref = _monolithic_answer()["output_ids"][0]
        r, _, _ = _fleet()
        stream = r.submit_stream(dict(REQ, stream=True))
        toks = [next(stream), next(stream)]
        died = stream._dst.name
        stream._inner = _DyingIter()
        toks.extend(stream)
        assert PROMPT.tolist() + toks == ref
        assert r.disagg_reingests == 1 and stream._dst.name != died

    def test_corrupt_artifact_refetched_never_decoded(self, paged):
        ref = _monolithic_answer()
        r, _, decs = _fleet(n_decode=1)
        st = r._replicas["d0"]
        real = st.handle
        flips = {"n": 0}

        class CorruptingWire:
            """Flip a block hash of the first wire copy only."""

            def __getattr__(self, k):
                if k == "ingest":
                    def ingest(wire):
                        if flips["n"] == 0:
                            flips["n"] += 1
                            wire = dict(wire, block_hashes=["f" * 64] +
                                        wire["block_hashes"][1:])
                        return real.ingest(wire)
                    return ingest
                return getattr(real, k)
        st.handle = CorruptingWire()
        assert r.submit(dict(REQ)) == ref
        assert flips["n"] == 1 and r.disagg_reingests == 1
        # the corrupt copy never reached the decode engine
        assert decs[0]._models["m"][0]._engine.admissions == 1

    def test_sampled_stream_propagates_decode_death(self, paged):
        r, _, _ = _fleet()
        stream = r.submit_stream(dict(REQ, stream=True, do_sample=True,
                                      temperature=0.7))
        next(stream)
        stream._inner = _DyingIter()
        with pytest.raises(ConnectionError):
            list(stream)


class TestFairness:
    """A tenant's weight holds on the prefill pool: the order in which the
    worker takes queued requests is read where it takes them, so the check
    does not hang on which thread wakes first."""

    def test_weighted_tenant_jumps_a_flooded_queue(self):
        pe = disagg.PrefillEngine(_gen(), model="m", scheduler=(
            WeightedFairQueue({"paid": 8, "flood": 1})))
        taken = []
        gate = threading.Event()
        orig = pe._prefill_one

        def gated(item):
            taken.append(item["queue"])
            if len(taken) == 1:
                # park the worker in the first request while the others
                # queue up behind it
                gate.wait(timeout=60)
            return orig(item)
        pe._prefill_one = gated

        def one(tenant, i):
            pe.prefill(PROMPT, GCFG, queue=tenant,
                       request_id=f"{tenant}-{i}")

        def wait_depth(n):
            deadline = time.monotonic() + 60
            while pe.queue_depth() < n:
                assert time.monotonic() < deadline, pe.queue_depth()
                time.sleep(0.001)
        threads = [threading.Thread(target=one, args=("flood", 99))]
        try:
            threads[0].start()
            while not taken:
                time.sleep(0.001)
            for i in range(6):
                threads.append(threading.Thread(target=one,
                                                args=("flood", i)))
                threads[-1].start()
            wait_depth(6)
            threads.append(threading.Thread(target=one, args=("paid", 0)))
            threads[-1].start()
            wait_depth(7)
        finally:
            gate.set()
            for t in threads:
                t.join(timeout=60)
            pe.shutdown()
        assert len(taken) == 8
        # weight 8 against 1: the paid request is taken right after the
        # one in flight, not behind the six queued floods
        assert taken.index("paid") == 1, taken

    def test_queue_tag_rides_the_artifact(self):
        pe = disagg.PrefillEngine(_gen(), model="m")
        try:
            art = pe.prefill(PROMPT, GCFG, queue="tenant-a")
        finally:
            pe.shutdown()
        back = disagg.KVHandoffArtifact.from_wire(art.to_wire())
        assert back.queue == "tenant-a"
