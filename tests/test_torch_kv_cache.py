"""The port's paged KV block pool against the JAX package's: one script of
``begin_sequence``/``release``/``register_prompt``/``fork``/
``ensure_writable``/``warm_prefix`` calls on both gives the same block
ids, refcounts, matched tokens, chain keys, hits, bytes saved and
evictions; the blocks a warmed prefix fills hold the JAX pool's values to
1e-5 (fp32); gather, scatter, token writes and copy-on-write move the bits
unchanged.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve.generation import Generator as JaxGenerator
from alpa_tpu.serve.kv_cache import KVBlockPool as JaxPool
from alpa_tpu.serve.kv_cache import KVPoolExhaustedError as JaxExhausted
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import Generator, KVBlockPool, KVPoolExhaustedError
from alpa_tpu_torch.serve.kv_cache import stacked_kv_caches

SHAPE = dict(hidden_size=32, num_layers=2, num_heads=4, seq_len=32,
             vocab_size=64)
BS = 8   # seq_len 32: four blocks per sequence


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _generators():
    jcfg = jgm.GPTConfig(**SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    tcfg = tgm.GPTConfig(**SHAPE)
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    return (JaxGenerator(jmodel, params, jcfg, prefill_chunk=BS),
            Generator(tmodel, tcfg, prefill_chunk=BS, device="cpu"))


def _pools(**kw):
    jgen, tgen = _generators()
    return (JaxPool(jgen.config, block_size=BS, **kw),
            KVBlockPool(tgen.config, block_size=BS, device="cpu", **kw))


def _toks(*vals):
    return np.array(vals, np.int32)


def _state(pool, seqs):
    """Everything the bookkeeping decides, comparable across packages."""
    return {"stats": pool.stats(), "rc": pool._rc.tolist(),
            "free": list(pool._free), "keys": list(pool._entries),
            "blocks": [e.block for e in pool._entries.values()],
            "pinned": [e.pinned for e in pool._entries.values()],
            "tables": {k: (list(s.ids), s.matched_tokens, s.prompt_len,
                           s.capacity_tokens) if s is not None else None
                       for k, s in seqs.items()}}


def _script(pool, gen, is_jax):
    """Reserve, publish, reuse, fork, copy on write, evict and warm, with
    the state after every call."""
    seqs, states = {}, []

    def rec():
        states.append(_state(pool, seqs))

    a = np.arange(1, 21, dtype=np.int32)          # 20 tokens
    seqs["a"] = pool.begin_sequence(a, 4)
    rec()
    pool.register_prompt(seqs["a"], a)
    rec()
    seqs["b"] = pool.begin_sequence(a, 4)         # live prompt hit
    rec()
    b2 = np.concatenate([a[:8], _toks(50, 51, 52, 53, 54, 55, 56, 57, 58)])
    seqs["c"] = pool.begin_sequence(b2, 2)        # one shared block
    rec()
    seqs["d"] = pool.fork(seqs["c"])
    rec()
    pool.ensure_writable(seqs["d"], 0)            # shared -> private copy
    rec()
    pool.ensure_writable(seqs["d"], 0)            # now exclusive
    rec()
    done = np.concatenate([b2, _toks(60, 61, 62, 63, 1, 2, 3)])
    pool.release(seqs.pop("c"), tokens=done, register=True)
    rec()
    pool.release(seqs.pop("d"), register=False)
    pool.release(seqs.pop("b"), tokens=np.concatenate([a, _toks(9, 9)]))
    rec()
    # pressure: the LRU leaves go first, never a live block
    seqs["big"] = pool.begin_sequence(np.arange(30, 50, dtype=np.int32), 10)
    rec()
    seqs["none"] = pool.begin_sequence(np.arange(40, 60, dtype=np.int32), 8)
    rec()
    pool.release(seqs.pop("big"), register=False)
    pool.release(seqs.pop("a"), register=False)
    seqs.pop("none")
    rec()
    assert pool.warm_prefix(gen, np.arange(3, 22, dtype=np.int32)) == 16
    rec()
    seqs["w"] = pool.begin_sequence(np.arange(3, 30, dtype=np.int32), 2)
    rec()
    exhausted = JaxExhausted if is_jax else KVPoolExhaustedError
    with pytest.raises(exhausted):
        pool.begin_sequence(np.arange(60), 70)
    return states


def test_bookkeeping_equals_jax_over_one_call_script():
    jgen, tgen = _generators()
    jpool, tpool = _pools(num_blocks=8)
    want = _script(jpool, jgen, True)
    got = _script(tpool, tgen, False)
    assert len(got) == len(want) == 14
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"state after call {step} differs"
    final = got[-1]["stats"]
    assert final["prefix_hits"] == 3 and final["evictions"] == 2
    assert final["pinned_entries"] == 2
    assert final["bytes_saved"] == 5 * BS * tpool.token_bytes
    assert got[10]["tables"]["none"] is None     # transient backpressure
    assert tpool.token_bytes == jpool.token_bytes


def test_warmed_blocks_hold_the_jax_values():
    jgen, tgen = _generators()
    jpool, tpool = _pools(num_blocks=6)
    ids = np.arange(5, 30, dtype=np.int32)
    assert jpool.warm_prefix(jgen, ids) == tpool.warm_prefix(tgen, ids) == 24
    for jk, jv, tk, tv in zip(jpool._kp, jpool._vp, tpool._kp, tpool._vp):
        assert tk.shape == jk.shape == (7, BS, 4, 8)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                   rtol=1e-5)


def test_gather_scatter_write_and_copy_move_the_bits():
    _, tgen = _generators()
    pool = KVBlockPool(tgen.config, block_size=BS, num_blocks=12,
                       device="cpu")
    gen = torch.Generator().manual_seed(0)
    dense, _ = stacked_kv_caches(tgen.config, 1)
    dense.copy_(torch.randn(dense.shape, generator=gen))
    toks = np.arange(1, 20, dtype=np.int32)          # 19 tokens: 3 blocks
    seq = pool.begin_sequence(toks, 6)
    pool.scatter_prompt(seq, dense)
    for i, b in enumerate(seq.ids[:3]):
        assert torch.equal(pool._kv[:, :, b],
                           dense[:, :, 0, i * BS:(i + 1) * BS])
    pool.release(seq, tokens=toks)
    hit = pool.begin_sequence(toks, 6)
    assert hit.matched_tokens == 16
    out, _ = stacked_kv_caches(tgen.config, 1)
    caches = pool.gather_dense(hit, out=out)
    assert all(c[2] == 16 for c in caches)
    assert torch.equal(out[:, :, 0, :16], dense[:, :, 0, :16])
    assert not out[:, :, 0, 16:].any()
    blocks = pool.gather_blocks(hit, 2)
    np.testing.assert_array_equal(
        blocks[1][0].reshape(16, 4, 8), dense[0, 1, 0, :16].numpy())
    # a decode tick's K/V at row 1, position 19 -> block 2, offset 3
    batch, _ = stacked_kv_caches(tgen.config, 2)
    batch.copy_(torch.randn(batch.shape, generator=gen))
    pool.write_tokens(batch, [None, hit], np.array([0, 19]))
    assert torch.equal(pool._kv[:, :, hit.ids[2], 3], batch[:, :, 1, 19])
    assert pool.write_calls == 1 and pool.write_seconds > 0
    with pytest.raises(AssertionError, match="past its reserved"):
        pool.write_tokens(batch, [None, hit], np.array([0, 32]))
    twin = pool.fork(hit)
    src = twin.ids[2]
    dst = pool.ensure_writable(twin, 2)
    assert dst != src and torch.equal(pool._kv[:, :, dst],
                                      pool._kv[:, :, src])


def test_pool_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tgen = _generators()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVBlockPool(tgen.config, block_size=BS)
    assert KVBlockPool.for_generator(tgen, block_size=BS).device.type == \
        "cpu"


@pytest.mark.parametrize("kw", [dict(block_size=5), dict(block_size=-8)])
def test_bad_block_size_raises_as_in_jax(kw):
    jgen, tgen = _generators()
    with pytest.raises(ValueError):
        JaxPool(jgen.config, **kw)
    with pytest.raises(ValueError):
        KVBlockPool(tgen.config, device="cpu", **kw)
