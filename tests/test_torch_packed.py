"""The port's packed prefill against the JAX package's, in fp32 from the
same weights: ``pack_prompts`` gives the same arrays; ``GPTModel`` with
``segment_ids`` gives the same logits, with and without caches; and
``PackedPrefill`` gives the same last logits and row caches (to 1e-5),
with and without a shared prefix.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve.generation import Generator as JaxGenerator
from alpa_tpu.serve.packed import PackedPrefill as JaxPackedPrefill
from alpa_tpu.serve.packed import pack_prompts as jax_pack_prompts
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import Generator, PackedPrefill, pack_prompts

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=64,
             vocab_size=128, activation="relu", pos_offset=2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jgm.GPTConfig(**SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(1))
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE)
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    return jmodel, params, jcfg, tmodel, tcfg


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SHAPE["vocab_size"], n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("lengths", [(5,), (3, 7, 1), (10, 10, 10, 2)])
def test_pack_prompts_equals_jax(lengths):
    prompts = _prompts(lengths)
    got = pack_prompts(prompts, 40, 4)
    want = jax_pack_prompts(prompts, 40, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceeds bucket"):
        pack_prompts(prompts, sum(lengths) - 1, 4)


def _close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_segment_ids_forward_equals_jax(with_cache):
    jmodel, params, jcfg, tmodel, tcfg = _models()
    ids, seg, pos, _, _ = pack_prompts(_prompts((6, 9, 4)), 24, 4)
    if with_cache:
        # the packed chunk over a 16-token prefix written at offset 16
        pre = _prompts((16,), seed=2)[0][None]
        jcaches = jgm.init_kv_caches(jcfg, 1)
        _, jcaches = jmodel.apply(params, jnp.asarray(pre), None, jcaches)
        jcaches = [(k, v, jnp.int32(16)) for (k, v, _i) in jcaches]
        want, _ = jmodel.apply(params, jnp.asarray(ids),
                               jnp.asarray(pos + 16), jcaches,
                               segment_ids=jnp.asarray(seg))
        caches = tgm.init_kv_caches(tcfg, 1)
        with torch.inference_mode():
            _, caches = tmodel(torch.from_numpy(pre).long(), None, caches)
            caches = [(k, v, 16) for (k, v, _i) in caches]
            got, _ = tmodel(torch.from_numpy(ids).long(),
                            torch.from_numpy(pos + 16).long(), caches,
                            segment_ids=torch.from_numpy(seg).long())
    else:
        want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(pos),
                            segment_ids=jnp.asarray(seg))
        with torch.inference_mode():
            got = tmodel(torch.from_numpy(ids).long(),
                         torch.from_numpy(pos).long(),
                         segment_ids=torch.from_numpy(seg).long())
    valid = seg[0] >= 0
    _close(got[0][torch.from_numpy(valid)], np.asarray(want)[0][valid])


def test_segment_ids_need_a_scalar_cache_index():
    _, _, _, tmodel, tcfg = _models()
    caches = [(k, v, torch.zeros(1, dtype=torch.long))
              for (k, v, _i) in tgm.init_kv_caches(tcfg, 1)]
    with pytest.raises(ValueError, match="scalar"):
        tmodel(torch.ones(1, 4, dtype=torch.long), None, caches,
               segment_ids=torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("with_prefix", [False, True],
                         ids=["plain", "prefix"])
def test_packed_prefill_equals_jax(with_prefix):
    jmodel, params, jcfg, tmodel, tcfg = _models()
    prompts = _prompts((7, 12, 3), seed=3)
    jprefix = prefix = None
    if with_prefix:
        pre = _prompts((16,), seed=4)[0]
        jprefix = JaxGenerator(jmodel, params, jcfg,
                               prefill_chunk=8).cache_prefix(pre)
        prefix = Generator(tmodel, tcfg, prefill_chunk=8,
                           device="cpu").cache_prefix(pre)
    jpack = JaxPackedPrefill(jmodel, params, jcfg, total_bucket=32,
                             max_rows=4, prefix=jprefix)
    pack = PackedPrefill(tmodel, tcfg, total_bucket=32, max_rows=4,
                         prefix=prefix)
    want_last, want_rows = jpack(prompts)
    last, rows = pack(prompts)
    n = len(prompts)
    _close(last[:n], np.asarray(want_last)[:n])
    for (k, v, idx), (jk, jv, jidx) in zip(rows, want_rows):
        assert k.shape == (4, SHAPE["seq_len"], 4, 16)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(k[:n], np.asarray(jk)[:n])
        _close(v[:n], np.asarray(jv)[:n])
    if prefix is not None:
        # the handle is copied, never written
        assert all(c[2] == 16 for c in prefix.caches)
        fresh = Generator(tmodel, tcfg, prefill_chunk=8,
                          device="cpu").cache_prefix(pre)
        for (k, v, _i), (fk, fv, _j) in zip(prefix.caches, fresh.caches):
            assert torch.equal(k, fk) and torch.equal(v, fv)
    assert pack.calls == 1
