"""The port's GPT model against the flax model, from the same weights.

Weights come from the JAX package's ``init_gpt_real`` and are converted
with ``gpt_params_from_flax``; token ids come from numpy with a seed.
fp32 logits agree to atol 1e-4 (logits are O(1); the two frameworks sum
in different orders).  One bf16 case is held to atol 0.05: the same cast
points, but each side rounds its fp32 sums to bf16 in its own order; 0.05
is three bf16 ulps at the logits' magnitude (|logit| < 4, ulp 2**-6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax

ATOL = 1e-4
SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=128,
             vocab_size=256)
# GPT-2 style (gelu, no offset) and OPT style (relu, positions + 2)
FAMILIES = {"gpt": {}, "opt": dict(activation="relu", pos_offset=2)}


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _pair(family="gpt", impl="reference", jdtype=jnp.float32,
          tdtype=torch.float32, seed=0):
    """(jax model, jax params, jax config, port model, port config), built
    once per argument set; the tests never modify the weights."""
    kw = dict(SHAPE, **FAMILIES[family])
    jcfg = jgm.GPTConfig(dtype=jdtype, attention_impl=impl, **kw)
    jmodel, params = jgm.init_gpt_real(jcfg, 2, jax.random.PRNGKey(seed))
    tcfg = tgm.GPTConfig(dtype=tdtype, attention_impl=impl, **kw)
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    return jmodel, params, jcfg, tmodel.eval(), tcfg


def _ids(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, SHAPE["vocab_size"], (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_cache_free_logits(family, impl):
    jmodel, params, _, tmodel, _ = _pair(family, impl)
    ids = _ids(2, 48)
    ref = jmodel.apply(params, jnp.asarray(ids))
    with torch.inference_mode():
        out = tmodel(_t(ids))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=0)


def test_untied_lm_head():
    kw = dict(SHAPE, tie_embeddings=False)
    jcfg, tcfg = jgm.GPTConfig(**kw), tgm.GPTConfig(**kw)
    jmodel, params = jgm.init_gpt_real(jcfg, 2, jax.random.PRNGKey(4))
    tmodel = tgm.GPTModel(tcfg)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    ids = _ids(2, 16, seed=4)
    with torch.inference_mode():
        out = tmodel(_t(ids))
    np.testing.assert_allclose(out.numpy(),
                               _np(jmodel.apply(params, jnp.asarray(ids))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_prefill_logits_and_caches_at_index_zero(impl):
    jmodel, params, jcfg, tmodel, tcfg = _pair("opt", impl)
    ids = _ids(2, 32, seed=1)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    j_logits, j_caches = jmodel.apply(params, jnp.asarray(ids),
                                      jnp.asarray(pos),
                                      jgm.init_kv_caches(jcfg, 2))
    with torch.inference_mode():
        t_logits, t_caches = tmodel(_t(ids), _t(pos),
                                    tgm.init_kv_caches(tcfg, 2))
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)
    for (tk, tv, ti), (jk, jv, ji) in zip(t_caches, j_caches):
        assert ti == int(ji) == 32
        np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_chunked_prefill_at_nonzero_start(impl):
    """A second 16-token chunk written at scalar cache index 16."""
    jmodel, params, jcfg, tmodel, tcfg = _pair("gpt", impl)
    ids = _ids(2, 32, seed=2)
    j_caches = jgm.init_kv_caches(jcfg, 2)
    t_caches = tgm.init_kv_caches(tcfg, 2)
    for start in (0, 16):
        chunk = ids[:, start:start + 16]
        pos = np.broadcast_to(np.arange(start, start + 16, dtype=np.int32),
                              (2, 16))
        j_logits, j_caches = jmodel.apply(params, jnp.asarray(chunk),
                                          jnp.asarray(pos), j_caches)
        with torch.inference_mode():
            t_logits, t_caches = tmodel(_t(chunk), _t(pos), t_caches)
        assert t_caches[0][2] == start + 16
        assert isinstance(t_caches[0][2], int)
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)


def test_decode_with_per_row_index():
    """After a padded prefill, rows continue at their own lengths."""
    jmodel, params, jcfg, tmodel, tcfg = _pair("opt", "flash")
    ids = _ids(3, 32, seed=3)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (3, 32))
    lengths = np.array([5, 17, 32], np.int32)
    tok = _ids(3, 1, seed=5)
    _, j_caches = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(pos),
                               jgm.init_kv_caches(jcfg, 3))
    j_caches = [(k, v, jnp.asarray(lengths)) for (k, v, _) in j_caches]
    j_logits, j_caches = jmodel.apply(params, jnp.asarray(tok),
                                      jnp.asarray(lengths[:, None]),
                                      j_caches)
    with torch.inference_mode():
        _, t_caches = tmodel(_t(ids), _t(pos), tgm.init_kv_caches(tcfg, 3))
        t_caches = [(k, v, _t(lengths)) for (k, v, _) in t_caches]
        t_logits, t_caches = tmodel(_t(tok), _t(lengths[:, None]),
                                    t_caches)
    np.testing.assert_allclose(t_logits.numpy(), _np(j_logits), atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(t_caches[0][2].numpy(), lengths + 1)
    np.testing.assert_allclose(t_caches[0][0].numpy(), _np(j_caches[0][0]),
                               atol=ATOL, rtol=0)


def test_bf16_cache_free_logits():
    jmodel, params, _, tmodel, _ = _pair("opt", "reference", jnp.bfloat16,
                                         torch.bfloat16)
    ids = _ids(2, 32, seed=6)
    ref = jmodel.apply(params, jnp.asarray(ids))
    with torch.inference_mode():
        out = tmodel(_t(ids))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(ref), atol=0.05,
                               rtol=0)


def test_config_ladders_match_jax():
    assert tgm.gpt_specs == jgm.gpt_specs
    assert tgm.opt_specs == jgm.opt_specs
    j = jgm.config_from_opt_spec("opt-1.3b", attention_impl="flash")
    t = tgm.config_from_opt_spec("opt-1.3b", attention_impl="flash")
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    for key, value in td.items():
        if key != "dtype":
            assert jd[key] == value, key


def test_segment_ids_match_flax():
    """Packed sequences give the flax model's logits (two segments and a
    padded tail)."""
    jmodel, params, _, tmodel, _ = _pair()
    ids = _ids(1, 8)
    seg = np.array([[0, 0, 0, 1, 1, 1, 1, -1]], np.int32)
    pos = np.array([[0, 1, 2, 0, 1, 2, 3, 0]], np.int32)
    want = jmodel.apply(params, ids, pos, segment_ids=seg)
    with torch.inference_mode():
        got = tmodel(_t(ids), _t(pos), segment_ids=_t(seg))
    np.testing.assert_allclose(got[0, :7].numpy(), np.asarray(want)[0, :7],
                               atol=ATOL)
