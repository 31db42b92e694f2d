"""The port's speculative decoding against the JAX package's, on a
2-layer OPT-style model at hidden 64 in fp32 with the same weights
(``model/convert.py``); ``test_torch_beam_search.py`` holds beam search
and the HF-style wrapper on the same models.

The weights are the JAX init scaled by 8 so that greedy tokens vary
(every greedy choice compared is won by a top-2 logit margin above 1e-2,
far above the fp32 logit error of about 1e-5 at this size); the draft is
the target with each weight multiplied by ``1 + 0.02 N(0, 1)``, so that
it agrees with the target on part of its proposals.  Every comparison is
exact: tokens and ``stats``; ``speculative_accept`` is compared on the
same arrays and uniforms.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.serve import GenerationConfig as JaxGenerationConfig
from alpa_tpu.serve import Generator as JaxGenerator
from alpa_tpu.serve import generation as jgen
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import GenerationConfig, Generator
from alpa_tpu_torch.serve import generation as tgen

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=128,
             vocab_size=256, activation="relu", pos_offset=2)
SCALE = 8.0
DRAFT_NOISE = 0.02
PROMPT_LEN = 20
NEW_TOKENS = 24
MARGIN = 1e-2


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


def _scaled(params, noise, seed):
    rs = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        if "ln" in jax.tree_util.keystr(path):
            return x
        return (x * SCALE * (1 + noise * rs.standard_normal(x.shape))
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX model, JAX config, port config, {"target"|"draft": (JAX
    params, port model)})."""
    jcfg = jgm.GPTConfig(attention_impl="flash", **SHAPE)
    jmodel, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE)
    out = {}
    for name, noise in (("target", 0.0), ("draft", DRAFT_NOISE)):
        p = _scaled(params, noise, seed=1)
        tmodel = tgm.GPTModel(tcfg)
        tmodel.load_state_dict(gpt_params_from_flax(p, tcfg, "cpu"))
        out[name] = (p, tmodel)
    return jmodel, jcfg, tcfg, out


@functools.lru_cache(maxsize=None)
def _jax_generator(name, prefill_chunk):
    """One JAX generator per model and prefill mode, so that its compiled
    steps serve every test."""
    jmodel, jcfg, _, models = _models()
    return JaxGenerator(jmodel, models[name][0], jcfg,
                        prefill_chunk=prefill_chunk)


def _pair(name, prefill_chunk=None):
    _, _, tcfg, models = _models()
    return (_jax_generator(name, prefill_chunk),
            Generator(models[name][1], tcfg, prefill_chunk=prefill_chunk,
                      device="cpu"))


def _prompt(n=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, SHAPE["vocab_size"], n).astype(np.int32)


def _assert_clear_margins(row, plen):
    """Every generated token of ``row`` is the argmax of a cache-free
    forward, won by a margin above MARGIN."""
    _, _, _, models = _models()
    with torch.inference_mode():
        logits = models["target"][1](
            torch.from_numpy(np.array(row[None, :-1], np.int64)))
    step = logits[0, plen - 1:].float()
    top2 = torch.topk(step, 2, dim=-1).values
    np.testing.assert_array_equal(step.argmax(-1).numpy(), row[plen:])
    assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN


@pytest.mark.parametrize("case", ["accept_all", "reject_mid", "p_equals_q",
                                  "random"])
def test_speculative_accept_matches_jax(case):
    rng = np.random.default_rng(3)
    k, v = 4, 32

    def probs(n):
        x = rng.random((n, v)) ** 4
        return x / x.sum(-1, keepdims=True)
    q, p = probs(k), probs(k + 1)
    props = [int(np.argmax(q[i])) for i in range(k)]
    us, u_extra = rng.random(k), float(rng.random())
    if case == "accept_all":
        us = np.zeros(k)
    elif case == "reject_mid":
        us = np.array([0.0, 0.0, 1.0, 0.0])
    elif case == "p_equals_q":
        p[:k] = q
        us = np.array([0.0, 1.0, 0.0, 0.0])
    got = tgen.speculative_accept(props, q, p, us, u_extra)
    want = jgen.speculative_accept(props, q, p, us, u_extra)
    assert got == want
    for temp, top_k in ((1.0, 0), (0.7, 5)):
        cfg = dict(temperature=temp, top_k=top_k)
        np.testing.assert_array_equal(
            tgen._warp_probs_np(p, GenerationConfig(**cfg)),
            jgen._warp_probs_np(p, JaxGenerationConfig(**cfg)))


@pytest.mark.parametrize("num_draft", [1, 3, 4])
@pytest.mark.parametrize("draft", ["draft", "self"])
def test_greedy_speculative_matches_jax_and_plain_greedy(num_draft, draft):
    jt, tt = _pair("target")
    jd, td = (jt, tt) if draft == "self" else _pair("draft")
    prompt = _prompt()
    cfg = dict(max_new_tokens=NEW_TOKENS)
    ref, ref_stats = jt.generate_speculative(jd, prompt, JaxGenerationConfig(
        **cfg), num_draft=num_draft)
    out, stats = tt.generate_speculative(td, prompt, GenerationConfig(**cfg),
                                         num_draft=num_draft)
    plain = tt.generate(prompt[None], GenerationConfig(**cfg))[0]
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert stats == ref_stats
    np.testing.assert_array_equal(out, plain)
    _assert_clear_margins(plain, PROMPT_LEN)
    if draft == "self":
        assert stats["accepted"] == stats["proposed"]
    else:
        assert 0 < stats["accepted"] < stats["proposed"]
    assert tt.verify_calls == stats["rounds"]


def test_greedy_speculative_round_cut_at_the_cache_edge():
    """A prompt that fills the cache to its last position: the last rounds
    shrink and the final one falls back to a plain decode, as in JAX."""
    jt, tt = _pair("target", prefill_chunk=16)
    jd, td = _pair("draft")
    plen = SHAPE["seq_len"] - NEW_TOKENS
    prompt = _prompt(plen, seed=2)
    cfg = dict(max_new_tokens=NEW_TOKENS)
    ref, ref_stats = jt.generate_speculative(jd, prompt, JaxGenerationConfig(
        **cfg), num_draft=4)
    out, stats = tt.generate_speculative(td, prompt, GenerationConfig(**cfg),
                                         num_draft=4)
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert stats == ref_stats
    np.testing.assert_array_equal(
        out, tt.generate(prompt[None], GenerationConfig(**cfg))[0])
    assert len(out) == SHAPE["seq_len"]


def test_sampled_speculative_matches_jax_under_one_seed():
    jt, tt = _pair("target")
    jd, td = _pair("draft")
    prompt = _prompt()
    cfg = dict(max_new_tokens=NEW_TOKENS, do_sample=True, temperature=0.8,
               top_k=20)
    for seed in (0, 5):
        ref, ref_stats = jt.generate_speculative(
            jd, prompt, JaxGenerationConfig(**cfg), num_draft=3, seed=seed)
        out, stats = tt.generate_speculative(
            td, prompt, GenerationConfig(**cfg), num_draft=3, seed=seed)
        np.testing.assert_array_equal(out, np.asarray(ref))
        assert stats == ref_stats


def test_speculative_seq_len_checks_raise_as_jax():
    _, tt = _pair("target")
    small_cfg = tgm.GPTConfig(**{**SHAPE, "seq_len": 32})
    small = Generator(tgm.GPTModel(small_cfg), small_cfg, device="cpu")
    prompt = _prompt()
    with pytest.raises(ValueError, match="draft seq_len"):
        tt.generate_speculative(small, prompt,
                                GenerationConfig(max_new_tokens=16))
    with pytest.raises(ValueError, match="exceeds seq_len"):
        tt.generate_speculative(tt, prompt,
                                GenerationConfig(max_new_tokens=120))
    with pytest.raises(ValueError, match="num_draft"):
        tt.generate_speculative(tt, prompt, num_draft=0)
