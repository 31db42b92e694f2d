"""The port's serving path against the JAX package's, greedy, from the same
weights: ``Generator.generate`` with bucketed and chunked prefill, and
``POST /completions`` through the port's HTTP controller.  Tokens must be
identical; the test asserts that every greedy choice it compares was won
by a top-2 logit margin above 1e-3, far above the fp32 logit error
(< 1e-5 at this size), so the comparison cannot hinge on a near-tie.
"""
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
    jmodel, params, jcfg, tmodel, tcfg = _models()
    return (JaxGenerator(jmodel, params, jcfg, prefill_chunk=prefill_chunk),
            Generator(tmodel, tcfg, prefill_chunk=prefill_chunk,
                      device="cpu"))


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
