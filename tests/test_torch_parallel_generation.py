"""``Generator(..., parallel_method=...)`` of the port against the JAX
package's.

Counterparts of ``TestPipelinedGeneration`` (``tests/serve/
test_serving.py``), on its tiny configs (hidden 32, 2 layers, 4 heads, seq
32, vocab 64, a pipeline boundary every layer) with the flax weights
converted:

* GPT and BLOOM under ``PipeshardParallel(num_micro_batches=1,
  ManualLayerOption(), UniformStageOption(2), "inference")``: the port's
  pipelined greedy tokens equal JAX's plain and pipelined tokens and the
  port's plain ones, exactly, and the trace counts stay flat on a second
  ``generate``;
* chunked prefill, greedy speculation (a plain draft and the target
  drafting for itself), beam search and a cached prefix under the method
  give plain ``generate``'s tokens;
* ``ShardParallel`` on a 2-device logical CPU mesh gives the same tokens;
* the ``params`` setter reaches the tensors the stages read;
* a decode step moves no cache (no RESHARD of one) and copies none: the
  stages write the caches in place, at the addresses passed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import PipeshardParallel as JaxPipeshard
from alpa_tpu.model import bloom_model as jbloom
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.serve import generation as jgen
from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                            ShardParallel, UniformStageOption)
from alpa_tpu_torch.model import bloom_model as tbloom
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model.convert import (bloom_params_from_flax,
                                          gpt_params_from_flax)
from alpa_tpu_torch.serve.generation import GenerationConfig, Generator

SHAPE = dict(hidden_size=32, num_layers=2, num_heads=4, seq_len=32,
             vocab_size=64, pipeline_boundary_every=1)
PROMPTS = [[5, 9, 1, 44, 3], [7, 7, 2, 60, 31, 8, 8, 19, 4], [13, 2]]


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _pipeshard():
    return PipeshardParallel(devices=["cpu"] * 2, num_micro_batches=1,
                             layer_option=ManualLayerOption(),
                             stage_option=UniformStageOption(num_stages=2),
                             pipeline_schedule="inference")


@functools.lru_cache(maxsize=None)
def _weights(family, seed=0):
    """(flax model, flax params, the port's state dict and config)."""
    if family == "gpt":
        jcfg = jgm.GPTConfig(**SHAPE)
        jmodel, params = jgm.init_gpt_real(jcfg, 1,
                                           jax.random.PRNGKey(seed))
        tcfg = tgm.GPTConfig(**SHAPE)
        return jmodel, params, gpt_params_from_flax(params, tcfg), tcfg
    jcfg = jbloom.BloomConfig(**SHAPE)
    jmodel = jbloom.BloomModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8),
                                                            jnp.int32))
    tcfg = tbloom.BloomConfig(**SHAPE)
    return jmodel, params, bloom_params_from_flax(params, tcfg), tcfg


def _generator(family, method=None, seed=0, **kw):
    _, _, sd, tcfg = _weights(family, seed)
    model = (tgm.GPTModel if family == "gpt" else tbloom.BloomModel)(
        tcfg, device="cpu")
    model.load_state_dict(sd)
    return Generator(model, tcfg, device="cpu", parallel_method=method,
                     **kw)


def _jax_tokens(family, ids, new_tokens, piped):
    jmodel, params, _, _ = _weights(family)
    method = None
    if piped:
        alpa_tpu.init(cluster="local")
        method = JaxPipeshard(
            num_micro_batches=1, layer_option=jlc.ManualLayerOption(),
            stage_option=jstage.UniformStageOption(num_stages=2),
            pipeline_schedule="inference")
    gen = jgen.Generator(jmodel, params, jmodel.config,
                         parallel_method=method)
    return np.asarray(gen.generate(ids, jgen.GenerationConfig(
        max_new_tokens=new_tokens)))


@pytest.mark.parametrize("family", ["gpt", "bloom"])
def test_pipelined_greedy_equals_jax(family):
    """``test_pipelined_greedy_matches_plain`` and
    ``test_pipelined_bloom_matches_plain``: one prompt of 8 tokens, 8 new
    (GPT) or 6 (BLOOM); the port's pipelined tokens equal JAX's plain and
    pipelined ones and the port's plain ones; a second ``generate`` takes
    no new trace; mixed prompt lengths agree with the plain Generator."""
    seed, n = (0, 8) if family == "gpt" else (1, 6)
    ids = np.random.RandomState(seed).randint(0, 64, (1, 8))
    piped = _generator(family, _pipeshard())
    got = piped.generate(ids, GenerationConfig(max_new_tokens=n))
    np.testing.assert_array_equal(got, _jax_tokens(family, ids, n, False))
    np.testing.assert_array_equal(got, _jax_tokens(family, ids, n, True))
    np.testing.assert_array_equal(got, _generator(family).generate(
        ids, GenerationConfig(max_new_tokens=n)))
    traces = (piped.prefill_traces, piped.decode_traces)
    assert min(traces) > 0
    again = piped.generate(ids, GenerationConfig(max_new_tokens=n))
    np.testing.assert_array_equal(again, got)
    assert (piped.prefill_traces, piped.decode_traces) == traces
    cfg = GenerationConfig(max_new_tokens=6)
    for a, b in zip(piped.generate(PROMPTS, cfg),
                    _generator(family).generate(PROMPTS, cfg)):
        np.testing.assert_array_equal(a, b)


def test_chunked_speculative_beam_and_prefix_equal_plain():
    """Under the pipeshard method: chunked prefill (chunk 4) of mixed
    prompts, greedy speculation with a plain draft and with the target as
    its own draft, beam search and a cached prefix each give the plain
    Generator's tokens; the verify leg runs through its executable."""
    cfg = GenerationConfig(max_new_tokens=6)
    plain = _generator("gpt")
    want = plain.generate(PROMPTS, cfg)
    chunked = _generator("gpt", _pipeshard(), prefill_chunk=4)
    for a, b in zip(chunked.generate(PROMPTS, cfg), want):
        np.testing.assert_array_equal(a, b)
    assert chunked.get_executable("chunk_prefill").num_fwd_stages == 2

    piped = _generator("gpt", _pipeshard())
    prompt = np.asarray(PROMPTS[1])
    greedy = plain.generate(prompt, GenerationConfig(max_new_tokens=10))[0]
    for draft in (_generator("gpt", seed=3), piped):
        row, stats = piped.generate_speculative(
            draft, prompt, GenerationConfig(max_new_tokens=10), num_draft=3)
        np.testing.assert_array_equal(row, greedy)
        assert stats["rounds"] > 0
    assert piped.get_executable("verify").num_fwd_stages == 2

    np.testing.assert_array_equal(
        piped.generate_beam(prompt, num_beams=3, max_new_tokens=5),
        plain.generate_beam(prompt, num_beams=3, max_new_tokens=5))

    prefix = [3, 1, 4, 1, 5, 9]
    plain_c = _generator("gpt", prefill_chunk=4)
    handle, handle_c = (chunked.cache_prefix(prefix),
                        plain_c.cache_prefix(prefix))
    for a, b in zip(chunked.generate(PROMPTS, cfg, prefix=handle),
                    plain_c.generate(PROMPTS, cfg, prefix=handle_c)):
        np.testing.assert_array_equal(a, b)


def test_shard_parallel_on_two_devices():
    """``ShardParallel`` over a 2-device logical CPU mesh traces the calls
    through the SPMD partitioner; the tokens equal plain ones and the
    caches passed hold the new K/V."""
    cfg = GenerationConfig(max_new_tokens=6)
    gen = _generator("gpt", ShardParallel(devices=["cpu"] * 2))
    for a, b in zip(gen.generate(PROMPTS, cfg),
                    _generator("gpt").generate(PROMPTS, cfg)):
        np.testing.assert_array_equal(a, b)
    ex = gen.get_executable("decode")
    assert ex.plan["logical_mesh"] is not None
    assert gen.prefill_traces > 0 and gen.decode_traces > 0


def test_params_setter_reaches_the_stages():
    """The setter copies new weights into the model's own tensors, which
    the pipelined calls read: after it, the pipelined tokens are those of
    a plain Generator built on the new weights, with no new trace."""
    cfg = GenerationConfig(max_new_tokens=8)
    ids = np.random.RandomState(4).randint(0, 64, (2, 7))
    piped = _generator("gpt", _pipeshard())
    before = piped.generate(ids, cfg)
    traces = (piped.prefill_traces, piped.decode_traces)
    other = _generator("gpt", seed=7)
    piped.params = other.params
    after = piped.generate(ids, cfg)
    np.testing.assert_array_equal(after, other.generate(ids, cfg))
    assert not np.array_equal(after, before)
    assert (piped.prefill_traces, piped.decode_traces) == traces


@pytest.mark.parametrize("family", ["gpt", "bloom"])
def test_decode_moves_and_copies_no_cache(family):
    """A pipelined decode step's program has no RESHARD of a cache (only
    the activations and the index cross the stages), neither its launch
    nor the Generator copies a cache, the executable hands back the very
    caches passed (written in place by the stage graphs, no functional
    copy), holding the step's K/V; the plan verifier passes the plan.
    Under ``ShardParallel`` over two devices the caches come back sharded
    and are copied back: the traffic counts those bytes."""
    piped = _generator(family, _pipeshard())
    piped.generate(PROMPTS, GenerationConfig(max_new_tokens=4))
    for kind in ("prefill", "decode"):
        assert piped.get_cache_traffic(kind) == {"reshards": 0,
                                                  "copied_bytes": 0}
        assert piped.get_executable(kind).get_plan_verdict().ok
    ex = piped.get_executable("decode")
    assert ex.get_resharding_stats()["cross_mesh"] > 0
    caches = piped._caches(3)
    ptrs = [(k.data_ptr(), v.data_ptr()) for k, v, _ in caches]
    index = torch.tensor([5, 9, 2])
    fresh = [(k.clone(), v.clone(), index) for k, v, _ in caches]
    with torch.inference_mode():    # as ``generate`` runs its calls
        _, out = piped._decode(torch.tensor([1, 2, 3]), index, caches)
    assert [(k.data_ptr(), v.data_ptr()) for k, v, _ in out] == ptrs
    assert all(torch.equal(i, index + 1) for _, _, i in out)
    assert not all(torch.equal(k, k2) for (k, _, _), (k2, _, _) in
                   zip(out, fresh))
    want = (tgm.GPTModel if family == "gpt" else tbloom.BloomModel)(
        piped.config, device="cpu")
    want.load_state_dict(piped.params)
    with torch.inference_mode():
        want(torch.tensor([[1], [2], [3]]), index[:, None], fresh)
    for (k, v, _), (k2, v2, _) in zip(out, fresh):
        torch.testing.assert_close(k, k2, rtol=0, atol=1e-6)
        torch.testing.assert_close(v, v2, rtol=0, atol=1e-6)
    with torch.inference_mode():
        _, handed = piped._steps["decode"](
            piped._weights, torch.tensor([1, 2, 3]), index + 1,
            [(k, v) for k, v, _ in caches])
    assert all(k2 is k and v2 is v
               for (k, v, _), (k2, v2) in zip(caches, handed))
    sharded = _generator(family, ShardParallel(devices=["cpu"] * 2))
    sharded.generate(PROMPTS, GenerationConfig(max_new_tokens=2))
    assert sharded.get_cache_traffic("decode")["copied_bytes"] > 0
