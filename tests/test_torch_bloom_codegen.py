"""The port's BLOOM and CodeGen families against the JAX package's.

Counterparts of ``tests/model/test_bloom_codegen.py``, on the same tiny
configs (hidden 32, 2 layers, 4 heads; CodeGen's rotary_dim 8):

* fp32 logits of the port's models equal the flax models' on the same
  weights (``convert.bloom_params_from_flax`` /
  ``codegen_params_from_flax``), without caches and through the cached
  prefill (atol 1e-4, rtol 1e-4);
* the cached decode equals the full-context forward at the same positions
  (atol 1e-4), and mixed prompt lengths decode at per-row indices;
* the spec ladders, ``alibi_slopes(112)`` against JAX's, and the ALiBi
  bias against HF's ``build_alibi_tensor`` at 112 heads (equal up to each
  query row's constant shift, which the softmax drops);
* the HF state-dict converters against tiny ``transformers`` models built
  from a config (JAX's 5e-4), where ``transformers`` is installed;
* greedy tokens of the port's ``Generator`` equal the JAX ``Generator``'s,
  for mixed prompt lengths; pipelined (two stages, the ``"inference"``
  schedule) equal plain, with no cache moved or copied.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpa_tpu_torch
from alpa_tpu.model import bloom_model as jbloom
from alpa_tpu.model import codegen_model as jcodegen
from alpa_tpu.serve import generation as jgen
from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                            UniformStageOption)
from alpa_tpu_torch.model import bloom_model as tbloom
from alpa_tpu_torch.model import codegen_model as tcodegen
from alpa_tpu_torch.model.convert import (bloom_params_from_flax,
                                          codegen_params_from_flax)
from alpa_tpu_torch.serve.generation import GenerationConfig, Generator

TOL = dict(atol=1e-4, rtol=1e-4)
HF_TOL = dict(atol=5e-4, rtol=5e-4)
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            seq_len=24)
FAMILIES = {
    "bloom": (jbloom.BloomConfig, jbloom.BloomModel, tbloom.BloomConfig,
              tbloom.BloomModel, bloom_params_from_flax, {}),
    "codegen": (jcodegen.CodeGenConfig, jcodegen.CodeGenModel,
                tcodegen.CodeGenConfig, tcodegen.CodeGenModel,
                codegen_params_from_flax, dict(rotary_dim=8)),
}


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


@functools.lru_cache(maxsize=None)
def _pair(family, seed=0, **extra):
    """(flax model, flax params, the port's model on the same weights,
    the port's config)."""
    jcfg_cls, jmodel_cls, tcfg_cls, tmodel_cls, convert, kw = \
        FAMILIES[family]
    shape = dict(TINY, **kw, **extra)
    jmodel = jmodel_cls(jcfg_cls(**shape))
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.ones((1, 8),
                                                            jnp.int32))
    tcfg = tcfg_cls(**shape)
    tmodel = tmodel_cls(tcfg, device="cpu")
    tmodel.load_state_dict(convert(params, tcfg, "cpu"))
    return jmodel, params, tmodel.eval(), tcfg


def _ids(seed, shape, vocab=TINY["vocab_size"]):
    return np.random.RandomState(seed).randint(0, vocab, shape)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_logits_equal_flax(family):
    """Without caches, and prefilled into caches at index 0."""
    jmodel, params, tmodel, tcfg = _pair(family)
    ids = _ids(0, (2, 10))
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids)).numpy()
        cached, _ = tmodel(torch.from_numpy(ids), None,
                           tmodel.init_kv_caches(2))
    np.testing.assert_allclose(got, want, **TOL)
    jc = (jbloom.init_bloom_kv_caches if family == "bloom" else
          jcodegen.init_codegen_kv_caches)(_pair(family)[0].config, 2)
    jcached, _ = jmodel.apply(params, jnp.asarray(ids, jnp.int32), None, jc)
    np.testing.assert_allclose(cached.numpy(), np.asarray(jcached), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_equals_full_context(family):
    """Prefill 6 tokens, then decode 4 one at a time: each step's logits
    equal the full-context forward's at its position."""
    _, _, tmodel, _ = _pair(family)
    ids = torch.from_numpy(_ids(1, (2, 10)))
    with torch.no_grad():
        full = tmodel(ids)
        logits, caches = tmodel(ids[:, :6], None, tmodel.init_kv_caches(2))
        np.testing.assert_allclose(logits.numpy(), full[:, :6].numpy(),
                                   **TOL)
        for t in range(6, 10):
            step, caches = tmodel(ids[:, t:t + 1], None, caches)
            np.testing.assert_allclose(step[:, 0].numpy(),
                                       full[:, t].numpy(), **TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_per_row_cache_indices(family):
    """Rows of 4 and 7 tokens prefilled padded to 7, then one decode step
    per row at its own index (a (B,) tensor), against the full-context
    forward and against JAX's same per-row step."""
    jmodel, params, tmodel, tcfg = _pair(family)
    ids = _ids(2, (2, 10))
    lens = [4, 7]
    padded = ids[:, :7].copy()
    padded[0, 4:] = 0
    tok = np.stack([ids[0, 4], ids[1, 7]])[:, None]
    with torch.no_grad():
        full = tmodel(torch.from_numpy(ids))
        _, caches = tmodel(torch.from_numpy(padded), None,
                           tmodel.init_kv_caches(2))
        index = torch.tensor(lens)
        step, _ = tmodel(torch.from_numpy(tok), None,
                         [(k, v, index) for k, v, _ in caches])
    np.testing.assert_allclose(step[0, 0].numpy(), full[0, 4].numpy(), **TOL)
    np.testing.assert_allclose(step[1, 0].numpy(), full[1, 7].numpy(), **TOL)
    jc = (jbloom.init_bloom_kv_caches if family == "bloom" else
          jcodegen.init_codegen_kv_caches)(jmodel.config, 2)
    _, jc = jmodel.apply(params, jnp.asarray(padded, jnp.int32), None, jc)
    jc = [(k, v, jnp.asarray(lens, jnp.int32)) for k, v, _ in jc]
    jstep, _ = jmodel.apply(params, jnp.asarray(tok, jnp.int32), None, jc)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **TOL)


def test_spec_ladders_and_alibi_slopes():
    """The ladders equal JAX's; ``alibi_slopes`` equals JAX's for every head
    count up to 112 (BLOOM-176B's, not a power of two)."""
    assert tbloom.bloom_specs == jbloom.bloom_specs
    assert tcodegen.codegen_specs == jcodegen.codegen_specs
    cfg = tbloom.config_from_bloom_spec("bloom-176b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads) == \
        (14336, 70, 112)
    cfg = tcodegen.config_from_codegen_spec("codegen-16b")
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.rotary_dim) == (6144, 34, 24, 64)
    for n in list(range(1, 33)) + [48, 96, 112]:
        np.testing.assert_array_equal(tbloom.alibi_slopes(n),
                                      jbloom.alibi_slopes(n))
    q = torch.arange(5)
    got = tbloom.alibi_bias(112, q, torch.arange(7)).numpy()
    want = np.asarray(jbloom.alibi_bias(112, jnp.arange(5), jnp.arange(7)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_codegen_config_checks_and_get_model():
    """The two ``__post_init__`` checks of JAX's config; ``get_model``
    builds each family's model from its config or ladder name."""
    from alpa_tpu_torch.serve.generation import config_from_name, get_model
    for name, family in (("bloom", tbloom.BloomModel),
                         ("codegen", tcodegen.CodeGenModel)):
        cfg = _pair(name)[3]
        assert isinstance(get_model(cfg, device="cpu").model, family)
    assert config_from_name("codegen-350m") == \
        tcodegen.config_from_codegen_spec("350m")
    assert config_from_name("bloom-560m") == \
        tbloom.config_from_bloom_spec("560m")
    with pytest.raises(ValueError, match="cannot exceed the head dim"):
        tcodegen.CodeGenConfig(hidden_size=32, num_heads=4, rotary_dim=16)
    with pytest.raises(ValueError, match="must be even"):
        tcodegen.CodeGenConfig(hidden_size=32, num_heads=4, rotary_dim=3)


def test_alibi_matches_hf_build_alibi_tensor():
    """At 112 heads, our bias minus HF's ``slope * k`` is ``-slope * q``:
    a constant per query row, which the softmax drops."""
    pytest.importorskip("transformers")
    from transformers.models.bloom.modeling_bloom import build_alibi_tensor
    s = 9
    hf = build_alibi_tensor(torch.ones(1, s), 112, torch.float32)[:, 0]
    ours = tbloom.alibi_bias(112, torch.arange(s), torch.arange(s))
    slopes = torch.tensor(tbloom.alibi_slopes(112), dtype=torch.float32)
    shift = slopes[:, None, None] * torch.arange(s)[None, :, None]
    np.testing.assert_allclose((ours + shift).numpy(),
                               hf[:, None, :].expand(112, s, s).numpy(),
                               rtol=1e-6, atol=1e-6)


def _hf_pair(family):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    if family == "bloom":
        hf = transformers.BloomForCausalLM(transformers.BloomConfig(
            vocab_size=128, hidden_size=32, n_layer=2, n_head=4,
            use_cache=False)).eval()
        cfg = tbloom.BloomConfig(**TINY)
        model = tbloom.BloomModel(cfg, device="cpu")
        model.load_state_dict(tbloom.params_from_hf(hf.state_dict(), cfg))
    else:
        hf = transformers.CodeGenForCausalLM(transformers.CodeGenConfig(
            vocab_size=128, n_embd=32, n_layer=2, n_head=4, rotary_dim=8,
            n_positions=64, use_cache=False)).eval()
        cfg = tcodegen.CodeGenConfig(rotary_dim=8, **TINY)
        model = tcodegen.CodeGenModel(cfg, device="cpu")
        model.load_state_dict(tcodegen.params_from_hf(hf.state_dict(), cfg))
    return hf, model.eval()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_hf_state_dict_converter_matches_transformers(family):
    """``params_from_hf`` of a tiny ``transformers`` model's state dict:
    the port's logits equal HF's (5e-4), as JAX's converter test holds."""
    hf, model = _hf_pair(family)
    ids = torch.tensor([[1, 5, 9, 2, 7, 3], [4, 4, 8, 1, 0, 6]])
    with torch.no_grad():
        want = hf(ids).logits.numpy()
        got = model(ids).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


def _jax_generator(family, **kw):
    jmodel, params, _, _ = _pair(family)
    return jgen.Generator(jmodel, params, jmodel.config,
                          prompt_buckets=[8, 16], **kw)


def _port_generator(family, **kw):
    _, _, tmodel, tcfg = _pair(family)
    return Generator(tmodel, tcfg, prompt_buckets=[8, 16], device="cpu",
                     **kw)


PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5, 4], [11]]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_tokens_equal_jax(family):
    """Greedy tokens of the port's Generator equal the JAX Generator's:
    one prompt, and three of mixed lengths at per-row indices; chunked
    prefill gives the same."""
    cfg = GenerationConfig(max_new_tokens=5)
    want = _jax_generator(family).generate(PROMPTS, cfg)
    got = _port_generator(family).generate(PROMPTS, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    one = np.array([1, 2, 3], np.int32)
    np.testing.assert_array_equal(
        _port_generator(family).generate(one, cfg),
        np.asarray(_jax_generator(family).generate(one, cfg)))
    chunked = _port_generator(family, prefill_chunk=4).generate(PROMPTS, cfg)
    for a, b in zip(chunked, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_pipelined_equals_plain(family):
    """Two stages (a boundary after the first block), the ``"inference"``
    schedule: the mixed-length greedy tokens equal the plain Generator's,
    a second ``generate`` takes no new trace, and no call moves or copies
    a cache (the ALiBi slopes and rotary frequencies, constants made in
    the trace, leave the cache writes in place)."""
    _, _, tmodel, tcfg = _pair(family)
    cfg = GenerationConfig(max_new_tokens=5)
    want = _port_generator(family).generate(PROMPTS, cfg)
    marked = type(tcfg)(**{**tcfg.__dict__, "pipeline_boundary_every": 1})
    model = type(tmodel)(marked, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    piped = Generator(model, marked, prompt_buckets=[8, 16], device="cpu",
                      parallel_method=PipeshardParallel(
                          devices=["cpu"] * 2, num_micro_batches=1,
                          layer_option=ManualLayerOption(),
                          stage_option=UniformStageOption(2),
                          pipeline_schedule="inference"))
    got = piped.generate(PROMPTS, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    traces = (piped.prefill_traces, piped.decode_traces)
    again = piped.generate(PROMPTS, cfg)
    for a, b in zip(again, want):
        np.testing.assert_array_equal(a, b)
    assert (piped.prefill_traces, piped.decode_traces) == traces
    assert piped.get_executable("decode").num_fwd_stages == 2
    # the stages write the caches in place: nothing moved or copied
    for kind in ("prefill", "decode"):
        assert piped.get_cache_traffic(kind) == {"reshards": 0,
                                                  "copied_bytes": 0}
