"""The port's weight loading (``model/weight_loading.py``) against the JAX
package's: params directories cross between the packages in both
directions, synthesized directories are the same files, HF-named state
dicts (seeded numpy, OPT and GPT-2 layouts) convert to what JAX's
converter followed by ``model/convert.py`` gives, and a model served from
a loaded directory gives the original's tokens.  Every comparison is
exact (fp32 values copied, transposed or concatenated, never computed).
"""
import functools
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import weight_loading as jwl
from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import weight_loading as twl
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.serve import GenerationConfig, Generator, get_hf_model

SHAPE = dict(hidden_size=64, num_layers=2, num_heads=4, seq_len=64,
             vocab_size=128, activation="relu", pos_offset=2)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg = jgm.GPTConfig(**SHAPE)
    _, params = jgm.init_gpt_real(jcfg, 1, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_jax_params_dir_loads_in_the_port(tmp_path):
    params = _jax_params()
    jwl.save_params_dir(params, str(tmp_path))
    tcfg = tgm.GPTConfig(**SHAPE)
    got = twl.load_params_dir(str(tmp_path), device="cpu")
    _assert_state_dicts_equal(got, gpt_params_from_flax(params, tcfg, "cpu"))
    # bf16 weights, LayerNorm kept in fp32, as the model stores them
    half = twl.load_params_dir(str(tmp_path), dtype=torch.bfloat16,
                               device="cpu")
    assert half["h.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert half["h.0.ln1.weight"].dtype == torch.float32


def test_port_params_dir_loads_in_jax(tmp_path):
    params = _jax_params()
    tcfg = tgm.GPTConfig(**SHAPE)
    model = tgm.GPTModel(tcfg)
    model.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu"))
    twl.save_params_dir(model, str(tmp_path))
    with open(tmp_path / "index.txt", encoding="utf-8") as f:
        index = f.read().split("\n")
    jax_dir = tmp_path / "jax"
    jwl.save_params_dir(params, str(jax_dir))
    with open(jax_dir / "index.txt", encoding="utf-8") as f:
        assert index == f.read().split("\n")
    loaded = jwl.load_params_dir(
        str(tmp_path), jax.tree_util.tree_map(lambda _: None, params))
    flat_a = jax.tree_util.tree_leaves_with_path(loaded)
    flat_b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(path))


def test_synthesized_dirs_are_the_same_files(tmp_path):
    jcfg = jgm.GPTConfig(**SHAPE)
    avals = jax.eval_shape(
        lambda k: jgm.GPTModel(jcfg).init(k, jax.numpy.ones(
            (1, jcfg.seq_len), jax.numpy.int32)), jax.random.PRNGKey(0))
    jwl.synthesize_params_dir(avals, str(tmp_path / "jax"))
    twl.synthesize_params_dir(tgm.GPTConfig(**SHAPE), str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / n),
                                          np.load(tmp_path / "jax" / n),
                                          err_msg=n)
    # a resumed synthesis keeps the leaves already written
    stamp = os.path.getmtime(tmp_path / "port" / "params.wte.embedding.npy")
    twl.synthesize_params_dir(tgm.GPTConfig(**SHAPE), str(tmp_path / "port"))
    assert os.path.getmtime(
        tmp_path / "port" / "params.wte.embedding.npy") == stamp


def test_params_dir_onto_a_mesh_reads_each_block(tmp_path):
    params = _jax_params()
    jwl.save_params_dir(params, str(tmp_path))
    mesh = PhysicalDeviceMesh(["cpu"] * 4).get_logical_mesh((2, 2))
    specs = {"h.0.attn.qkv.weight": ((0,), (1,)), "wte.weight": ((1,), ())}
    got = twl.load_params_dir(str(tmp_path), specs=specs, logical_mesh=mesh)
    want = gpt_params_from_flax(params, tgm.GPTConfig(**SHAPE), "cpu")
    for name, spec in specs.items():
        arr = got[name]
        assert isinstance(arr, DistributedArray) and arr.spec == spec
        ref = DistributedArray.from_full(want[name], spec, mesh)
        for a, b in zip(arr.shards, ref.shards):
            assert torch.equal(a, b), name
        assert torch.equal(arr.gather(), want[name])
    replicated = got["ln_f.weight"]
    assert all(torch.equal(s, want["ln_f.weight"])
               for s in replicated.shards)


def _hf_opt_state_dict(cfg, rng):
    h, f = cfg.hidden_size, cfg.hidden_size * cfg.mlp_ratio
    sd = {"model.decoder.embed_tokens.weight": (cfg.vocab_size, h),
          "model.decoder.embed_positions.weight": (cfg.seq_len + 2, h),
          "model.decoder.final_layer_norm.weight": (h,),
          "model.decoder.final_layer_norm.bias": (h,),
          "lm_head.weight": (cfg.vocab_size, h)}
    for i in range(cfg.num_layers):
        p = f"model.decoder.layers.{i}."
        for x in ("q", "k", "v", "out"):
            sd[f"{p}self_attn.{x}_proj.weight"] = (h, h)
            sd[f"{p}self_attn.{x}_proj.bias"] = (h,)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}{ln}.weight"] = (h,)
            sd[f"{p}{ln}.bias"] = (h,)
        sd[f"{p}fc1.weight"], sd[f"{p}fc1.bias"] = (f, h), (f,)
        sd[f"{p}fc2.weight"], sd[f"{p}fc2.bias"] = (h, f), (h,)
    return {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in sd.items()}


def _hf_gpt2_state_dict(cfg, rng):
    h = cfg.hidden_size
    sd = {"transformer.wte.weight": (cfg.vocab_size, h),
          "transformer.wpe.weight": (cfg.seq_len + 8, h),
          "transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}{ln}.weight"], sd[f"{p}{ln}.bias"] = (h,), (h,)
        sd[f"{p}attn.c_attn.weight"] = (h, 3 * h)
        sd[f"{p}attn.c_attn.bias"] = (3 * h,)
        sd[f"{p}attn.c_proj.weight"], sd[f"{p}attn.c_proj.bias"] = \
            (h, h), (h,)
        sd[f"{p}mlp.c_fc.weight"], sd[f"{p}mlp.c_fc.bias"] = \
            (h, 4 * h), (4 * h,)
        sd[f"{p}mlp.c_proj.weight"], sd[f"{p}mlp.c_proj.bias"] = \
            (4 * h, h), (h,)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sd.items()}


_OPT_HF = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64,
               ffn_dim=256, activation_function="relu",
               do_layer_norm_before=True, model_type="opt")
_GPT2_HF = dict(vocab_size=128, n_embd=64, n_layer=2, n_head=4,
                n_positions=64, model_type="gpt2")


@pytest.mark.parametrize("family", ["opt", "gpt2"])
def test_hf_state_dicts_convert_as_jax_then_convert_py(family):
    rng = np.random.default_rng(7)
    if family == "opt":
        hf = types.SimpleNamespace(**_OPT_HF)
        jcfg, tcfg = jwl.config_from_hf_opt(hf), twl.config_from_hf_opt(hf)
        sd = _hf_opt_state_dict(tcfg, rng)
        ref = jwl.convert_opt_state_dict(sd, jcfg)
        got = twl.convert_opt_state_dict(sd, tcfg)
    else:
        hf = types.SimpleNamespace(**_GPT2_HF)
        jcfg, tcfg = jwl.config_from_hf_gpt2(hf), twl.config_from_hf_gpt2(hf)
        sd = _hf_gpt2_state_dict(tcfg, rng)
        ref = jwl.convert_gpt2_state_dict(sd, jcfg)
        got = twl.convert_gpt2_state_dict(sd, tcfg)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "seq_len", "mlp_ratio", "activation", "pos_offset",
                  "tie_embeddings"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    _assert_state_dicts_equal(got, gpt_params_from_flax(ref, tcfg, "cpu"))


def test_post_norm_opt_refused():
    hf = types.SimpleNamespace(**{**_OPT_HF, "do_layer_norm_before": False})
    with pytest.raises(ValueError, match="post-norm"):
        twl.config_from_hf_opt(hf)


class _DuckOPT:
    """An object shaped like ``OPTForCausalLM``: ``config`` and
    ``state_dict()``."""

    def __init__(self, sd):
        self.config = types.SimpleNamespace(**_OPT_HF)
        self._sd = sd

    def state_dict(self):
        return dict(self._sd)


def test_load_opt_from_an_object_and_a_local_directory(tmp_path):
    hf = types.SimpleNamespace(**_OPT_HF)
    sd = _hf_opt_state_dict(twl.config_from_hf_opt(hf),
                            np.random.default_rng(1))
    duck = _DuckOPT(sd)
    model, params, cfg = twl.load_opt(duck, device="cpu")
    with open(tmp_path / "config.json", "w", encoding="utf-8") as f:
        json.dump(_OPT_HF, f)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    model_d, params_d, cfg_d = twl.load_opt(str(tmp_path), device="cpu")
    assert cfg_d == cfg
    _assert_state_dicts_equal(params_d, params)
    _assert_state_dicts_equal(dict(model_d.state_dict()),
                              dict(model.state_dict()))
    assert twl.hf_family(str(tmp_path)) == "opt"
    assert twl.hf_family(duck) == "opt"
    with pytest.raises(ValueError, match="never downloaded"):
        twl.load_opt("facebook/opt-125m", device="cpu")
    # the wrapper over the directory serves what the object's model serves
    wrapped = get_hf_model(str(tmp_path), device="cpu")
    prompt = np.arange(1, 9, dtype=np.int64)[None]
    ref = Generator(model, cfg, device="cpu").generate(
        prompt, GenerationConfig(max_new_tokens=6))
    np.testing.assert_array_equal(
        wrapped.generate(input_ids=prompt, max_new_tokens=6), ref)


def test_served_tokens_survive_a_params_dir_round_trip(tmp_path):
    tcfg = tgm.GPTConfig(dtype=torch.bfloat16, **SHAPE)
    model = tgm.GPTModel(tcfg, device="cpu")
    tgm.init_random_(model, 0)
    prompt = np.random.default_rng(0).integers(1, 128, (1, 12))
    cfg = GenerationConfig(max_new_tokens=8)
    ref = Generator(model, tcfg, device="cpu").generate(prompt, cfg)
    twl.save_params_dir(model, str(tmp_path))
    loaded = tgm.GPTModel(tcfg, device="cpu")
    loaded.load_state_dict(twl.load_params_dir(
        str(tmp_path), dtype=torch.bfloat16, device="cpu"))
    _assert_state_dicts_equal(dict(loaded.state_dict()),
                              dict(model.state_dict()))
    np.testing.assert_array_equal(
        Generator(loaded, tcfg, device="cpu").generate(prompt, cfg), ref)
