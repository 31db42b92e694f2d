"""BLOOM decoder-only LM in PyTorch (counterpart of
``alpa_tpu/model/bloom_model.py``).

Architectural deltas from GPT, as in the JAX model:

* ALiBi attention biases instead of positional embeddings (per-head
  slopes, linear in the key-query distance): no position table, so any
  length the cache holds is admissible;
* a LayerNorm right after the word embedding (``ln_emb``);
* a fused QKV projection whose output is laid out per head as (head, 3,
  head_dim), HF's checkpoint layout (``params_from_hf``).

The attention is ``reference_attention`` with the ALiBi bias, as in the
JAX model: the flash kernels take no bias operand.  Cast points are the
GPT port's (LayerNorms in fp32, Linear and embedding weights cast to
``config.dtype`` at use, the residual in ``config.dtype``).  KV caches
follow the GPT convention (``update_kv_cache``: an int, 0-d or per-row
index, written in place), so ``serve.generation.Generator`` and the
serving engine drive the model unchanged, and ``pipeline_boundary_every``
marks pipeline layers for ``ManualLayerOption``.
"""
import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alpa_tpu_torch.model.gpt_model import (_dense, init_kv_caches,
                                            reference_attention,
                                            update_kv_cache)
from alpa_tpu_torch.model.weight_loading import _np, _put
from alpa_tpu_torch.pipeline_parallel.primitive_def import \
    mark_pipeline_boundary


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    seq_len: int = 2048          # cache capacity; ALiBi has no hard limit
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    pipeline_boundary_every: int = 0


# name -> (hidden, layers, heads): HF's bigscience/bloom-*
bloom_specs = {
    "560m": (1024, 24, 16),
    "1b1": (1536, 24, 16),
    "1b7": (2048, 24, 16),
    "3b": (2560, 30, 32),
    "7b1": (4096, 30, 32),
    "176b": (14336, 70, 112),
}


def config_from_bloom_spec(name: str, **kwargs) -> BloomConfig:
    hidden, layers, heads = bloom_specs[name.lower().replace("bloom-", "")]
    return BloomConfig(hidden_size=hidden, num_layers=layers,
                       num_heads=heads, **kwargs)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al.; HF's ``build_alibi_tensor``):
    a geometric sequence from 2^(-8/n) for the nearest power of two n
    below the head count, and every other slope of twice that count for
    the heads beyond it."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(num_heads).is_integer():
        return pow2_slopes(num_heads)
    closest = 2 ** int(np.floor(np.log2(num_heads)))
    base = pow2_slopes(closest)
    extra = pow2_slopes(2 * closest)[0::2][:num_heads - closest]
    return np.concatenate([base, extra])


def alibi_bias(num_heads: int, q_pos, k_pos) -> torch.Tensor:
    """The fp32 additive score bias slope_h * (k - q): (H, Sq, Sk) for
    (Sq,) query positions, (B, H, Sq, Sk) for (B, Sq).  HF adds slope * k,
    the same under the softmax's shift invariance per row; the distance
    form is exact for the cached decode too."""
    slopes = torch.tensor(alibi_slopes(num_heads), dtype=torch.float32,
                          device=k_pos.device)
    dist = (k_pos[None, :] - q_pos[..., :, None]).float()   # (.., Sq, Sk)
    return slopes[:, None, None] * dist[..., None, :, :]


class BloomAttention(nn.Module):

    def __init__(self, config: BloomConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.qkv = nn.Linear(h, 3 * h, **kw)
        self.out = nn.Linear(h, h, **kw)

    def forward(self, x, kv_cache=None):
        cfg = self.config
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        s = x.shape[1]
        # HF packs qkv per head: (nh, 3, hd)
        qkv = _dense(self.qkv, x, cfg.dtype).unflatten(-1, (nh, 3, hd))
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        steps = torch.arange(s, device=x.device)
        new_cache = None
        if kv_cache is not None:
            index = kv_cache[2]
            k_use, v_use, new_cache = update_kv_cache(kv_cache, k, v)
            k_pos = torch.arange(k_use.shape[1], device=x.device)
            if isinstance(index, int) or index.dim() == 0:
                bias = alibi_bias(nh, index + steps, k_pos)[None]
            else:
                bias = alibi_bias(nh, index[:, None] + steps, k_pos)
            out = reference_attention(q, k_use, v_use, causal=True,
                                      offset=index, bias=bias)
        else:
            bias = alibi_bias(nh, steps, steps)[None]
            out = reference_attention(q, k, v, causal=True, bias=bias)
        return _dense(self.out, out.flatten(-2), cfg.dtype), new_cache


class BloomBlock(nn.Module):

    def __init__(self, config: BloomConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.ln1 = nn.LayerNorm(h, eps=eps, dtype=torch.float32,
                                device=device)
        self.attn = BloomAttention(config, device, param_dtype)
        self.ln2 = nn.LayerNorm(h, eps=eps, dtype=torch.float32,
                                device=device)
        self.fc_in = nn.Linear(h, config.mlp_ratio * h, **kw)
        self.fc_out = nn.Linear(config.mlp_ratio * h, h, **kw)

    def forward(self, x, kv_cache=None):
        dtype = self.config.dtype
        attn_out, new_cache = self.attn(self.ln1(x.float()), kv_cache)
        x = x + attn_out.to(x.dtype)
        y = _dense(self.fc_in, self.ln2(x.float()), dtype)
        y = _dense(self.fc_out, F.gelu(y, approximate="tanh"), dtype)
        return x + y.to(x.dtype), new_cache


class BloomModel(nn.Module):
    """Returns logits (and the new KV caches if given).  ``position_ids``
    is taken for the Generator's interface and not used: ALiBi's positions
    come from the cache index."""

    def __init__(self, config: BloomConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.wte = nn.Embedding(config.vocab_size, h, **kw)
        self.ln_emb = nn.LayerNorm(h, eps=eps, dtype=torch.float32,
                                   device=device)
        self.h = nn.ModuleList(BloomBlock(config, device, param_dtype)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(h, eps=eps, dtype=torch.float32,
                                 device=device)
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = nn.Linear(h, config.vocab_size, bias=False, **kw)

    def forward(self, input_ids, position_ids=None, kv_caches=None):
        del position_ids
        cfg = self.config
        x = F.embedding(input_ids, self.wte.weight).to(cfg.dtype)
        x = self.ln_emb(x.float()).to(cfg.dtype)
        new_caches = [] if kv_caches is not None else None
        for i, block in enumerate(self.h):
            if (cfg.pipeline_boundary_every and i > 0 and
                    i % cfg.pipeline_boundary_every == 0):
                mark_pipeline_boundary()
            x, c = block(x, kv_caches[i] if kv_caches is not None else None)
            if new_caches is not None:
                new_caches.append(c)
        x = self.ln_f(x.float())
        if self.lm_head is None:
            logits = F.linear(x.to(cfg.dtype), self.wte.weight.to(cfg.dtype))
        else:
            logits = _dense(self.lm_head, x, cfg.dtype)
        if new_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch_size: int, dtype=None, device=None):
        return init_bloom_kv_caches(self.config, batch_size, dtype, device)


def init_bloom_kv_caches(config: BloomConfig, batch_size: int, dtype=None,
                         device=None) -> List:
    """GPT's cache layout: (B, seq_len, heads, head_dim) per layer."""
    return init_kv_caches(config, batch_size, dtype, device)


def params_from_hf(state_dict: Dict[str, Any], config: BloomConfig,
                   device=None) -> Dict[str, torch.Tensor]:
    """An HF ``BloomForCausalLM`` state dict (tensors or arrays, keyed by
    HF's names) as ``BloomModel``'s, LayerNorms in fp32, the rest in
    ``config.dtype``, on ``device`` (the CPU unless given).  HF's fused
    QKV rows are (head, 3, head_dim), this model's layout, so they map as
    they are; HF's ``Linear`` weights are already (out, in)."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def get(key):
        out = sd.get("transformer." + key, sd.get(key))
        if out is None:
            raise KeyError(f"state dict misses key {key!r}: not a BLOOM "
                           "checkpoint?")
        return out

    host = {"wte.weight": get("word_embeddings.weight"),
            "ln_emb.weight": get("word_embeddings_layernorm.weight"),
            "ln_emb.bias": get("word_embeddings_layernorm.bias"),
            "ln_f.weight": get("ln_f.weight"), "ln_f.bias": get("ln_f.bias")}
    names = {"ln1": "input_layernorm", "ln2": "post_attention_layernorm",
             "attn.qkv": "self_attention.query_key_value",
             "attn.out": "self_attention.dense",
             "fc_in": "mlp.dense_h_to_4h", "fc_out": "mlp.dense_4h_to_h"}
    for i in range(config.num_layers):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                host[f"h.{i}.{ours}.{part}"] = get(f"h.{i}.{theirs}.{part}")
    if not config.tie_embeddings:
        host["lm_head.weight"] = sd["lm_head.weight"]
    return {k: _put(v, k, config.dtype, device) for k, v in host.items()}
