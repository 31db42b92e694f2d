"""CodeGen (Salesforce) decoder-only LM in PyTorch (counterpart of
``alpa_tpu/model/codegen_model.py``).

Architectural deltas from GPT, as in the JAX model:

* rotary position embeddings (GPT-J's rotate-every-two) on the first
  ``rotary_dim`` dims of every head, at the cache's write offset: no
  position table;
* attention and MLP in parallel off one LayerNorm
  (``x + attn(ln(x)) + mlp(ln(x))``);
* bias-free qkv/out projections; an untied lm head with a bias.

HF's checkpoint packs the fused qkv in ``mp_num=4`` groups of [q, v, k];
``params_from_hf`` permutes it to plain head-major [q; k; v]
(``_qkv_permutation``), so the model stays a straight chain of products.
The attention is ``reference_attention``, as in the JAX model.  Cast
points and KV caches follow the GPT port (``update_kv_cache``: an int, 0-d
or per-row index, written in place); ``pipeline_boundary_every`` marks
pipeline layers.
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
class CodeGenConfig:
    vocab_size: int = 50400
    hidden_size: int = 1024
    num_layers: int = 20
    num_heads: int = 16
    seq_len: int = 2048
    rotary_dim: int = 32
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    layer_norm_eps: float = 1e-5
    pipeline_boundary_every: int = 0

    def __post_init__(self):
        hd = self.hidden_size // self.num_heads
        if self.rotary_dim > hd:
            raise ValueError(
                f"rotary_dim ({self.rotary_dim}) cannot exceed the head "
                f"dim ({hd} = hidden_size {self.hidden_size} / num_heads "
                f"{self.num_heads})")
        if self.rotary_dim % 2 != 0:
            raise ValueError(
                f"rotary_dim ({self.rotary_dim}) must be even: rotary "
                "rotates (2i, 2i+1) dimension pairs")


# name -> (hidden, layers, heads, rotary_dim): Salesforce/codegen-*
codegen_specs = {
    "350m": (1024, 20, 16, 32),
    "2b": (2560, 32, 32, 64),
    "6b": (4096, 33, 16, 64),
    "16b": (6144, 34, 24, 64),
}


def config_from_codegen_spec(name: str, **kwargs) -> CodeGenConfig:
    key = name.lower().replace("codegen-", "").split("-")[0]
    hidden, layers, heads, rot = codegen_specs[key]
    return CodeGenConfig(hidden_size=hidden, num_layers=layers,
                         num_heads=heads, rotary_dim=rot, **kwargs)


def apply_rotary(x, offset, rotary_dim: int):
    """GPT-J's rotate-every-two rotary embedding on the first
    ``rotary_dim`` dims of each head of x (B, S, H, D).  ``offset`` is the
    absolute position of x's first token: an int or 0-d tensor (every
    row), a (B,) tensor (per row) or a (B, S) position matrix.  The angles
    and the rotation are fp32, cast back to x's dtype."""
    b, s = x.shape[0], x.shape[1]
    steps = torch.arange(s, device=x.device)
    if isinstance(offset, int) or offset.dim() == 0:
        pos = (offset + steps).expand(b, s)
    elif offset.dim() == 1:
        pos = offset[:, None] + steps[None, :]
    else:
        pos = offset
    inv_freq = torch.tensor(
        1.0 / (10000.0 ** (np.arange(0, rotary_dim, 2) / rotary_dim)),
        dtype=torch.float32, device=x.device)
    ang = pos[..., None].float() * inv_freq                # (B, S, rot/2)
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = rot[..., 0::2].float(), rot[..., 1::2].float()  # (2i, 2i+1)
    rot = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).flatten(-2)
    return torch.cat([rot.to(x.dtype), rest], dim=-1)


class CodeGenAttention(nn.Module):

    def __init__(self, config: CodeGenConfig, device=None,
                 param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device,
                  bias=False)
        self.qkv = nn.Linear(h, 3 * h, **kw)
        self.out = nn.Linear(h, h, **kw)

    def forward(self, x, kv_cache=None):
        cfg = self.config
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        q, k, v = (t.unflatten(-1, (nh, hd)) for t in
                   _dense(self.qkv, x, cfg.dtype).chunk(3, dim=-1))
        new_cache = None
        if kv_cache is not None:
            index = kv_cache[2]
            # rotary positions are absolute: offset by the write index
            q = apply_rotary(q, index, cfg.rotary_dim)
            k = apply_rotary(k, index, cfg.rotary_dim)
            k_use, v_use, new_cache = update_kv_cache(kv_cache, k, v)
            out = reference_attention(q, k_use, v_use, causal=True,
                                      offset=index)
        else:
            q = apply_rotary(q, 0, cfg.rotary_dim)
            k = apply_rotary(k, 0, cfg.rotary_dim)
            out = reference_attention(q, k, v, causal=True)
        return _dense(self.out, out.flatten(-2), cfg.dtype), new_cache


class CodeGenBlock(nn.Module):

    def __init__(self, config: CodeGenConfig, device=None,
                 param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.ln1 = nn.LayerNorm(h, eps=config.layer_norm_eps,
                                dtype=torch.float32, device=device)
        self.attn = CodeGenAttention(config, device, param_dtype)
        self.fc_in = nn.Linear(h, config.mlp_ratio * h, **kw)
        self.fc_out = nn.Linear(config.mlp_ratio * h, h, **kw)

    def forward(self, x, kv_cache=None):
        dtype = self.config.dtype
        ln = self.ln1(x.float())
        attn_out, new_cache = self.attn(ln, kv_cache)
        y = _dense(self.fc_in, ln, dtype)
        y = _dense(self.fc_out, F.gelu(y, approximate="tanh"), dtype)
        # parallel residual: one LayerNorm feeds both branches (GPT-J)
        return x + attn_out.to(x.dtype) + y.to(x.dtype), new_cache


class CodeGenModel(nn.Module):
    """Returns logits (and the new KV caches if given).  ``position_ids``
    is taken for the Generator's interface and not used: rotary positions
    come from the cache index."""

    def __init__(self, config: CodeGenConfig, device=None,
                 param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.wte = nn.Embedding(config.vocab_size, h, **kw)
        self.h = nn.ModuleList(CodeGenBlock(config, device, param_dtype)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_eps,
                                 dtype=torch.float32, device=device)
        self.lm_head = nn.Linear(h, config.vocab_size, **kw)

    def forward(self, input_ids, position_ids=None, kv_caches=None):
        del position_ids
        cfg = self.config
        x = F.embedding(input_ids, self.wte.weight).to(cfg.dtype)
        new_caches = [] if kv_caches is not None else None
        for i, block in enumerate(self.h):
            if (cfg.pipeline_boundary_every and i > 0 and
                    i % cfg.pipeline_boundary_every == 0):
                mark_pipeline_boundary()
            x, c = block(x, kv_caches[i] if kv_caches is not None else None)
            if new_caches is not None:
                new_caches.append(c)
        logits = _dense(self.lm_head, self.ln_f(x.float()), cfg.dtype)
        if new_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch_size: int, dtype=None, device=None):
        return init_codegen_kv_caches(self.config, batch_size, dtype,
                                      device)


def init_codegen_kv_caches(config: CodeGenConfig, batch_size: int,
                           dtype=None, device=None) -> List:
    """GPT's cache layout: (B, seq_len, heads, head_dim) per layer."""
    return init_kv_caches(config, batch_size, dtype, device)


def _qkv_permutation(hidden: int, mp_num: int = 4) -> np.ndarray:
    """The column permutation taking HF CodeGen's qkv layout to plain
    head-major [q; k; v]: HF packs the 3h outputs as ``mp_num`` groups of
    [query, value, key] blocks of h / mp_num columns each; ``perm[j]`` is
    the HF column that lands at column j."""
    local = hidden // mp_num
    perm = np.empty(3 * hidden, np.int64)
    cols = np.arange(local)
    for g in range(mp_num):
        base = g * 3 * local
        perm[g * local:(g + 1) * local] = base + cols                # q
        perm[hidden + g * local:hidden + (g + 1) * local] = \
            base + 2 * local + cols                                  # k
        perm[2 * hidden + g * local:2 * hidden + (g + 1) * local] = \
            base + local + cols                                      # v
    return perm


def params_from_hf(state_dict: Dict[str, Any], config: CodeGenConfig,
                   device=None) -> Dict[str, torch.Tensor]:
    """An HF ``CodeGenForCausalLM`` state dict (tensors or arrays, keyed
    by HF's names) as ``CodeGenModel``'s, LayerNorms in fp32, the rest in
    ``config.dtype``, on ``device`` (the CPU unless given); the fused qkv
    rows are permuted to [q; k; v] (``_qkv_permutation``)."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def get(key):
        out = sd.get(key)
        if out is None:
            raise KeyError(f"state dict misses key {key!r}: not a CodeGen "
                           "checkpoint?")
        return out

    perm = _qkv_permutation(config.hidden_size)
    host = {"wte.weight": get("transformer.wte.weight"),
            "ln_f.weight": get("transformer.ln_f.weight"),
            "ln_f.bias": get("transformer.ln_f.bias"),
            "lm_head.weight": get("lm_head.weight"),
            "lm_head.bias": get("lm_head.bias")}
    for i in range(config.num_layers):
        src, p = f"transformer.h.{i}.", f"h.{i}."
        host[p + "ln1.weight"] = get(src + "ln_1.weight")
        host[p + "ln1.bias"] = get(src + "ln_1.bias")
        host[p + "attn.qkv.weight"] = get(src + "attn.qkv_proj.weight")[perm]
        host[p + "attn.out.weight"] = get(src + "attn.out_proj.weight")
        for ours, theirs in (("fc_in", "mlp.fc_in"), ("fc_out", "mlp.fc_out")):
            host[f"{p}{ours}.weight"] = get(f"{src}{theirs}.weight")
            host[f"{p}{ours}.bias"] = get(f"{src}{theirs}.bias")
    return {k: _put(v, k, config.dtype, device) for k, v in host.items()}
