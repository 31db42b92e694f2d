"""GPT-style decoder-only transformer in PyTorch.

Counterpart of ``alpa_tpu/model/gpt_model.py`` for serving and training.
It computes what the flax model computes, with the same cast points:

* LayerNorm runs in fp32 (eps from the config) and its output is cast to
  ``cfg.dtype`` at the next Linear;
* Linear and embedding weights are stored in ``param_dtype`` and cast to
  ``cfg.dtype`` at use, as flax casts its fp32 params.  Serving stores them
  in ``cfg.dtype`` (the default; the cast is then a no-op); training keeps
  them in fp32, where an Adam step far below a bf16 ulp still lands.
  LayerNorm parameters are always fp32;
* the residual is added in ``cfg.dtype``;
* tied logits are ``x.to(dtype) @ wte.T``.

``remat_blocks`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant); ``remat_policy="dots"`` keeps
the outputs of the Linear products, as ``dots_with_no_batch_dims_saveable``
keeps the dots without batch dimensions.

KV caches are lists of ``(k_cache, v_cache, index)`` per layer.  Unlike the
functional JAX version, ``update_kv_cache`` writes the caches in place,
with one ``index_put_`` per cache (a full-size copy per layer and step
would double the cache traffic).  A scalar ``index`` is a Python ``int``,
so the flash kernel's ``q_offset`` needs no device sync; a per-row index is
a (B,) tensor, and a 0-d tensor is a scalar index that a traced function
takes as an input (on ``reference_attention``).  Traced for a pipeshard or
sharded executable, the write stays an ``index_put_`` on the cache input,
which the executable keeps in place (``compile_executable``).

With ``attention_impl="flash"``, the cache-free forward and the prefill at
a scalar cache index go through the flash kernel (the JAX package's
``_flash_forward`` with ``q_offset`` computes exactly the einsum reference
there); decode with a per-row index stays on ``reference_attention``, as in
JAX.  ``pipeline_boundary_every=k`` calls ``mark_pipeline_boundary()``
before every k-th block, as the JAX model does, for ``ManualLayerOption``;
outside a pipeshard trace the call does nothing.  Inside a pipeshard trace
``remat_blocks`` wraps each block in a ``remat_block`` marker pair that
carries the block's ``remat_policy``, and the layer transform recomputes
the block under that policy (``"dots"`` keeps its ``mm``/``addmm``
outputs).

``segment_ids`` packs several sequences into one row: tokens attend only
within their own segment (a block-diagonal mask over the causal one, as an
additive bias on ``reference_attention``; the flash kernel takes no bias
operand, so a packed forward stays on the plain path, as in JAX).  Inside a
pipeshard trace the bias is a value of the traced graph, computed from the
``segment_ids`` input, which each remat region reads as an input of its
own, so one trace serves every packing.  Not in this port yet: the
ring/ulysses attention variants.
"""
import dataclasses
import functools
import math
import weakref
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from alpa_tpu_torch.ops.flash_attention import flash_attention
from alpa_tpu_torch.pipeline_parallel.layer_construction import \
    checkpoint_kwargs
from alpa_tpu_torch.pipeline_parallel.primitive_def import (
    mark_pipeline_boundary, remat_block, tracing_active)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 51200
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    seq_len: int = 1024
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.float32
    # "reference" | "flash"
    attention_impl: str = "reference"
    tie_embeddings: bool = True
    layer_norm_eps: float = 1e-5
    causal: bool = True
    # MLP activation: "gelu" (GPT-2, tanh approximation) | "relu" (OPT)
    activation: str = "gelu"
    # learned-positional-table offset (OPT reserves the first 2 rows)
    pos_offset: int = 0
    # recompute each block in the backward pass (memory <-> FLOPs)
    remat_blocks: bool = False
    # None: save nothing; "dots": save the Linear products' outputs
    remat_policy: Optional[str] = None
    # mark a pipeline-layer boundary before every k-th block (0: none)
    pipeline_boundary_every: int = 0


# The GPT ladder: name -> (hidden, layers, heads); seq 1024, vocab 51200
gpt_specs = {
    "125M": (768, 12, 12),
    "350M": (1024, 24, 16),
    "760M": (1536, 24, 16),
    "1.3B": (2048, 24, 32),
    "2.6B": (2560, 32, 32),
    "6.7B": (4096, 32, 32),
    "15B": (5120, 48, 40),
    "39B": (8192, 48, 64),
    "76B": (10240, 60, 80),
}


def config_from_spec(name: str, **kwargs) -> GPTConfig:
    hidden, layers, heads = gpt_specs[name]
    return GPTConfig(hidden_size=hidden, num_layers=layers, num_heads=heads,
                     **kwargs)


# OPT ladder: name -> (hidden, layers, heads); seq 2048, vocab 50272,
# relu MLP, +2 positional offset (350m omitted: post-norm layout)
opt_specs = {
    "125m": (768, 12, 12),
    "1.3b": (2048, 24, 32),
    "2.7b": (2560, 32, 32),
    "6.7b": (4096, 32, 32),
    "13b": (5120, 40, 40),
    "30b": (7168, 48, 56),
    "66b": (9216, 64, 72),
    "175b": (12288, 96, 96),
}


def config_from_opt_spec(name: str, **kwargs) -> GPTConfig:
    """OPT-family GPTConfig."""
    hidden, layers, heads = opt_specs[name.lower().replace("opt-", "")]
    defaults = dict(vocab_size=50272, seq_len=2048, activation="relu",
                    pos_offset=2, tie_embeddings=True)
    defaults.update(kwargs)
    return GPTConfig(hidden_size=hidden, num_layers=layers,
                     num_heads=heads, **defaults)


def reference_attention(q, k, v, *, causal: bool, offset=0, bias=None):
    """Plain einsum attention.  q: (B, Sq, H, D); k/v: (B, Sk, H, D).

    Scores are computed in q's dtype and softmaxed in fp32; masked scores
    are -1e9.  ``offset`` shifts query positions: an int applies to every
    row, a (B,) tensor gives per-row offsets.  ``bias`` is an additive
    score bias broadcastable to (B, H, Sq, Sk), added in fp32 (the packed
    prefill's segment mask)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        if isinstance(offset, int) or offset.dim() == 0:
            mask = (q_pos + offset >= k_pos)[None, None]      # (1,1,Sq,Sk)
        else:
            mask = (q_pos[None] + offset[:, None, None]
                    >= k_pos[None])[:, None]                  # (B,1,Sq,Sk)
        scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def get_attention_fn(config: GPTConfig):
    if config.attention_impl == "flash":
        return flash_attention
    if config.attention_impl == "reference":
        return reference_attention
    raise NotImplementedError(
        f"attention_impl {config.attention_impl!r} is not ported yet")


def _dense(layer: nn.Linear, x, dtype):
    """``layer`` applied in ``dtype``: input, weight and bias cast at use,
    as flax ``Dense(dtype=...)`` casts them."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def update_kv_cache(kv_cache, k, v):
    """Write step K/V into the resident caches, in place, and return
    ``(k_full, v_full, new_cache)``.

    ``kv_cache`` is (k_cache, v_cache, index) with an int or 0-d tensor
    index (uniform write position) or a (B,) tensor (per-row positions for
    mixed-length batching).  The JAX version zeroes positions at or past
    index + s in the views it returns; here the full caches are returned
    as they are.  Those positions are masked by the caller's causal
    offset, so their weights are exactly 0 and their (finite) contents add
    nothing: the result is the same."""
    k_cache, v_cache, index = kv_cache
    b, s = k.shape[0], k.shape[1]
    steps = torch.arange(s, device=k.device)
    if isinstance(index, int) or index.dim() == 0:
        cols = (index + steps).expand(b, s)
    else:
        cols = index[:, None] + steps[None, :]
    rows = torch.arange(b, device=k.device)[:, None]
    k_cache = k_cache.index_put_((rows, cols), k.to(k_cache.dtype))
    v_cache = v_cache.index_put_((rows, cols), v.to(v_cache.dtype))
    return k_cache, v_cache, (k_cache, v_cache, index + s)


class SelfAttention(nn.Module):

    def __init__(self, config: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.qkv = nn.Linear(h, 3 * h, **kw)
        self.out = nn.Linear(h, h, **kw)

    def forward(self, x, kv_cache=None, attn_bias=None):
        cfg = self.config
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        q, k, v = _dense(self.qkv, x, cfg.dtype).chunk(3, dim=-1)
        q, k, v = (t.unflatten(-1, (nh, hd)) for t in (q, k, v))

        new_cache = None
        if kv_cache is not None:
            index = kv_cache[2]
            k_use, v_use, new_cache = update_kv_cache(kv_cache, k, v)
            if (isinstance(index, int) and cfg.attention_impl == "flash"
                    and attn_bias is None):
                # prefill at a scalar index: the flash kernel's q_offset
                out = flash_attention(q, k_use, v_use, causal=True,
                                      offset=index)
            else:
                out = reference_attention(q, k_use, v_use, causal=True,
                                          offset=index, bias=attn_bias)
        elif attn_bias is not None:
            out = reference_attention(q, k, v, causal=cfg.causal,
                                      bias=attn_bias)
        else:
            out = get_attention_fn(cfg)(q, k, v, causal=cfg.causal)
        return _dense(self.out, out.flatten(-2), cfg.dtype), new_cache


class MLPBlock(nn.Module):

    def __init__(self, config: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.fc_in = nn.Linear(h, config.mlp_ratio * h, **kw)
        self.fc_out = nn.Linear(config.mlp_ratio * h, h, **kw)

    def forward(self, x):
        dtype = self.config.dtype
        x = _dense(self.fc_in, x, dtype)
        x = (F.relu(x) if self.config.activation == "relu" else
             F.gelu(x, approximate="tanh"))
        return _dense(self.fc_out, x, dtype)


class TransformerBlock(nn.Module):

    def __init__(self, config: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_eps
        kw = dict(dtype=torch.float32, device=device)
        self.ln1 = nn.LayerNorm(h, eps=eps, **kw)
        self.attn = SelfAttention(config, device, param_dtype)
        self.ln2 = nn.LayerNorm(h, eps=eps, **kw)
        self.mlp = MLPBlock(config, device, param_dtype)

    def forward(self, x, kv_cache=None, attn_bias=None):
        attn_out, new_cache = self.attn(self.ln1(x.float()), kv_cache,
                                        attn_bias)
        x = x + attn_out.to(x.dtype)
        x = x + self.mlp(self.ln2(x.float())).to(x.dtype)
        return x, new_cache


def _remat_kwargs(config: GPTConfig) -> dict:
    return checkpoint_kwargs(config.remat_policy)


class GPTModel(nn.Module):
    """Decoder-only LM.  Returns logits (and the new KV caches if given).

    ``param_dtype`` is the storage dtype of Linear and embedding weights
    (default ``config.dtype``); they are cast to ``config.dtype`` at use."""

    def __init__(self, config: GPTConfig, device=None, param_dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        kw = dict(dtype=param_dtype or config.dtype, device=device)
        self.wte = nn.Embedding(config.vocab_size, h, **kw)
        self.wpe = nn.Embedding(config.seq_len + config.pos_offset, h, **kw)
        self.h = nn.ModuleList(TransformerBlock(config, device, param_dtype)
                               for _ in range(config.num_layers))
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_eps,
                                 dtype=torch.float32, device=device)
        self.lm_head = None
        if not config.tie_embeddings:
            self.lm_head = nn.Linear(h, config.vocab_size, bias=False, **kw)

    def forward(self, input_ids, position_ids=None, kv_caches=None,
                segment_ids=None, return_hidden=False):
        """``return_hidden=True`` returns the final (B, S, H) fp32 hidden
        states instead of logits, for ``chunked_cross_entropy_loss``.

        ``segment_ids`` (B, S): packed sequences, each token attending only
        within its own segment; ids < 0 mark padding that attends to
        nothing.  With caches, the chunk is written at their scalar index,
        and the keys before it (a shared prefix) are visible to every
        segment.  Pass per-segment ``position_ids``."""
        cfg = self.config
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).expand(b, s)
        seg_bias = (None if segment_ids is None else
                    _segment_bias(segment_ids, kv_caches))
        # rows are gathered, then cast: the same numbers as flax's cast of
        # the whole table, without writing a cast copy of it
        x = (F.embedding(input_ids, self.wte.weight).to(cfg.dtype) +
             F.embedding(position_ids + cfg.pos_offset,
                         self.wpe.weight).to(cfg.dtype))
        remat = (cfg.remat_blocks and kv_caches is None and
                 torch.is_grad_enabled())
        marked = remat and tracing_active()
        remat_kw = _remat_kwargs(cfg) if remat else None
        new_caches = [] if kv_caches is not None else None
        for i, block in enumerate(self.h):
            if (cfg.pipeline_boundary_every and i > 0 and
                    i % cfg.pipeline_boundary_every == 0):
                mark_pipeline_boundary()
            if marked:
                # the layer transform runs the block under checkpoint
                x = remat_block(
                    lambda y, blk=block: blk(y, attn_bias=seg_bias)[0], x,
                    f"block_{i}", cfg.remat_policy)
                continue
            if remat:
                x = torch_checkpoint.checkpoint(
                    functools.partial(_run_block, block,
                                      *_block_params(block), seg_bias), x,
                    use_reentrant=False, **remat_kw)
                continue
            x, new_cache = block(
                x, kv_caches[i] if kv_caches is not None else None,
                seg_bias)
            if new_caches is not None:
                new_caches.append(new_cache)
        x = self.ln_f(x.float())
        if return_hidden:
            return x
        if self.lm_head is None:
            logits = F.linear(x.to(cfg.dtype), self.wte.weight.to(cfg.dtype))
        else:
            logits = _dense(self.lm_head, x, cfg.dtype)
        if new_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch_size: int, dtype=None, device=None):
        """This family's caches (``init_kv_caches``)."""
        return init_kv_caches(self.config, batch_size, dtype, device)


_PARAM_SLOTS = weakref.WeakKeyDictionary()


def _block_params(block: nn.Module):
    """The (module, name) slots of a block's parameters, found once per
    block, and the tensors they hold now (under ``functional_call``, the
    ones passed in)."""
    slots = _PARAM_SLOTS.get(block)
    if slots is None:
        slots = _PARAM_SLOTS[block] = [
            (m, name) for m in block.modules()
            for name, p in m._parameters.items() if p is not None]
    return slots, [m._parameters[name] for m, name in slots]


def _run_block(block, slots, params, attn_bias, x):
    """``block`` on ``params``, the tensors its slots held when the
    forward ran: the checkpoint's recomputation in the backward runs
    after the caller's ``functional_call`` has given the block its own
    parameters back, and must read the tensors the forward read (a traced
    step would otherwise keep the recomputation's weights as constants of
    the trace).  The slots are written as ``functional_call`` writes
    them, without its per-call checks."""
    held = [m._parameters[name] for m, name in slots]
    for (m, name), p in zip(slots, params):
        m._parameters[name] = p
    try:
        return block(x, attn_bias=attn_bias)[0]
    finally:
        for (m, name), p in zip(slots, held):
            m._parameters[name] = p


def _segment_bias(segment_ids, kv_caches):
    """(B, 1, S, keys) fp32: 0 where a query may see a key of its own
    segment (or, with caches, a key before the chunk's write index), -1e9
    elsewhere."""
    seg = segment_ids
    if kv_caches is None:
        same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)
    else:
        start = kv_caches[0][2]
        if not isinstance(start, int):
            raise ValueError("packed sequences need a scalar (int) cache "
                             "index")
        b, s = seg.shape
        cache_len = kv_caches[0][0].shape[1]
        seg_k = torch.full((b, cache_len), -2, dtype=seg.dtype,
                           device=seg.device)
        seg_k[:, start:start + s] = seg
        prefix_k = torch.arange(cache_len, device=seg.device) < start
        same = (((seg[:, :, None] == seg_k[:, None, :]) |
                 prefix_k[None, None, :]) & (seg[:, :, None] >= 0))
    return torch.where(same, 0.0, -1e9).float()[:, None]


def init_kv_caches(config: GPTConfig, batch_size: int, dtype=None,
                   device=None) -> List:
    """Zeroed KV caches with a scalar write index 0, one per layer."""
    dtype = dtype or config.dtype
    hd = config.hidden_size // config.num_heads
    shape = (batch_size, config.seq_len, config.num_heads, hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device), 0)
            for _ in range(config.num_layers)]


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``model``'s parameters with random values from ``seed``:
    Linear weights N(0, 1/fan_in), embeddings N(0, 1/hidden), biases 0,
    LayerNorm scale 1.  Values are drawn in fp32 on the model's device,
    parameter by parameter, and then cast, so two configs that differ only
    in dtype or depth share their leading layers' weights.  Any decoder
    family of the port (GPT/OPT, BLOOM, CodeGen)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    hidden = model.config.hidden_size
    norms = {id(p) for m in model.modules() if isinstance(m, nn.LayerNorm)
             for p in m.parameters(recurse=False)}
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif id(p) in norms:
            p.fill_(1.0)
        else:
            std = (hidden if p.dim() == 2 and name.startswith("w")
                   else p.shape[-1]) ** -0.5
            p.copy_(torch.empty(p.shape, device=device).normal_(
                0.0, std, generator=gen))
    return model
