"""Autoregressive generation with resident KV caches (counterpart of
``alpa_tpu/serve/generation.py``).

PyTorch runs eagerly, so there is nothing to compile: the bucket ladder is
kept only so that prefill shapes stay few and stable.  Sampling draws from
a ``torch.Generator`` in place of ``jax.random`` keys, so sampled tokens
differ from the JAX package's; greedy decoding matches it.

Not ported yet: speculative decoding, beam search, ``cache_prefix`` and
``parallel_method``.
"""
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from alpa_tpu_torch.model.gpt_model import (GPTConfig, GPTModel,
                                            config_from_opt_spec,
                                            config_from_spec,
                                            init_kv_caches, init_random_)
from alpa_tpu_torch.platform import get_device


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0           # 0 = no top-k filtering
    do_sample: bool = False
    eos_token_id: Optional[int] = None


# The top-k mask value.  It must be -inf: a finite sentinel leaves masked
# tokens with tiny but nonzero probability.
TOP_K_MASK = float("-inf")


def _sample_logits(logits, generator: torch.Generator,
                   cfg: GenerationConfig):
    logits = logits.float()
    if not cfg.do_sample:
        return logits.argmax(dim=-1)
    if cfg.temperature != 1.0:
        logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        top = torch.topk(logits, cfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < top, TOP_K_MASK)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def default_prompt_buckets(seq_len: int) -> List[int]:
    """Power-of-two prompt-length buckets up to seq_len."""
    buckets, b = [], 32
    while b < seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(seq_len)
    return buckets


class Generator:
    """Prefill + decode loop over a GPT-family model.

    Prompts are right-padded to the bucket ladder.  Right padding is safe:
    the causal mask bounds attention to positions before each row's write
    index, and each decode step overwrites the padded junk at its position
    before that position becomes attendable.  Mixed prompt lengths share
    one batch through per-row KV-cache indices.

    ``prefill_chunk``: chunked prefill; prompts stream through the cached
    path in fixed-size chunks written at a scalar cache index.

    ``prefill_calls`` / ``decode_calls`` count model calls of each kind.
    """

    def __init__(self, model: GPTModel, config: GPTConfig,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: Optional[int] = None, device=None):
        self.device = get_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.prompt_buckets = sorted(prompt_buckets or
                                     default_prompt_buckets(config.seq_len))
        self.prefill_chunk = prefill_chunk
        self.prefill_calls = 0
        self.decode_calls = 0

    def _bucket_len(self, n: int) -> int:
        for b in self.prompt_buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.prompt_buckets[-1]}")

    def _ids(self, prompts, width: int) -> torch.Tensor:
        ids = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
        return torch.from_numpy(ids).to(self.device)

    def _run_bucketed_prefill(self, prompts, lengths):
        """Right-pad to the bucket ladder and prefill at cache index 0."""
        b = len(prompts)
        ids = self._ids(prompts, self._bucket_len(int(lengths.max())))
        caches = init_kv_caches(self.config, b, device=self.device)
        self.prefill_calls += 1
        logits, caches = self.model(ids, None, caches)
        last = logits[torch.arange(b, device=self.device), lengths - 1]
        # per-row cache indices: each row continues at its own length
        return last, [(kc, vc, lengths) for (kc, vc, _i) in caches]

    def _run_chunked_prefill(self, prompts, lengths):
        """Stream the prompts through fixed-size chunks; the chunk start
        rides the caches' scalar write index."""
        b, c = len(prompts), self.prefill_chunk
        s_max = int(lengths.max())
        n_chunks = max(1, -(-s_max // c))
        if n_chunks * c > self.config.seq_len:
            raise ValueError(
                f"chunked prefill of {s_max} tokens pads to {n_chunks * c},"
                f" exceeding the KV capacity (seq_len "
                f"{self.config.seq_len}); use a chunk size dividing seq_len "
                f"or a shorter prompt")
        ids = self._ids(prompts, n_chunks * c)
        caches = init_kv_caches(self.config, b, device=self.device)
        last = torch.zeros((b, self.config.vocab_size),
                           dtype=self.config.dtype, device=self.device)
        rows = torch.arange(b, device=self.device)
        for ci in range(n_chunks):
            start = caches[0][2]                      # scalar chunk start
            pos = start + torch.arange(c, device=self.device).expand(b, c)
            self.prefill_calls += 1
            logits, caches = self.model(ids[:, ci * c:(ci + 1) * c], pos,
                                        caches)
            off = lengths - 1 - start
            hit = (off >= 0) & (off < c)
            sel = logits[rows, off.clamp(0, c - 1)]
            last = torch.where(hit[:, None], sel, last)
        # per-row decode positions take over from the scalar chunk index
        return last, [(kc, vc, lengths) for (kc, vc, _i) in caches]

    def _decode(self, token, index, caches):
        self.decode_calls += 1
        logits, caches = self.model(token[:, None], index[:, None], caches)
        return logits[:, 0, :], caches

    def generate(self, input_ids,
                 generation_config: Optional[GenerationConfig] = None,
                 rng: Optional[torch.Generator] = None):
        """Generate for a batch of (possibly mixed-length) prompts.

        ``input_ids``: (B, S) array, or a list of 1-D prompts of varying
        lengths.  Uniform-length batches return a (B, S + T) array with
        finished rows eos-padded; mixed-length batches return a list of B
        1-D arrays (prompt + generation, truncated at eos).  ``rng`` is a
        ``torch.Generator`` on this generator's device (default: seed 0).

        Runs under ``torch.inference_mode()``, entered here because the
        mode is thread-local and the batcher calls from its own thread.
        """
        with torch.inference_mode():
            return self._generate(input_ids,
                                  generation_config or GenerationConfig(),
                                  rng)

    def _generate(self, input_ids, cfg: GenerationConfig, rng):
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        if isinstance(input_ids, (list, tuple)):
            prompts = [np.asarray(p, np.int64).reshape(-1)
                       for p in input_ids]
        else:
            arr = np.asarray(input_ids, np.int64)
            if arr.ndim == 1:
                arr = arr[None]
            prompts = list(arr)
        b = len(prompts)
        lengths_np = np.array([len(p) for p in prompts], np.int64)
        s_max = int(lengths_np.max())
        if s_max + cfg.max_new_tokens > self.config.seq_len:
            raise ValueError(
                f"prompt {s_max} + max_new_tokens {cfg.max_new_tokens} "
                f"exceeds seq_len {self.config.seq_len}")
        lengths = torch.from_numpy(lengths_np).to(self.device)
        if self.prefill_chunk:
            logits, caches = self._run_chunked_prefill(prompts, lengths)
        else:
            logits, caches = self._run_bucketed_prefill(prompts, lengths)
        generated = []
        finished = torch.zeros((b,), dtype=torch.bool, device=self.device)
        index = lengths
        for _ in range(cfg.max_new_tokens):
            nxt = _sample_logits(logits, rng, cfg)
            if cfg.eos_token_id is not None:
                nxt = torch.where(finished, cfg.eos_token_id, nxt)
                finished = finished | (nxt == cfg.eos_token_id)
            generated.append(nxt)
            logits, caches = self._decode(nxt, index, caches)
            index = index + 1
            if cfg.eos_token_id is not None and bool(finished.all()):
                break
        gen = (torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
               if generated else np.zeros((b, 0), np.int32))
        prompts = [p.astype(np.int32) for p in prompts]
        if len(set(lengths_np.tolist())) == 1:
            # uniform prompts: 2-D (B, S + T), finished rows eos-padded
            return np.concatenate([np.stack(prompts), gen], axis=1)
        # mixed lengths: one 1-D row per prompt, truncated at its eos
        outs = []
        for i, p in enumerate(prompts):
            row = gen[i]
            if cfg.eos_token_id is not None:
                hits = np.nonzero(row == cfg.eos_token_id)[0]
                if hits.size:
                    row = row[:hits[0] + 1]
            outs.append(np.concatenate([p, row]))
        return outs


def get_model(name_or_config, params=None, seed: int = 0,
              device=None) -> Generator:
    """Build a servable Generator.

    ``name_or_config``: a GPTConfig, or a ladder name like "gpt-125M" /
    "opt-1.3b".  Weights are random from ``seed`` unless ``params`` (a
    state dict, e.g. from ``model.convert.gpt_params_from_flax``) is given.
    ``device`` defaults to CUDA and raises when CUDA is missing.
    """
    device = get_device(device)
    if isinstance(name_or_config, GPTConfig):
        config = name_or_config
    else:
        name = str(name_or_config)
        if name.lower().startswith("opt"):
            config = config_from_opt_spec(name)
        else:
            config = config_from_spec(name.split("-")[-1])
    model = GPTModel(config, device=device)
    if params is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(params)
    return Generator(model, config, device=device)
