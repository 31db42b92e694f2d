"""Autoregressive generation with resident KV caches (counterpart of
``alpa_tpu/serve/generation.py``).

PyTorch runs eagerly, so there is nothing to compile: the bucket ladder is
kept only so that prefill shapes stay few and stable.  Sampling draws from
a ``torch.Generator`` in place of ``jax.random`` keys, so sampled tokens
differ from the JAX package's; greedy decoding matches it.

``cache_prefix`` precomputes a shared prompt prefix into a
``PrefixHandle``; ``generate(..., prefix=)`` and the engine prefill only
each request's suffix over a copy of its caches.  The port's caches are
written in place (``update_kv_cache``), so a suffix is never prefilled
over the handle's own tensors.

Speculative decoding (``generate_speculative``) draws on the host from
``np.random.default_rng(seed)`` exactly as the JAX package does, so its
sampled tokens match JAX's under one seed as far as the logits agree;
greedy speculation gives exactly the tokens of greedy ``generate``.  Beam
search (``generate_beam``) prefills once and reorders the beams' stacked
caches in place, with an ``index_select`` per step.

The Generator serves any decoder family that keeps the JAX contract
``model(input_ids, position_ids, kv_caches) -> (logits, caches)`` and
makes its caches with ``model.init_kv_caches`` (GPT/OPT, BLOOM, CodeGen).

``parallel_method`` (JAX's meaning): the four model calls (prefill,
decode, chunked prefill and speculation's verify) go through
``parallelize(..., method=parallel_method, donate_argnums=())``, with the
weights passed as an argument (``torch.func.functional_call`` over the
model's own tensors, so the ``params`` setter reaches what the stages
read) and the caches as arguments that come back as outputs.  Under
``PipeshardParallel(pipeline_schedule="inference")`` each stage writes its
layers' caches in place and hands them back, so a decode step neither
moves nor copies a cache; the caches of each batch size are allocated
once and reused by every ``generate``, so a captured step reads them at
the same addresses.  The write index enters as a tensor (per row; the
chunk start as a per-row vector), so one trace serves every position;
bucketed prefill writes at the int index 0, which keeps the flash kernel
on the prefill.  A method that hands caches back elsewhere (a sharded
mesh, as ``DistributedArray``s) has them copied back into the caches
passed, so every path keeps the in-place contract.
``prefill_traces``/``decode_traces`` count the traces taken (one per
executable under the pipeshard method, whose compiler marks the layers
of the graph it traced).
"""
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from alpa_tpu_torch.api import parallelize
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.model.gpt_model import (GPTConfig, GPTModel,
                                            config_from_opt_spec,
                                            config_from_spec, init_random_)
from alpa_tpu_torch.platform import get_device, to_device
from alpa_tpu_torch.serve.kv_cache import stacked_kv_caches


@dataclasses.dataclass
class PrefixHandle:
    """Precomputed KV of a shared prompt prefix (system prompt caching):
    B=1 caches holding ``length`` tokens at the scalar write index
    ``length``.  Made by ``Generator.cache_prefix``; ``last_logits`` are
    the prefix's final-token logits, so an empty suffix generates straight
    from it.  ``model`` guards against a handle of another model.  Its
    caches are only read: every user copies them first."""
    caches: Any
    length: int
    last_logits: Any
    model: Any = dataclasses.field(repr=False, default=None)


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


def _warp_probs_np(logits, cfg: GenerationConfig) -> np.ndarray:
    """Host-side probabilities under the cfg's temperature and top-k, with
    ``_sample_logits``'s semantics (ties at the k-th value survive), in
    float64 for exact rejection-sampling ratios."""
    x = np.asarray(logits, np.float64)
    if cfg.temperature != 1.0:
        x = x / max(cfg.temperature, 1e-6)
    if cfg.top_k > 0:
        kth = np.partition(x, -cfg.top_k, axis=-1)[..., -cfg.top_k, None]
        x = np.where(x < kth, TOP_K_MASK, x)
    x = x - x.max(axis=-1, keepdims=True)
    p = np.exp(x)
    return p / p.sum(axis=-1, keepdims=True)


def _sample_from_probs(p: np.ndarray, u: float) -> int:
    """Inverse-CDF draw from a probability vector with one uniform."""
    c = np.cumsum(p)
    return int(np.clip(np.searchsorted(c, u * c[-1], side="right"),
                       0, len(p) - 1))


def speculative_accept(props, q_probs, p_probs, us, u_extra):
    """Rejection-sampling acceptance (Leviathan et al.): proposal ``i``,
    drawn from ``q_i``, is accepted with probability ``min(1, p_i(x) /
    q_i(x))``; the first rejection emits from the residual ``norm(max(p_i
    - q_i, 0))``, and a round accepted whole emits a bonus token from
    ``p_k``, so every emitted token is distributed exactly as ``p``.
    Returns ``(num_accepted, extra_token)``.

    ``props``: k proposed tokens; ``q_probs``: (k, V) draft probabilities;
    ``p_probs``: (k+1, V) target probabilities; ``us``: k uniforms;
    ``u_extra``: one uniform for the residual or bonus draw."""
    k = len(props)
    for i in range(k):
        x = int(props[i])
        ratio = p_probs[i][x] / max(q_probs[i][x], 1e-300)
        if us[i] < min(1.0, ratio):
            continue
        residual = np.maximum(p_probs[i] - q_probs[i], 0.0)
        s = residual.sum()
        if s <= 0.0:
            # p == q: the residual is empty and acceptance was certain up
            # to rounding; draw from p itself
            residual, s = p_probs[i], p_probs[i].sum()
        return i, _sample_from_probs(residual / s, u_extra)
    return k, _sample_from_probs(p_probs[k], u_extra)


def default_prompt_buckets(seq_len: int) -> List[int]:
    """Power-of-two prompt-length buckets up to seq_len."""
    buckets, b = [], 32
    while b < seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(seq_len)
    return buckets


class Generator:
    """Prefill + decode loop over a decoder model (GPT/OPT, BLOOM,
    CodeGen).

    Prompts are right-padded to the bucket ladder.  Right padding is safe:
    the causal mask bounds attention to positions before each row's write
    index, and each decode step overwrites the padded junk at its position
    before that position becomes attendable.  Mixed prompt lengths share
    one batch through per-row KV-cache indices.

    ``prefill_chunk``: chunked prefill; prompts stream through the cached
    path in fixed-size chunks written at a scalar cache index.

    ``parallel_method``: a ``ParallelMethod`` the model calls run under
    (see the module docstring), e.g. ``PipeshardParallel(
    pipeline_schedule="inference")`` with a model that marks its pipeline
    boundaries.

    ``prefill_calls`` / ``decode_calls`` / ``verify_calls`` count model
    calls of each kind (a verify call is speculative decoding's forward of
    several tokens at the per-row index); ``prefill_traces`` /
    ``decode_traces`` the traces of the parallelized calls.
    """

    def __init__(self, model: torch.nn.Module, config,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 prefill_chunk: Optional[int] = None, device=None,
                 parallel_method=None):
        self.device = get_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.prompt_buckets = sorted(prompt_buckets or
                                     default_prompt_buckets(config.seq_len))
        self.prefill_chunk = prefill_chunk
        self.prefill_calls = 0
        self.decode_calls = 0
        self.verify_calls = 0
        self.prefill_traces = 0
        self.decode_traces = 0
        self.parallel_method = parallel_method
        self._steps: Dict[str, Any] = {}
        # kind -> the cache bytes the last call copied back
        self._copied_back: Dict[str, int] = {}
        # (batch size, role) -> the caches the parallelized calls reuse
        self._kv_pool: Dict[Any, List] = {}
        if parallel_method is not None:
            self._build_parallel_steps()

    def _build_parallel_steps(self):
        """The four model calls as parallelized functions of (weights,
        batch arguments, caches), JAX's ``prefill``/``decode``/
        ``chunk_prefill``/``verify``."""
        model = self.model
        # views of the model's own tensors: the setter writes into them
        self._weights = {k: p.detach() for k, p in model.named_parameters()}

        def traced(kind, x):
            if isinstance(x, FakeTensor):
                setattr(self, kind, getattr(self, kind) + 1)

        def run(params, ids, pos, kv, index):
            logits, caches = torch.func.functional_call(
                model, params, (ids, pos, [(k, v, index) for k, v in kv]))
            return logits, [(k, v) for k, v, _ in caches]

        def prefill(params, ids, lengths, kv):
            traced("prefill_traces", ids)
            logits, kv = run(params, ids, None, kv, 0)
            rows = torch.arange(ids.shape[0], device=ids.device)
            return logits[rows, lengths - 1], kv

        def decode(params, token, index, kv):
            traced("decode_traces", token)
            logits, kv = run(params, token[:, None], index[:, None], kv,
                             index)
            return logits[:, 0, :], kv

        def chunk_prefill(params, ids, lengths, start, last, kv):
            """One chunk at the per-row start ``start`` (all rows equal);
            ``last`` keeps each row's final-token logits."""
            traced("prefill_traces", ids)
            b, c = ids.shape
            pos = start[:, None] + torch.arange(c, device=ids.device)
            logits, kv = run(params, ids, pos, kv, start)
            off = lengths - 1 - start
            hit = (off >= 0) & (off < c)
            sel = logits[torch.arange(b, device=ids.device),
                         off.clamp(0, c - 1)]
            return torch.where(hit[:, None], sel, last), kv

        def verify(params, toks, index, kv):
            pos = index[:, None] + torch.arange(toks.shape[1],
                                                device=toks.device)
            return run(params, toks, pos, kv, index)

        method = self.parallel_method
        for name, fn, batch in (("prefill", prefill, (1, 2)),
                                ("decode", decode, (1, 2)),
                                ("chunk_prefill", chunk_prefill,
                                 (1, 2, 3, 4)),
                                ("verify", verify, (1, 2))):
            self._steps[name] = parallelize(fn, method=method,
                                            donate_argnums=(),
                                            batch_argnums=batch)

    def get_executable(self, kind: str = "decode"):
        """The executable the last parallelized ``kind`` call ran
        ("prefill", "decode", "chunk_prefill" or "verify")."""
        return self._steps[kind].get_last_executable()

    def get_cache_traffic(self, kind: str = "decode") -> Dict[str, int]:
        """What the last parallelized ``kind`` call did to the caches: the
        RESHARD instructions of its program that move a cache
        (``"reshards"``; pipeshard executables) and the bytes copied into
        or out of a cache (``"copied_bytes"``: by a pipeshard launch, and
        back into the caches passed where the call handed them back
        elsewhere)."""
        ex = self.get_executable(kind)
        copied = self._copied_back.get(kind, 0)
        if not hasattr(ex, "get_copy_stats"):
            return {"reshards": 0, "copied_bytes": copied}
        first = len(self._weights) + len(self._steps[kind].batch_argnums)
        n = 2 * self.config.num_layers
        caches_in = set(range(first, first + n))
        index = {v: i for i, v in enumerate(ex.global_invars)}
        reshards = sum(1 for inst in ex.instructions
                       if inst.opcode.name == "RESHARD" and
                       index.get(inst.var_key[0]) in caches_in)
        copies = ex.get_copy_stats()
        copied += (sum(b for i, b in copies["in"].items() if i in caches_in)
                   + sum(b for j, b in copies["out"].items()
                         if 1 <= j <= n))
        return {"reshards": reshards, "copied_bytes": copied}

    def _local(self, x):
        return x.gather(self.device) if isinstance(x, DistributedArray) \
            else x

    def _call(self, kind, *args, caches):
        """The parallelized ``kind`` on ``args`` and ``caches`` (triples);
        returns its first output and the caches, written in place (a
        cache handed back elsewhere is copied into the one passed)."""
        kv = [(k, v) for k, v, _ in caches]
        out, new = self._steps[kind](self._weights, *args, kv)
        copied = 0
        for (k, v), (k2, v2) in zip(kv, new):
            for t, t2 in ((k, k2), (v, v2)):
                if not (isinstance(t2, torch.Tensor) and
                        t2.data_ptr() == t.data_ptr()):
                    t.copy_(self._local(t2))
                    copied += t.numel() * t.element_size()
        self._copied_back[kind] = copied
        return self._local(out), kv

    def _caches(self, b: int, role: str = "main"):
        """Caches for ``b`` rows at index 0: new ones, or under a parallel
        method the ones of (``b``, ``role``) allocated at their first use
        (a captured step reads them where they lie)."""
        if self.parallel_method is None:
            return self.model.init_kv_caches(b, device=self.device)
        key = (b, role)
        if key not in self._kv_pool:
            self._kv_pool[key] = [
                (k, v) for k, v, _ in
                self.model.init_kv_caches(b, device=self.device)]
        return [(k, v, 0) for k, v in self._kv_pool[key]]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's weights by state-dict name: the tensors it reads
        (the JAX generator's ``params``)."""
        return dict(self.model.state_dict())

    @params.setter
    def params(self, new: Dict[str, torch.Tensor]):
        """Copy ``new`` (the same names, shapes and dtypes) into the
        model's own tensors: every address stays, so a captured decode
        tick, and under a parallel method every stage, reads the new
        weights (a hot swap's pointer flip)."""
        own = self.model.state_dict()
        if set(new) != set(own):
            raise ValueError(
                f"weights differ in names: missing "
                f"{sorted(set(own) - set(new))[:4]}, unknown "
                f"{sorted(set(new) - set(own))[:4]}")
        for k, t in own.items():
            src = new[k]
            if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
                raise ValueError(
                    f"weight {k}: {tuple(src.shape)} {src.dtype}, the "
                    f"model's is {tuple(t.shape)} {t.dtype}")
        with torch.no_grad():
            for k, t in own.items():
                t.copy_(new[k])

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
        return to_device(torch.from_numpy(ids), self.device)

    def _run_bucketed_prefill(self, prompts, lengths, caches=None,
                              role="main"):
        """Right-pad to the bucket ladder and prefill at cache index 0,
        into ``caches`` (written in place) or new ones."""
        b = len(prompts)
        ids = self._ids(prompts, self._bucket_len(int(lengths.max())))
        if caches is None:
            caches = self._caches(b, role)
        self.prefill_calls += 1
        if self._steps:
            last, kv = self._call("prefill", ids, lengths, caches=caches)
            return last, [(kc, vc, lengths) for kc, vc in kv]
        logits, caches = self.model(ids, None, caches)
        last = logits[torch.arange(b, device=self.device), lengths - 1]
        # per-row cache indices: each row continues at its own length
        return last, [(kc, vc, lengths) for (kc, vc, _i) in caches]

    def _run_chunked_prefill(self, prompts, lengths, b=None, caches=None,
                             start=0, init_last=None):
        """Stream the prompts through fixed-size chunks; the chunk start
        rides the caches' scalar write index.

        ``caches``/``start``: continue from precomputed K/V (a prefix),
        written in place from position ``start`` (their int index); the
        ``prompts`` are then suffixes and ``lengths`` total lengths.
        ``init_last`` seeds the final-logit accumulator (the prefix's last
        logits, kept by rows whose suffix is empty)."""
        b = len(prompts) if b is None else b
        c = self.prefill_chunk
        s_max = int(max(len(p) for p in prompts))
        if s_max == 0 and caches is not None:
            # every suffix is empty: the prefix's logits seed decode
            return init_last, [(kc, vc, lengths) for (kc, vc, _i) in caches]
        n_chunks = max(1, -(-s_max // c))
        if start + n_chunks * c > self.config.seq_len:
            raise ValueError(
                f"chunked prefill of {s_max} tokens at offset {start} pads "
                f"to {start + n_chunks * c}, exceeding the KV capacity "
                f"(seq_len {self.config.seq_len}); use a chunk size dividing "
                f"seq_len or a shorter prompt")
        ids = self._ids(prompts, n_chunks * c)
        if caches is None:
            caches = self._caches(b)
        last = init_last
        if last is None:
            last = torch.zeros((b, self.config.vocab_size),
                               dtype=self.config.dtype, device=self.device)
        rows = torch.arange(b, device=self.device)
        for ci in range(n_chunks):
            self.prefill_calls += 1
            chunk = ids[:, ci * c:(ci + 1) * c]
            if self._steps:
                # the chunk start as a per-row vector: one trace for all
                begin = torch.full((b,), start + ci * c, dtype=torch.int64,
                                   device=self.device)
                last, kv = self._call("chunk_prefill", chunk, lengths,
                                      begin, last, caches=caches)
                caches = [(kc, vc, start + (ci + 1) * c) for kc, vc in kv]
                continue
            begin = caches[0][2]                      # scalar chunk start
            pos = begin + torch.arange(c, device=self.device).expand(b, c)
            logits, caches = self.model(chunk, pos, caches)
            off = lengths - 1 - begin
            hit = (off >= 0) & (off < c)
            sel = logits[rows, off.clamp(0, c - 1)]
            last = torch.where(hit[:, None], sel, last)
        # per-row decode positions take over from the scalar chunk index
        return last, [(kc, vc, lengths) for (kc, vc, _i) in caches]

    def cache_prefix(self, prefix_ids) -> PrefixHandle:
        """Precompute the KV of a shared prefix (chunked mode only: the
        chunk step is what resumes suffixes at any cache offset)."""
        if not self.prefill_chunk:
            raise ValueError(
                "cache_prefix requires Generator(prefill_chunk=...)")
        p = np.asarray(prefix_ids, np.int64).reshape(-1)
        with torch.inference_mode():
            lengths = torch.tensor([len(p)], device=self.device)
            last, caches = self._run_chunked_prefill([p], lengths)
            if self.parallel_method is not None:
                # the pooled caches are reused: the handle keeps a copy
                caches = [(kc.clone(), vc.clone(), i)
                          for (kc, vc, i) in caches]
        # the scalar index again: suffix chunks continue from it
        caches = [(kc, vc, len(p)) for (kc, vc, _i) in caches]
        return PrefixHandle(caches=caches, length=len(p), last_logits=last,
                            model=self.model)

    def check_prefix(self, prefix: PrefixHandle):
        if not self.prefill_chunk:
            raise ValueError("prefix caching requires "
                             "Generator(prefill_chunk=...)")
        if prefix.model is not self.model:
            raise ValueError("PrefixHandle was built for another model")

    def _decode(self, token, index, caches):
        self.decode_calls += 1
        if self._steps:
            logits, kv = self._call("decode", token, index, caches=caches)
            return logits, [(kc, vc, index + 1) for kc, vc in kv]
        logits, caches = self.model(token[:, None], index[:, None], caches)
        return logits[:, 0, :], caches

    def generate(self, input_ids,
                 generation_config: Optional[GenerationConfig] = None,
                 rng: Optional[torch.Generator] = None,
                 prefix: Optional[PrefixHandle] = None):
        """Generate for a batch of (possibly mixed-length) prompts.

        ``input_ids``: (B, S) array, or a list of 1-D prompts of varying
        lengths.  Uniform-length batches return a (B, S + T) array with
        finished rows eos-padded; mixed-length batches return a list of B
        1-D arrays (prompt + generation, truncated at eos).  ``rng`` is a
        ``torch.Generator`` on this generator's device (default: seed 0).

        ``prefix``: a ``cache_prefix`` handle.  Its KV is copied across the
        batch and only each request's suffix (``input_ids``) is prefilled;
        returned rows hold suffix + generation.

        Runs under ``torch.inference_mode()``, entered here because the
        mode is thread-local and the batcher calls from its own thread.
        """
        with torch.inference_mode():
            return self._generate(input_ids,
                                  generation_config or GenerationConfig(),
                                  rng, prefix)

    def _generate(self, input_ids, cfg: GenerationConfig, rng, prefix):
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
        plen = 0
        if prefix is not None:
            self.check_prefix(prefix)
            plen = prefix.length
        lengths_np = np.array([plen + len(p) for p in prompts], np.int64)
        s_max = int(lengths_np.max())
        if s_max + cfg.max_new_tokens > self.config.seq_len:
            raise ValueError(
                f"prompt {s_max} + max_new_tokens {cfg.max_new_tokens} "
                f"exceeds seq_len {self.config.seq_len}")
        lengths = torch.from_numpy(lengths_np).to(self.device)
        if prefix is not None:
            # a copy of the prefix K/V per row: the prefill writes in place
            if self.parallel_method is None:
                init = [(kc.repeat(b, 1, 1, 1), vc.repeat(b, 1, 1, 1), idx)
                        for (kc, vc, idx) in prefix.caches]
            else:
                init = [(kc.copy_(pk.expand_as(kc)),
                         vc.copy_(pv.expand_as(vc)), idx)
                        for (kc, vc, _), (pk, pv, idx) in zip(
                            self._caches(b), prefix.caches)]
            logits, caches = self._run_chunked_prefill(
                prompts, lengths, b, caches=init, start=plen,
                init_last=prefix.last_logits.repeat(b, 1))
        elif self.prefill_chunk:
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


    # ---- speculative decoding ----

    def generate_speculative(self, draft: "Generator", input_ids,
                             generation_config: Optional[
                                 GenerationConfig] = None,
                             num_draft: int = 4, seed: int = 0):
        """Speculative decoding of one prompt: ``draft`` (any Generator
        over the same vocabulary) proposes ``num_draft`` tokens a round and
        this (target) model verifies them in one cached forward.

        Greedy mode accepts the agreeing argmax prefix and emits exactly
        the tokens of greedy ``generate``.  With ``cfg.do_sample`` the
        proposals are drawn from the draft's warped distribution and
        accepted by rejection sampling (``speculative_accept``), so every
        emitted token is distributed as the target's; ``seed`` drives the
        host-side draws (``np.random.default_rng``, as in JAX).  Rollback
        after a rejection resets the caches' index: the K/V beyond it stay
        masked.  Returns ``(row, stats)``, the prompt and its tokens and
        ``{"rounds", "proposed", "accepted"}``."""
        with torch.inference_mode():
            return self._generate_speculative(
                draft, input_ids, generation_config or GenerationConfig(),
                int(num_draft), seed)

    def _generate_speculative(self, draft, input_ids, cfg, k, seed):
        np_rng = np.random.default_rng(seed)
        prompt = np.asarray(input_ids, np.int32).reshape(-1)
        if k < 1:
            raise ValueError(f"num_draft must be >= 1, got {k}")
        if len(prompt) + cfg.max_new_tokens > self.config.seq_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens "
                f"{cfg.max_new_tokens} exceeds seq_len "
                f"{self.config.seq_len}")
        if len(prompt) + cfg.max_new_tokens > draft.config.seq_len:
            # a draft cache too small would overrun silently: proposals
            # turn to garbage and acceptance collapses with no error
            raise ValueError(
                f"draft seq_len {draft.config.seq_len} cannot hold "
                f"prompt {len(prompt)} + max_new_tokens "
                f"{cfg.max_new_tokens}")

        def host(logits):
            return logits.float().cpu().numpy()

        def pick_target(logits):
            """The next token from target logits: argmax or a warped
            draw."""
            if not cfg.do_sample:
                return int(np.argmax(host(logits)[0]))
            p = _warp_probs_np(host(logits)[0], cfg)
            return _sample_from_probs(p, np_rng.uniform())

        t_logits, t_caches = self._spec_prefill(self, prompt)
        # a generator drafting for itself keeps its draft caches apart
        _, d_caches = self._spec_prefill(
            draft, prompt, "draft" if draft is self else "main")
        pending = pick_target(t_logits)
        generated = [pending]
        stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        eos = cfg.eos_token_id
        cap = min(self.config.seq_len, draft.config.seq_len)
        while len(generated) < cfg.max_new_tokens and \
                (eos is None or pending != eos):
            # shrink the round near the cache's end so that the verify
            # write (k_r + 1 tokens) always fits: greedy exactness holds
            # up to the edge
            idx = int(t_caches[0][2][0])
            k_r = min(k, cap - idx - 1, cfg.max_new_tokens - len(generated))
            if k_r < 1:
                # no room for a round: one plain decode
                t_logits, t_caches = self._decode(
                    self._ints([pending]), t_caches[0][2], t_caches)
                pending = pick_target(t_logits)
                generated.append(pending)
                continue
            # the draft proposes k_r tokens in k_r + 1 decodes: the last
            # feed keeps its cache in step with the verify write
            props, q_rows = [], []
            tok = pending
            for _ in range(k_r):
                d_logits, d_caches = draft._decode(
                    draft._ints([tok]), d_caches[0][2], d_caches)
                if cfg.do_sample:
                    q = _warp_probs_np(host(d_logits)[0], cfg)
                    q_rows.append(q)
                    tok = _sample_from_probs(q, np_rng.uniform())
                else:
                    tok = int(np.argmax(host(d_logits)[0]))
                props.append(tok)
            _, d_caches = draft._decode(draft._ints([props[-1]]),
                                        d_caches[0][2], d_caches)
            # the target verifies [pending, p1..p_k_r] in one forward
            v_logits, t_caches = self._verify(
                self._ints([[pending] + props]), t_caches)
            if cfg.do_sample:
                p_rows = _warp_probs_np(host(v_logits)[0], cfg)
                a, extra = speculative_accept(
                    props, np.stack(q_rows), p_rows,
                    np_rng.uniform(size=k_r), np_rng.uniform())
                emitted = props[:a] + [extra]
            else:
                t_preds = np.argmax(host(v_logits)[0], axis=-1)
                a = 0
                while a < k_r and t_preds[a] == props[a]:
                    a += 1
                emitted = props[:a] + [int(t_preds[a])]
            stats["rounds"] += 1
            stats["proposed"] += k_r
            stats["accepted"] += a
            # rollback: this round confirmed pending and a proposals
            conf = 1 + a
            t_caches = [(kc, vc, i - (k_r + 1) + conf)
                        for (kc, vc, i) in t_caches]
            d_caches = [(kc, vc, i - (k_r + 1) + conf)
                        for (kc, vc, i) in d_caches]
            for t in emitted:
                generated.append(t)
                if eos is not None and t == eos:
                    break
            pending = generated[-1]
        gen = np.asarray(generated[:cfg.max_new_tokens], np.int32)
        if eos is not None:
            hits = np.nonzero(gen == eos)[0]
            if hits.size:
                gen = gen[:hits[0] + 1]
        return np.concatenate([prompt, gen]), stats

    def _ints(self, values) -> torch.Tensor:
        return to_device(torch.tensor(values, dtype=torch.int64),
                         self.device)

    @staticmethod
    def _spec_prefill(gen: "Generator", prompt, role="main"):
        """One prompt prefilled by ``gen``'s own path (chunked or
        bucketed); the caches continue at the per-row index."""
        lengths = gen._ints([len(prompt)])
        caches = gen._caches(1, role)
        if gen.prefill_chunk:
            return gen._run_chunked_prefill([prompt], lengths, caches=caches)
        return gen._run_bucketed_prefill([prompt], lengths, caches=caches)

    def _verify(self, toks, caches):
        """The verify leg: ``toks`` (B, s) written at the per-row index in
        one cached forward, all s logits returned (on
        ``reference_attention``, as every per-row-index forward)."""
        b, s = toks.shape
        index = caches[0][2]
        self.verify_calls += 1
        if self._steps:
            logits, kv = self._call("verify", toks, index, caches=caches)
            return logits, [(kc, vc, index + s) for kc, vc in kv]
        pos = index[:, None] + torch.arange(s, device=self.device)
        return self.model(toks, pos, caches)

    # ---- beam search ----

    def generate_beam(self, input_ids, num_beams: int = 4,
                      max_new_tokens: int = 32, length_penalty: float = 1.0,
                      eos_token_id: Optional[int] = None) -> np.ndarray:
        """Beam search for one prompt: prefill once, repeat the prompt's
        caches over the beams (one stacked tensor) and after every step
        reorder them with one ``index_select`` on the beam axis.  Scoring
        is JAX's: a finished beam extends only by eos at no cost (-1e9 for
        any other token), each beam's generated length stops at its eos,
        and the best beam is the one with the highest score over
        ``max(length, 1) ** length_penalty``.  Returns it as (1, S + T)."""
        with torch.inference_mode():
            return self._generate_beam(input_ids, int(num_beams),
                                       max_new_tokens, length_penalty,
                                       eos_token_id)

    def _generate_beam(self, input_ids, num_beams, max_new_tokens,
                       length_penalty, eos_token_id):
        ids = np.asarray(input_ids, np.int64)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError("beam search takes one prompt")
        s = ids.shape[1]
        if s + max_new_tokens > self.config.seq_len:
            raise ValueError(
                f"prompt {s} + max_new_tokens {max_new_tokens} exceeds "
                f"seq_len {self.config.seq_len}")
        kv1, caches1 = stacked_kv_caches(self.config, 1, self.device)
        lengths = self._ints([s])
        if self.prefill_chunk:
            logits1, _ = self._run_chunked_prefill([ids[0]], lengths,
                                                   caches=caches1)
        else:
            logits1, _ = self._run_bucketed_prefill([ids[0]], lengths,
                                                    caches=caches1)
        k = num_beams
        kv = kv1.repeat(1, 1, k, 1, 1, 1)
        del kv1, caches1
        beams = self._ints(ids).repeat(k, 1)                     # (K, S)
        logits = logits1.repeat(k, 1)
        scores = torch.full((k,), -1e9, device=self.device)
        scores[0] = 0.0
        finished = torch.zeros((k,), dtype=torch.bool, device=self.device)
        # generated length per beam, frozen at its eos
        gen_len = torch.zeros((k,), device=self.device)
        vocab = torch.arange(logits.shape[-1], device=self.device)
        eos_row = torch.where(vocab == (eos_token_id or 0), 0.0, -1e9)
        index = s
        for t in range(max_new_tokens):
            logp = torch.log_softmax(logits.float(), dim=-1)
            cand = scores[:, None] + torch.where(finished[:, None],
                                                 eos_row[None], logp)
            flat = cand.reshape(-1)
            # a stable sort: equal scores keep the lower flat index first,
            # as XLA's top_k does
            top_idx = torch.sort(flat, descending=True,
                                 stable=True).indices[:k]
            top_scores = flat[top_idx]
            v = logp.shape[-1]
            beam_idx = top_idx // v
            tok_idx = top_idx % v
            beams = torch.cat([beams.index_select(0, beam_idx),
                               tok_idx[:, None]], dim=1)
            scores = top_scores
            finished = finished.index_select(0, beam_idx)
            gen_len = gen_len.index_select(0, beam_idx)
            # beams running at the start of this step count its token,
            # eos included
            gen_len = torch.where(finished, gen_len, gen_len + 1.0)
            if eos_token_id is not None:
                finished = finished | (tok_idx == eos_token_id)
            if t == max_new_tokens - 1 or (
                    eos_token_id is not None and bool(finished.all())):
                break
            # in place: the caches keep their addresses from step to step
            kv.copy_(kv.index_select(2, beam_idx))
            caches = [(kv[0, i], kv[1, i],
                       torch.full((k,), index, dtype=torch.int64,
                                  device=self.device))
                      for i in range(kv.shape[1])]
            logits, _ = self._decode(tok_idx, caches[0][2], caches)
            index += 1
        norm = scores / (gen_len.clamp(min=1.0) ** length_penalty)
        best = int(torch.argmax(norm))
        return beams[best:best + 1].cpu().numpy().astype(np.int32)

def _family(config):
    """The model class of a config: GPT/OPT, BLOOM or CodeGen."""
    from alpa_tpu_torch.model.bloom_model import BloomConfig, BloomModel
    from alpa_tpu_torch.model.codegen_model import (CodeGenConfig,
                                                    CodeGenModel)
    return {GPTConfig: GPTModel, BloomConfig: BloomModel,
            CodeGenConfig: CodeGenModel}[type(config)]


def config_from_name(name: str):
    """The config of a ladder name: "gpt-125M", "opt-1.3b", "bloom-560m"
    or "codegen-350m"."""
    from alpa_tpu_torch.model.bloom_model import config_from_bloom_spec
    from alpa_tpu_torch.model.codegen_model import config_from_codegen_spec
    low = name.lower()
    if low.startswith("opt"):
        return config_from_opt_spec(name)
    if low.startswith("bloom"):
        return config_from_bloom_spec(name)
    if low.startswith("codegen"):
        return config_from_codegen_spec(name)
    return config_from_spec(name.split("-")[-1])


def get_model(name_or_config, params=None, seed: int = 0,
              device=None, parallel_method=None) -> Generator:
    """Build a servable Generator.

    ``name_or_config``: a ``GPTConfig``, ``BloomConfig`` or
    ``CodeGenConfig``, or a ladder name (``config_from_name``).  Weights
    are random from ``seed`` unless ``params`` (a state dict, e.g. from
    ``model.convert.gpt_params_from_flax``) is given.  ``device`` defaults
    to CUDA and raises when CUDA is missing; ``parallel_method`` is the
    Generator's.
    """
    device = get_device(device)
    config = (name_or_config if not isinstance(name_or_config, str)
              else config_from_name(name_or_config))
    model = _family(config)(config, device=device)
    if params is None:
        init_random_(model, seed)
    else:
        model.load_state_dict(params)
    return Generator(model, config, device=device,
                     parallel_method=parallel_method)
