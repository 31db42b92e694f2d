"""HuggingFace-style inference wrapper (counterpart of
``alpa_tpu/serve/hf_wrapper.py``).

A caller of ``transformers`` writes ``model.generate(input_ids=...,
max_new_tokens=..., do_sample=..., num_beams=...)`` and gets token arrays
back; here the prefill and decode run on the port's ``Generator`` with
resident KV caches (greedy, sampling and beam search).  Duck typing only:
nothing here imports ``transformers``.
"""
import logging
from typing import Optional

import numpy as np
import torch

from alpa_tpu_torch.serve.generation import GenerationConfig, Generator

logger = logging.getLogger(__name__)


class WrappedInferenceModel:
    """A duck-typed HF model front: ``generate`` and ``config``."""

    def __init__(self, generator: Generator,
                 eos_token_id: Optional[int] = None):
        self.generator = generator
        self.eos_token_id = eos_token_id
        self.config = generator.config

    def generate(self, input_ids=None, attention_mask=None,
                 max_new_tokens: int = 32, max_length: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, num_beams: int = 1,
                 length_penalty: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 seed: Optional[int] = None,
                 **unused_kwargs) -> np.ndarray:
        """``GenerationMixin.generate`` in shape.

        ``input_ids``: (B, S) ints (numpy or torch).  ``attention_mask``:
        optional (B, S) ones and zeros; right-padded rows decode from their
        true lengths.  Returns a (B, S + T) int array; with a mask, rows of
        mixed lengths are padded with ``pad_token_id`` (else eos, else 0).
        ``seed`` seeds the sampler's ``torch.Generator``; without one every
        call draws fresh entropy, as ``transformers`` does."""
        if unused_kwargs:
            logger.warning("generate: ignoring unsupported kwargs %s",
                           sorted(unused_kwargs))
        ids = _to_numpy(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        eos = eos_token_id if eos_token_id is not None else self.eos_token_id
        if max_length is not None:
            max_new_tokens = max(0, max_length - ids.shape[1])

        if num_beams > 1:
            if ids.shape[0] != 1:
                raise ValueError("beam search takes batch size 1")
            if attention_mask is not None:
                # trailing pads never condition the beams
                n = int(_to_numpy(attention_mask).astype(np.int64).sum())
                ids = ids[:, :n]
            return self.generator.generate_beam(
                ids, num_beams=num_beams, max_new_tokens=max_new_tokens,
                length_penalty=length_penalty, eos_token_id=eos)

        cfg = GenerationConfig(max_new_tokens=max_new_tokens,
                               do_sample=do_sample, temperature=temperature,
                               top_k=top_k, eos_token_id=eos)
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2 ** 63))
        rng = torch.Generator(device=self.generator.device).manual_seed(seed)
        if attention_mask is not None:
            lengths = _to_numpy(attention_mask).astype(np.int64).sum(axis=1)
            prompts = [ids[i, :lengths[i]] for i in range(ids.shape[0])]
            outs = self.generator.generate(prompts, cfg, rng)
            if isinstance(outs, np.ndarray):
                return outs
            # rows of mixed lengths re-padded into one matrix, HF-style
            pad = pad_token_id if pad_token_id is not None else (eos or 0)
            width = max(len(o) for o in outs)
            mat = np.full((len(outs), width), pad, np.int32)
            for i, o in enumerate(outs):
                mat[i, :len(o)] = o
            return mat
        return np.asarray(self.generator.generate(ids, cfg, rng))

    def __call__(self, input_ids, **_):
        """One forward pass returning the logits (B, S, V)."""
        ids = torch.as_tensor(_to_numpy(input_ids).astype(np.int64),
                              device=self.generator.device)
        with torch.inference_mode():
            return self.generator.model(ids)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def get_hf_model(model_or_dir, dtype=None, device=None,
                 eos_token_id: Optional[int] = None, prompt_buckets=None,
                 **config_kwargs) -> WrappedInferenceModel:
    """An HF OPT or GPT-2 model object, or a local directory holding one
    (``config.json`` and its weights), as a servable wrapper: the weights
    are converted by ``model.weight_loading`` into the port's names and
    put on ``device`` (CUDA unless the caller asks for the CPU).  The
    family is read from the object's class name or the config's
    ``model_type``.  Nothing is downloaded.  ``config_kwargs`` set the
    port's own config fields (``attention_impl="flash"``)."""
    from alpa_tpu_torch.model.weight_loading import (hf_family, load_gpt2,
                                                     load_opt)
    loader = load_opt if hf_family(model_or_dir) == "opt" else load_gpt2
    model, _, config = loader(model_or_dir, dtype=dtype, device=device,
                              **config_kwargs)
    gen = Generator(model, config, prompt_buckets=prompt_buckets,
                    device=device)
    return WrappedInferenceModel(gen, eos_token_id=eos_token_id)
