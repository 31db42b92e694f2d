"""Packed 1-D prefill: many prompts in one model forward (counterpart of
``alpa_tpu/serve/packed.py``).

All prompts are flattened into one token row under a block-diagonal
segment mask (``GPTModel(segment_ids=...)``, plain attention: the flash
kernel takes no bias operand), and the packed KV is re-gathered into
per-row caches, so the continuous-batching engine decodes from it
unchanged.  One packed prefill pads only to the shared total bucket where
N single-prompt prefills each pad to their own bucket.

Scope: models whose positions enter through ``position_ids`` (GPT/OPT
learned embeddings).
"""
from typing import Sequence, Tuple

import numpy as np
import torch

from alpa_tpu_torch.model.gpt_model import GPTConfig, init_kv_caches


def pack_prompts(prompts: Sequence[np.ndarray], total_bucket: int,
                 max_rows: int) -> Tuple[np.ndarray, ...]:
    """Pack prompts into one (1, total_bucket) row.

    Returns (ids, segment_ids, position_ids, starts, lens); prompt slots
    beyond ``len(prompts)`` get a 1-token dummy segment at position 0 of
    the padding region (segment id -1 where unused)."""
    if len(prompts) > max_rows:
        raise ValueError(f"{len(prompts)} prompts exceed {max_rows} rows")
    ids = np.zeros((1, total_bucket), np.int32)
    seg = np.full((1, total_bucket), -1, np.int32)
    pos = np.zeros((1, total_bucket), np.int32)
    starts = np.zeros((max_rows,), np.int32)
    lens = np.ones((max_rows,), np.int32)
    off = 0
    for r, p in enumerate(prompts):
        p = np.asarray(p, np.int32).reshape(-1)
        n = len(p)
        if off + n > total_bucket:
            raise ValueError(
                f"packed length {off + n} exceeds bucket {total_bucket}")
        ids[0, off:off + n] = p
        seg[0, off:off + n] = r
        pos[0, off:off + n] = np.arange(n)
        starts[r] = off
        lens[r] = n
        off += n
    return ids, seg, pos, starts, lens


class PackedPrefill:
    """Packed forward + KV re-gather to rows.

    ``__call__`` takes up to ``max_rows`` prompts whose total length fits
    ``total_bucket`` and returns ``(last_logits (max_rows, V),
    row_caches)``, the row caches ``(max_rows, seq_len, H, D)`` per layer
    with per-row write indices: the engine's resident layout.  Rows beyond
    the prompts carry a 1-token dummy for the caller to ignore.

    ``prefix``: an optional ``generation.PrefixHandle`` (shared system
    prompt).  The pack is then written at cache offset ``prefix.length``
    into a copy of the prefix caches: every segment attends to the prefix
    plus its own span, positions continue from it, and each row is laid
    out as [prefix | suffix].
    """

    def __init__(self, model, config: GPTConfig, total_bucket: int,
                 max_rows: int, prefix=None):
        self.model = model
        self.config = config
        self.prefix = prefix
        plen = int(prefix.length) if prefix is not None else 0
        self.prefix_len = plen
        self.total_bucket = int(total_bucket)
        self.max_rows = int(max_rows)
        if plen + self.total_bucket > config.seq_len:
            raise ValueError(
                f"prefix {plen} + packed bucket {total_bucket} exceeds the "
                f"KV-cache capacity (seq_len {config.seq_len})")
        if prefix is not None and prefix.model is not model:
            raise ValueError("PrefixHandle was built for another model")
        self.device = next(model.parameters()).device
        self.calls = 0

    def __call__(self, prompts: Sequence[np.ndarray]):
        with torch.inference_mode():
            return self._prefill(prompts)

    def _prefill(self, prompts):
        ids, seg, pos, starts, lens = (
            torch.from_numpy(a.astype(np.int64)).to(self.device)
            for a in pack_prompts(prompts, self.total_bucket,
                                  self.max_rows))
        plen, cap = self.prefix_len, self.prefix_len + self.total_bucket
        if self.prefix is not None:
            # a copy: the packed forward writes its caches in place
            caches = [(k[:, :cap].clone(), v[:, :cap].clone(), plen)
                      for (k, v, _i) in self.prefix.caches]
            pos = pos + plen        # global positions after the prefix
        else:
            caches = [(k[:, :cap], v[:, :cap], 0) for (k, v, _i) in
                      init_kv_caches(self.config, 1, device=self.device)]
        self.calls += 1
        logits, caches = self.model(ids, pos, caches, segment_ids=seg)
        # one gather per layer moves each prompt's KV span to its row-local
        # origin after the prefix region (copied to every row); positions
        # past a prompt's length are clamped repeats, masked at decode
        t = torch.arange(self.config.seq_len, device=self.device)[None, :]
        sfx = plen + starts[:, None] + torch.minimum(
            (t - plen).clamp(min=0), lens[:, None] - 1)
        idx = torch.where(t < plen, t, sfx).clamp(max=cap - 1)
        row_caches = [(k[0][idx], v[0][idx], plen + lens)
                      for (k, v, _i) in caches]
        last = logits[0, starts + lens - 1]
        return last, row_caches
