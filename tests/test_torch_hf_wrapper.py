"""The port's HF-style wrapper (``serve/hf_wrapper.py``) against the
JAX package's, on ``test_torch_speculative.py``'s models (a 2-layer
OPT-style model at hidden 64 in fp32, the JAX init scaled by 8, the same
weights through ``model/convert.py``).  The comparison is exact: the
wrapper's token matrix."""
import numpy as np
import pytest
import torch

from alpa_tpu.serve import WrappedInferenceModel as JaxWrapped
from alpa_tpu_torch.serve import WrappedInferenceModel
from test_torch_speculative import (PROMPT_LEN, SHAPE,  # noqa: F401
                                    _keep_global_torch_rng, _pair, _prompt)


@pytest.mark.parametrize("mode", ["greedy", "sampled_top1", "beams",
                                  "mixed_lengths"])
def test_hf_wrapper_generate_matches_jax(mode):
    jt, tt = _pair("target")
    jw, tw = JaxWrapped(jt), WrappedInferenceModel(tt)
    prompt = _prompt()
    ids = torch.from_numpy(prompt[None].astype(np.int64))
    if mode == "greedy":
        kw = dict(max_new_tokens=8)
    elif mode == "sampled_top1":
        # sampling draws from a torch.Generator in the port and a JAX key
        # in JAX; top_k=1 leaves one token, so both must draw greedy's
        kw = dict(max_new_tokens=8, do_sample=True, top_k=1, seed=3)
    elif mode == "beams":
        kw = dict(max_new_tokens=8, num_beams=4, length_penalty=0.5)
    else:
        short = np.zeros_like(prompt)
        short[:12] = prompt[:12]
        ids = torch.from_numpy(np.stack([prompt, short]).astype(np.int64))
        mask = np.ones((2, PROMPT_LEN), np.int64)
        mask[1, 12:] = 0
        kw = dict(max_new_tokens=8, attention_mask=mask, pad_token_id=0)
    out = tw.generate(input_ids=ids, **kw)
    ref = jw.generate(input_ids=ids, **kw)
    np.testing.assert_array_equal(out, np.asarray(ref))
    if mode == "sampled_top1":
        np.testing.assert_array_equal(
            out, tw.generate(input_ids=ids, max_new_tokens=8))


def test_hf_wrapper_sampling_reproducible_and_logits():
    _, tt = _pair("target")
    tw = WrappedInferenceModel(tt, eos_token_id=None)
    prompt = _prompt()[None]
    kw = dict(max_new_tokens=8, do_sample=True, temperature=0.8, top_k=20)
    np.testing.assert_array_equal(tw.generate(prompt, seed=7, **kw),
                                  tw.generate(prompt, seed=7, **kw))
    assert tw.generate(prompt, max_length=PROMPT_LEN + 5).shape == \
        (1, PROMPT_LEN + 5)
    logits = tw(prompt)
    assert logits.shape == (1, PROMPT_LEN, SHAPE["vocab_size"])
