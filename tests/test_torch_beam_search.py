"""The port's beam search against the JAX package's, on
``test_torch_speculative.py``'s models (a 2-layer OPT-style model at
hidden 64 in fp32, the JAX init scaled by 8, the same weights through
``model/convert.py``).  The comparison is exact: the best beam."""
import numpy as np
import pytest

from alpa_tpu_torch.serve import GenerationConfig
from test_torch_speculative import (PROMPT_LEN,  # noqa: F401
                                    _keep_global_torch_rng, _pair, _prompt)


@pytest.mark.parametrize("num_beams", [1, 3, 4])
@pytest.mark.parametrize("eos", [False, True], ids=["no_eos", "eos"])
@pytest.mark.parametrize("length_penalty", [0.5, 1.0])
def test_beam_search_matches_jax(num_beams, eos, length_penalty):
    jt, tt = _pair("target")
    prompt = _prompt()
    greedy = tt.generate(prompt[None], GenerationConfig(max_new_tokens=10))
    # an eos that greedy decoding reaches at its sixth token
    eos_id = int(greedy[0, PROMPT_LEN + 5]) if eos else None
    kw = dict(num_beams=num_beams, max_new_tokens=10,
              length_penalty=length_penalty, eos_token_id=eos_id)
    out = tt.generate_beam(prompt, **kw)
    np.testing.assert_array_equal(out, np.asarray(jt.generate_beam(prompt,
                                                                   **kw)))
    if num_beams == 1:
        np.testing.assert_array_equal(
            out, tt.generate(prompt[None], GenerationConfig(
                max_new_tokens=10, eos_token_id=eos_id))[:, :out.shape[1]])


def test_beam_search_chunked_prefill_matches_bucketed():
    _, tt = _pair("target")
    _, tc = _pair("target", prefill_chunk=16)
    prompt = _prompt()
    np.testing.assert_array_equal(tc.generate_beam(prompt, num_beams=4,
                                                   max_new_tokens=8),
                                  tt.generate_beam(prompt, num_beams=4,
                                                   max_new_tokens=8))
