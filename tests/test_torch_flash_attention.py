"""The port's flash attention against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the
CPU the JAX forward runs its Pallas kernels in interpret mode and the
port's wrapper runs its plain PyTorch version (the CUDA kernel is held to
that plain version on the card by chip_smoke.py).  Tolerances: fp32 at
rtol = atol = 2e-5, as tests/ops/test_attention.py; bf16 outputs at 1e-2
(about two bf16 ulps at |out| < 1: both sides compute in fp32 and round
once, at different points).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpa_tpu.model.gpt_model import \
    reference_attention as jax_reference_attention
from alpa_tpu.ops.flash_attention import VMEM_RESIDENT_LIMIT, _flash_forward
from alpa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from alpa_tpu_torch.model.gpt_model import reference_attention
from alpa_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) * 0.5
                 for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


# (b, sq, sk, h, d, causal, q_offset)
CASES = [
    pytest.param(2, 128, 128, 4, 64, True, 0, id="s128-causal"),
    pytest.param(2, 128, 128, 4, 64, False, 0, id="s128-noncausal"),
    pytest.param(2, 96, 96, 4, 64, True, 0, id="s96-causal"),
    pytest.param(2, 96, 96, 4, 64, False, 0, id="s96-noncausal"),
    pytest.param(2, 32, 128, 4, 64, True, 64, id="q-offset"),
    # k/v of 8 MiB per (b, h): JAX takes its streaming kernel here
    pytest.param(1, 256, 16384, 1, 64, True, 16128, id="over-4MiB"),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,off", CASES)
def test_forward_matches_jax_kernel(b, sq, sk, h, d, causal, off):
    """(out, lse) of the port's wrapper == JAX ``_flash_forward``."""
    q, k, v = _qkv(b, sq, sk, h, d)
    j_out, j_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, q_offset=off)
    before = fa.FLASH_FWD_LAUNCHES
    t_out, t_lse = fa.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=off)
    assert fa.FLASH_FWD_LAUNCHES == before   # CPU: plain version, no launch
    assert t_out.dtype == torch.float32 and t_lse.shape == (b * h, sq)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


def test_cases_cover_both_jax_kernels():
    """The case list holds k/v sizes on both sides of the JAX package's
    resident/streaming line, so both Pallas forwards are compared."""
    sizes = {2 * p.values[2] * p.values[4] * 4 > VMEM_RESIDENT_LIMIT
             for p in CASES}
    assert sizes == {False, True}


@pytest.mark.parametrize("causal,off", [(True, 0), (False, 0), (True, 64)])
def test_flash_attention_matches_jax_flash_and_reference(causal, off):
    sq = 32 if off else 128
    q, k, v = _qkv(2, sq, 128, 4, 64, seed=1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             offset=off).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jax_flash_attention(jq, jk, jv, causal=causal,
                                            offset=off)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jax_reference_attention(jq, jk, jv, causal=causal,
                                                offset=off)), **TOL)


def test_reference_attention_per_row_offset_matches_jax():
    q, k, v = _qkv(3, 1, 64, 4, 64, seed=2)
    offs = np.array([3, 40, 63], np.int32)
    out = reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              offset=torch.from_numpy(offs).long())
    ref = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  offset=jnp.asarray(offs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bf16_forward_matches_jax_kernel():
    q, k, v = _qkv(2, 96, 160, 2, 64, seed=3)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    j_out, j_lse = _flash_forward(*jb, causal=True, q_offset=64)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    t_out, t_lse = fa.flash_attention_forward(*tb, causal=True, q_offset=64)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


def test_gradients_flow_through_flash_attention():
    """A call that needs a gradient goes through ``FlashAttention`` and
    gives autograd's gradients through the plain forward, at fp32 TOL."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(1, 32, 32, 1, 64))
    do = torch.from_numpy(_qkv(1, 32, 32, 1, 64, seed=9)[0])
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref_out, _ = fa.flash_attention_forward_reference(q, k, v, causal=True)
    for g, r in zip(grads, torch.autograd.grad(ref_out, (q, k, v), do)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)
