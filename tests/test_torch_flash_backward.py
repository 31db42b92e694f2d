"""The port's flash-attention backward against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the
CPU the JAX backward runs its Pallas kernels in interpret mode (as
tests/ops/test_attention.py runs them) and the port's wrapper runs its
plain PyTorch version (the CUDA kernels are held to that plain version on
the card by chip_smoke.py).  Tolerances: fp32 gradients at rtol = atol =
2e-4 against the Pallas kernels, 3e-4 against the recompute path beyond
4 MiB (its einsum reference sums over 16384 keys in another order); bf16
gradients at 1e-2 (about two bf16 ulps: both sides compute in fp32 and
round once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpa_tpu.ops.flash_attention import (VMEM_RESIDENT_LIMIT,
                                          _bwd_kernels_feasible,
                                          _flash_backward_kernels,
                                          _flash_forward)
from alpa_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from alpa_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


def _inputs(b, sq, sk, h, d, seed=0):
    """q, k, v, dO as numpy fp32."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) * 0.5
                 for shape in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d),
                               (b, sq, h, d)))


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


# (b, sq, sk, h, d, causal, q_offset)
CASES = [
    pytest.param(2, 128, 128, 2, 64, True, 0, id="s128-causal"),
    pytest.param(2, 128, 128, 2, 64, False, 0, id="s128-noncausal"),
    pytest.param(2, 96, 96, 2, 64, True, 0, id="s96-causal"),
    pytest.param(2, 96, 96, 2, 64, False, 0, id="s96-noncausal"),
    pytest.param(2, 32, 128, 2, 64, True, 64, id="q-offset"),
]


@pytest.mark.parametrize("b,sq,sk,h,d,causal,off", CASES)
def test_plain_backward_matches_jax_kernels(b, sq, sk, h, d, causal, off):
    """(dq, dk, dv) of the port's wrapper == JAX ``_flash_backward_kernels``
    from the same (out, lse) residuals, at TOL; no launch on the CPU."""
    q, k, v, do = _inputs(b, sq, sk, h, d)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = _flash_forward(jq, jk, jv, causal=causal, q_offset=off)
    want = _flash_backward_kernels(jq, jk, jv, out, lse, jdo, causal=causal,
                                   q_offset=off)
    before = (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
    got = fa.flash_attention_backward(_t(q), _t(k), _t(v), _t(out),
                                      _t(lse), _t(do), causal=causal,
                                      q_offset=off)
    assert (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_bf16_backward_matches_jax_kernels():
    """bf16 inputs and residuals: gradients in bf16 within 1e-2."""
    q, k, v, do = _inputs(2, 96, 160, 2, 64, seed=3)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, lse = _flash_forward(*jb[:3], causal=True, q_offset=64)
    want = _flash_backward_kernels(*jb[:3], out, lse, jb[3], causal=True,
                                   q_offset=64)
    tb = [_t(x, torch.bfloat16) for x in (q, k, v)]
    got = fa.flash_attention_backward(
        *tb, _t(np.asarray(out, np.float32), torch.bfloat16), _t(lse),
        _t(do, torch.bfloat16), causal=True, q_offset=64)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=1e-2,
                                   atol=1e-2)


def _jax_grads(q, k, v, do, causal, off):
    def loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, causal=causal, offset=off)
        return jnp.sum(out * jnp.asarray(do))
    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, do, causal, off):
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, offset=off)
    return torch.autograd.grad(out, (tq, tk, tv), _t(do))


@pytest.mark.parametrize("causal,off", [(True, 0), (False, 0), (True, 64)])
def test_autograd_flash_attention_matches_jax(causal, off):
    """Gradients through the port's differentiable ``flash_attention`` ==
    ``jax.grad`` through JAX's (its backward kernels here), at TOL."""
    sq = 32 if off else 128
    q, k, v, do = _inputs(2, sq, 128, 2, 64, seed=1)
    for g, w in zip(_port_grads(q, k, v, do, causal, off),
                    _jax_grads(q, k, v, do, causal, off)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_over_4MiB_matches_jax_recompute_path():
    """k/v of 8 MiB per (b, h): JAX recomputes the backward through its
    einsum reference; the port runs its kernels (here their plain version)
    at every length.  Gradients agree at 3e-4."""
    q, k, v, do = _inputs(1, 256, 16384, 1, 64, seed=2)
    assert 2 * 16384 * 64 * 4 > VMEM_RESIDENT_LIMIT
    assert not _bwd_kernels_feasible(jnp.asarray(q), jnp.asarray(k))
    for g, w in zip(_port_grads(q, k, v, do, True, 16128),
                    _jax_grads(q, k, v, do, True, 16128)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=3e-4, atol=3e-4)


def test_backward_reference_is_not_autograd_of_forward():
    """The plain backward takes (out, lse) as given: it rebuilds P from the
    saved lse and delta from the saved out, as the kernels do.  Feeding a
    shifted lse scales P, which autograd through the forward never sees."""
    q, k, v, do = (_t(x) for x in _inputs(1, 32, 32, 1, 64, seed=4))
    out, lse = fa.flash_attention_forward_reference(q, k, v, causal=True)
    dv = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                               causal=True)[2]
    dv_shift = fa.flash_attention_backward_reference(
        q, k, v, out, lse + np.log(2.0), do, causal=True)[2]
    np.testing.assert_allclose(dv_shift.numpy(), dv.numpy() / 2, rtol=1e-5,
                               atol=1e-6)
