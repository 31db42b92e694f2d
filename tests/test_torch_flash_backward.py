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
import contextlib

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


def _chip_smoke():
    """``chip_smoke.py`` as a module, for its tolerances."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rounded_backward(q, k, v, out, lse, do, *, causal, q_offset=0,
                      split=True):
    """A model of the bf16 kernels' rounding: the plain backward with P and
    dS rounded to bf16 before the second products (dS K, P^T dO, dS^T Q),
    as the tensor cores take them from registers.  ``split``: each as the
    pair hi = bf16(x), lo = bf16(x - hi), summed by the products, as the
    kernels do; else one bf16 rounding, as the library backward does."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / np.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        q_pos = torch.arange(sq)[:, None] + q_offset
        s = s.masked_fill(q_pos < torch.arange(sk)[None, :], fa.NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - fa._delta(out, do).reshape(b, h, sq, 1))

    def rounded(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float() if split else hi

    p, ds = rounded(p), rounded(ds)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


SPLIT = [pytest.param(True, id="hi-lo"), pytest.param(False, id="one-bf16")]


@pytest.mark.parametrize("split", SPLIT)
def test_bf16_rounding_of_p_and_ds_fits_the_kernel_tolerance(split):
    """Rounding P and dS to bf16 before the second products keeps the
    gradients within chip_smoke's bf16 tolerance of the plain version at
    S=1024, the training length."""
    tol = _chip_smoke().GRAD_TOL[torch.bfloat16]
    q, k, v, do = (_t(x, torch.bfloat16)
                   for x in _inputs(1, 1024, 1024, 2, 64, seed=5))
    out, lse = fa.flash_attention_forward_reference(q, k, v, causal=True)
    model = _rounded_backward(q, k, v, out, lse, do, causal=True,
                              split=split)
    plain = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  causal=True)
    for m, p in zip(model, plain):
        assert m.dtype == torch.bfloat16
        np.testing.assert_allclose(m.float().numpy(), p.float().numpy(),
                                   **tol)


@pytest.mark.parametrize("split", SPLIT)
def test_bf16_rounding_of_p_and_ds_matches_jax_kernels(split):
    """The rounding model against JAX's backward kernels (interpret mode) at
    the bf16 shape of ``test_bf16_backward_matches_jax_kernels``."""
    tol = _chip_smoke().GRAD_TOL[torch.bfloat16]
    q, k, v, do = _inputs(2, 96, 160, 2, 64, seed=3)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    out, lse = _flash_forward(*jb[:3], causal=True, q_offset=64)
    want = _flash_backward_kernels(*jb[:3], out, lse, jb[3], causal=True,
                                   q_offset=64)
    got = _rounded_backward(
        *(_t(x, torch.bfloat16) for x in (q, k, v)),
        _t(np.asarray(out, np.float32), torch.bfloat16), _t(lse),
        _t(do, torch.bfloat16), causal=True, q_offset=64, split=split)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), _np(w), **tol)


def test_hi_lo_split_leaves_the_tolerance_to_the_output_rounding():
    """Why the kernels split P and dS: at head dim 128 and unit-scale
    inputs, |dP| reaches tens and the dS of a causal row with few keys
    nearly cancel, so one bf16 rounding of P and dS uses most of the 1e-2
    tolerance (on the card it broke it at one element); the hi + lo pair
    leaves the error at the output's own bf16 rounding."""
    rng = np.random.default_rng(3)
    q, k, v, do = (_t(rng.standard_normal((1, 128, 4, 128)), torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_attention_forward_reference(q, k, v, causal=True)
    plain = fa.flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  causal=True)

    def worst(split):   # max(|err| - tolerance) over the three gradients
        model = _rounded_backward(q, k, v, out, lse, do, causal=True,
                                  split=split)
        return max(float(((m.float() - p.float()).abs() -
                          (1e-2 + 1e-2 * p.float().abs())).max())
                   for m, p in zip(model, plain))

    assert worst(split=False) > -0.005
    assert worst(split=True) < -0.009


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_path_computes_delta_in_the_dq_kernel(monkeypatch, dtype):
    """The CUDA half of ``flash_attention_backward`` runs no torch reduction
    for delta: the dq kernel gets O and an fp32 (B*H, Sq) delta buffer, and
    the dk/dv kernel gets that same buffer.  Fake kernels record the
    arguments, so no card is needed."""
    calls = []

    def fake(name):
        def kernel(*args):
            calls.append((name, args))
            return 0
        return kernel

    def no_delta(*_):
        raise AssertionError("_delta called on the CUDA path")

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa, "_delta", no_delta)
    monkeypatch.setattr(fa, "_bwd_kernels",
                        lambda: (fake("dq"), fake("dkv")))
    monkeypatch.setattr(fa.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fa.torch.cuda, "current_stream", lambda: Stream())
    q, k, v, do = (_t(x, dtype) for x in _inputs(2, 40, 72, 3, 64, seed=6))
    out = torch.zeros_like(q)
    lse = torch.zeros(6, 40)
    before = (fa.FLASH_BWD_DQ_LAUNCHES, fa.FLASH_BWD_DKV_LAUNCHES)
    dq, dk, dv = fa._backward_kernels(q, k, v, out, lse, do, True, 0)
    assert (fa.FLASH_BWD_DQ_LAUNCHES - before[0],
            fa.FLASH_BWD_DKV_LAUNCHES - before[1]) == (1, 1)
    (dq_name, dq_args), (dkv_name, dkv_args) = calls
    assert (dq_name, dkv_name) == ("dq", "dkv")
    assert dq_args[4] == out.data_ptr() and dq_args[7] == dq.data_ptr()
    assert dkv_args[5] == dq_args[6]          # the delta the dq kernel wrote
    assert dkv_args[6:8] == (dk.data_ptr(), dv.data_ptr())
    assert len(dq_args[14]) == 15 and len(dkv_args[14]) == 12
    assert list(dq_args[14])[12:] == list(out.stride()[:3])
