"""The port's flash attention against the JAX package's.

Inputs come from numpy with a seed and go through both packages.  On the
CPU the JAX forward runs its Pallas kernels in interpret mode and the
port's wrapper runs its plain PyTorch version (the CUDA kernel is held to
that plain version on the card by chip_smoke.py).  Tolerances: fp32 at
rtol = atol = 2e-5, as tests/ops/test_attention.py; bf16 outputs at 1e-2
(about two bf16 ulps at |out| < 1: both sides compute in fp32 and round
once, at different points).  The bf16 CUDA kernel rounds P to bf16 once
before P V; ``_rounded_forward`` models that here.
"""
import contextlib

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
# bf16 outputs against the plain version, chip_smoke.py's TOL for bf16
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


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
    """A call that needs a gradient goes through the ``flash_fwd`` op, whose
    registered gradient is the ``flash_bwd`` op, and gives autograd's
    gradients through the plain forward, at fp32 TOL."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(1, 32, 32, 1, 64))
    do = torch.from_numpy(_qkv(1, 32, 32, 1, 64, seed=9)[0])
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    ref_out, _ = fa.flash_attention_forward_reference(q, k, v, causal=True)
    for g, r in zip(grads, torch.autograd.grad(ref_out, (q, k, v), do)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL)


def _rounded_forward(q, k, v, *, causal, q_offset=0):
    """A model of the bf16 kernel's rounding: S from the bf16 q and k with
    fp32 sums, scaled in fp32 after the product, and P = exp(S - m) summed
    into l in fp32, then rounded once to bf16 before P V, as the tensor
    cores take it from registers."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(d)
    if causal:
        q_pos = torch.arange(sq)[:, None] + q_offset
        s = s.masked_fill(q_pos < torch.arange(sk)[None, :], fa.NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-20)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, (m + torch.log(l)).reshape(b * h, sq)


def _worst(got, want, atol, rtol) -> float:
    """max(|got - want| - (atol + rtol |want|)): below 0 is within the
    tolerance, and -atol would be no error at all."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


# (sq, sk, d, causal, q_offset)
ROUNDING_CASES = [
    pytest.param(1024, 1024, 64, True, 0, id="train-d64"),
    pytest.param(1024, 1024, 128, True, 0, id="s1024-d128"),
    pytest.param(256, 1000, 128, False, 0, id="ragged-noncausal-d128"),
    pytest.param(96, 160, 64, True, 64, id="q-offset"),
]


@pytest.mark.parametrize("sq,sk,d,causal,off", ROUNDING_CASES)
def test_bf16_rounding_of_p_fits_the_kernel_tolerance(sq, sk, d, causal, off):
    """One bf16 rounding of P keeps the output within the bf16 tolerance of
    both the plain version and JAX's bf16 ``_flash_forward`` (interpret
    mode), with more than half of the 1e-2 margin left: the error stays at
    the output's own rounding, so P needs no hi + lo pair (unlike the
    backward's dS).  lse is unaffected by the rounding."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, n, 2, d)).astype(np.float32)
               for n in (sq, sk, sk))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, lse = _rounded_forward(tq, tk, tv, causal=causal, q_offset=off)
    plain_out, plain_lse = fa.flash_attention_forward_reference(
        tq, tk, tv, causal=causal, q_offset=off)
    j_out, j_lse = _flash_forward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        q_offset=off)
    assert out.dtype == torch.bfloat16
    assert _worst(out, plain_out, **BF16_TOL) < -0.005
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(j_out, np.float32), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=1e-5,
                               atol=1e-4)


def _fake_cuda(monkeypatch, kernel):
    """Run ``_launch``'s CUDA half on CPU tensors with ``kernel`` in place
    of the built entry point."""

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(fa, "_kernel", lambda: kernel)
    monkeypatch.setattr(fa.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(fa.torch.cuda, "current_stream", lambda: Stream())


def test_cuda_path_sends_bf16_to_the_tensor_core_kernel(monkeypatch):
    """``_launch`` hands the entry point dtype 1 for bf16 (which the
    launcher sends to the tensor-core kernel) and 0 for fp32, with the
    (B, S, H) strides of the model's packed qkv views, and counts one
    launch each.  A fake kernel records the arguments, so no card is
    needed."""
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0

    _fake_cuda(monkeypatch, kernel)
    rng = np.random.default_rng(8)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.from_numpy(
            rng.standard_normal((2, 40, 3 * 3 * 64)).astype(np.float32))
        q, k, v = (t.unflatten(-1, (3, 64))
                   for t in qkv.to(dtype).chunk(3, dim=-1))
        before = fa.FLASH_FWD_LAUNCHES
        out, lse = fa._launch(q, k, v, True, 0)
        assert fa.FLASH_FWD_LAUNCHES - before == 1
        args = calls[-1]
        assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr())
        assert args[5] == (1 if dtype == torch.bfloat16 else 0)
        assert args[6:11] == (2, 3, 40, 40, 64)
        assert args[11:20] == (*q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3])
        assert q.stride()[:3] == (40 * 576, 576, 64)
        assert out.dtype == dtype and lse.shape == (6, 40)


def test_forward_wrapper_rejects_misaligned_bf16(monkeypatch):
    """The bf16 kernel copies 16-byte chunks: a pointer or a (B, S, H)
    stride that is not a multiple of 16 bytes raises before any launch;
    fp32 takes any."""
    def kernel(*args):
        raise AssertionError("kernel called")

    _fake_cuda(monkeypatch, kernel)

    def bf16(shape, offset=0):
        flat = torch.zeros(offset + int(torch.Size(shape).numel()),
                           dtype=torch.bfloat16)
        return flat[offset:].view(shape)

    q, k, v = (bf16((1, 8, 2, 64)) for _ in range(3))
    odd = bf16((1, 8, 2, 68))[..., :64]          # S and H strides of 68
    for bad in ((q, k, bf16((1, 8, 2, 64), offset=1)), (q, odd, v)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fa._launch(*bad, True, 0)
    with pytest.raises(AssertionError, match="kernel called"):
        fa._launch(*(t.float() for t in (q, odd, v)), True, 0)


def test_make_fx_traces_one_forward_and_one_backward_op(monkeypatch):
    """``make_fx`` in fake mode of a flash call and its gradient holds
    exactly one forward and one backward custom-op node; the traced graph
    run on CPU tensors equals eager bit for bit.  Tracing calls neither
    wrapper (both raise while it runs), so it launches nothing and moves
    no launch counter."""
    from torch.fx.experimental.proxy_tensor import make_fx

    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 48, 48, 2, 64, seed=4))
    do = torch.from_numpy(_qkv(2, 48, 48, 2, 64, seed=5)[0])

    def f(q, k, v, do):
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = fa.flash_attention(qq, kk, vv, causal=True)
            return [out, *torch.autograd.grad(out, (qq, kk, vv), do)]

    counters = (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
                fa.FLASH_BWD_DKV_LAUNCHES)

    def untouched(*args, **kwargs):
        raise AssertionError("tracing called a kernel wrapper")

    with monkeypatch.context() as m:
        m.setattr(fa, "flash_attention_forward", untouched)
        m.setattr(fa, "flash_attention_backward", untouched)
        gm = make_fx(f, tracing_mode="fake")(q, k, v, do)
    targets = [n.target for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count(torch.ops.alpa_tpu_torch.flash_fwd.default) == 1
    assert targets.count(torch.ops.alpa_tpu_torch.flash_bwd.default) == 1
    assert (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
            fa.FLASH_BWD_DKV_LAUNCHES) == counters
    for traced, eager in zip(gm(q, k, v, do), f(q, k, v, do)):
        assert torch.equal(traced, eager)
