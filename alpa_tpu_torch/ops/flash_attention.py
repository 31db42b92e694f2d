"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions.

Counterpart of ``alpa_tpu/ops/flash_attention.py``.  The JAX package has
two forward Pallas kernels, one with k/v resident in VMEM and one that
streams k/v once they pass 4 MiB per (batch, head).  They compute the same
function, and the CUDA kernel in ``csrc/flash_fwd.cu`` replaces both: a
loop over k tiles inside the block does what the streaming grid dimension
did, so the port has no residency limit.  For bf16 it runs on the tensor
cores, for fp32 on the CUDA cores.

The backward keeps the JAX package's two kernels, ``_flash_bwd_dq_kernel``
and ``_flash_bwd_dkv_kernel``, as two CUDA kernels in ``csrc/flash_bwd.cu``:
for bf16 they run on the tensor cores, for fp32 on the CUDA cores.  The dq
kernel also computes delta = rowsum(dO * O), which the JAX package computes
in XLA, and hands it to the dk/dv kernel in an fp32 buffer.  The JAX
package runs its kernels only while k/v (and q/dO) fit its 4 MiB VMEM
budget and recomputes through the einsum reference beyond it; the GPU has
no such limit, so the port runs its kernels at every length.

``flash_attention_forward`` and ``flash_attention_backward`` are the
kernels' wrappers.  A CPU tensor goes to the plain version; a CUDA tensor
launches the kernels or raises.  Every launch adds one to its counter:
``FLASH_FWD_LAUNCHES``, ``FLASH_BWD_DQ_LAUNCHES``, ``FLASH_BWD_DKV_LAUNCHES``.
The two wrappers are also the ``torch.library`` custom ops
``alpa_tpu_torch::flash_fwd`` and ``alpa_tpu_torch::flash_bwd``, the first
with the second as its registered gradient (the counterpart of the JAX
package's ``custom_vjp``).  ``make_fx`` cannot see into a ``ctypes`` call,
so a traced graph holds each call as one op node, shaped by the ops' fake
implementations; tracing launches nothing and moves no counter.
``flash_attention`` goes through these ops.
"""
import ctypes
import functools
import math
from typing import Tuple

import torch

from alpa_tpu_torch.ops import _build

NEG_INF = -1e9

#: kernel launches made by ``flash_attention_forward`` in this process
FLASH_FWD_LAUNCHES = 0
#: launches of the dq and the dk/dv kernel by ``flash_attention_backward``
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0

_SOURCE = "flash_fwd.cu"
_BWD_SOURCE = "flash_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_shapes(q, k, v, q_offset):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch, heads or head dim")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be a non-negative int, got "
                         f"{q_offset!r}")


def flash_attention_forward_reference(q, k, v, *, causal: bool,
                                      q_offset: int = 0
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the JAX kernels'
    semantics.  q: (B, Sq, H, D); k, v: (B, Sk, H, D).  Returns
    ``(out (B, Sq, H, D) in q's dtype, lse (B*H, Sq) fp32)``."""
    _check_shapes(q, k, v, q_offset)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(d)),
                     k.float())
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-20)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = (acc / l.transpose(1, 2)[..., None]).to(q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, sq)
    return out, lse


def _kernel_args(*tensors):
    """Validate what the CUDA kernels take (q, k, v and, for the backward,
    dO); raise on anything else."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype; got {[t.dtype for t in tensors]}")
    if tensors[0].shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {_HEAD_DIMS}; got "
                         f"{tensors[0].shape[-1]}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash kernel needs a contiguous head dimension")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"flash kernel inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")


def _aligned(t) -> bool:
    """What the bf16 kernels' 16-byte copies need of a tensor."""
    return t.dtype != torch.bfloat16 or (
        t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built kernel's C entry point, with its signature declared."""
    fn = _build.load(_SOURCE).alpa_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 +
                   [ctypes.c_int64] * 9 +
                   [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])
    return fn


def _launch(q, k, v, causal: bool, q_offset: int):
    global FLASH_FWD_LAUNCHES
    _kernel_args(q, k, v)
    if not all(map(_aligned, (q, k, v))):
        raise ValueError("bf16 flash forward needs 16-byte aligned pointers "
                         "and (B, S, H) strides")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], b, h, sq, sk, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), q_offset, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def flash_attention_forward(q, k, v, *, causal: bool, q_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of flash attention; the port of ``_flash_forward``.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the Hopper kernel (fp32 or bf16, head dim 64 or 128, strides with a
    contiguous head dim, for bf16 multiples of 16 bytes, as are the
    pointers) and raises on what the kernel cannot take."""
    _check_shapes(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, causal=causal,
                                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"not {q.device.type}")
    return _launch(q, k, v, causal, q_offset)


def _delta(out, do) -> torch.Tensor:
    """rowsum(dO * O) in fp32, laid out (B*H, Sq) as lse, for the plain
    version (the dq kernel computes its own).  ``out`` is taken as saved, in
    q's dtype, as the JAX package takes it (``:360``)."""
    b, sq, h, _ = out.shape
    return (do.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        b * h, sq)


def _check_backward(q, k, v, out, lse, do, q_offset):
    _check_shapes(q, k, v, q_offset)
    b, sq, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dO {tuple(do.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if lse.shape != (b * h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(b * h, sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def flash_attention_backward_reference(q, k, v, out, lse, do, *,
                                       causal: bool, q_offset: int = 0
                                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch version of the two backward kernels, with the JAX
    kernels' math (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``): P
    rebuilt from the saved ``lse``, delta from the saved ``out``, products
    in fp32.  Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    _check_backward(q, k, v, out, lse, do, q_offset)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _delta(out, do).reshape(b, h, sq, 1))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    """The dq and dk/dv kernels' C entry points, signatures declared."""
    lib = _build.load(_BWD_SOURCE)
    tail = ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_void_p])
    dq, dkv = lib.alpa_flash_bwd_dq, lib.alpa_flash_bwd_dkv
    dq.restype = dkv.restype = ctypes.c_int
    dq.argtypes = [ctypes.c_void_p] * 8 + tail
    dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    return dq, dkv


def _bwd_common(q, k, v, do, causal, q_offset, out=None):
    """The arguments both backward entry points take after their pointers,
    with the (B, S, H) strides of q, k, v, dO and, for the dq kernel, O.
    Also checks what the kernels take: the bf16 kernels copy 16-byte chunks,
    so their pointers and strides must be multiples of 16 bytes."""
    tensors = (q, k, v, do) if out is None else (q, k, v, do, out)
    _kernel_args(*tensors)
    if not all(map(_aligned, tensors)):
        raise ValueError("bf16 flash backward needs 16-byte aligned "
                         "pointers and (B, S, H) strides")
    b, sq, h, d = q.shape
    strides = [s for t in tensors for s in t.stride()[:3]]
    return (_DTYPES[q.dtype], b, h, sq, k.shape[1], d,
            (ctypes.c_int64 * len(strides))(*strides), int(causal), q_offset,
            1.0 / math.sqrt(d))


def _launch_bwd_dq(q, k, v, out, do, lse, causal: bool, q_offset: int):
    """Launch the dq kernel; returns ``(dq, delta)``, delta = rowsum(dO * O)
    in fp32 (B*H, Sq), computed by the kernel for the dk/dv kernel."""
    global FLASH_BWD_DQ_LAUNCHES
    common = _bwd_common(q, k, v, do, causal, q_offset, out)
    b, sq, h, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *common, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError "
                           f"{err}")
    FLASH_BWD_DQ_LAUNCHES += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal: bool, q_offset: int):
    """Launch the dk/dv kernel with the delta the dq kernel wrote."""
    global FLASH_BWD_DKV_LAUNCHES
    common = _bwd_common(q, k, v, do, causal, q_offset)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *common, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError "
                           f"{err}")
    FLASH_BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, do, *, causal: bool,
                             q_offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` of flash attention from the forward's residuals;
    the port of ``_flash_backward_kernels``.

    On a CPU tensor this is the plain version; on a CUDA tensor it launches
    the dq kernel, which also computes delta, then the dk/dv kernel (fp32
    or bf16, head dim 64 or 128, strided q/k/v/dO with a contiguous head
    dim), and raises on what the kernels cannot take."""
    _check_backward(q, k, v, out, lse, do, q_offset)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, out, lse, do,
                                                  causal=causal,
                                                  q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"not {q.device.type}")
    return _backward_kernels(q, k, v, out, lse, do, causal, q_offset)


def _backward_kernels(q, k, v, out, lse, do, causal: bool, q_offset: int):
    """The CUDA half of ``flash_attention_backward``: the dq kernel, which
    also writes delta, then the dk/dv kernel on the same stream."""
    if do.stride(-1) != 1 or not _aligned(do):  # autograd's dO: any layout
        do = do.clone(memory_format=torch.contiguous_format)
    lse = lse.contiguous()
    dq, delta = _launch_bwd_dq(q, k, v, out, do, lse, causal, q_offset)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, delta, causal, q_offset)
    return dq, dk, dv


@torch.library.custom_op("alpa_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, q_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_forward`` as one op: one node of a traced graph,
    which launches the kernel on CUDA tensors (the plain version on CPU
    ones) when the graph runs.  Outputs are contiguous, as the fake
    implementation gives them."""
    out, lse = flash_attention_forward(q, k, v, causal=causal,
                                       q_offset=q_offset)
    return out.contiguous(), lse.contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, q_offset):
    del k, v, causal, q_offset
    b, sq, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b * h, sq), dtype=torch.float32)


@torch.library.custom_op("alpa_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool, q_offset: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_backward`` as one op (see ``flash_fwd_op``)."""
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                     q_offset=q_offset)
    return tuple(g.contiguous() for g in grads)


@flash_bwd_op.register_fake
def _flash_bwd_fake(q, k, v, out, lse, do, causal, q_offset):
    del out, lse, do, causal, q_offset
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    """The counterpart of the JAX package's ``custom_vjp`` residuals: the
    forward saves ``(q, k, v, out, lse)`` and the backward consumes them."""
    q, k, v, causal, q_offset = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.q_offset = causal, q_offset


def _flash_backward(ctx, do, dlse):
    del dlse   # lse is a residual; nothing differentiates it
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, do, ctx.causal,
                              ctx.q_offset)
    return dq, dk, dv, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q, k, v, *, causal: bool = True, offset: int = 0,
                    block_q: int = 256, block_k: int = 256):
    """Drop-in replacement for ``reference_attention`` (model/gpt_model.py)
    with the JAX package's signature.  ``block_q``/``block_k`` are accepted
    as hints; the CUDA kernels pick their own tiles.  Differentiable, and
    one node of a graph traced with ``make_fx``: the call goes through
    ``flash_fwd_op``, whose gradient is ``flash_bwd_op``."""
    del block_q, block_k
    return flash_fwd_op(q, k, v, causal, offset)[0]
