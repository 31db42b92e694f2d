"""Flash-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of ``alpa_tpu/ops/flash_attention.py``.  The JAX package has
two forward Pallas kernels, one with k/v resident in VMEM and one that
streams k/v once they pass 4 MiB per (batch, head).  They compute the same
function, and the CUDA kernel in ``csrc/flash_fwd.cu`` replaces both: a
loop over k tiles inside the block does what the streaming grid dimension
did, so the port has no residency limit.

``flash_attention_forward`` is the kernel's wrapper.  A CPU tensor goes to
the plain version; a CUDA tensor launches the kernel or raises.  Every
launch adds one to ``FLASH_FWD_LAUNCHES``.

The backward kernels (the JAX package's ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``) come with the training slice; until then a call
that needs a gradient raises ``NotImplementedError``.
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

_SOURCE = "flash_fwd.cu"
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


def _kernel_args(q, k, v):
    """Validate what the CUDA kernel takes; raise on anything else."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {_HEAD_DIMS}; got "
                         f"{q.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous head dimension")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


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
    the Hopper kernel (fp32 or bf16, head dim 64 or 128, any strides with a
    contiguous head dim) and raises on what the kernel cannot take."""
    _check_shapes(q, k, v, q_offset)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, causal=causal,
                                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, "
                         f"not {q.device.type}")
    return _launch(q, k, v, causal, q_offset)


def flash_attention(q, k, v, *, causal: bool = True, offset: int = 0,
                    block_q: int = 256, block_k: int = 256):
    """Drop-in replacement for ``reference_attention`` (model/gpt_model.py)
    with the JAX package's signature.  ``block_q``/``block_k`` are accepted
    as hints; the CUDA kernel picks its own tiles."""
    del block_q, block_k
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward kernel yet (the training "
            "slice ports _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel)")
    return flash_attention_forward(q, k, v, causal=causal,
                                   q_offset=offset)[0]
