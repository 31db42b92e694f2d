"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

or, on a machine with two cards or more, ``python3 chip_smoke.py
--two-cards`` for phase 8's fidelity and dispatch checks with the two
stages on two cards (cross-card RESHARDs, one CUDA graph pool per card,
CUDA events across cards).

Phases, each reported on its own line:

1. setup: the card's name and power limit; build the flash kernels from
   ``alpa_tpu_torch/csrc`` (one nvcc per source, started together) and
   report the build time;
2. kernel: the CUDA flash-attention forward against its plain PyTorch
   version on the card, case by case (ragged lengths, both head dims, with
   and without the causal mask, the model's packed qkv views), with the
   tolerance stated; at the training shape two runs give bit-identical
   outputs; times of the kernel, the plain version and
   ``scaled_dot_product_attention`` (a yardstick only, never called by the
   port) at the serving prefill shape and at the training shape, beside the
   least time the card could take;
3. backward kernels: the dq and dk/dv kernels against the plain backward,
   case by case; at the training shape two runs give bit-identical
   gradients, the library backward's own error against the plain version
   is printed beside the kernels', and the kernels' times stand beside the
   plain version, ``torch.autograd.grad`` through
   ``scaled_dot_product_attention`` (its forward excluded) and the least
   time the card could take;
4. serving: ``run_controller`` + ``register_model`` of OPT-1.3B (bf16,
   flash attention, all 24 layers, random weights from a seed), four
   concurrent ``POST /completions`` of 37, 128, 300 and 511 tokens with 32
   greedy new tokens; every prefill must have launched the kernel once per
   layer;
5. fidelity: a 4-layer fp32 OPT-1.3B with the same weights generates the
   same greedy tokens with the kernel as with the plain version;
6. training: ``bench.py``'s GPT train step at GPT-1.3B's full 24 layers
   (h2048, seq 1024, batch 8, bf16 compute, fp32 params and Adam, flash
   attention, per-block remat) through ``parallelize(ShardParallel())``
   and ``value_and_grad``: 3 warm-up and 10 timed steps, 48 forward and
   24 + 24 backward launches per step, a finite loss that falls; step
   time, tokens/s, TFLOPS, MFU and peak memory, and a line in
   ``bench.py``'s JSON schema; then ``torch.profiler`` over two more
   steps: the ten heaviest kernels by device time and the device's busy
   share;
7. training fidelity: the same model in fp32 at 4 layers, batch 2, takes
   3 Adam steps with the kernels and 3 with the plain versions in their
   place; losses agree to 1e-5 relative, step-0 gradients to 1e-4 of each
   tensor's largest;
8. pipeshard: the README's ``PipeshardParallel`` example on GPT-1.3B
   (``ManualLayerOption`` at ``pipeline_boundary_every``,
   ``UniformStageOption(2)``, 1F1B, one device per stage mesh: the card
   named twice on a one-card machine, else two cards).  Fidelity: GPT-1.3B's
   width at 4 layers in fp32, batch 4, two microbatches, against
   ``ShardParallel`` from the same weights: step-0 gradients to 1e-4 of each
   tensor's largest, and over 2 Adam steps losses to 1e-5 relative and
   parameters to 1e-4 of their tensor's largest value where the step-0
   gradient is at least 1e-2 of the tensor's largest, to Adam's bound of
   2 x lr x steps elsewhere (``param_diffs``).  Full
   width: 24 layers, bf16 compute, fp32 params and Adam, no remat, batch 8
   in 4 microbatches, 3 warm-up and 5 timed steps: a finite loss that
   falls, the first step's loss within 1e-2 relative of one
   ``ShardParallel`` step from the same state and batch, and exactly 96
   forward, 96 dq and 96 dk/dv launches per step; step time, tokens/s,
   TFLOPS, MFU, the allocated peak of the replayed steps beside the CUDA
   graphs' pools, trace and build time, the instruction counts and the
   schedule, then ``torch.profiler`` over two more steps (the first step
   runs the stage graphs as they are, the second captures each stage run
   as a CUDA graph, later steps replay them in the default dispatch mode);
   then the dispatch modes on the same executable, nothing traced again:
   from the seed state, two steps uncaptured and two in each of
   "sequential", "registers", "threaded", "overlap" and "auto", losses and
   parameters bit-identical, with step time, host time per step,
   resharding bytes and each mode's own profiled device share; then the
   peak of its third step without and with the in-place apply-grad, each
   built in this run and run uncaptured, with bit-identical losses; and
   the replayed steps' allocated peak plus the graphs' pools beside the
   uncaptured peak;
8b. pipeshard remat blocks: phase 8 with ``remat_blocks=True`` (GPT's
   per-block remat inside the pipeshard trace): first loss within 1e-2 of
   ``ShardParallel``'s on the same config, 192 forward launches per step,
   step and peak beside phase 8's;
9. pipeshard auto-layer fidelity: the fidelity check of phase 8 for 4
   layers without boundaries under ``AutoLayerOption(layer_num=4,
   remat_layer=True)``;
10. pipeshard auto: the README's headline form at full width and depth,
   GPT-1.3B with no boundaries under ``AutoLayerOption(layer_num=8,
   remat_layer=True)`` and ``UniformStageOption(2)``, 4 microbatches, 1F1B,
   as phase 8 measures it (first loss within 1e-6 of ``ShardParallel``'s,
   192 forward launches per step: each block's forward runs again in its
   layer's backward), with the layer cuts (blocks and flops per layer);
   then one step under ``get_3d_parallel_method(dp=1, op=1, pp=2)`` and one
   under ``AutoStageOption`` on one card (the stage DP's partition, solver
   and solve time), each first loss within 1e-6 of ``ShardParallel``'s;
11. pipeshard infer: a forward-only ``parallelize``d function returning
   GPT-1.3B's logits under ``PipeshardParallel`` (2 stages x 4
   microbatches, the ``"inference"`` schedule, batch 8): logits against the
   eager forward at bf16 tolerance, 96 forward and no backward launch per
   call, call time, host time, device share and tokens/s.

Any failure exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
and the line before it lists the kernels as JSON.
"""
import concurrent.futures
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

import alpa_tpu_torch
from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                            ManualLayerOption, PipeshardParallel,
                            UniformStageOption, get_3d_parallel_method)
from alpa_tpu_torch.model.gpt_model import (GPTModel, config_from_opt_spec,
                                            config_from_spec, init_random_)
from alpa_tpu_torch.model.model_util import (TrainState, adam, gpt_lm_loss,
                                             make_apply_fn)
from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.ops import flash_attention as fa
from alpa_tpu_torch.serve import GenerationConfig, get_model, run_controller
from alpa_tpu_torch.telemetry.perf import GPU_SPECS, compute_mfu
from alpa_tpu_torch.util import compute_gpt_tflops, node_flops

SEED = 0
LR = 1e-4   # Adam's learning rate in every training phase
PROMPT_LENGTHS = (37, 128, 300, 511)
NEW_TOKENS = 32
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
SPEC = GPU_SPECS["h100-sxm"]
PEAK_BYTES_PER_S = SPEC["hbm_bytes_per_s"]
PEAK_FLOPS = {torch.bfloat16: SPEC["peak_bf16_tflops"] * 1e12,
              torch.float32: SPEC["peak_fp32_tflops"] * 1e12}
# bench.py's divisor for vs_baseline (a V100's TFLOPS in the reference)
BASELINE_TFLOPS_PER_DEVICE = 37.01
# backward kernels vs plain: bf16 gradients are rounded once from fp32 on
# both sides (an ulp is 2**-8 relative), and the kernels' second products
# see P and dS to 16 bits (a bf16 hi + lo pair); fp32 gradients differ by
# the order of sums over up to 16384 keys
GRAD_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
            torch.float32: dict(atol=1e-4, rtol=1e-4)}
# kernel vs plain: bf16 outputs are rounded once from fp32 on both sides,
# so they may differ by a bf16 ulp or two (2**-8 relative, 1e-2 at |x|<1);
# fp32 outputs differ only by summation order
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2),
       torch.float32: dict(atol=2e-5, rtol=2e-5)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq, sk, causal, off) -> float:
    """(q, k) pairs the causal mask leaves visible."""
    rows = np.arange(sq)
    return float((np.minimum(sk, rows + off + 1) if causal
                  else np.full(sq, sk)).sum())


def bound(nbytes, flops, dtype):
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and FLOPs over the dtype's peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_bound(b, sq, sk, h, d, causal, off, dtype):
    """Least time for the attention forward on this card: each needed
    input byte read once, each output byte written once, and the FLOPs of
    the (q, k) pairs the causal mask leaves visible."""
    keys = min(sk, sq + off) if causal else sk
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h * d * item * (2 * sq + 2 * keys) + b * h * sq * 4)
    flops = 4.0 * b * h * d * visible_pairs(sq, sk, causal, off)
    return bound(nbytes, flops, dtype)


def flash_bwd_bound(b, sq, sk, h, d, causal, off, dtype, part="all"):
    """Least time for the attention backward (``part="all"``: read q, k,
    v, out, dO, lse, delta, write dq, dk, dv; five products over the
    visible pairs), or for what one kernel computes: ``"dq"`` reads q, k,
    v, dO, lse, delta, writes dq and needs three products (S, dP, dS K);
    ``"dkv"`` writes dk, dv and needs four (S, dP, P^T dO, dS^T Q)."""
    item = torch.tensor([], dtype=dtype).element_size()
    q_t, k_t = b * sq * h * d * item, b * sk * h * d * item
    rows = 2 * b * h * sq * 4            # lse and delta
    nbytes, products = {
        "all": (3 * q_t + 2 * k_t + rows + q_t + 2 * k_t, 5),
        "dq": (2 * q_t + 2 * k_t + rows + q_t, 3),
        "dkv": (2 * q_t + 2 * k_t + rows + 2 * k_t, 4),
    }[part]
    flops = 2.0 * products * b * h * d * visible_pairs(sq, sk, causal, off)
    return bound(nbytes, flops, dtype)


def make_qkv(b, sq, sk, h, d, dtype, gen, packed=False):
    """q as a strided view of a packed qkv projection, as the model gives
    it; k/v as contiguous KV caches or, ``packed`` (self-attention, sq ==
    sk), as views of the same projection, as the model's training and
    cache-free forward give them."""
    qkv = torch.randn(b, sq, 3 * h * d, device="cuda", generator=gen)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.to(dtype).chunk(3, -1))
    if packed:
        return q, k, v
    k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v


def max_violation(a, b, atol, rtol) -> float:
    """max(|a - b| - (atol + rtol |b|)); <= 0 means within tolerance."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def time_fwd(name, q, k, v, causal, off, bnd, bound_by):
    """Times of the forward kernel, its plain version and one
    ``scaled_dot_product_attention`` call on the same inputs."""
    ms = cuda_ms(lambda: fa.flash_attention_forward(
        q, k, v, causal=causal, q_offset=off))
    plain_ms = cuda_ms(lambda: fa.flash_attention_forward_reference(
        q, k, v, causal=causal, q_offset=off))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # is_causal aligns the mask top-left: q_pos >= k_pos, which is q_offset
    # 0, the same function on the same inputs
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    print(f"kernel timing {name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, scaled_dot_product_attention {library_ms:.5f} ms, bound "
          f"{bnd:.5f} ms ({bound_by}) [{card_line()}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_kernel():
    """Returns the forward kernel's entry (timed at the serving prefill
    shape) and its numbers at the training shape."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, b, sq, sk, h, d, causal, q_offset, dtype)
    cases = [
        ("prefill-bucket", 4, 512, 2048, 32, 64, True, 0, bf16),
        ("prefill-chunk", 4, 256, 2048, 32, 64, True, 512, bf16),
        ("non-causal", 2, 512, 512, 32, 64, False, 0, bf16),
        ("ragged-sq96", 4, 96, 2048, 32, 64, True, 0, bf16),
        ("fp32-over-4MiB", 1, 256, 16384, 1, 64, True, 16128, f32),
        ("head-dim-128", 2, 256, 1024, 16, 128, True, 256, bf16),
        # bench.py's GPT-1.3B step: timed, and run twice
        ("train", 8, 1024, 1024, 32, 64, True, 0, bf16),
        ("ragged-sk1000", 2, 300, 1000, 16, 64, False, 0, bf16),
        ("head-dim-128-noncausal", 2, 500, 520, 16, 128, False, 0, bf16),
        # q, k and v as the model's views of one packed qkv projection
        ("model-qkv-views", 2, 1000, 1000, 16, 64, True, 0, bf16),
    ]
    entry = fwd_train = None
    for name, b, sq, sk, h, d, causal, off, dtype in cases:
        q, k, v = make_qkv(b, sq, sk, h, d, dtype, gen,
                           packed=name == "model-qkv-views")
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              q_offset=off)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_forward_reference(
            q, k, v, causal=causal, q_offset=off)
        check(out.shape == ref_out.shape and out.dtype == dtype,
              f"{name}: out {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite out")
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (max_violation(out, ref_out, **TOL[dtype]) <= 0 and
              max_violation(lse, ref_lse, **LSE_TOL) <= 0)
        bnd, bound_by = flash_bound(b, sq, sk, h, d, causal, off, dtype)
        print(f"kernel case {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"causal={causal} q_offset={off} {dtype}: max|out err| "
              f"{err:.3e} (tol {TOL[dtype]}), max|lse err| {lse_err:.3e} "
              f"(tol {LSE_TOL}), bound {bnd:.5f} ms ({bound_by}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"kernel case {name} disagrees with the plain version")
        if name == "prefill-bucket":
            entry = {"name": "flash_fwd", "route": "cuda",
                     "source": "alpa_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "alpa_tpu/ops/flash_attention.py:62",
                     "also_replaces": "alpa_tpu/ops/flash_attention.py:110",
                     "launches": 0, "max_abs_err": err,
                     **time_fwd(name, q, k, v, causal, off, bnd, bound_by)}
        elif name == "train":
            again = fa.flash_attention_forward(q, k, v, causal=causal,
                                               q_offset=off)
            same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
            print(f"kernel case {name}: two runs bit-identical: {same}")
            check(same, f"kernel case {name}: outputs differ between runs")
            del again
            fwd_train = {"max_abs_err": err,
                         **time_fwd(name, q, k, v, causal, off, bnd,
                                    bound_by)}
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return entry, fwd_train


def phase_bwd_kernel():
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, b, sq, sk, h, d, causal, q_offset, dtype); the first is the
    # training shape, and it is timed
    cases = [
        ("train", 8, 1024, 1024, 32, 64, True, 0, bf16),
        ("ragged-s1000", 2, 1000, 1000, 8, 64, True, 0, bf16),
        ("non-causal", 2, 512, 512, 16, 64, False, 0, bf16),
        ("q-offset", 2, 256, 2048, 16, 64, True, 512, bf16),
        ("fp32-over-4MiB", 1, 256, 16384, 1, 64, True, 16128, f32),
        ("head-dim-128", 2, 512, 512, 16, 128, True, 0, bf16),
        ("ragged-s37", 3, 37, 37, 5, 64, True, 0, bf16),
        ("causal-d128-ragged", 2, 600, 600, 4, 128, True, 0, bf16),
        # the training shape's FLOPs at head dim 128: half the tiles, each
        # twice the products; timed too
        ("train-d128", 4, 1024, 1024, 16, 128, True, 0, bf16),
    ]
    entries = None
    for name, b, sq, sk, h, d, causal, off, dtype in cases:
        q, k, v = make_qkv(b, sq, sk, h, d, dtype, gen)
        do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              q_offset=off)
        grads = fa.flash_attention_backward(q, k, v, out, lse, do,
                                            causal=causal, q_offset=off)
        torch.cuda.synchronize()
        refs = fa.flash_attention_backward_reference(
            q, k, v, out, lse, do, causal=causal, q_offset=off)
        errs, ok = [], True
        for g, r, t in zip(grads, refs, (q, k, v)):
            check(g.shape == t.shape and g.dtype == dtype,
                  f"{name}: gradient {tuple(g.shape)} {g.dtype}")
            check(bool(torch.isfinite(g).all()), f"{name}: non-finite grad")
            errs.append(float((g.float() - r.float()).abs().max()))
            ok = ok and max_violation(g, r, **GRAD_TOL[dtype]) <= 0
        bnd, bound_by = flash_bwd_bound(b, sq, sk, h, d, causal, off, dtype)
        print(f"bwd kernel case {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"causal={causal} q_offset={off} {dtype}: max|err| dq "
              f"{errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} (tol "
              f"{GRAD_TOL[dtype]}), bound {bnd:.5f} ms ({bound_by}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"bwd kernel case {name} disagrees with the plain version")
        if entries is None:
            again = fa.flash_attention_backward(q, k, v, out, lse, do,
                                                causal=causal, q_offset=off)
            same = all(torch.equal(g, a) for g, a in zip(grads, again))
            print(f"bwd kernel case {name}: two runs bit-identical: {same}")
            check(same, f"bwd kernel case {name}: gradients differ between "
                  "two runs")
            del again
            entries = time_bwd(q, k, v, out, lse, do, refs, errs,
                               (b, sq, sk, h, d, causal, off, dtype))
        elif name == "train-d128":
            ms = cuda_ms(lambda: fa.flash_attention_backward(
                q, k, v, out, lse, do, causal=causal, q_offset=off))
            print(f"bwd kernel timing {name}: backward with delta {ms:.5f} "
                  f"ms [{card_line()}]")
        del q, k, v, do, out, lse, grads, refs
    torch.cuda.empty_cache()
    return entries


def time_bwd(q, k, v, out, lse, do, refs, errs, shape):
    """Times of the two kernels, the whole backward (the dq kernel computes
    delta), the plain version and the library backward at the training
    shape, and the library backward's own error against the plain version.
    Returns the backward entries."""
    causal, off = shape[5:7]
    _, delta = fa._launch_bwd_dq(q, k, v, out, do, lse, causal, off)
    dq_ms = cuda_ms(lambda: fa._launch_bwd_dq(q, k, v, out, do, lse, causal,
                                              off))
    dkv_ms = cuda_ms(lambda: fa._launch_bwd_dkv(q, k, v, do, lse, delta,
                                                causal, off))
    all_ms = cuda_ms(lambda: fa.flash_attention_backward(
        q, k, v, out, lse, do, causal=causal, q_offset=off))
    plain_ms = cuda_ms(lambda: fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, causal=causal, q_offset=off), iters=5)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    # is_causal aligns the mask top-left, which is q_offset 0
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    # the graph is retained, so only the backward is timed
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    lib_errs = [float((g.transpose(1, 2).float() - r.float()).abs().max())
                for g, r in zip(torch.autograd.grad(lib_out, (qt, kt, vt),
                                                    dot), refs)]
    bnd, bound_by = flash_bwd_bound(*shape)
    print(f"bwd kernel timing train: dq kernel {dq_ms:.5f} ms, dk/dv kernel "
          f"{dkv_ms:.5f} ms, backward with delta {all_ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, autograd through scaled_dot_product_attention "
          f"{library_ms:.5f} ms, flash_bwd_bound {bnd:.5f} ms ({bound_by}) "
          f"[{card_line()}]")
    print(f"bwd kernel error train: max|err| against the plain version, "
          f"kernels dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; "
          f"library backward dq {lib_errs[0]:.3e} dk {lib_errs[1]:.3e} dv "
          f"{lib_errs[2]:.3e} (the library rounds P and dS to bf16 once, "
          f"the kernels to a bf16 hi + lo pair)")
    entries = []
    for name, ms, err, line, part in (
            ("flash_bwd_dq", dq_ms, errs[0], 244, "dq"),
            ("flash_bwd_dkv", dkv_ms, max(errs[1:]), 290, "dkv")):
        kb, kb_by = flash_bwd_bound(*shape, part=part)
        entries.append({
            "name": name, "route": "cuda",
            "source": "alpa_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"alpa_tpu/ops/flash_attention.py:{line}",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": kb, "bound_by": kb_by,
            "library_ms": library_ms,
            "note": "plain_ms and library_ms compute dq, dk and dv "
                    "together; bound_ms is this kernel's own outputs"})
    return entries


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())["output_ids"][0]


def concurrent_completions(port, prompts, new_tokens):
    """POST every prompt at once from its own thread; (outputs, seconds
    per request, wall seconds)."""
    outs, secs = [None] * len(prompts), [None] * len(prompts)
    barrier = threading.Barrier(len(prompts))
    errors = []

    def call(i):
        barrier.wait()
        tic = time.perf_counter()
        try:
            outs[i] = post(port, {"model": "opt-1.3b",
                                  "prompt_ids": prompts[i].tolist(),
                                  "max_new_tokens": new_tokens})
        except Exception as e:  # pylint: disable=broad-except
            errors.append(e)
        secs[i] = time.perf_counter() - tic

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    tic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - tic
    check(not any(t.is_alive() for t in threads), "a request hung")
    check(not errors, f"request failed: {errors[:1]}")
    return outs, secs, wall


def phase_serving():
    cfg = config_from_opt_spec("1.3b", dtype=torch.bfloat16,
                               attention_impl="flash")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENGTHS]
    server = run_controller(port=0)
    try:
        tic = time.perf_counter()
        gen = server.controller.register_model("opt-1.3b", cfg)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in gen.model.parameters())
        print(f"serving: registered OPT-1.3B ({cfg.num_layers} layers, "
              f"hidden {cfg.hidden_size}, {n_params} params, bf16, flash) "
              f"in {time.perf_counter() - tic:.2f} s")
        post(server.port, {"model": "opt-1.3b",
                           "prompt_ids": prompts[0].tolist(),
                           "max_new_tokens": 2})          # warm-up
        fa.FLASH_FWD_LAUNCHES = 0
        gen.prefill_calls = 0
        batcher = server.controller._models["opt-1.3b"][0]
        batches0 = batcher.batches_run
        outs, secs, wall = concurrent_completions(server.port, prompts,
                                                  NEW_TOKENS)
        launches, prefills = fa.FLASH_FWD_LAUNCHES, gen.prefill_calls
        batches = batcher.batches_run - batches0
        for p, o in zip(prompts, outs):
            check(len(o) == len(p) + NEW_TOKENS,
                  f"answer of {len(o)} tokens for a {len(p)}-token prompt")
            check(o[:len(p)] == p.tolist(), "answer does not echo prompt")
            check(all(0 <= t < cfg.vocab_size for t in o[len(p):]),
                  "token out of vocabulary")
        check(prefills >= 1 and launches == cfg.num_layers * prefills,
              f"flash launches {launches} != {cfg.num_layers} x "
              f"{prefills} prefill calls")
        print(f"serving: {len(prompts)} concurrent /completions ok in "
              f"{batches} batch(es); {prefills} prefill call(s), "
              f"{launches} flash kernel launches "
              f"({cfg.num_layers} per prefill)")
        _, ttft, _ = concurrent_completions(server.port, prompts, 1)
        decode_s = max(secs) - max(ttft)
        print(f"serving metrics [{card_line()}]: time to first token "
              f"(max over requests, 1-token requests) {max(ttft):.4f} s; "
              f"end-to-end latency mean {np.mean(secs):.4f} s max "
              f"{max(secs):.4f} s; decode "
              f"{len(prompts) * (NEW_TOKENS - 1) / decode_s:.1f} tokens/s "
              f"(all requests, from max latency - max TTFT)")
        with torch.inference_mode():
            ids = torch.as_tensor(prompts[0][None], device="cuda")
            logits = gen.model(ids)
        check(logits.shape == (1, len(prompts[0]), cfg.vocab_size) and
              bool(torch.isfinite(logits).all()), "non-finite logits")
    finally:
        server.shutdown()
    del gen
    torch.cuda.empty_cache()
    return launches


def phase_fidelity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        config_from_opt_spec("1.3b", dtype=torch.float32,
                             attention_impl="flash"), num_layers=4)
    gen = get_model(cfg, seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in PROMPT_LENGTHS]
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    before = fa.FLASH_FWD_LAUNCHES
    with_kernel = gen.generate(prompts, gcfg)
    check(fa.FLASH_FWD_LAUNCHES - before == cfg.num_layers,
          "fidelity run did not go through the kernel")
    ids = torch.as_tensor(prompts[3][None], device="cuda")
    with torch.inference_mode():
        logits_kernel = gen.model(ids)
    kernel_fn = fa.flash_attention_forward
    # the same model with the plain version called in the kernel's place
    fa.flash_attention_forward = fa.flash_attention_forward_reference
    try:
        with_plain = gen.generate(prompts, gcfg)
        with torch.inference_mode():
            logits_plain = gen.model(ids)
    finally:
        fa.flash_attention_forward = kernel_fn
    same = all(np.array_equal(a, b) for a, b in zip(with_kernel, with_plain))
    diff = float((logits_kernel - logits_plain).abs().max())
    print(f"fidelity: fp32 OPT-1.3B at 4 layers, greedy tokens kernel == "
          f"plain: {same}; max|logit diff| (511-token prompt) {diff:.3e}")
    check(same, "greedy tokens differ between kernel and plain version")
    check(diff < 1e-3, f"fp32 logits differ by {diff}")


def make_train_step(method=None, donate_argnums=(0,)):
    """``bench.py``'s train step, through the port (``ShardParallel()`` by
    default)."""

    @alpa_tpu_torch.parallelize(
        method=method or alpa_tpu_torch.ShardParallel(),
        donate_argnums=donate_argnums)
    def train_step(state, batch):

        def loss_fn(p):
            return gpt_lm_loss(state.apply_fn, p, batch)

        loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    return train_step


def train_state(cfg):
    model = GPTModel(cfg, device="cuda", param_dtype=torch.float32)
    init_random_(model, SEED)
    return TrainState.create(apply_fn=make_apply_fn(model),
                             params=dict(model.named_parameters()),
                             tx=adam(LR))


def lm_batch(cfg, batch_size):
    rng = np.random.default_rng(SEED)
    return {"input_ids": rng.integers(0, cfg.vocab_size,
                                      (batch_size, cfg.seq_len)),
            "labels": rng.integers(0, cfg.vocab_size,
                                   (batch_size, cfg.seq_len))}


def launch_counts():
    return (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
            fa.FLASH_BWD_DKV_LAUNCHES)


def reset_launch_counts():
    fa.FLASH_FWD_LAUNCHES = 0
    fa.FLASH_BWD_DQ_LAUNCHES = 0
    fa.FLASH_BWD_DKV_LAUNCHES = 0


def phase_training(kernel_ms):
    """``kernel_ms``: (forward, dq, dk/dv) kernel ms at the training shape,
    for the attention kernels' share of a step."""
    cfg = config_from_spec("1.3B", dtype=torch.bfloat16,
                           attention_impl="flash", remat_blocks=True)
    batch_size, warmup, n_iter = 8, 3, 10
    alpa_tpu_torch.init(cluster="local")
    state = train_state(cfg)
    n_params = sum(p.numel() for p in state.params.values())
    batch = lm_batch(cfg, batch_size)
    train_step = make_train_step()
    losses = []
    reset_launch_counts()
    for _ in range(warmup):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    per_step = [c // warmup for c in launch_counts()]
    tic = time.perf_counter()
    for _ in range(n_iter):
        state, loss = train_step(state, batch)
        losses.append(loss)
    float(loss)   # drains the queue
    latency = (time.perf_counter() - tic) / n_iter
    counts = launch_counts()
    losses = [float(x) for x in losses]
    steps = warmup + n_iter
    want = (2 * cfg.num_layers, cfg.num_layers, cfg.num_layers)
    check(tuple(per_step) == want and
          counts == tuple(w * steps for w in want),
          f"launches per step (fwd, dq, dkv) {per_step}, over {steps} steps "
          f"{counts}; want {want} per step")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens_per_sec = batch_size * cfg.seq_len / latency
    tflops = compute_gpt_tflops(batch_size, cfg.seq_len, cfg.num_layers,
                                cfg.hidden_size, cfg.vocab_size, 1, latency)
    peak = SPEC["peak_bf16_tflops"]
    mfu = compute_mfu(tflops, peak)
    peak_bytes = train_step.get_last_executable().get_total_allocation_size()
    print(f"training: GPT-1.3B ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {n_params} params, bf16 compute, fp32 params "
          f"and Adam, flash, remat), batch {batch_size} x seq {cfg.seq_len}; "
          f"launches per step fwd {per_step[0]} dq {per_step[1]} dkv "
          f"{per_step[2]}; losses {['%.4f' % x for x in losses]}")
    attn_s = sum(n * ms for n, ms in zip(per_step, kernel_ms)) / 1e3
    print(f"training metrics [{card_line()}]: step {latency:.5f} s, "
          f"{tokens_per_sec:.1f} tokens/s, {tflops:.3f} TFLOPS "
          f"(compute_gpt_tflops), MFU {mfu:.4f} of {peak} TFLOP/s bf16, "
          f"peak allocated {peak_bytes / 2**30:.3f} GiB; attention kernels "
          f"(launches x kernel ms) {attn_s:.5f} s per step, "
          f"{attn_s / latency:.4f} of the step")
    print(json.dumps({
        "metric": "gpt_train_tflops_per_chip", "value": round(tflops, 3),
        "unit": "TFLOPS/chip",
        "vs_baseline": round(tflops / BASELINE_TFLOPS_PER_DEVICE, 4),
        "detail": {"model": f"h{cfg.hidden_size}-l{cfg.num_layers}",
                   "opt": "adam", "ce": "dense", "batch": batch_size,
                   "seq": cfg.seq_len, "latency_s": round(latency, 5),
                   "tokens_per_sec": round(tokens_per_sec, 1),
                   "n_devices": 1, "platform": "gpu",
                   "generation": "h100-sxm", "peak_bf16_tflops": peak,
                   "mfu": round(mfu, 4)}}))
    state, profile = profile_steps(train_step, state, batch, 2, latency)
    del state, train_step
    alpa_tpu_torch.shutdown()
    torch.cuda.empty_cache()
    return counts, {"latency": latency, **(profile or {})}


def profile_steps(train_step, state, batch, steps, latency,
                  label="training"):
    """``profile_calls`` over ``steps`` training steps; returns the state and
    the profile."""
    box = [state]

    def run():
        box[0], loss = train_step(box[0], batch)
        return loss

    profile = profile_calls(run, steps, latency, label)
    return box[0], profile


def profile_calls(run, steps, latency, label, top=10):
    """``torch.profiler`` over ``steps`` calls of ``run`` (one step each,
    returning a tensor to wait on): the ``top`` heaviest kernels by device
    time per step, the flash kernels' share, and the device's busy share, both
    under the profiler (the union of kernel intervals over the span from
    the first kernel's start to the last one's end) and as device time per
    step over ``latency``, the step time measured without it.  Returns the
    device time per step with those two shares."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        tic = time.perf_counter()
        for _ in range(steps):
            out = run()
        out.float().sum().item()
        wall = time.perf_counter() - tic
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in prof.key_averages() if e.device_type == cuda),
                     key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print(f"{label} profile: profiler: no device time")
        return None
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, reach = 0.0, spans[0][0]
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    span_us = reach - spans[0][0]
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    per_step = total_us / 1e6 / steps
    busy_step = busy_us / 1e6 / steps
    print(f"{label} profile [{card_line()}]: {steps} steps, host wall "
          f"{wall:.5f} s with the profiler on; device time {per_step:.5f} s "
          f"per step in {len(kernels)} kernels by name (a sum of kernel "
          f"times, which kernels running at once on two streams inflate), "
          f"{per_step / latency:.4f} of the step time without the profiler; "
          f"busy time (the union of kernel intervals) {busy_step:.5f} s per "
          f"step, {busy_step / latency:.4f} of that step time; busy share "
          f"{busy_us / span_us:.4f} of the device span "
          f"{span_us / 1e6:.5f} s with the profiler; flash kernels "
          f"{flash_us / 1e6 / steps:.5f} s per step, "
          f"{flash_us / total_us:.4f} of the device time")
    for rank, e in enumerate(kernels[:top], 1):
        print(f"{label} profile kernel {rank}: "
              f"{e.self_device_time_total / 1e3 / steps:.3f} ms per step, "
              f"{e.count // steps} launches per step, "
              f"{e.self_device_time_total / total_us:.4f} of the device "
              f"time: {e.key[:120]}")
    return {"device_s_per_step": per_step,
            "device_share": per_step / latency,
            "busy_s_per_step": busy_step,
            "busy_share": busy_us / span_us}


def fidelity_run(cfg, batch, steps):
    """(losses, step-0 gradients) of ``steps`` Adam steps from the seed."""
    state = train_state(cfg)
    _, grads0 = alpa_tpu_torch.value_and_grad(
        lambda p: gpt_lm_loss(state.apply_fn, p, batch))(
            {k: t for k, t in state.params.items()})
    train_step = make_train_step()
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    return losses, grads0


def phase_train_fidelity():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash",
                         remat_blocks=True), num_layers=4)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in lm_batch(cfg, 2).items()}
    reset_launch_counts()
    kernel_losses, kernel_grads = fidelity_run(cfg, batch, 3)
    check(min(launch_counts()) > 0,
          "fidelity run did not go through the kernels")
    fwd, bwd = fa.flash_attention_forward, fa.flash_attention_backward
    # the same steps with the plain versions called in the kernels' place
    fa.flash_attention_forward = fa.flash_attention_forward_reference
    fa.flash_attention_backward = fa.flash_attention_backward_reference
    try:
        plain_losses, plain_grads = fidelity_run(cfg, batch, 3)
    finally:
        fa.flash_attention_forward, fa.flash_attention_backward = fwd, bwd
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(kernel_losses, plain_losses))
    grad_rel = max(float((kernel_grads[k] - g).abs().max() /
                         g.abs().max().clamp_min(1e-30))
                   for k, g in plain_grads.items())
    print(f"training fidelity: fp32 GPT-1.3B at 4 layers, batch 2, 3 Adam "
          f"steps; losses kernel {kernel_losses} plain {plain_losses}, max "
          f"relative difference {loss_rel:.3e} (tol 1e-5); step-0 gradients "
          f"max |diff| / max |g| per tensor {grad_rel:.3e} (tol 1e-4)")
    check(loss_rel <= 1e-5, f"losses differ by {loss_rel} relative")
    check(grad_rel <= 1e-4, f"step-0 gradients differ by {grad_rel}")
    torch.cuda.empty_cache()


def stage_devices():
    """Two one-device stage meshes: the card named twice on a one-card
    machine, else the first two cards."""
    if torch.cuda.device_count() == 1:
        return ["cuda:0"] * 2
    return ["cuda:0", "cuda:1"]


def shard_method():
    """The ShardParallel reference: the first card."""
    return alpa_tpu_torch.ShardParallel(devices=["cuda:0"])


def pipeshard_method(num_micro_batches):
    return PipeshardParallel(devices=stage_devices(),
                             num_micro_batches=num_micro_batches,
                             layer_option=ManualLayerOption(),
                             stage_option=UniformStageOption(num_stages=2),
                             pipeline_schedule="1f1b")


def auto_pipeshard_method(num_micro_batches, layer_num, devices=None,
                          stage_option=None):
    """The README's headline form: automatic remat layers, by default in
    two uniform stages on ``stage_devices()``."""
    return PipeshardParallel(
        devices=devices or stage_devices(),
        num_micro_batches=num_micro_batches,
        layer_option=AutoLayerOption(layer_num=layer_num, remat_layer=True),
        stage_option=stage_option or UniformStageOption(num_stages=2),
        pipeline_schedule="1f1b")


def max_rel_diff(got, want):
    """{name: max |got - want| / max |want|} (``got`` may lie on another
    stage's card)."""
    return {k: float((got[k].to(w.device) - w).abs().max() /
                     w.abs().max().clamp_min(1e-30))
            for k, w in want.items()}


def param_diffs(got, want, grads, bound):
    """Parameters after Adam steps, element by element: the largest
    |got - want| / max |want| of each tensor over the elements whose step-0
    gradient is at least 1e-2 of the tensor's largest; and, over the
    others, the count and the largest |got - want|, which is held to
    ``bound`` (Adam moves an element at most lr a step).  Adam's m /
    sqrt(v) turns a gradient near its rounding noise into a step of up to
    lr whatever its size, with a sign the order of sums decides: the key
    third of a qkv bias has a gradient that is zero in exact arithmetic (a
    shift of every score of a row leaves the softmax as it is)."""
    rel, n_small, n_all, small_max = {}, 0, 0, 0.0
    for k, w in want.items():
        g = grads[k].abs()
        small = g < 1e-2 * g.max()
        diff = (got[k].to(w.device) - w).abs()
        held = diff[~small]
        rel[k] = float(held.max() / w.abs().max().clamp_min(1e-30)) \
            if held.numel() else 0.0
        n_small += int(small.sum())
        n_all += w.numel()
        if small.any():
            small_max = max(small_max, float(diff[small].max()))
    return rel, n_small, n_all, small_max


def phase_pipeshard_fidelity():
    """Manual layers (a boundary every 2 blocks), 2 microbatches, 2 stages,
    1F1B, against ShardParallel (``pipeshard_fidelity``)."""
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash",
                         pipeline_boundary_every=2), num_layers=4)
    pipeshard_fidelity("pipeshard fidelity", cfg, lambda: pipeshard_method(2))


def phase_pipeshard_auto_fidelity():
    """``AutoLayerOption(layer_num=4, remat_layer=True)`` (no boundaries),
    2 microbatches, 2 stages, 1F1B, against ShardParallel
    (``pipeshard_fidelity``)."""
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash"),
        num_layers=4)
    pipeshard_fidelity("pipeshard auto-layer fidelity", cfg,
                       lambda: auto_pipeshard_method(2, 4))


def pipeshard_fidelity(label, cfg, method):
    """fp32, 4 layers at GPT-1.3B's width, batch 4, from the same weights
    through ``method()`` and through ShardParallel: step-0 gradients (the
    microbatch mean against the whole batch's), then 2 Adam steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = lm_batch(cfg, 4)

    def grad_step(state, batch):
        return alpa_tpu_torch.value_and_grad(
            lambda p: gpt_lm_loss(state.apply_fn, p, batch))(state.params)

    runs = {}
    for name, make in (("pipeshard", method), ("shard", shard_method)):
        state = train_state(cfg)
        reset_launch_counts()
        _, grads = alpa_tpu_torch.parallelize(
            grad_step, method=make(), donate_argnums=())(state, batch)
        train_step = make_train_step(make())
        losses = []
        for _ in range(2):
            state, loss = train_step(state, batch)
            losses.append(float(loss))
        check(min(launch_counts()) > 0,
              f"{label}: the {name} run did not go through the kernels")
        runs[name] = (losses, grads, state.params)
        del state, train_step
    (p_losses, p_grads, p_params), (s_losses, s_grads, s_params) = \
        runs["pipeshard"], runs["shard"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(p_losses, s_losses))
    grad_rel = max_rel_diff(p_grads, s_grads)
    bound = 2 * LR * len(p_losses)
    param_rel, n_small, n_all, small_max = param_diffs(p_params, s_params,
                                                       s_grads, bound)
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    print(f"{label}: fp32 GPT-1.3B at 4 layers, batch 4, 2 microbatches, 2 "
          f"stages; step-0 gradients max |diff| / max |g| per tensor "
          f"{grad_rel[worst_g]:.3e} at {worst_g} (tol 1e-4); 2 Adam steps: "
          f"losses pipeshard {p_losses} shard {s_losses}, max relative "
          f"difference {loss_rel:.3e} (tol 1e-5); parameters max |diff| / "
          f"max |p| per tensor {param_rel[worst_p]:.3e} at {worst_p} (tol "
          f"1e-4) over the elements whose step-0 gradient is at least 1e-2 "
          f"of its tensor's largest; the other {n_small} of {n_all} elements "
          f"differ by at most {small_max:.3e} (tol {bound:.1e}, Adam's 2 x "
          f"lr x steps)")
    check(grad_rel[worst_g] <= 1e-4,
          f"{label}: gradient {worst_g} differs by {grad_rel[worst_g]}")
    check(loss_rel <= 1e-5, f"{label}: losses differ by {loss_rel}")
    check(param_rel[worst_p] <= 1e-4,
          f"{label}: parameter {worst_p} differs by {param_rel[worst_p]}")
    check(small_max <= bound, f"{label}: parameters with near-zero "
          f"gradients differ by {small_max}, over Adam's bound {bound}")
    del runs
    torch.cuda.empty_cache()


def pipeshard_config(**kw):
    """GPT-1.3B at full width and depth for the pipeshard phases: bf16
    compute, flash, no per-block remat unless ``kw`` asks for it."""
    return config_from_spec("1.3B", dtype=torch.bfloat16,
                            attention_impl="flash", **kw)


def shard_first_loss(cfg, batch):
    """The loss of one ShardParallel step from the seed state: the
    reference of the pipeshard phases' first loss."""
    state = train_state(cfg)
    ref_step = make_train_step(shard_method())
    state, loss = ref_step(state, batch)
    loss = float(loss)
    del state, ref_step
    torch.cuda.empty_cache()
    return loss


def first_loss(method, cfg, batch):
    """The loss of one step under ``method`` from the seed state, and the
    step's executable."""
    state = train_state(cfg)
    step = make_train_step(method)
    state, loss = step(state, batch)
    loss, ex = float(loss), step.get_last_executable()
    del state, step
    torch.cuda.empty_cache()
    return loss, ex


def timed_pipeshard(label, cfg, method, batch, ref_loss, ref_tol, shard_profile,
                    forward_runs=1, keep=False):
    """Train ``cfg`` through the pipeshard ``method`` from the seed state: 3
    warm-up steps (the first runs the stage graphs as they are, the second
    captures them as CUDA graphs) and 5 timed steps, which replay them in
    the default dispatch mode, then ``torch.profiler`` over 2 more.  Checks
    a finite, falling loss, the first loss against ``ref_loss`` (relative
    ``ref_tol``) and the flash launches per step (``forward_runs`` forward
    launches per block and microbatch, one of each backward kernel,
    counting the launches inside the replays); prints the step's metrics.
    Returns a dict: the (fwd, dq, dkv) launches of the run, the executable,
    the step time, host time and peak, the profile, and with ``keep`` the
    step and its state."""
    batch_size, num_micro_batches = 8, method.num_micro_batches
    warmup, n_iter = 3, 5
    cards = sorted(set(str(d) for d in method.devices.devices.flat))
    # the batch on the card, as a prefetching loader leaves it: a host
    # array's copy would wait for the previous step and hide the host time
    batch = {k: torch.as_tensor(v, device=cards[0]) for k, v in batch.items()}
    # what earlier phases still hold (objects in reference cycles wait for
    # a collection) would count in this phase's peak
    gc.collect()
    torch.cuda.empty_cache()
    held = max(torch.cuda.memory_allocated(d) for d in cards)
    state = train_state(cfg)
    n_params = sum(p.numel() for p in state.params.values())
    # the user's default: auto donation, its fake pass timed
    train_step = make_train_step(method, donate_argnums="auto")
    reset_launch_counts()
    tic = time.perf_counter()
    state, loss = train_step(state, batch)
    losses = [float(loss)]
    first_s = time.perf_counter() - tic
    ex = train_step.get_last_executable()
    n_leaves = len(torch.utils._pytree.tree_leaves(state))
    donated = train_step.get_donated_invars(state, batch)
    check(sum(donated) == n_leaves and all(donated[:n_leaves]),
          f"{label}: auto donation donated {sum(donated)} leaves, want the "
          f"state's {n_leaves}")
    for _ in range(warmup - 1):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    # the peak of the replayed steps (a replay allocates nothing: the
    # graphs' working memory is in their pools, reported beside it)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    gc_s = []

    def on_gc(phase, info):
        """Wall time of Python's full collections in the timed steps."""
        if info["generation"] == 2:
            gc_s.append(time.perf_counter() if phase == "start"
                        else time.perf_counter() - gc_s.pop())

    gc.callbacks.append(on_gc)
    try:
        tic = time.perf_counter()
        for _ in range(n_iter):
            state, loss = train_step(state, batch)
            losses.append(loss)
        host = (time.perf_counter() - tic) / n_iter
        float(loss)   # drains the queue
        latency = (time.perf_counter() - tic) / n_iter
    finally:
        gc.callbacks.remove(on_gc)
    # the host time of a step call on an idle card: in the pipelined steps
    # above the host also waits once the launch queue is full
    state, idle_host = idle_host_seconds(train_step, state, batch)
    counts = launch_counts()
    losses = [float(x) for x in losses]
    steps = warmup + n_iter + IDLE_CALLS
    want = num_micro_batches * cfg.num_layers
    want = (forward_runs * want, want, want)
    check(counts == tuple(w * steps for w in want),
          f"{label} launches (fwd, dq, dkv) {counts} over {steps} steps; "
          f"want {want} per step")
    check(all(np.isfinite(losses)), f"non-finite {label} loss: {losses}")
    check(losses[-1] < losses[0], f"{label} loss did not fall: {losses}")
    ref_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(ref_rel <= ref_tol, f"{label} first loss {losses[0]} vs "
          f"ShardParallel {ref_loss}: {ref_rel} relative")
    tokens_per_sec = batch_size * cfg.seq_len / latency
    n_cards = len(cards)
    tflops = compute_gpt_tflops(batch_size, cfg.seq_len, cfg.num_layers,
                                cfg.hidden_size, cfg.vocab_size, n_cards,
                                latency)
    peak = SPEC["peak_bf16_tflops"]
    mfu = compute_mfu(tflops, peak)
    card = card_line()
    layer = method.layer_option
    print(f"{label}: GPT-1.3B ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, {n_params} params, bf16 compute, fp32 params "
          f"and Adam, flash), {layer}, batch {batch_size} x seq "
          f"{cfg.seq_len} in {num_micro_batches} microbatches, "
          f"{ex.num_fwd_stages} stages on {list(method.devices.devices.flat)}"
          f", {method.pipeline_schedule}; launches per step fwd "
          f"{counts[0] // steps} dq {counts[1] // steps} dkv "
          f"{counts[2] // steps}; losses "
          f"{['%.4f' % x for x in losses]}; first loss vs ShardParallel "
          f"{ref_loss:.4f}: {ref_rel:.3e} relative (tol {ref_tol:.0e})")
    print(f"{label} compile [{card}]: auto donation's fake pass "
          f"{ex.donation_seconds:.3f} s, trace {ex.trace_seconds:.3f} s, "
          f"slicing, stage graphs and program {ex.compile_seconds:.3f} s, "
          f"first call "
          f"{first_s:.3f} s; stage nodes " + ", ".join(
              f"{e.name} {e.num_nodes}" for e in ex.stage_execs +
              [a for a in ex.apply_execs if a is not None]) +
          f"; instructions {ex.get_instruction_counts()}; executed "
          f"resharding bytes per step {ex.executed_resharding_bytes}")
    print(f"{label} schedule:\n" + ex.get_schedule_text())
    peak_bytes = ex.get_total_allocation_size()
    reserved = max(torch.cuda.max_memory_reserved(d) for d in cards)
    pool = ex.get_graph_pool_bytes()
    stats = ex.last_dispatch_stats
    print(f"{label} metrics [{card}]: step {latency:.5f} s, "
          f"{tokens_per_sec:.1f} tokens/s, {tflops:.3f} TFLOPS "
          f"(compute_gpt_tflops over {n_cards} card(s)), MFU {mfu:.4f} of "
          f"{peak} TFLOP/s bf16; dispatch mode {stats['mode']}, stage graphs "
          f"replayed as CUDA graphs: {stats['graphs']} (captured "
          f"{ex.capture_count} time(s)); allocated peak over the timed "
          f"steps {peak_bytes / 2**30:.3f} GiB ({held / 2**30:.3f} GiB of "
          f"it held before the phase), the graphs' pools reserve "
          f"{(pool or 0) / 2**30:.3f} GiB beside it; host {host:.5f} s per "
          f"step until the step call returns in the timed steps, "
          f"{idle_host:.5f} s for a call on an idle card; Python's full "
          f"garbage "
          f"collections in the {n_iter} timed steps: {len(gc_s)}, "
          f"{sum(gc_s):.5f} s")
    check(stats["graphs"] and ex.capture_count == 1,
          f"{label}: the timed steps did not replay one capture: {stats}, "
          f"{ex.capture_count} captures")
    state, profile = profile_steps(train_step, state, batch, 2, latency,
                                   label=label)
    if profile and shard_profile.get("busy_share") is not None:
        print(f"{label} vs ShardParallel (phase 6) [{card}]: device time "
              f"per step {profile['device_s_per_step']:.5f} vs "
              f"{shard_profile['device_s_per_step']:.5f} s, device share of "
              f"the step {profile['device_share']:.4f} vs "
              f"{shard_profile['device_share']:.4f}, busy share under the "
              f"profiler {profile['busy_share']:.4f} vs "
              f"{shard_profile['busy_share']:.4f}; step {latency:.5f} vs "
              f"{shard_profile['latency']:.5f} s")
    out = {"counts": launch_counts(),   # the timed and profiled steps
           "ex": ex, "latency": latency, "host": host,
           "idle_host": idle_host, "peak": peak_bytes, "reserved": reserved,
           "pool": pool, "profile": profile, "held": held}
    if keep:
        out.update(step=train_step, state=state)
    else:
        del state, train_step
        torch.cuda.empty_cache()
    return out


def apply_grad_peaks(cfg, batch, steps=3):
    """The peak of phase 8's step without and with the in-place apply-grad
    (a donated state input that one apply-grad graph reads is written in
    place by it or freed right after it), in that order, each from the seed
    state after the same collection, built in this process, with the stage
    graphs run uncaptured (the private switch ``_capture = False``) so that
    the allocator sees every value.  Without it the apply-grad graphs are
    built with no donated inputs, so donated storage is released only after
    the whole step.  Returns ``{variant: (peak bytes of the last of
    ``steps`` steps, bytes held before, losses, the allocator's reserved
    peak over that step)}``; checks that both give the same losses, bit
    for bit."""
    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    init = pe.StageExecutable.__init__

    def undonated(self, comp, mesh_id, device, root, donate=()):
        init(self, comp, mesh_id, device, root)

    out = {}
    for variant in ("without", "with"):
        method = pipeshard_method(4)
        cards = sorted(set(str(d) for d in method.devices.devices.flat))
        gc.collect()
        torch.cuda.empty_cache()
        held = max(torch.cuda.memory_allocated(d) for d in cards)
        state = train_state(cfg)
        step = make_train_step(method, donate_argnums="auto")
        if variant == "without":
            pe.StageExecutable.__init__ = undonated
        try:
            ex, _ = step.get_executable(state, batch)   # builds it
        finally:
            pe.StageExecutable.__init__ = init
        ex._capture = False
        losses = []
        for i in range(steps):
            if i == steps - 1:
                for d in cards:
                    torch.cuda.reset_peak_memory_stats(d)
            state, loss = step(state, batch)
            losses.append(float(loss))
        out[variant] = (ex.get_total_allocation_size(), held, losses,
                        max(torch.cuda.max_memory_reserved(d)
                            for d in cards))
        del state, step, ex
        torch.cuda.empty_cache()
    check(out["without"][2] == out["with"][2],
          f"the in-place apply-grad changed the losses: {out}")
    return out


IDLE_CALLS = 2


def idle_host_seconds(train_step, state, batch):
    """The mean host time of ``IDLE_CALLS`` step calls, each started on an
    idle card: what dispatching a step costs the host.  Returns the state
    and the seconds."""
    total = 0.0
    for _ in range(IDLE_CALLS):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        state, _ = train_step(state, batch)
        total += time.perf_counter() - tic
    torch.cuda.synchronize()
    return state, total / IDLE_CALLS


def reset_state_(state, seed_params):
    """Put ``state`` back to the seed state in place: the seed parameters,
    zero Adam moments and counts."""
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(seed_params[k])
        for x in torch.utils._pytree.tree_leaves(state.opt_state):
            if isinstance(x, torch.Tensor):
                x.zero_()
        if isinstance(state.step, torch.Tensor):
            state.step.zero_()
            return state
    return dataclasses.replace(state, step=0)


DISPATCH_MODES = ("sequential", "registers", "threaded", "overlap", "auto")


def phase_dispatch(cfg, batch, run, label="pipeshard dispatch"):
    """The dispatch modes on phase 8's executable (``run``: what
    ``timed_pipeshard`` kept), nothing traced again: from the seed state,
    put back in place each time, two steps with the stage graphs run
    uncaptured (the private switch ``_capture = False``, on the current
    stream), then two in each mode replaying the CUDA graphs (the private
    switch ``_pipeline_dispatch_mode``).  Losses and parameters must be
    bit-identical across modes and to the uncaptured steps, and the step
    must not be captured again.  Then 3 more steps per mode, timed: step
    time, host time per step, executed resharding bytes, and ``torch.
    profiler`` over 2 more in that mode: its own busy time per step and
    device share."""
    from alpa_tpu_torch.global_env import global_config
    # the state leaves ``run``: no old reference keeps the buffers phase 8's
    # last step handed back
    step, state, ex = run["step"], run.pop("state"), run["ex"]
    cards = sorted(set(str(d) for d in ex.mesh_devices))
    batch = {k: torch.as_tensor(v, device=cards[0]) for k, v in batch.items()}
    model = GPTModel(cfg, device=cards[0], param_dtype=torch.float32)
    init_random_(model, SEED)
    seed = {k: p.detach() for k, p in model.named_parameters()}
    del model
    ref = None
    card = card_line()
    box = [None]

    def one_step():
        box[0], loss = step(box[0], batch)
        return loss

    try:
        for mode in ("uncaptured",) + DISPATCH_MODES:
            global_config._pipeline_dispatch_mode = (
                "sequential" if mode == "uncaptured" else mode)
            ex._capture = mode != "uncaptured"
            state = reset_state_(state, seed)
            losses = []
            for _ in range(2):
                state, loss = step(state, batch)
                losses.append(float(loss))
            ran = ex.last_dispatch_stats["mode"]
            if ref is None:
                ref = (losses, {k: p.clone() for k, p in state.params.items()})
                same = True
            else:
                same = losses == ref[0] and all(
                    torch.equal(p, ref[1][k]) for k, p in state.params.items())
            torch.cuda.synchronize()
            tic = time.perf_counter()
            for _ in range(3):
                state, loss = step(state, batch)
            host = (time.perf_counter() - tic) / 3
            float(loss)
            latency = (time.perf_counter() - tic) / 3
            moved = ex.executed_resharding_bytes
            state, idle_host = idle_host_seconds(step, state, batch)
            box[0], state = state, None
            profile = profile_calls(one_step, 2, latency,
                                    f"{label} {mode}", top=0)
            state, box[0] = box[0], None
            busy = profile["busy_s_per_step"] if profile else None
            share = (f"busy time {busy:.5f} s per step, device share "
                     f"{busy / latency:.4f}" if profile
                     else "device share not measured")
            print(f"{label} [{card}]: {mode} (ran as {ran}, "
                  f"stage graphs replayed as CUDA graphs: "
                  f"{ex.last_dispatch_stats['graphs']}): losses {losses}, "
                  f"losses and parameters bit-identical to the uncaptured "
                  f"steps: {same}; step {latency:.5f} s, host {host:.5f} s "
                  f"per step until the call returns, {idle_host:.5f} s for a "
                  f"call on an idle card; executed resharding bytes per step "
                  f"{moved}; {share} (this mode's own profile over this "
                  f"step time)")
            check(same, f"dispatch mode {mode}: losses {losses} or "
                  f"parameters differ from the uncaptured steps {ref[0]}")
            check(ran == ("overlap" if mode == "auto" else
                          "sequential" if mode == "uncaptured" else mode),
                  f"dispatch mode {mode} ran as {ran}")
    finally:
        global_config._pipeline_dispatch_mode = "auto"
        ex._capture = True
    check(ex.capture_count == 1 and ex.recapture_count == 0,
          f"the dispatch phase captured phase 8's step again "
          f"({ex.capture_count} captures)")
    del seed, ref


def phase_pipeshard(shard_profile):
    """GPT-1.3B at full width and depth through PipeshardParallel with manual
    layers (a boundary every 12 blocks), 2 stages, 4 microbatches; then the
    dispatch modes on its executable (``phase_dispatch``); then its peak
    without and with the in-place apply-grad (``apply_grad_peaks``).
    Returns phase 8's run (``timed_pipeshard``, without step and state) and
    the ShardParallel reference loss."""
    cfg = pipeshard_config(pipeline_boundary_every=12)
    batch = lm_batch(cfg, 8)
    ref_loss = shard_first_loss(cfg, batch)
    run = timed_pipeshard("pipeshard", cfg, pipeshard_method(4), batch,
                          ref_loss, 1e-2, shard_profile, keep=True)
    phase_dispatch(cfg, batch, run)
    del run["step"], run["ex"]
    torch.cuda.empty_cache()
    peaks = apply_grad_peaks(cfg, batch)
    (off, off_held, losses, _), (on, on_held, _, on_reserved) = (
        peaks["without"], peaks["with"])
    print(f"pipeshard apply-grad peaks [{card_line()}]: step "
          f"{len(losses)} of the seed state, stage graphs uncaptured, peak "
          f"allocated without the in-place apply-grad {off / 2**30:.3f} GiB "
          f"({off_held / 2**30:.3f} GiB held before), with it "
          f"{on / 2**30:.3f} GiB ({on_held / 2**30:.3f} GiB held before): "
          f"{(off - on) / 2**30:.3f} GiB less; losses bit-identical "
          f"{['%.6f' % x for x in losses]}")
    # a replay allocates nothing: the graphs' working memory is their pools
    graphs = run["peak"] + (run["pool"] or 0)
    print(f"pipeshard memory [{card_line()}]: replayed steps (CUDA graphs) "
          f"allocated peak {run['peak'] / 2**30:.3f} GiB + the graphs' pools "
          f"{(run['pool'] or 0) / 2**30:.3f} GiB = {graphs / 2**30:.3f} GiB "
          f"({run['held'] / 2**30:.3f} GiB held before); uncaptured steps "
          f"(the peak with the in-place apply-grad above) {on / 2**30:.3f} "
          f"GiB ({on_held / 2**30:.3f} GiB held before); graphs minus "
          f"uncaptured, net of what each held before: "
          f"{(graphs - run['held'] - on + on_held) / 2**30:+.3f} GiB; the "
          f"allocator's reserved peak (its segments, the pools' included, "
          f"with what each leaves unused inside them) "
          f"{run['reserved'] / 2**30:.3f} GiB over the replayed steps vs "
          f"{on_reserved / 2**30:.3f} GiB over the uncaptured step")
    return run, ref_loss


def phase_pipeshard_remat_blocks(shard_profile, phase8):
    """GPT-1.3B with per-block remat (``remat_blocks=True``, ``bench.py``'s
    setting) inside a pipeshard trace: manual layers (a boundary every 12
    blocks), 2 stages, 4 microbatches, 1F1B, as phase 8 measures it; the
    first loss within 1e-2 relative of ShardParallel's on the same config;
    each block's forward runs twice (192/96/96 launches per step).  Prints
    the peak and step beside phase 8's."""
    cfg = pipeshard_config(pipeline_boundary_every=12, remat_blocks=True)
    batch = lm_batch(cfg, 8)
    ref_loss = shard_first_loss(cfg, batch)
    label = "pipeshard remat blocks"
    run = timed_pipeshard(label, cfg, pipeshard_method(4), batch, ref_loss,
                          1e-2, shard_profile, forward_runs=2)
    print(f"{label} vs phase 8 [{card_line()}]: step {run['latency']:.5f} "
          f"vs {phase8['latency']:.5f} s, allocated peak "
          f"{run['peak'] / 2**30:.3f} vs {phase8['peak'] / 2**30:.3f} GiB, "
          f"graph pools {(run['pool'] or 0) / 2**30:.3f} vs "
          f"{(phase8['pool'] or 0) / 2**30:.3f} GiB")
    return run["counts"]


def phase_pipeshard_infer():
    """The inference path at full width and depth: a forward-only function
    returning GPT-1.3B's logits (bf16, flash, manual layers at a boundary
    every 12 blocks), ``parallelize``d under PipeshardParallel with 2 stages
    x 4 microbatches and the ``"inference"`` schedule, batch 8, one card:
    the logits of every call against the same ``GPTModel`` forward run
    eagerly (bf16 tolerance, atol 1e-2 and rtol 1e-2); exactly 24 x 4
    forward launches and no backward launch per call.  3 warm-up calls
    (the first runs the stage graphs as they are, the second captures
    them), 5 timed, then ``torch.profiler`` over 2 more: call time, host
    time, device share, tokens/s."""
    label = "pipeshard infer"
    cfg = pipeshard_config(pipeline_boundary_every=12)
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTModel(cfg, device="cuda", param_dtype=torch.float32)
    init_random_(model, SEED)
    params = {k: p.detach() for k, p in model.named_parameters()}
    apply = make_apply_fn(model)
    batch = {"input_ids": torch.as_tensor(lm_batch(cfg, 8)["input_ids"],
                                          device="cuda")}
    method = PipeshardParallel(devices=stage_devices(), num_micro_batches=4,
                               layer_option=ManualLayerOption(),
                               stage_option=UniformStageOption(num_stages=2),
                               pipeline_schedule="inference")
    forward = alpa_tpu_torch.parallelize(
        lambda p, b: apply(p, b["input_ids"]), method=method)
    with torch.no_grad():
        want = apply(params, batch["input_ids"])
    tol = TOL[torch.bfloat16]
    reset_launch_counts()
    tic = time.perf_counter()
    out = forward(params, batch)
    first_s = time.perf_counter() - tic
    ex = forward.get_last_executable()
    errs = [max_violation(out, want, **tol)]
    for _ in range(2):
        errs.append(max_violation(forward(params, batch), want, **tol))
    n_iter = 5
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n_iter):
        out = forward(params, batch)
    host = (time.perf_counter() - tic) / n_iter
    float(out[0, 0, 0])
    latency = (time.perf_counter() - tic) / n_iter
    errs.append(max_violation(out, want, **tol))
    counts = launch_counts()
    calls = 3 + n_iter
    want_counts = (cfg.num_layers * 4 * calls, 0, 0)
    diff = float((out.float() - want.float()).abs().max())
    card = card_line()
    stats = ex.last_dispatch_stats
    print(f"{label}: GPT-1.3B logits ({cfg.num_layers} layers, bf16, flash, "
          f"manual layers), batch 8 x seq {cfg.seq_len} in 4 microbatches, "
          f"{ex.num_fwd_stages} stages on {list(method.devices.devices.flat)}"
          f", schedule inference, nothing donated: "
          f"{not any(forward.get_donated_invars(params, batch))}; launches "
          f"(fwd, dq, dkv) {counts} over {calls} calls; max |logits - eager "
          f"forward| {diff:.3e} (max |logit| "
          f"{float(want.float().abs().max()):.3f}), tolerance violations per "
          f"call {errs} (atol {tol['atol']}, rtol {tol['rtol']}); trace "
          f"{ex.trace_seconds:.3f} s, first call {first_s:.3f} s")
    check(counts == want_counts, f"{label}: launches {counts} over {calls} "
          f"calls, want {want_counts}")
    check(max(errs) <= 0, f"{label}: logits differ from the eager forward "
          f"by {diff}")
    check(stats["graphs"] and ex.capture_count == 1,
          f"{label}: the timed calls did not replay one capture: {stats}")
    box = []

    def run():
        box[:] = [forward(params, batch)]
        return box[0]

    profile = profile_calls(run, 2, latency, label)
    share = (f"{profile['busy_s_per_step'] / latency:.4f}" if profile
             else "not measured")
    print(f"{label} metrics [{card}]: call {latency:.5f} s, "
          f"{8 * cfg.seq_len / latency:.1f} tokens/s, host {host:.5f} s per "
          f"call until it returns, device share {share} (busy time over "
          f"the call time); dispatch mode "
          f"{stats['mode']}; graph pools "
          f"{(ex.get_graph_pool_bytes() or 0) / 2**30:.3f} GiB")
    counts = launch_counts()
    del forward, ex, out, want, box, params, model
    torch.cuda.empty_cache()
    return counts[0]


def phase_pipeshard_auto(shard_profile, ref_loss=None):
    """The README's headline form at full width and depth: GPT-1.3B with no
    boundaries, ``AutoLayerOption(layer_num=8, remat_layer=True)``, 2
    uniform stages, 4 microbatches, 1F1B; each block's flash forward runs
    twice (the recompute).  Prints the layer cuts; then one step under
    ``get_3d_parallel_method`` (dp = op = 1, pp = 2) and one under
    ``AutoStageOption`` on one device, each first loss held to
    ShardParallel's.  Returns the (fwd, dq, dkv) launches of the timed
    run."""
    cfg = pipeshard_config()
    batch = lm_batch(cfg, 8)
    if ref_loss is None:
        ref_loss = shard_first_loss(cfg, batch)
    label = "pipeshard auto"
    run = timed_pipeshard(label, cfg, auto_pipeshard_method(4, 8), batch,
                          ref_loss, 1e-6, shard_profile, forward_runs=2)
    counts, ex = run["counts"], run["ex"]
    del run
    flash = torch.ops.alpa_tpu_torch.flash_fwd.default
    cuts = [(sum(n.target is flash for n in c.nodes),
             sum(node_flops(n) for n in c.nodes)) for c in ex.fwd_layer_comps]
    check(len(cuts) == 8 and sum(b for b, _ in cuts) == cfg.num_layers,
          f"{label}: layer cuts {cuts}")
    print(f"{label} layers: (blocks, forward flops per microbatch by "
          f"node_flops) {cuts}; stages {len(ex.fwd_layer_comps)} layers in "
          f"{ex.num_fwd_stages}")
    del ex

    method = get_3d_parallel_method(num_micro_batches=4, data_parallel=1,
                                    operator_parallel=1, pipeline_parallel=2,
                                    devices=stage_devices())
    loss, ex = first_loss(method, cfg, batch)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    print(f"{label} get_3d_parallel_method(dp=1, op=1, pp=2): "
          f"{method.layer_option}, first loss {loss:.6f}, {rel:.3e} relative "
          f"to ShardParallel (tol 1e-6); trace {ex.trace_seconds:.3f} s")
    check(rel <= 1e-6, f"{label}: 3D method's first loss {loss} vs "
          f"{ref_loss}")
    del ex

    method = auto_pipeshard_method(4, 8, devices=stage_devices()[:1],
                                   stage_option=AutoStageOption())
    loss, ex = first_loss(method, cfg, batch)
    rel = abs(loss - ref_loss) / abs(ref_loss)
    info = ex.stage_dp_info
    print(f"{label} AutoStageOption on one card [{card_line()}]: partition "
          f"{info['partition']} of {len(ex.fwd_layer_comps)} layers, solver "
          f"{info['solver']}, solve {info['solve_seconds']:.6f} s, the stage "
          f"DP with its cost tensor {info['seconds']:.6f} s; first loss "
          f"{loss:.6f}, {rel:.3e} relative to ShardParallel (tol 1e-6)")
    check(info["solver"].startswith("native") and
          info["partition"] == [(0, 8, (1, 1))],
          f"{label}: stage DP {info}")
    check(rel <= 1e-6, f"{label}: AutoStageOption's first loss {loss} vs "
          f"{ref_loss}")
    del ex
    torch.cuda.empty_cache()
    return counts


def kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_bf16_kernel<64>`` from its mangled name."""
    # the last "flash_": nvcc names an anonymous namespace after the file
    match = re.search(r"(flash_\w+?_kernel)I(.*?E)E+v",
                      mangled[mangled.rfind("flash_"):])
    if match is None:
        return mangled
    args = re.sub(r"Li(\d+)E", r",\1", match[2])
    args = args.replace("13__nv_bfloat16", "bf16").strip(",")
    return f"{match[1]}<{re.sub(r'^f,', 'float,', args)}>"


def build_kernels():
    """One nvcc per source, all started together."""
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    print(f"setup: built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - tic:.2f} s")
    for lib in libs:
        name = spill = None
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "Function properties for" in line:
                name = kernel_name(line.split()[-1])
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[-1].strip()
                print(f"setup: {lib.name}: {name}: {regs}; {spill}")


def two_cards():
    """``--two-cards``: phase 8's checks with its two stages on two cards
    (cross-card RESHARDs, a pool per card, CUDA events across cards): the
    pipeshard fidelity phase, then phase 8 and its dispatch modes
    (``phase_dispatch``: every mode bit-identical to the uncaptured steps,
    resharding bytes per step)."""
    check(torch.cuda.device_count() >= 2,
          f"--two-cards needs two cards, found {torch.cuda.device_count()}")
    phase_pipeshard_fidelity()
    cfg = pipeshard_config(pipeline_boundary_every=12)
    batch = lm_batch(cfg, 8)
    ref_loss = shard_first_loss(cfg, batch)
    run = timed_pipeshard("pipeshard two cards", cfg, pipeshard_method(4),
                          batch, ref_loss, 1e-2, {}, keep=True)
    phase_dispatch(cfg, batch, run, label="pipeshard two cards dispatch")


def main(args) -> int:
    if args not in ([], ["--two-cards"]):
        print("usage: chip_smoke.py [--two-cards]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    print(f"setup: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_kernels()
    if args:
        try:
            two_cards()
        except SmokeFailure as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    try:
        fwd_entry, fwd_train = phase_kernel()
        bwd_entries = phase_bwd_kernel()
        serving = phase_serving()
        phase_fidelity()
        (train_fwd, train_dq, train_dkv), shard_profile = phase_training(
            (fwd_train["ms"], *(e["ms"] for e in bwd_entries)))
        phase_train_fidelity()
        phase_pipeshard_fidelity()
        phase_pipeshard_auto_fidelity()
        phase8, ref_loss = phase_pipeshard(shard_profile)
        pipe = phase8["counts"]
        remat = phase_pipeshard_remat_blocks(shard_profile, phase8)
        auto = phase_pipeshard_auto(shard_profile, ref_loss)
        infer = phase_pipeshard_infer()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    fwd_entry["launches"] = (serving + train_fwd + pipe[0] + remat[0] +
                             auto[0] + infer)
    fwd_entry["launches_by_path"] = {"serving": serving,
                                     "training": train_fwd,
                                     "pipeshard": pipe[0],
                                     "pipeshard_remat_blocks": remat[0],
                                     "pipeshard_auto": auto[0],
                                     "pipeshard_infer": infer}
    fwd_entry["at_training_shape"] = fwd_train
    for entry, n, p, r, a in zip(bwd_entries, (train_dq, train_dkv),
                                 pipe[1:], remat[1:], auto[1:]):
        entry["launches"] = n + p + r + a
        entry["launches_by_path"] = {"training": n, "pipeshard": p,
                                     "pipeshard_remat_blocks": r,
                                     "pipeshard_auto": a,
                                     "pipeshard_infer": 0}
    print(card_line())
    print(json.dumps({"kernels": [fwd_entry, *bwd_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
