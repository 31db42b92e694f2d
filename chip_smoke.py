"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each reported on its own line:

1. setup: the card's name and power limit; build the flash kernel from
   ``alpa_tpu_torch/csrc`` and report the build time;
2. kernel: the CUDA flash-attention forward against its plain PyTorch
   version on the card, case by case, with the tolerance stated; times of
   the kernel, the plain version and ``scaled_dot_product_attention`` (a
   yardstick only, never called by the port) at the serving prefill shape,
   beside the least time the card could take;
3. serving: ``run_controller`` + ``register_model`` of OPT-1.3B (bf16,
   flash attention, all 24 layers, random weights from a seed), four
   concurrent ``POST /completions`` of 37, 128, 300 and 511 tokens with 32
   greedy new tokens; every prefill must have launched the kernel once per
   layer;
4. fidelity: a 4-layer fp32 OPT-1.3B with the same weights generates the
   same greedy tokens with the kernel as with the plain version.

Any failure exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
and the line before it lists the kernels as JSON.
"""
import dataclasses
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from alpa_tpu_torch.model.gpt_model import config_from_opt_spec
from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.ops import flash_attention as fa
from alpa_tpu_torch.serve import GenerationConfig, get_model, run_controller

SEED = 0
PROMPT_LENGTHS = (37, 128, 300, 511)
NEW_TOKENS = 32
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def flash_bound(b, sq, sk, h, d, causal, off, dtype):
    """Least time for the attention forward on this card: each needed
    input byte read once, each output byte written once, and the FLOPs of
    the (q, k) pairs the causal mask leaves visible."""
    rows = np.arange(sq)
    visible = (np.minimum(sk, rows + off + 1) if causal
               else np.full(sq, sk)).sum()
    keys = min(sk, sq + off) if causal else sk
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * h * d * item * (2 * sq + 2 * keys) + b * h * sq * 4)
    flops = 4.0 * b * h * d * float(visible)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def make_qkv(b, sq, sk, h, d, dtype, gen):
    """q as a strided view of a packed qkv projection, as the model gives
    it; k/v as contiguous KV caches."""
    qkv = torch.randn(b, sq, 3 * h * d, device="cuda", generator=gen)
    q = qkv.to(dtype)[..., :h * d].unflatten(-1, (h, d))
    k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
    return q, k, v


def max_violation(a, b, atol, rtol) -> float:
    """max(|a - b| - (atol + rtol |b|)); <= 0 means within tolerance."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() - (atol + rtol * b.abs())).max())


def phase_kernel():
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
    ]
    entry = None
    for name, b, sq, sk, h, d, causal, off, dtype in cases:
        q, k, v = make_qkv(b, sq, sk, h, d, dtype, gen)
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
        bound, bound_by = flash_bound(b, sq, sk, h, d, causal, off, dtype)
        print(f"kernel case {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"causal={causal} q_offset={off} {dtype}: max|out err| "
              f"{err:.3e} (tol {TOL[dtype]}), max|lse err| {lse_err:.3e} "
              f"(tol {LSE_TOL}), bound {bound:.5f} ms ({bound_by}) "
              f"{'ok' if ok else 'MISMATCH'}")
        check(ok, f"kernel case {name} disagrees with the plain version")
        if entry is None:   # the serving prefill shape: time it
            ms = cuda_ms(lambda: fa.flash_attention_forward(
                q, k, v, causal=causal, q_offset=off))
            plain_ms = cuda_ms(lambda: fa.flash_attention_forward_reference(
                q, k, v, causal=causal, q_offset=off))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            # is_causal aligns the mask top-left: q_pos >= k_pos, which is
            # q_offset 0, the same function on the same inputs
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
            print(f"kernel timing {name}: kernel {ms:.5f} ms, plain "
                  f"{plain_ms:.5f} ms, scaled_dot_product_attention "
                  f"{library_ms:.5f} ms, bound {bound:.5f} ms ({bound_by})"
                  f" [{card_line()}]")
            entry = {"name": "flash_fwd", "route": "cuda",
                     "source": "alpa_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "alpa_tpu/ops/flash_attention.py:62",
                     "also_replaces": "alpa_tpu/ops/flash_attention.py:110",
                     "launches": 0, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v, out, lse, ref_out, ref_lse
    torch.cuda.empty_cache()
    return entry


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


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    print(f"setup: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    tic = time.perf_counter()
    lib = _build.build("flash_fwd.cu")
    print(f"setup: built {lib.name} in {time.perf_counter() - tic:.2f} s")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"setup: {line.strip()}")
    try:
        entry = phase_kernel()
        entry["launches"] = phase_serving()
        phase_fidelity()
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(card_line())
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
