"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

or, on a machine with two cards or more, ``python3 chip_smoke.py
--two-cards`` for phase 8's fidelity and dispatch checks with the two
stages on two cards (cross-card RESHARDs, one CUDA graph pool per card,
CUDA events across cards), and on a machine with four, ``python3
chip_smoke.py --four-cards`` for the sharded step over four cards.

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
   width at ``PIPESHARD_LAYERS`` (6) of its 24 layers (every pipeshard
   phase's depth, a boundary after the third block), bf16 compute, fp32
   params and Adam, no remat, batch 8 in 4 microbatches, 3 warm-up and 5
   timed steps: a finite loss that falls, the first step's loss within
   1e-2 relative of one ``ShardParallel`` step from the same state and
   batch, and exactly 4 x 6 forward, dq and dk/dv launches per step;
   step time, tokens/s,
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
   ``ShardParallel``'s on the same config, 8 x 6 forward launches per
   step, step and peak beside phase 8's;
9. pipeshard auto-layer fidelity: the fidelity check of phase 8 for 4
   layers without boundaries under ``AutoLayerOption(layer_num=4,
   remat_layer=True)``;
10. pipeshard auto: the README's headline form at phase 8's width and depth,
   GPT-1.3B with no boundaries under ``AutoLayerOption(layer_num=4,
   remat_layer=True)`` and ``UniformStageOption(2)``, 4 microbatches, 1F1B,
   as phase 8 measures it (first loss within 1e-6 of ``ShardParallel``'s,
   8 x 6 forward launches per step: each block's forward runs again in its
   layer's backward), with the layer cuts (blocks and flops per layer);
   then one step under ``get_3d_parallel_method(dp=1, op=1, pp=2)`` and one
   under ``AutoStageOption`` on one card (the stage DP's partition, solver
   and solve time), each first loss within 1e-6 of ``ShardParallel``'s;
11. pipeshard infer: a forward-only ``parallelize``d function returning
   GPT-1.3B's logits under ``PipeshardParallel`` (2 stages x 4
   microbatches, the ``"inference"`` schedule, batch 8): logits against the
   eager forward at bf16 tolerance, 4 x 6 forward and no backward launch
   per call, call time, host time, device share and tokens/s;
12. shard grad-acc: fidelity first, GPT-1.3B's width at 4 layers in fp32,
   batch 8, ``ShardParallel(num_micro_batches=4)`` against eager
   ``ShardParallel()`` from the same weights (phase 8's checks: step-0
   gradients to 1e-4 of each tensor's largest, over 2 Adam steps losses to
   1e-5 relative and parameters by ``param_diffs``); then ``bench.py``'s
   GPT-1.3B step at full width and 6 of its 24 layers (bf16 compute,
   fp32 params and
   Adam, flash, per-block remat) under ``ShardParallel(
   num_micro_batches=4)``, batch 32 (phase 6's batch of 8 per
   microbatch): 3 warm-up and 5 timed steps, exactly 8 x 6 forward, 4 x 6
   dq and 4 x 6 dk/dv launches per step, a finite loss that falls, the first
   loss within 1e-2 relative of the mean of four eager forward losses of
   the same state on the microbatches; step time, tokens/s, TFLOPS, MFU,
   trace and compile seconds, peak allocated memory beside phase 6's, then
   ``torch.profiler`` over two more steps: device share, the ten heaviest
   kernels and the accumulation adds (``aten::add_``) beside their bound;
13. planner: ``plan_auto_sharding`` on GPT-1.3B's train step (full width,
   24 layers, batch 8, bf16, flash, Adam), traced once on fake tensors, for
   the card's one-device mesh and a virtual mesh of the card named 8
   times (candidate shapes (1, 8) and (2, 4)): per shape the strategy
   graph's nodes, edges and strategies, build and solve seconds, solver
   and objective; the chosen shape and the specs of ``wte``, block 0's
   qkv, out, fc_in and fc_out weights and the batch.  Checks: the MILP
   solved (the one-device graph is trivial), within ``ilp_time_limit``,
   to an objective no worse than the same graph's with every input
   replicated.

14. spmd fidelity: a 4-layer GPT at narrow width (hidden 256, 4 heads,
   seq 256, vocab 1024) in fp32 on the flash kernels, batch 8, under
   ``ShardParallel`` on a forced (2, 2) logical mesh and under
   ``Zero2Parallel``, each over the card named 4 times (the SPMD
   executor's virtual mesh), against the one-device step from the same
   weights: step-0 gradients to 1e-5 of each tensor's largest, then 2 SGD
   steps (momentum 0.9; ``sgd_state`` says why not Adam) with losses to
   1e-5 relative and parameters to 1e-5 of each tensor's largest, and 4 x
   the one-device flash launches; the plan's specs and the collectives
   per step by kind and bytes;
15. spmd: phase 6's GPT-1.3B at ``SPMD_LAYERS`` (6) of its 24 layers
   (full width, bf16 compute, fp32 params and Adam, flash, per-block
   remat, batch 8) under ``ShardParallel`` with
   the ILP's mesh-shape search and under ``Zero2Parallel``, each over the
   card named twice, against the one-device step on the same weights
   and batch: Adam's first moment after one step (0.1 x the step-0
   gradient through the plan that runs) to ``SPMD_GRAD_TOL`` of each
   tensor's largest, the first loss to ``SPMD_LOSS_TOL`` relative, and the
   parameters after 2 Adam steps by ``param_diffs`` (to
   ``SPMD_PARAM_TOL`` of each tensor's largest where the step-0 gradient
   is at least 1e-2 of its tensor's largest, to ``adam_bound``
   elsewhere); exactly twice phase 6's flash launches per step; the
   chosen shape and objective, collectives per step, peak allocated
   memory and the step time (a one-card number: the two devices share
   the card).

16a. two-level fidelity: phase 14's 4-layer GPT (hidden 256, fp32, flash,
   batch 8) under the two-level plan, 2 SGD steps against the one-device
   step (losses to 1e-5 relative, parameters to 1e-5 of each tensor's
   largest, each stage's devices launching the flash kernels on their
   shares): ``PipeshardParallel`` in two stages of four virtual devices
   (the card named 8 times), the ILP in each; ``get_3d_parallel_method(2,
   2, 1, 2)`` on the card named 4 times; the first with ZeRO-2 in each
   stage; the tile executor's moving branch between the card and the
   host (every destination shard against the array sliced), and the
   first pipeshard with one stage on the card and one on the host; then
   ``AutoStageOption`` on the card named 4 times: its partition,
   submeshes and solve seconds, and its first loss;
16. two-level: phase 8's GPT-1.3B (6 layers, bf16 compute, fp32 params
   and Adam, flash, no remat, a boundary after 3 blocks, batch 8 in 4
   microbatches, 1F1B) in two stages of two virtual devices each (the card
   named 4 times), each stage planned by the ILP and run by the SPMD
   partitioner, values moved between the stage meshes as tiles; held to
   phase 8's step by phase 15's bounds on the first loss and on the
   parameters after 2 steps, and Adam's first moment after one step to
   ``TWO_LEVEL_GRAD_TOL`` (cuBLAS at its default configuration); 2 x
   phase 8's flash launches per step; each stage's logical shape, ILP
   objective, solver and
   solve seconds, collectives and RESHARDs per step (planned, naive and
   executed bytes), the dispatch per mesh, step time and peak memory.

17. telemetry and calibration (on one card, after phase 8 for (a)-(b),
   inside phase 4b for (e)): (a) phase 8's captured step from the seed
   state, 2 + 10 steps with the flight recorder off and again on:
   losses and parameters bit-identical, the median step with it on at
   most ``FLIGHT_COST_TOL`` x the median without; (b) one traced step:
   a device-clock span (CUDA events) for every RUN and RESHARD, the step
   bit-identical to an untraced one, the critical path within the step's
   wall time, every stage's MFU in (0, 1], the stages' RUN time within
   wall x meshes; the ``StepPerfReport`` printed and the Chrome trace
   saved; (c) ``profile_one_mesh`` on the card named twice (backend
   "plain") over collectives of 2^10 to 2^28 bytes, (b)'s step ingested
   into a ``CalibrationStore`` under a temporary directory, and
   ``AutoStageOption(profiling_mode="measured")`` on GPT at hidden 2048
   and 4 layers: the partition, each stage's analytic and measured
   seconds beside its RUN time, ``alpa_cost_model_drift_ratio``; (d)
   phase 13's planner (6 layers) on the card named twice, cold, warm in
   the process and warm in a subprocess over a disk cache: identical
   plans, the hits, the solve seconds; (e) after phase 4b's requests,
   ``GET /metrics``: the ``alpa_serving_*`` and ``alpa_kv_*`` families,
   the requests served and the TTFT histogram's count.

18. faults and state (on one card; (a)-(c) on phase 8's executable):
   (a) two steps under a ``FaultPlan`` raising once at ``stage_launch``
   and once at ``cross_mesh_send`` with a retry policy: both retried,
   losses and parameters bit-identical to the steps without faults, no
   recapture; (b) two steps, an asynchronous ``CheckpointManager`` save,
   two more, the saved step restored into the live state and the two
   steps again, bit-identical with no recapture; a flipped byte of a
   chunk named by ``verify_step`` and its restore refused; the bytes
   written, the save's blocking and total seconds, the restore seconds;
   (c) six steps under ``ElasticSupervisor`` with a preemption notice at
   step 3: quiesce, a snapshot inside ``elastic_grace_period_s``, the
   plan reused, the six losses bit-identical to an uninterrupted run;
   (d) phase 14's narrow GPT under ``Zero2Parallel`` on the card named 4
   times, a worker lost down to 2: resumed losses equal a direct restore
   at degree 2, a restore across plans raises
   ``PlanFingerprintMismatch``; (e) OPT-1.3B through the controller:
   ``POST /admin/reload`` of seed-1 weights while 8 streams run (all
   finish; later greedy tokens equal a fresh ``Generator``'s), a corrupt
   checkpoint refused, ``scheduler_tick`` faults shedding load (503)
   until recovery, ``check_alive`` and ``WedgeDetector`` ``ok``.  The
   checkpoints go under a temporary directory, removed after.

19. the rest of serving, OPT-1.3B (bf16, flash, ``SERVING_REST_LAYERS``
   of its 24 layers, seed 0) with
   OPT-125M (seed 1) as the draft: (a) greedy ``generate_speculative``
   (4 drafts a round) with the OPT-125M draft and with the target as its
   own draft, 4 prompts of 32-480 tokens and 64 new tokens, equal to
   greedy ``generate`` (or parted at a near-tie, ``NEAR_TIE``), the
   self-draft accepting at least ``SELF_DRAFT_MIN_ACCEPT`` of its
   proposals; acceptance, target forwards per token and ms per token
   beside plain decode's; one sampled run, reproducible under its seed;
   (b) ``generate_beam`` with 1 beam (== greedy) and 4, 32 new tokens,
   one prefill per search; (c) a prefill controller and a decode
   controller in this process behind a ``Router`` in ``forced``
   disaggregation: phase 4b's 16 streamed requests (32 new tokens) equal
   the monolithic paged engine token for token, the decode engine
   captured once; handoff seconds and artifact bytes; a corrupt artifact
   refused and re-fetched; the int8 handoff within 4 x the codec's bound;
   (d) ``RouterServer`` over two local replicas and an
   ``HTTPReplicaHandle`` to a controller on localhost: 32 concurrent
   requests, half over SSE, against one replica's tokens, the placement
   split, ``POST /admin/rolling_reload`` under traffic with zero errors,
   one replica's health dropped and restored; (e) the target's weights
   through ``save_params_dir``/``load_params_dir`` (temporary directory),
   bit-equal, served to the same tokens.  Each path's flash launches are
   24 per prefill model call (12 for the draft's) and appear in the
   kernels line.

20. plan analyses (``analysis/``), over the plans the earlier phases ran:
   (a) the verdict of each pipeshard plan of phases 8, 8b, 10, 11 and 16,
   recorded by the phase while its executable lived: ok, the errors,
   warnings and notes by (analysis, code), the analyses' seconds at the
   first launch (cold) and a second lowering's that replays the verdict
   from the cache (warm), the model checker's states (or skipped beyond
   ``FIXTURE_MAX_OPS``), the numerics' largest composed bound, the
   equivalence's terms, the static peak per mesh beside the measured
   peak; no error finding, each plan verified exactly once whatever its
   captures and dispatch modes; (b) phase 16a's int8 and fp8 codec plans:
   the certified composed bound at least the worst element error 16a
   measured; (c) the superoptimizer on phase 8's configuration: "suggest"
   on the plan as compiled (the simulated critical-path and peak ratios;
   its two steps from the seed state are the baseline), then the list
   deoptimized under "auto": rewrite searched, gated and run, its CUDA
   graphs captured from the rewritten list, losses and every parameter
   after two steps bit-identical to the baseline's, the step's device
   time (CUDA events) and the graphs' pools beside the baseline's; a
   second decision on the plan replays the rewrite from the ``superopt``
   cache with zero search (these steps' flash launches count under
   ``pipeshard_superopt``); (d) phase 18c's elastic episode reports a real
   verdict; under ``verify_plans="error"`` a real failure injected at
   ``stage_launch`` (a site the model checker classes unsafe) is refused
   where "warn" retries it; ``dump_debug_info`` writes
   ``plan_verdict.txt`` and ``superopt.txt``.  Phases 13, 15 and 16 also
   scan their partitioned GPT-1.3B programs for a strided local slice
   that reaches an op other than mm, bmm, sum, add and add_ (ROADMAP C.8:
   none may), and phases 15 and 16 print the contiguous copies that the
   C.8 repair makes per step.

``--four-cards`` (a machine with four cards): first C.4's bisection
(phase 16a's narrow pipeshard over the card layouts, every dispatch
mode, collectives and tiles checked); then GPT-1.3B at batch 32 (8 per
card) under ``DataParallel``, ``Zero2Parallel`` and the ILP's
``ShardParallel`` over the four cards (collectives over NCCL), held by
phase 15's bounds against phase 12's one-card
``ShardParallel(num_micro_batches=4)`` step at batch 32 (the first loss,
Adam's first moment and the parameters after one step), 4 x its flash
launches per microbatch; step time, tokens/s, MFU
over 4 x 989 TFLOP/s, collective bytes and NCCL device time per step, the
plan's ILP objective beside the measured step, peak memory per card;
then phase 16 over the four cards (two stages of two cards, NCCL inside
each), direct and tiled, held to phase 8's step by phase 16's bounds.

21. serving families and pipelined serving: (a) OPT-1.3B (24 layers,
   bf16, flash, a boundary after 12 blocks) behind
   ``Generator(parallel_method=PipeshardParallel(num_micro_batches=1,
   ManualLayerOption(), UniformStageOption(2), "inference"))``, its two
   stages on phase 8's devices, and behind the plain ``Generator`` on the
   same weights: phase 4's 4 prompts (37-511 tokens), 32 greedy new
   tokens, three ``generate`` calls (traced and warm, captured, replayed);
   the tokens equal the plain ones (phase 4b's near-tie rule), the trace
   counts stay flat after the first call, no RESHARD and no copy of a
   cache in a decode step after warm-up, one capture and no recapture,
   24 flash-forward launches per prefill call; ms per token of both
   paths, the decode step's time (CUDA events) and the peak memory;
   (b) BLOOM-560m and CodeGen-350M at their ladders' widths and depths
   (bf16, random weights from the seed): the cached decode (a 64-token
   prefill, 8 decode steps) against the full-context forward at the same
   positions (``FAMILY_LOGIT_REL``), and at 2 layers in fp32 to 1e-4;
   phase 4's prompts through the plain Generator of each and BLOOM-560m
   pipelined in two stages, whose tokens equal the plain ones (near-tie
   rule); ms per token; (c) phase 8's GPT-1.3B (6 layers, bf16, a
   boundary after 3 blocks, 4 microbatches, 1F1B) with per-block remat
   under ``remat_policy="dots"``, and with packed rows (``segment_ids``,
   positions restarting per segment): the first loss to 1e-2 relative and
   Adam's first moment to ``TWO_LEVEL_GRAD_TOL`` of the same step run
   eagerly, the step time beside phase 8's (the CPU tests hold both
   steps to the JAX package's in fp32).

Any failure exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``
and the line before it lists the kernels as JSON.
"""
import concurrent.futures
import contextlib
import dataclasses
import faulthandler
import gc
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

import alpa_tpu_torch
from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                            ManualLayerOption, PipeshardParallel,
                            UniformStageOption, get_3d_parallel_method)
from alpa_tpu_torch.model.gpt_model import (GPTModel, config_from_opt_spec,
                                            config_from_spec, init_random_)
from alpa_tpu_torch.model.bloom_model import (BloomModel,
                                             config_from_bloom_spec)
from alpa_tpu_torch.model.codegen_model import (CodeGenModel,
                                               config_from_codegen_spec)
from alpa_tpu_torch.model.model_util import (TrainState, adam,
                                             cross_entropy_loss, gpt_lm_loss,
                                             make_apply_fn, sgd)
from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.ops import flash_attention as fa
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.serve import (ContinuousBatchingEngine, GenerationConfig,
                                  Generator, KVBlockPool, get_model,
                                  run_controller)
from alpa_tpu_torch.telemetry.perf import GPU_SPECS, compute_mfu
from alpa_tpu_torch.util import compute_gpt_tflops, node_flops

SEED = 0
LR = 1e-4   # Adam's learning rate in every training phase
PROMPT_LENGTHS = (37, 128, 300, 511)
NEW_TOKENS = 32
# phase 4b: a 256-token system prompt, 16 streamed requests with suffixes
# of 32-480 tokens and 64 greedy new tokens, on the controller's engine of
# 4 rows (JAX's default), chunked prefill of 128 tokens
ENGINE_PREFIX = 256
ENGINE_REQUESTS = 16
ENGINE_NEW_TOKENS = 64
ENGINE_ROWS = 4
ENGINE_CHUNK = 128
# the longest wait of phase 4b's profile for its rows to be admitted
# and its ticks to run, in seconds
ENGINE_PROFILE_TIMEOUT = 120
# the whole run's own limit in seconds, from the start of main(); the run
# is given 1200 s
WATCHDOG_S = 1140
# two bf16 paths through 24 layers (a solo B=1 decode against the engine's
# B=4 tick) may order a near-tie differently: a divergence is accepted
# only where the two tokens' logits lie within this many logit units of
# each other and of the top (8 bf16 ulps at |logit| in [4, 8))
NEAR_TIE = 0.25
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


def concurrent_completions(port, prompts, new_tokens, model="opt-1.3b"):
    """POST every prompt at once from its own thread; (outputs, seconds
    per request, wall seconds)."""
    outs, secs = [None] * len(prompts), [None] * len(prompts)
    barrier = threading.Barrier(len(prompts))
    errors = []

    def call(i):
        barrier.wait()
        tic = time.perf_counter()
        try:
            outs[i] = post(port, {"model": model,
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
        batcher = server.controller._models["opt-1.3b"][0].batcher
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


def read_sse(port, body, times):
    """POST a streamed completion; (tokens, final event), with the host
    clock of each token appended to ``times``."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/completions",
        data=json.dumps({**body, "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    tokens, final = [], None
    with urllib.request.urlopen(req, timeout=600) as resp:
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            event = json.loads(line[len("data: "):])
            if "token" in event:
                times.append(time.perf_counter())
                tokens.append(event["token"])
            else:
                final = event
    return tokens, final


def engine_tokens(engine, prompts):
    """Enqueue every prompt at once (the loop admits under the engine's
    lock), then read the streams: one list of tokens per prompt."""
    with engine._cv:
        streams = [engine.submit_stream(p, GenerationConfig(
            max_new_tokens=ENGINE_NEW_TOKENS)) for p in prompts]
    return [list(s) for s in streams]


def near_tie_divergence(model, prompt, got, want):
    """None if the token lists are equal; else (position, gap): the logit
    gap between the two tokens where they first differ, from a cache-free
    forward over the prompt and the common tokens, and how far the lower
    of them lies below the top logit there."""
    pos = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
               None)
    if pos is None:
        return None if len(got) == len(want) else (len(got), float("inf"))
    ids = torch.as_tensor(np.concatenate([prompt, got[:pos]])[None],
                          device=next(model.parameters()).device)
    with torch.inference_mode():
        logits = model(ids)[0, -1].float()
    top = float(logits.max())
    a, b = float(logits[got[pos]]), float(logits[want[pos]])
    return pos, max(abs(a - b), top - min(a, b))


def profile_engine_ticks(engine, start_work, ticks, label, top=8):
    """``torch.profiler`` over ``ticks`` decode ticks of a live engine: the
    busy time (the union of kernel intervals) per tick and its share of
    the profiled span, the wall time per tick, and the ``top`` heaviest
    kernels by device time per tick.  The profiler is set up on the idle
    engine; ``start_work()`` then submits the rows and returns their
    streams.  Recording starts once every row is admitted and 5 ticks
    have run, and stops after ``ticks`` ticks or when the rows finish,
    whichever comes first.  Every wait ends within
    ``ENGINE_PROFILE_TIMEOUT`` seconds or fails the phase.  Returns the
    profile (None when no tick was recorded) and the streams."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    deadline = time.monotonic() + ENGINE_PROFILE_TIMEOUT

    def wait_for(cond, what):
        while not cond():
            check(time.monotonic() < deadline, f"{label}: {what} within "
                  f"{ENGINE_PROFILE_TIMEOUT} s")
            time.sleep(0.001)

    # warm-up is the profiler's set-up (CUPTI's included); the one active
    # step is the recorded window
    window = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities,
                                schedule=window) as prof:
        streams = start_work()
        wait_for(lambda: int(engine._active.sum()) >= len(streams),
                 "every row admitted")
        admitted = engine.decode_steps
        wait_for(lambda: engine.decode_steps >= admitted + 5,
                 "the prefills done")
        # counted from just before the step() that starts the recording
        # (ticks run while it starts) to just before the one that stops
        # it (the engine's thread waits for the GIL while it stops)
        start, tic = engine.decode_steps, time.perf_counter()
        prof.step()
        wait_for(lambda: (engine.decode_steps >= start + ticks or
                          not engine._active.any()), f"{ticks} ticks")
        done, wall = engine.decode_steps - start, time.perf_counter() - tic
        prof.step()
    if done == 0:
        return None, streams
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, streams
    busy_us, reach = 0.0, spans[0][0]
    for s0, e0 in spans:
        busy_us += max(0.0, e0 - max(s0, reach))
        reach = max(reach, e0)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in prof.key_averages() if e.device_type == cuda),
                     key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels) or 1.0
    for rank, e in enumerate(kernels[:top], 1):
        print(f"{label} tick kernel {rank}: "
              f"{e.self_device_time_total / 1e3 / done:.4f} ms per tick, "
              f"{e.count / done:.1f} launches per tick, "
              f"{e.self_device_time_total / total_us:.4f} of the device "
              f"time: {e.key[:110]}")
    return {"ticks": done, "wall_s_per_tick": wall / done,
            "busy_s_per_tick": busy_us / 1e6 / done,
            "busy_share": busy_us / (reach - spans[0][0])}, streams


def phase_engine():
    """Phase 4b: the serving engine.  OPT-1.3B as phase 4 builds it (bf16,
    flash, 24 layers, random weights from the seed), chunked prefill of
    128 tokens, registered on ``run_controller`` with ``kv_paged`` and
    ``kv_prefix_reuse`` on and a 256-token system prompt warmed into the
    pool; 16 concurrent streamed ``POST /completions`` (the system prompt
    and a suffix of 32-480 tokens, 64 greedy new tokens) on the replica's
    engine of 4 rows.  Checks: every streamed answer equals the same
    prompts sent to a paged engine directly; that engine's tokens equal an
    unpaged engine's over the same prefix as a ``PrefixHandle``; the
    non-streamed answer (the batcher, all 16 sent at once) equals the
    streamed one or parts from it at a near-tie (``NEAR_TIE``); every
    request hits the warmed prefix; 24 forward launches per prefill model
    call and no backward launch; one capture per engine, a replay per tick, no step failure; one
    decode tick replayed gives the logits of the same tick run uncaptured,
    bit for bit.  Then the forward kernel at the engine's suffix shape, the
    tick's time uncaptured and replayed beside its bound, the tick's device
    share under ``torch.profiler`` and the request metrics."""
    label = "serving engine"
    cfg = config_from_opt_spec("1.3b", dtype=torch.bfloat16,
                               attention_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTModel(cfg, device="cuda")
    init_random_(model, SEED)
    gen = Generator(model, cfg, prefill_chunk=ENGINE_CHUNK)
    rng = np.random.default_rng(SEED + 4)
    system = rng.integers(0, cfg.vocab_size, ENGINE_PREFIX)
    suffix_lens = rng.integers(32, 481, ENGINE_REQUESTS + 1)
    suffixes = [rng.integers(0, cfg.vocab_size, n) for n in suffix_lens]
    prompts = [np.concatenate([system, s]) for s in suffixes]
    warm_prompt, prompts, suffixes = prompts[0], prompts[1:], suffixes[1:]
    saved = (global_config.kv_paged, global_config.kv_prefix_reuse,
             global_config.kv_block_size)
    global_config.kv_paged = global_config.kv_prefix_reuse = True
    global_config.kv_block_size = 16
    server = run_controller(port=0)
    name = "opt-1.3b-engine"
    try:
        metrics_before = get_metrics(server.port)
        server.controller.register_model(name, gen, prefix_ids=system)
        tic = time.perf_counter()
        engine = server.controller._models[name][0].engine
        pool = engine._pool
        build_s = time.perf_counter() - tic
        # warm-up: one streamed request (the capture happens here)
        tokens, final = read_sse(server.port, {
            "model": name, "prompt_ids": warm_prompt.tolist(),
            "max_new_tokens": 8}, [])
        check(final == {"done": True} and len(tokens) == 8,
              f"{label}: warm-up stream ended with {final}")
        reset_launch_counts()
        prefills0, steps0 = gen.prefill_calls, engine.decode_steps
        replays0 = engine.decode_replays
        times = [[] for _ in prompts]
        results = [None] * len(prompts)
        submitted = [None] * len(prompts)
        errors = []
        barrier = threading.Barrier(len(prompts))

        def call(i):
            barrier.wait()
            submitted[i] = time.perf_counter()
            try:
                results[i] = read_sse(server.port, {
                    "model": name, "prompt_ids": prompts[i].tolist(),
                    "max_new_tokens": ENGINE_NEW_TOKENS}, times[i])
            except Exception as e:  # pylint: disable=broad-except
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not any(t.is_alive() for t in threads), f"{label}: a stream "
              "hung")
        check(not errors, f"{label}: a stream failed: {errors[:1]}")
        launches = launch_counts()
        prefills = gen.prefill_calls - prefills0
        steps = engine.decode_steps - steps0
        replays = engine.decode_replays - replays0
        streamed = [r[0] for r in results]
        for (tokens, final), p in zip(results, prompts):
            check(final == {"done": True} and
                  len(tokens) == ENGINE_NEW_TOKENS and
                  all(0 <= t < cfg.vocab_size for t in tokens),
                  f"{label}: stream of {len(tokens)} tokens ended with "
                  f"{final}")
        stats = pool.stats()
        ttft = [t[0] - s for t, s in zip(times, submitted)]
        tpot = [(t[-1] - t[0]) / (len(t) - 1) for t in times]
        wall = max(t[-1] for t in times) - min(submitted)
        print(f"{label}: OPT-1.3B ({cfg.num_layers} layers, bf16, flash), "
              f"engine of {engine.B} rows built with a {ENGINE_PREFIX}-token "
              f"warmed prefix in {build_s:.2f} s; {len(prompts)} streams of "
              f"{ENGINE_NEW_TOKENS} tokens ok, prompts "
              f"{sorted(len(p) for p in prompts)}; {prefills} prefill model "
              f"calls, flash launches (fwd, dq, dkv) {launches}; {steps} "
              f"ticks, {replays} "
              f"replays, captures {engine.decode_captures}, step failures "
              f"{engine.step_failures}; pool {stats}")
        check(stats["prefix_hits"] >= 15, f"{label}: prefix hits "
              f"{stats['prefix_hits']}")
        check(prefills >= 1 and
              launches == (cfg.num_layers * prefills, 0, 0),
              f"{label}: flash launches (fwd, dq, dkv) {launches}, want "
              f"({cfg.num_layers} x {prefills} prefill calls, 0, 0)")
        check(engine.decode_captures == 1 and
              engine.decode_replays == engine.decode_steps and
              replays == steps, f"{label}: captures "
              f"{engine.decode_captures}, replays {engine.decode_replays} "
              f"for {engine.decode_steps} ticks")
        check(engine.step_failures == 0, f"{label}: step failures")
        # the batcher, all requests at once: equal, or parted at a near-tie
        ties = []
        answers, _, _ = concurrent_completions(server.port, prompts,
                                               ENGINE_NEW_TOKENS, model=name)
        for p, got, want in zip(prompts, streamed, answers):
            check(want[:len(p)] == p.tolist(), f"{label}: no echo")
            tie = near_tie_divergence(model, p, got, want[len(p):])
            if tie is not None:
                ties.append(tie)
        print(f"{label}: streamed == non-streamed for "
              f"{len(prompts) - len(ties)} of {len(prompts)} requests; parted "
              f"at (position, logit gap) {ties} (tolerance {NEAR_TIE})")
        check(all(gap <= NEAR_TIE for _, gap in ties), f"{label}: streamed "
              f"and non-streamed answers part beyond a near-tie: {ties}")
        timed("telemetry serving metrics", serving_metrics_check,
              server.port, metrics_before, len(prompts), 1 + len(prompts),
              8 + ENGINE_NEW_TOKENS * len(prompts))
        write_ms = pool.write_seconds / max(1, pool.write_calls) * 1e3
        blocks_in_use = stats["blocks_in_use"]
        bytes_saved = stats["bytes_saved"]
    finally:
        server.shutdown()
        (global_config.kv_paged, global_config.kv_prefix_reuse,
         global_config.kv_block_size) = saved
    # the handler class holds the controller in a reference cycle
    del engine, pool, server
    gc.collect()
    torch.cuda.empty_cache()

    # the same requests straight to a paged engine, then to an unpaged one
    # over the same prefix as a PrefixHandle
    pool = KVBlockPool.for_generator(gen, block_size=16)
    paged = ContinuousBatchingEngine(gen, max_batch=ENGINE_ROWS,
                                     prompt_bucket=cfg.seq_len, kv_pool=pool)
    pool.warm_prefix(gen, system)
    paged_tokens = engine_tokens(paged, prompts)
    check(paged_tokens == streamed, f"{label}: the server's streams differ "
          "from the paged engine's tokens")
    with torch.inference_mode(), paged._cv:
        # one tick, uncaptured and replayed, on the idle engine's buffers
        start = paged._index.clone()
        paged._tick_body()
        uncaptured = paged._logits.clone()
        paged._index.copy_(start)
        paged._graph.replay()
        replayed = paged._logits.clone()
        same = torch.equal(uncaptured, replayed)
        tick_ms = cuda_ms(paged._tick_body)
        paged._index.copy_(start)
        replay_ms = cuda_ms(paged._graph.replay)
        paged._index.copy_(start)
        tick_bytes = (sum(p.numel() * p.element_size()
                          for p in model.parameters()) +
                      paged._kv.numel() * paged._kv.element_size())
    tick_bound = tick_bytes / PEAK_BYTES_PER_S * 1e3
    check(same, f"{label}: a replayed tick's logits differ from the "
          "uncaptured tick's")
    check(paged.decode_captures == 1 and paged.step_failures == 0 and
          paged.decode_replays == paged.decode_steps, f"{label}: paged "
          f"engine captures {paged.decode_captures}, replays "
          f"{paged.decode_replays} for {paged.decode_steps} ticks")
    # decode at steady state: four long requests, profiled for 50 ticks

    def long_requests():
        with paged._cv:
            return [paged.submit_stream(p, GenerationConfig(
                max_new_tokens=300)) for p in prompts[:ENGINE_ROWS]]

    profile, long_streams = profile_engine_ticks(paged, long_requests, 50,
                                                 label)
    for stream in long_streams:
        list(stream)
    paged.shutdown()
    del paged, pool
    gc.collect()
    torch.cuda.empty_cache()
    handle = gen.cache_prefix(system)
    unpaged = ContinuousBatchingEngine(gen, max_batch=ENGINE_ROWS,
                                       prompt_bucket=cfg.seq_len,
                                       prefix=handle)
    unpaged_tokens = engine_tokens(unpaged, suffixes)
    unpaged.shutdown()
    print(f"{label}: paged == unpaged tokens for all {len(prompts)} "
          f"requests: {paged_tokens == unpaged_tokens}; replayed tick logits "
          f"== uncaptured: {same}")
    check(paged_tokens == unpaged_tokens, f"{label}: paged and unpaged "
          "engines give different tokens")
    peak = torch.cuda.max_memory_allocated()
    card = card_line()
    share = steady = "not measured"
    if profile is not None:
        share = (f"{profile['busy_share']:.4f} (busy "
                 f"{profile['busy_s_per_tick'] * 1e3:.5f} ms of "
                 f"{profile['wall_s_per_tick'] * 1e3:.5f} ms per tick over "
                 f"{profile['ticks']} ticks of {ENGINE_ROWS} live rows)")
        steady = f"{ENGINE_ROWS / profile['wall_s_per_tick']:.1f} tokens/s"
    print(f"{label} metrics [{card}]: TTFT (to the first SSE event) p50 "
          f"{np.percentile(ttft, 50):.4f} s p99 {np.percentile(ttft, 99):.4f} "
          f"s; time per output token p50 {np.percentile(tpot, 50) * 1e3:.3f} "
          f"ms p99 {np.percentile(tpot, 99) * 1e3:.3f} ms; "
          f"{len(prompts) * ENGINE_NEW_TOKENS / wall:.1f} output tokens/s "
          f"over {wall:.3f} s (first submit to last token)")
    print(f"{label} tick [{card}]: {ENGINE_ROWS} rows, uncaptured "
          f"{tick_ms:.5f} ms, replayed {replay_ms:.5f} ms, bound "
          f"{tick_bound:.5f} ms ({tick_bytes} bytes: weights + the dense "
          f"KV rows, over {PEAK_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"steady decode {steady}; device share under torch.profiler "
          f"{share}; "
          f"write_tokens host {write_ms:.5f} ms per tick; pool blocks in "
          f"use {blocks_in_use}, bytes saved {bytes_saved}; peak allocated "
          f"{peak / 2**30:.3f} GiB")
    # the forward kernel at the engine's chunked suffix shape
    gen_k = torch.Generator(device="cuda").manual_seed(SEED)
    b, sq, sk, off = 1, ENGINE_CHUNK, cfg.seq_len, ENGINE_PREFIX
    h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    q, k, v = make_qkv(b, sq, sk, h, d, torch.bfloat16, gen_k)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True, q_offset=off)
    ref_out, ref_lse = fa.flash_attention_forward_reference(
        q, k, v, causal=True, q_offset=off)
    err = float((out.float() - ref_out.float()).abs().max())
    ok = (max_violation(out, ref_out, **TOL[torch.bfloat16]) <= 0 and
          max_violation(lse, ref_lse, **LSE_TOL) <= 0)
    bnd, bound_by = flash_bound(b, sq, sk, h, d, True, off, torch.bfloat16)
    print(f"kernel case engine-suffix: B={b} Sq={sq} Sk={sk} H={h} D={d} "
          f"causal=True q_offset={off} bf16: max|out err| {err:.3e} "
          f"{'ok' if ok else 'MISMATCH'}")
    check(ok, "kernel at the engine's suffix shape disagrees with the plain "
          "version")
    timing = {"max_abs_err": err, **time_fwd("engine-suffix", q, k, v, True,
                                             off, bnd, bound_by)}
    del q, k, v, out, lse, ref_out, ref_lse, handle, model, gen
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timing


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


def make_train_step(method=None, donate_argnums=(0,), loss_of=gpt_lm_loss):
    """``bench.py``'s train step, through the port (``ShardParallel()`` by
    default); ``loss_of(apply_fn, params, batch)``."""

    @alpa_tpu_torch.parallelize(
        method=method or alpa_tpu_torch.ShardParallel(),
        donate_argnums=donate_argnums)
    def train_step(state, batch):

        def loss_fn(p):
            return loss_of(state.apply_fn, p, batch)

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
    return counts, {"latency": latency, "peak": peak_bytes,
                    **(profile or {})}


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


def profile_calls(run, steps, latency, label, top=10, ops=()):
    """``torch.profiler`` over ``steps`` calls of ``run`` (one step each,
    returning a tensor to wait on): the ``top`` heaviest kernels by device
    time per step, the flash kernels' share, the device time per step of
    the kernels each host op in ``ops`` (e.g. ``"aten::add_"``) launched
    (under ``"ops"``), and the device's busy share, both
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
    by_op = {e.key: e.device_time_total for e in prof.key_averages()}
    return {"device_s_per_step": per_step,
            "device_share": per_step / latency,
            "busy_s_per_step": busy_step,
            "busy_share": busy_us / span_us,
            "ops": {op: by_op.get(op, 0) / 1e6 / steps for op in ops}}


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


def pipeshard_fidelity(label, cfg, method, batch_size=4,
                       what="2 microbatches, 2 stages", name="pipeshard"):
    """fp32, 4 layers at GPT-1.3B's width, batch ``batch_size``, from the
    same weights through ``method()`` and through ShardParallel: step-0
    gradients (the microbatch mean against the whole batch's), then 2 Adam
    steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = lm_batch(cfg, batch_size)

    def grad_step(state, batch):
        return alpa_tpu_torch.value_and_grad(
            lambda p: gpt_lm_loss(state.apply_fn, p, batch))(state.params)

    runs = {}
    for run, make in ((name, method), ("shard", shard_method)):
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
              f"{label}: the {run} run did not go through the kernels")
        runs[run] = (losses, grads, state.params)
        del state, train_step
    (p_losses, p_grads, p_params), (s_losses, s_grads, s_params) = \
        runs[name], runs["shard"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(p_losses, s_losses))
    grad_rel = max_rel_diff(p_grads, s_grads)
    bound = 2 * LR * len(p_losses)
    param_rel, n_small, n_all, small_max = param_diffs(p_params, s_params,
                                                       s_grads, bound)
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    print(f"{label}: fp32 GPT-1.3B at 4 layers, batch {batch_size}, {what}"
          f"; step-0 gradients max |diff| / max |g| per tensor "
          f"{grad_rel[worst_g]:.3e} at {worst_g} (tol 1e-4); 2 Adam steps: "
          f"losses {name} {p_losses} shard {s_losses}, max relative "
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
    """GPT-1.3B at full width and ``PIPESHARD_LAYERS`` of its 24 layers for
    the pipeshard phases: bf16 compute, flash, no per-block remat unless
    ``kw`` asks for it."""
    return dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.bfloat16,
                         attention_impl="flash", **kw),
        num_layers=PIPESHARD_LAYERS)


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
                    forward_runs=1, keep=False, record=True):
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
    step and its state.  With ``record`` the plan's verdict is recorded
    for phase 20a (``record_plan``)."""
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
    if record:
        record_plan(label, ex, peak_bytes, pool)
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

    def undonated(self, comp, mesh_id, device, root, donate=(),
                  device_id=0):
        init(self, comp, mesh_id, device, root, (), device_id)

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
    run["state"] = state
    del seed, ref


#: the flight recorder's cost bound: the median over ABBA blocks of the
#: steps with it on over the steps with it off
FLIGHT_COST_TOL = 1.02
#: blocks of four steps (off, on, on, off) timed for that bound
FLIGHT_BLOCKS = 8
#: steps from one state, with it off and then on, that must agree bit for bit
FLIGHT_SAME_STEPS = 3


def phase_telemetry_pipeshard(cfg, batch, run):
    """Phase 17 (a)-(b) on phase 8's executable (``run``: what
    ``timed_pipeshard`` kept, the state put back by ``phase_dispatch``).
    Returns the flash launches of its steps, the report and its joined
    step."""
    import os
    import tempfile
    from alpa_tpu_torch.telemetry import trace as ttrace
    step, state, ex = run["step"], run.pop("state"), run["ex"]
    cards = sorted(set(str(d) for d in ex.mesh_devices))
    batch = {k: torch.as_tensor(v, device=cards[0]) for k, v in batch.items()}
    model = GPTModel(cfg, device=cards[0], param_dtype=torch.float32)
    init_random_(model, SEED)
    seed = {k: p.detach() for k, p in model.named_parameters()}
    del model
    card = card_line()
    reset_launch_counts()
    runs = {}
    saved = global_config.flight_recorder
    ratios, times = [], {False: [], True: []}
    try:
        # bit-identity: the same steps from the same state, off then on
        for label, on in (("off", False), ("on", True)):
            global_config.flight_recorder = on
            state = reset_state_(state, seed)
            losses = []
            for _ in range(FLIGHT_SAME_STEPS):
                state, loss = step(state, batch)
                losses.append(float(loss))
            runs[label] = (losses, {k: p.clone()
                                    for k, p in state.params.items()})
        # the cost: off and on alternate in ABBA blocks over one state, so
        # drift and warm-up fall on both alike; each block's ratio pairs
        # its two steps on with its two steps off
        for _ in range(FLIGHT_BLOCKS):
            block = {False: 0.0, True: 0.0}
            for on in (False, True, True, False):
                global_config.flight_recorder = on
                torch.cuda.synchronize()
                tic = time.perf_counter()
                state, loss = step(state, batch)
                float(loss)
                dt = time.perf_counter() - tic
                times[on].append(dt)
                block[on] += dt
            ratios.append(block[True] / block[False])
    finally:
        global_config.flight_recorder = saved
    (off_l, off_p), (on_l, on_p) = runs["off"], runs["on"]
    same = off_l == on_l and all(torch.equal(p, on_p[k])
                                 for k, p in off_p.items())
    del runs, off_p, on_p
    ratio = float(np.median(ratios))
    q1, q3 = (float(q) for q in np.percentile(ratios, [25, 75]))
    print(f"telemetry flight recorder [{card}]: phase 8's step (CUDA graphs, "
          f"dispatch {ex.last_dispatch_stats['mode']}), {FLIGHT_BLOCKS} "
          f"off-on-on-off blocks: median step {np.median(times[False]):.5f} "
          f"s off, {np.median(times[True]):.5f} s on; block ratio on/off "
          f"median {ratio:.4f} (quartiles {q1:.4f}-{q3:.4f}, range "
          f"{min(ratios):.4f}-{max(ratios):.4f}; bound {FLIGHT_COST_TOL}); "
          f"losses and parameters of {FLIGHT_SAME_STEPS} steps bit-identical:"
          f" {same}; {len(ex._last_program.ops)} ops a step")
    check(same, "telemetry: the flight recorder changed the step")
    check(ratio <= FLIGHT_COST_TOL, f"telemetry: flight recorder block "
          f"ratio median {ratio} over {FLIGHT_COST_TOL}")

    # (b) one traced step against the same step untraced
    state = reset_state_(state, seed)
    state, loss = step(state, batch)
    ref_loss = float(loss)
    ref_params = {k: p.clone() for k, p in state.params.items()}
    state = reset_state_(state, seed)
    rec = ttrace.get_recorder()
    rec.clear()
    ttrace.set_enabled(True)
    try:
        torch.cuda.synchronize()
        tic = time.perf_counter()
        state, loss = step(state, batch)
        loss = float(loss)
        wall_us = (time.perf_counter() - tic) * 1e6
    finally:
        ttrace.set_enabled(False)
    same = loss == ref_loss and all(torch.equal(p, ref_params[k])
                                    for k, p in state.params.items())
    del ref_params
    report = ex.get_perf_report()
    joined = ex._last_joined_step
    ops, prog = ex._device_ops
    counts = {"RUN": 0, "RESHARD": 0}
    for op, hook in zip(ops, prog.hooks):
        if op.name.startswith("RUN"):
            counts["RUN"] += len(hook.members)
        elif hook.kind == "launch" or op.name.startswith("RESHARD"):
            counts["RESHARD"] += len(hook.members)
    want = {k: ex.get_instruction_counts()[k] for k in counts}
    run_us = sum(o.dur_us for o in ops if o.name.startswith("RUN"))
    mfus = {k: st.mfu for k, st in report.stages.items()}
    # the knob's directory, else a temporary file
    path = os.path.join(global_config.telemetry_trace_dir or
                        tempfile.mkdtemp(prefix="alpa_port_trace_"),
                        "phase17_step.json")
    ex.dump_stage_execution_trace(path)
    print(f"telemetry traced step [{card}]: {len(ops)} ops, each a "
          f"device-clock span ({len(prog.hooks)} hooks), covering "
          f"{counts} of the step's {want} instructions; wall {wall_us:.1f} "
          f"us, critical path {report.critical_path.total_us:.1f} us, "
          f"envelope {report.envelope_us:.1f} us, RUN time {run_us:.1f} us "
          f"over {ex.num_meshes} meshes; stage MFU " + ", ".join(
              f"{k} {v:.4f}" for k, v in sorted(mfus.items())) +
          f" (of {SPEC['peak_bf16_tflops']} TFLOP/s bf16; the flash op "
          f"counts its layout flops only, as the JAX package's "
          f"jaxpr_eqn_flops); bit-identical to the untraced step: {same}; "
          f"Chrome trace {path}")
    print(report.format_text())
    check(len(ops) == len(prog.hooks) and counts == want,
          f"telemetry: device spans cover {counts} of {want}")
    check(same, "telemetry: the traced step differs from the untraced one")
    check(report.critical_path.total_us <= wall_us,
          f"telemetry: critical path {report.critical_path.total_us} us "
          f"over the wall {wall_us} us")
    check(mfus and all(0 < v <= 1 for v in mfus.values()),
          f"telemetry: stage MFU {mfus}")
    check(run_us <= wall_us * ex.num_meshes,
          f"telemetry: RUN time {run_us} us over {ex.num_meshes} x wall "
          f"{wall_us} us")
    check(ex.capture_count == 1 and ex.recapture_count == 0,
          f"telemetry: the hooks made the step captured again "
          f"({ex.capture_count} captures, {ex.recapture_count} recaptures)")
    run["state"] = state
    del seed
    return launch_counts(), report, joined


def metric_samples(text: str, name: str) -> Dict[str, float]:
    """``{label set: value}`` of the samples named ``name`` in Prometheus
    text (the label set as written, "" for none)."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = re.match(rf"^{re.escape(name)}(\{{[^}}]*\}})?\s+(\S+)$", line)
        if m:
            out[m.group(1) or ""] = float(m.group(2))
    return out


def get_metrics(port) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        return resp.read().decode()


SERVING_FAMILIES = (
    "alpa_serving_queue_depth", "alpa_serving_batch_size",
    "alpa_serving_batches_total", "alpa_serving_requests_total",
    "alpa_serving_request_seconds", "alpa_serving_admissions_total",
    "alpa_serving_decode_steps_total", "alpa_serving_tokens_total",
    "alpa_serving_step_failures_total", "alpa_serving_active_rows",
    "alpa_serving_ttft_seconds", "alpa_kv_blocks_in_use",
    "alpa_kv_prefix_hits_total", "alpa_kv_bytes_saved_total",
    "alpa_kv_evictions_total")


def serving_metrics_check(port, before: str, requests: int, streams: int,
                          tokens: int):
    """Phase 17 (e): ``GET /metrics`` after phase 4b's requests: every
    serving and KV family present, the batched requests served
    (``alpa_serving_requests_total{outcome="ok"}``), the streams' first
    tokens (the TTFT histogram's count) and tokens, each as counted since
    ``before`` (the text read before the phase)."""
    text = get_metrics(port)
    missing = [f for f in SERVING_FAMILIES
               if f"# TYPE {f} " not in text]

    def delta(name, labels=""):
        return (metric_samples(text, name).get(labels, 0.0) -
                metric_samples(before, name).get(labels, 0.0))
    ok = delta("alpa_serving_requests_total", '{outcome="ok"}')
    ttft = delta("alpa_serving_ttft_seconds_count")
    toks = delta("alpa_serving_tokens_total")
    print(f"serving metrics [{card_line()}]: GET /metrics {len(text)} bytes, "
          f"{text.count('# TYPE ')} families; serving and KV families "
          f"missing {missing}; requests served {ok:.0f} (sent {requests}), "
          f"TTFT count {ttft:.0f} (streams {streams}), tokens {toks:.0f} "
          f"(streamed {tokens}); blocks in use "
          f"{metric_samples(text, 'alpa_kv_blocks_in_use')}, prefix hits "
          f"{metric_samples(text, 'alpa_kv_prefix_hits_total')}")
    check(not missing, f"serving metrics: families missing {missing}")
    check(ok == requests, f"serving metrics: {ok} requests counted, "
          f"{requests} served")
    check(ttft == streams, f"serving metrics: TTFT count {ttft}, "
          f"{streams} streams")
    check(toks >= tokens, f"serving metrics: {toks} tokens counted, "
          f"{tokens} streamed")


def phase_calibration(joined):
    """Phase 17 (c): the collectives of the card named twice profiled
    (backend "plain"), (b)'s step ingested into a ``CalibrationStore``
    under a temporary directory, and the stage DP's measured profiling on
    GPT at hidden 2048, 4 layers: its partition, each forward stage's
    analytic seconds, its measured profile and its RUN time in a traced
    step, and the drift gauge."""
    import tempfile
    from alpa_tpu_torch.mesh_profiling import (
        COLLECTIVE_KINDS, ProfilingResultDatabase, calibration_from_file,
        estimate_stage_cost, mesh_signature, profile_one_mesh)
    from alpa_tpu_torch.pipeline_parallel.stage_dp import cost_logical_mesh
    from alpa_tpu_torch.shard_parallel.auto_sharding import \
        AutoShardingOption
    from alpa_tpu_torch.telemetry import calibration as tcal
    from alpa_tpu_torch.telemetry import metrics as tmetrics
    from alpa_tpu_torch.telemetry import trace as ttrace
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="alpa_port_calibration_")
    devices = ["cuda:0", "cuda:0"]
    tic = time.perf_counter()
    res = profile_one_mesh(devices, sizes=tuple(1 << k
                                                for k in range(10, 29, 2)))
    prof_s = time.perf_counter() - tic
    sig = mesh_signature(devices)
    db = ProfilingResultDatabase()
    db.update_one_mesh(sig, res)
    db_file = f"{tmp}/prof_db.json"
    db.save(db_file)
    cal = calibration_from_file(db_file)
    print(f"calibration profile [{card}]: {sig} in {prof_s:.2f} s (backend "
          f"{cal.backend}: the card named twice, copies, not NCCL); "
          + "; ".join(f"{k} alpha {cal.collective_ab[k][0]:.3e} s beta "
                      f"{cal.collective_ab[k][1]:.3e} s/B" for k in
                      COLLECTIVE_KINDS) + "; matmul s/flop " + ", ".join(
              f"{f:.3g} flops {t:.3e}" for f, t in cal.dot_points))
    check(cal.backend == "plain" and len(cal.collective_ab) == 4,
          f"calibration: fit {cal}")
    store = tcal.CalibrationStore(f"{tmp}/store")
    got = tcal.ingest_joined(joined, store=store)
    print(f"calibration store [{card}]: phase 17b's step ingested "
          f"{sum(got.values())} samples into {len(store)} entries under "
          f"{store.store_dir}")
    check(len(store) > 0, "calibration: nothing ingested")

    # the stage DP's measured profiling
    tcal.reset_calibration_store(tcal.CalibrationStore(f"{tmp}/live"))
    cfg = dataclasses.replace(pipeshard_config(), num_layers=4,
                              pipeline_boundary_every=0)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 8).items()}
    method = PipeshardParallel(
        devices=devices, num_micro_batches=4,
        layer_option=AutoLayerOption(layer_num=4),
        stage_option=AutoStageOption(profiling_mode="measured",
                                     measured_candidates_limit=8,
                                     profiling_database_filename=db_file),
        pipeline_schedule="1f1b")
    state = train_state(cfg)
    step = make_train_step(method)
    tic = time.perf_counter()
    state, loss = step(state, batch)
    first_s = time.perf_counter() - tic
    ex = step.get_last_executable()
    info = ex.stage_dp_info
    for _ in range(2):
        state, loss = step(state, batch)
    ttrace.set_enabled(True)
    try:
        state, loss = step(state, batch)
        float(loss)
    finally:
        ttrace.set_enabled(False)
    report = ex.get_perf_report()
    lines = []
    for s_idx, (a, b, shape) in enumerate(info["partition"]):
        name = f"stage_{s_idx}_fwd"
        logical = cost_logical_mesh(shape, calibration_from_file(
            db_file, "plain"))
        analytic = estimate_stage_cost(ex.fwd_layer_comps[a:b], logical,
                                       AutoShardingOption())
        profiled = float(info["costs"][a, b - 1,
                                       info["choices"].index(shape)])
        st = report.stages.get(name)
        ran = st.run_time_us / st.n_runs * 1e-6 if st else float("nan")
        tcal.get_calibration_store().set_modeled(
            "stage_run", tcal.stage_signature(name), analytic * 1e6)
        lines.append(f"{name} layers {a}-{b - 1} on {shape}: analytic "
                     f"{analytic:.6f} s, the DP's entry {profiled:.6f} s, RUN "
                     f"{ran:.6f} s per microbatch")
    text = tmetrics.get_registry().to_prometheus_text()
    drift = metric_samples(text, "alpa_cost_model_drift_ratio")
    print(f"calibration measured stage DP [{card}]: GPT hidden "
          f"{cfg.hidden_size}, {cfg.num_layers} layers, 4 microbatches on "
          f"{devices}: partition {info['partition']}, {info['measured']} "
          f"entries measured, calibrated {info['calibrated']}, first call "
          f"{first_s:.2f} s; " + "; ".join(lines) +
          f"; alpa_cost_model_drift_ratio {drift}")
    check(info["measured"] > 0, "calibration: no candidate measured")
    check(all(np.isfinite(float(x)) for x in drift.values()) and drift,
          f"calibration: drift {drift}")
    tcal.reset_calibration_store()
    del state, step, ex
    gc.collect()
    torch.cuda.empty_cache()


def compile_cache_plan(cache_dir=None):
    """Phase 13's planner (GPT-1.3B at ``SPMD_LAYERS``, batch 8) on the card
    named twice, through the compile cache: ``(plan, seconds, stats)``,
    the plan as its shape, specs and strategy vector."""
    from alpa_tpu_torch.compile_cache import (CompileCache,
                                              get_compile_cache,
                                              reset_compile_cache)
    from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
    from alpa_tpu_torch.shard_parallel import AutoShardingOption
    from alpa_tpu_torch.shard_parallel.solver import (plan_auto_sharding,
                                                      trace_flat)
    if cache_dir is not None:
        reset_compile_cache(CompileCache(cache_dir=cache_dir))
    cfg = dataclasses.replace(config_from_spec(
        "1.3B", dtype=torch.bfloat16, attention_impl="flash"),
        num_layers=SPMD_LAYERS)
    fun, avals, paths, bidx = planned_step(cfg, 8, "cuda")
    traced = trace_flat(fun, avals, torch.device("cuda"))
    tic = time.perf_counter()
    _, specs, (graph, choice), shape = plan_auto_sharding(
        fun, avals, paths, bidx, PhysicalDeviceMesh(["cuda:0"] * 2),
        AutoShardingOption(), traced=traced)
    seconds = time.perf_counter() - tic
    plan = {"shape": list(shape), "specs": repr(specs),
            "choice": [int(c) for c in choice]}
    return plan, seconds, get_compile_cache().stats()["namespaces"]["ilp"]


def compile_cache_child():
    """The subprocess of phase 17 (d): the plan over the disk cache named
    by ``ALPA_TPU_CACHE_DIR``, as one JSON line."""
    plan, seconds, stats = compile_cache_plan()
    print(json.dumps({"plan": plan, "seconds": seconds, "stats": stats}))


def phase_compile_cache():
    """Phase 17 (d): the planner cold, warm in this process and warm in a
    subprocess reading the disk cache; the plans must be identical and
    the warm runs hit."""
    import os
    import tempfile
    from alpa_tpu_torch.compile_cache import reset_compile_cache
    tmp = tempfile.mkdtemp(prefix="alpa_port_cache_")
    try:
        cold, cold_s, cold_st = compile_cache_plan(tmp)
        warm, warm_s, warm_st = compile_cache_plan()
    finally:
        reset_compile_cache(None)
    env = dict(os.environ, ALPA_TPU_CACHE_DIR=tmp)
    tic = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", "import chip_smoke as s; "
         "s.compile_cache_child()"], cwd=os.path.dirname(
             os.path.abspath(__file__)), env=env, capture_output=True,
        text=True, timeout=600)
    child_s = time.perf_counter() - tic
    check(out.returncode == 0, f"compile cache subprocess failed: "
          f"{out.stderr[-2000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"compile cache [{card_line()}]: GPT-1.3B planner "
          f"({SPMD_LAYERS} layers) on "
          f"the card named twice, shape {cold['shape']}: cold "
          f"{cold_s:.3f} s ({cold_st}), warm in process {warm_s:.3f} s "
          f"({warm_st}), warm in a subprocess over {tmp} "
          f"{child['seconds']:.3f} s ({child['stats']}; the process "
          f"{child_s:.2f} s); plans identical: in process "
          f"{warm == cold}, subprocess {child['plan'] == cold}")
    check(warm == cold and child["plan"] == cold,
          "compile cache: a warm plan differs from the cold one")
    check(cold_st["misses"] == 1 and warm_st["hits"] == 1 and
          child["stats"]["disk_hits"] == 1,
          f"compile cache: hits {cold_st}, {warm_st}, {child['stats']}")


def phase_pipeshard(shard_profile):
    """GPT-1.3B at full width and phase 8's depth (``PIPESHARD_LAYERS``)
    through PipeshardParallel with manual layers (a boundary after
    ``PIPESHARD_BOUNDARY`` blocks), 2 stages, 4 microbatches; then the
    dispatch modes on its executable (``phase_dispatch``); then its peak
    without and with the in-place apply-grad (``apply_grad_peaks``).
    Returns phase 8's run (``timed_pipeshard``, without step and state) and
    the ShardParallel reference loss."""
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
    batch = lm_batch(cfg, 8)
    ref_loss = shard_first_loss(cfg, batch)
    run = timed_pipeshard("pipeshard", cfg, pipeshard_method(4), batch,
                          ref_loss, 1e-2, shard_profile, keep=True,
                          record=False)
    phase_dispatch(cfg, batch, run)
    traced, report, joined = timed("telemetry pipeshard",
                                   phase_telemetry_pipeshard, cfg, batch,
                                   run)
    run["traced_counts"], run["joined"] = traced, joined
    run["fault_counts"], run["faults"] = timed(
        "faults and state (a)-(c)", phase_faults_pipeshard, cfg, batch, run)
    # after every dispatch mode, capture and fault run on the executable
    record_plan("pipeshard", run["ex"], run["peak"], run["pool"])
    del run["step"], run["ex"], run["state"], report
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
    setting) inside a pipeshard trace: manual layers (a boundary after 6
    blocks), 2 stages, 4 microbatches, 1F1B, as phase 8 measures it; the
    first loss within 1e-2 relative of ShardParallel's on the same config;
    each block's forward runs twice (192/96/96 launches per step).  Prints
    the peak and step beside phase 8's."""
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY,
                           remat_blocks=True)
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
    """The inference path at full width and phase 8's depth: a
    forward-only function
    returning GPT-1.3B's logits (bf16, flash, manual layers at a boundary
    after 6 blocks), ``parallelize``d under PipeshardParallel with 2 stages
    x 4 microbatches and the ``"inference"`` schedule, batch 8, one card:
    the logits of every call against the same ``GPTModel`` forward run
    eagerly (bf16 tolerance, atol 1e-2 and rtol 1e-2); exactly 24 x 4
    forward launches and no backward launch per call.  3 warm-up calls
    (the first runs the stage graphs as they are, the second captures
    them), 5 timed, then ``torch.profiler`` over 2 more: call time, host
    time, device share, tokens/s."""
    label = "pipeshard infer"
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
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
    record_plan(label, ex, ex.get_total_allocation_size(),
                ex.get_graph_pool_bytes())
    del forward, ex, out, want, box, params, model
    torch.cuda.empty_cache()
    return counts[0]


def phase_pipeshard_auto(shard_profile, ref_loss=None):
    """The README's headline form at full width and phase 8's depth:
    GPT-1.3B with no
    boundaries, ``AutoLayerOption(layer_num=AUTO_LAYER_NUM,
    remat_layer=True)``, 2
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
    run = timed_pipeshard(label, cfg,
                          auto_pipeshard_method(4, AUTO_LAYER_NUM), batch,
                          ref_loss, 1e-6, shard_profile, forward_runs=2)
    counts, ex = run["counts"], run["ex"]
    del run
    flash = torch.ops.alpa_tpu_torch.flash_fwd.default
    cuts = [(sum(n.target is flash for n in c.nodes),
             sum(node_flops(n) for n in c.nodes)) for c in ex.fwd_layer_comps]
    check(len(cuts) == AUTO_LAYER_NUM and
          sum(b for b, _ in cuts) == cfg.num_layers,
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

    method = auto_pipeshard_method(4, AUTO_LAYER_NUM,
                                   devices=stage_devices()[:1],
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
          info["partition"] == [(0, AUTO_LAYER_NUM, (1, 1))],
          f"{label}: stage DP {info}")
    check(rel <= 1e-6, f"{label}: AutoStageOption's first loss {loss} vs "
          f"{ref_loss}")
    del ex
    torch.cuda.empty_cache()
    return counts


def phase_grad_acc_fidelity():
    """GPT-1.3B's width at 4 layers, fp32, batch 8: ``ShardParallel(
    num_micro_batches=4)`` against eager ``ShardParallel()`` from the same
    weights (``pipeshard_fidelity``'s checks)."""
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash",
                         remat_blocks=True), num_layers=4)
    pipeshard_fidelity(
        "shard grad-acc fidelity", cfg,
        lambda: alpa_tpu_torch.ShardParallel(devices=["cuda:0"],
                                             num_micro_batches=4),
        batch_size=8, what="4 microbatches, one device", name="grad-acc")


def eager_microbatch_loss(state, batch, num_micro_batches):
    """The mean of the eager forward losses (no gradient) of ``state`` on
    the microbatches of ``batch``."""
    with torch.no_grad():
        losses = [float(gpt_lm_loss(state.apply_fn, state.params,
                                    {k: v.chunk(num_micro_batches)[i]
                                     for k, v in batch.items()}))
                  for i in range(num_micro_batches)]
    return sum(losses) / len(losses)


def phase_shard_grad_acc(shard_profile):
    """Phase 12: ``bench.py``'s GPT-1.3B step (full width,
    ``SPMD_LAYERS`` of its 24 layers) under ``ShardParallel(
    num_micro_batches=4)``, batch 32 (phase 6's batch of 8 per
    microbatch).  Returns the flash launches of the run."""
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.bfloat16,
                         attention_impl="flash", remat_blocks=True),
        num_layers=SPMD_LAYERS)
    batch_size, nmb, warmup, n_iter = 32, 4, 3, 5
    alpa_tpu_torch.init(cluster="local")
    gc.collect()
    torch.cuda.empty_cache()
    state = train_state(cfg)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, batch_size).items()}
    ref_loss = eager_microbatch_loss(state, batch, nmb)
    train_step = make_train_step(
        alpa_tpu_torch.ShardParallel(num_micro_batches=nmb))
    reset_launch_counts()
    tic = time.perf_counter()
    state, loss = train_step(state, batch)
    losses = [float(loss)]
    first_s = time.perf_counter() - tic
    ex = train_step.get_last_executable()
    check(type(ex).__name__ == "GradAccMeshExecutable",
          f"grad-acc step ran {type(ex).__name__}")
    for _ in range(warmup - 1):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    tic = time.perf_counter()
    for _ in range(n_iter):
        state, loss = train_step(state, batch)
        losses.append(loss)
    float(loss)   # drains the queue
    latency = (time.perf_counter() - tic) / n_iter
    counts = launch_counts()
    losses = [float(x) for x in losses]
    steps = warmup + n_iter
    want = (2 * nmb * cfg.num_layers, nmb * cfg.num_layers,
            nmb * cfg.num_layers)
    check(counts == tuple(w * steps for w in want),
          f"grad-acc launches (fwd, dq, dkv) {counts} over {steps} steps; "
          f"want {want} per step")
    check(all(np.isfinite(losses)), f"non-finite grad-acc loss: {losses}")
    check(losses[-1] < losses[0], f"grad-acc loss did not fall: {losses}")
    ref_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(ref_rel <= 1e-2, f"grad-acc first loss {losses[0]} vs the eager "
          f"microbatch mean {ref_loss}: {ref_rel} relative")
    tokens_per_sec = batch_size * cfg.seq_len / latency
    tflops = compute_gpt_tflops(batch_size, cfg.seq_len, cfg.num_layers,
                                cfg.hidden_size, cfg.vocab_size, 1, latency)
    peak = SPEC["peak_bf16_tflops"]
    mfu = compute_mfu(tflops, peak)
    peak_bytes = ex.get_total_allocation_size()
    card = card_line()
    print(f"shard grad-acc: GPT-1.3B ({cfg.num_layers} layers, bf16 compute, "
          f"fp32 params and Adam, flash, remat), batch {batch_size} x seq "
          f"{cfg.seq_len} in {nmb} microbatches; launches per step fwd "
          f"{counts[0] // steps} dq {counts[1] // steps} dkv "
          f"{counts[2] // steps}; losses {['%.4f' % x for x in losses]}; "
          f"first loss vs the eager microbatch mean {ref_loss:.4f}: "
          f"{ref_rel:.3e} relative (tol 1e-2)")
    print(f"shard grad-acc compile [{card}]: plan {ex.plan_seconds:.3f} s "
          f"(one device: every input replicated, nothing traced), trace at "
          f"microbatch shapes {ex.trace_seconds:.3f} s, split and graphs "
          f"{ex.compile_seconds:.3f} s, first call {first_s:.3f} s; "
          f"compute-grad graph {ex.compute_exec.num_nodes} nodes, apply-grad "
          f"graph {ex.apply_exec.num_nodes} nodes, {len(ex._accs)} "
          f"accumulators of {sum(a.numel() * a.element_size() for a in ex._accs) / 2**30:.3f} GiB, "
          f"{len(ex.apply_exec.aliased)} state outputs written in place; "
          f"graphs run uncaptured")
    print(f"shard grad-acc metrics [{card}]: step {latency:.5f} s, "
          f"{tokens_per_sec:.1f} tokens/s, {tflops:.3f} TFLOPS "
          f"(compute_gpt_tflops), MFU {mfu:.4f} of {peak} TFLOP/s bf16, peak "
          f"allocated {peak_bytes / 2**30:.3f} GiB (phase 6, batch 8 without "
          f"accumulation: {shard_profile['peak'] / 2**30:.3f} GiB); phase 6's "
          f"step {shard_profile['latency']:.5f} s")
    # the accumulation adds (``acc += g`` in place, ``aten::add_``) under
    # the profiler, beside their bound: read acc and g, write acc
    acc_bytes = sum(a.numel() * a.element_size() for a in ex._accs)
    box = [state]

    def run():
        box[0], loss_ = train_step(box[0], batch)
        return loss_

    profile = profile_calls(run, 2, latency, "shard grad-acc",
                            ops=("aten::add_",))
    add_bound = 3 * acc_bytes * nmb / PEAK_BYTES_PER_S * 1e3
    if profile:
        print(f"shard grad-acc accumulation [{card}]: aten::add_ "
              f"{profile['ops']['aten::add_'] * 1e3:.5f} ms of device time "
              f"per step in {nmb} x {len(ex._accs)} adds, bound "
              f"{add_bound:.5f} ms (3 x {acc_bytes} bytes x {nmb} over "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    del box, state, train_step, ex
    alpa_tpu_torch.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return launch_counts()


class _Capture(alpa_tpu_torch.ParallelMethod):
    """The flat function, avals, paths and batch leaves ``parallelize``
    hands a method; compiles nothing."""
    donates_in_place = False

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        del donated_invars
        self.captured = (fun, list(avals), list(fun.in_paths),
                         [i for i, b in enumerate(batch_invars) if b])
        raise StopIteration


def planned_step(cfg, batch_size, device):
    """(flat step, avals, paths, batch leaves) of the GPT train step with
    Adam, its state and batch fake tensors on ``device`` (no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = GPTModel(cfg, device="meta", param_dtype=torch.float32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = {k: torch.empty(p.shape, device=device)
                  for k, p in model.named_parameters()}
        state = TrainState.create(apply_fn=make_apply_fn(model),
                                  params=params, tx=adam(LR))
        ids = torch.zeros(batch_size, cfg.seq_len, dtype=torch.int64,
                          device=device)
    method = _Capture()
    try:
        make_train_step(method, donate_argnums=())(
            state, {"input_ids": ids, "labels": ids})
    except StopIteration:
        pass
    return method.captured


def phase_planner(device="cuda"):
    """Phase 13: ``plan_auto_sharding`` on GPT-1.3B's train step (full
    width, depth cut to ``SPMD_LAYERS`` to keep the run's time, batch 8,
    bf16,
    flash, Adam), traced once on fake
    tensors, for the card's one-device mesh and a virtual 8-device mesh
    (the card named 8 times): the search's shapes, graph sizes, build and
    solve seconds, objective and the chosen specs."""
    from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
    from alpa_tpu_torch.shard_parallel import AutoShardingOption
    from alpa_tpu_torch.shard_parallel.ilp import (solution_cost,
                                                   solve_strategy_graph)
    from alpa_tpu_torch.shard_parallel.solver import (plan_auto_sharding,
                                                      trace_flat)
    from alpa_tpu_torch.shard_parallel.strategy import Edge
    from alpa_tpu_torch.global_env import global_config as gconf
    cfg = dataclasses.replace(config_from_spec(
        "1.3B", dtype=torch.bfloat16, attention_impl="flash"),
        num_layers=SPMD_LAYERS)
    fun, avals, paths, bidx = planned_step(cfg, 8, device)
    tic = time.perf_counter()
    traced = trace_flat(fun, avals, torch.device(device))
    trace_s = time.perf_counter() - tic
    n_ops = sum(n.op == "call_function" for n in traced.graph.nodes)
    card = card_line()
    print(f"planner: GPT-1.3B train step ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, batch 8, bf16, flash, Adam), {len(avals)} "
          f"inputs, traced on fake tensors in {trace_s:.3f} s: {n_ops} aten "
          f"ops [{card}]")
    names = {"wte": "[0].params['wte.weight']",
             "qkv": "[0].params['h.0.attn.qkv.weight']",
             "out": "[0].params['h.0.attn.out.weight']",
             "fc_in": "[0].params['h.0.mlp.fc_in.weight']",
             "fc_out": "[0].params['h.0.mlp.fc_out.weight']",
             "batch": "[1]['input_ids']"}
    for label, devices in (("one device", [device]),
                           ("8 virtual devices", [device] * 8)):
        tic = time.perf_counter()
        logical_mesh, specs, (graph, choice), shape = plan_auto_sharding(
            fun, avals, paths, bidx, PhysicalDeviceMesh(devices),
            AutoShardingOption(), traced=traced)
        total = time.perf_counter() - tic
        for row in graph.search:
            print(f"planner {label}, logical mesh {row['shape']}: "
                  f"{row['nodes']} nodes, {row['edges']} edges, "
                  f"{row['strategies']} strategies; build "
                  f"{row['build_seconds']:.3f} s, solve "
                  f"{row['solve_seconds']:.3f} s by {row['solver']}, "
                  f"objective {row['objective']:.4f}")
            check(row["solver"] in ("milp", "trivial"),
                  f"planner {label} {row['shape']}: solver {row['solver']}")
            check(row["solve_seconds"] <= gconf.ilp_time_limit,
                  f"planner {label} {row['shape']}: solve "
                  f"{row['solve_seconds']} s over ilp_time_limit")
        # the same graph with every input replicated, solved again: the
        # optimum can be no worse
        keep = {n.idx: [i for i, st in enumerate(n.strategies)
                        if n.kind != "invar" or not any(st.out_spec)]
                for n in graph.nodes}
        pinned = dataclasses.replace(graph, nodes=[
            dataclasses.replace(n, strategies=[n.strategies[i]
                                               for i in keep[n.idx]])
            for n in graph.nodes], edges=[
            Edge(e.src, e.dst, e.cost[np.ix_(keep[e.src], keep[e.dst])])
            for e in graph.edges])
        replicated = solution_cost(pinned, solve_strategy_graph(pinned))
        objective = solution_cost(graph, choice)
        spec_of = dict(zip(paths, specs))
        print(f"planner {label}: chose logical mesh {shape}, objective "
              f"{objective:.4f} (every input replicated: {replicated:.4f}), "
              f"search {total:.3f} s; specs " + ", ".join(
                  f"{k} {spec_of[v]}" for k, v in names.items()))
        check(objective <= replicated * (1 + 1e-9),
              f"planner {label}: objective {objective} over the replicated "
              f"inputs' {replicated}")
        if len(devices) > 1:
            # ROADMAP C.8: the chosen plan partitioned, scanned for strided
            # local slices that reach a layout-sensitive op
            from alpa_tpu_torch.shard_parallel.spmd_partition import \
                SpmdProgram
            n_out = len(next(n for n in traced.graph.nodes
                             if n.op == "output").args[0])
            tic = time.perf_counter()
            program = SpmdProgram(traced, graph, choice, logical_mesh, specs,
                                  [None] * n_out, natural_outputs=True)
            strided = strided_scan([program])
            print(f"planner {label} C.8 scan: the plan partitioned in "
                  f"{time.perf_counter() - tic:.3f} s, partitioner "
                  f"{program.partitioner_stats}; {strided} strided local "
                  f"slices reach an op other than mm, bmm, sum, add and "
                  f"add_")
            check(strided == 0, f"planner: {strided} strided slices (C.8)")
            del program
    del traced


SPMD_PATHS = ("[0].params['wte.weight']",
              "[0].params['h.0.attn.qkv.weight']",
              "[0].params['h.0.attn.out.weight']",
              "[0].params['h.0.mlp.fc_in.weight']",
              "[0].params['h.0.mlp.fc_out.weight']",
              "[0].opt_state[0]['mu']['h.0.mlp.fc_in.weight']",
              "[1]['input_ids']")


def leaf_paths(state, batch):
    """The ``keystr`` path of each flat leaf of ``(state, batch)``, in the
    order ``parallelize`` flattens them."""
    from torch.utils import _pytree as pytree
    leaves, _ = pytree.tree_flatten_with_path((state, batch))
    return [pytree.keystr(path) for path, _ in leaves]


def spmd_plan_line(label, ex, paths):
    """The plan of a sharded step: logical mesh, the specs of a few named
    leaves, how many leaves each spec has, and the collectives per step."""
    from collections import Counter
    spec_of = dict(zip(paths, ex.in_specs))
    counts = Counter(str(s) for s in ex.in_specs)
    named = ", ".join(f"{p.split(chr(39))[1] if chr(39) in p else p} "
                      f"{spec_of.get(p)}" for p in SPMD_PATHS if p in spec_of)
    print(f"{label} plan: logical mesh {tuple(ex.plan['shape'])}; specs "
          f"{named}; leaves per spec {dict(counts)}")
    print(f"{label} collectives per step: " + ", ".join(
        f"{kind} {row['count']} calls {row['bytes']} bytes ({row['backend']})"
        for kind, row in sorted(ex.get_collective_counts().items())))


def gathered_params(state):
    """The parameters as full CPU tensors (a sharded leaf gathered)."""
    return full_cpu(state.params)


def sgd_state(cfg):
    """``train_state`` with SGD (lr 1e-2, momentum 0.9) in place of Adam:
    Adam's m / sqrt(v) turns a gradient at its rounding noise into a step
    of up to lr, so two runs that sum in other orders part by up to lr per
    step where a gradient is zero in exact arithmetic (a qkv bias's key
    third), and the next step's gradients move with them."""
    model = GPTModel(cfg, device="cuda", param_dtype=torch.float32)
    init_random_(model, SEED)
    return TrainState.create(apply_fn=make_apply_fn(model),
                             params=dict(model.named_parameters()),
                             tx=sgd(1e-2, momentum=0.9))


def phase_spmd_fidelity():
    """Phase 14: a 4-layer GPT at narrow width in fp32 on the flash kernels,
    2 SGD steps (momentum 0.9) under ``ShardParallel`` on a forced (2, 2)
    logical mesh and under ``Zero2Parallel``, both over the card named 4
    times, against the one-device step from the same weights and batch:
    step-0 gradients, losses and parameters to 1e-5."""
    from alpa_tpu_torch import AutoShardingOption
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash",
                         remat_blocks=True), num_layers=4, hidden_size=256,
        num_heads=4, seq_len=256, vocab_size=1024)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in lm_batch(cfg, 8).items()}
    steps = 2
    state = sgd_state(cfg)
    _, ref_grads = alpa_tpu_torch.parallelize(
        lm_grad_step, method=shard_method(), donate_argnums=())(state, batch)
    ref_grads = {k: g.detach().cpu() for k, g in ref_grads.items()}
    train_step = make_train_step(shard_method())
    reset_launch_counts()
    ref_losses = []
    for _ in range(steps):
        state, loss = train_step(state, batch)
        ref_losses.append(float(loss))
    ref_counts = launch_counts()
    ref_params = gathered_params(state)
    del state, train_step
    for label, make in (
            ("spmd fidelity ShardParallel (2, 2)",
             lambda: alpa_tpu_torch.ShardParallel(
                 devices=["cuda:0"] * 4,
                 auto_sharding_option=AutoShardingOption(
                     logical_mesh_shape=(2, 2)))),
            ("spmd fidelity Zero2Parallel",
             lambda: alpa_tpu_torch.Zero2Parallel(devices=["cuda:0"] * 4))):
        state = sgd_state(cfg)
        paths = leaf_paths(state, batch)
        _, grads = alpa_tpu_torch.parallelize(
            lm_grad_step, method=make(), donate_argnums=())(state, batch)
        grad_rel = max_rel_diff(
            {k: (g.gather("cpu") if isinstance(
                g, alpa_tpu_torch.DistributedArray) else g.cpu())
             for k, g in grads.items()}, ref_grads)
        del grads
        train_step = make_train_step(make())
        reset_launch_counts()
        losses = []
        for _ in range(steps):
            state, loss = train_step(state, batch)
            losses.append(float(loss))
        counts = launch_counts()
        ex = train_step.get_last_executable()
        params = gathered_params(state)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        rel = max_rel_diff(params, ref_params)
        worst = max(rel, key=rel.get)
        worst_g = max(grad_rel, key=grad_rel.get)
        spmd_plan_line(label, ex, paths)
        print(f"{label}: fp32 GPT ({cfg.num_layers} layers, hidden "
              f"{cfg.hidden_size}, seq {cfg.seq_len}, batch 8, flash, remat) "
              f"on 4 virtual devices (the card named 4 times); step-0 "
              f"gradients max |diff| / max |g| per tensor "
              f"{grad_rel[worst_g]:.3e} at {worst_g} (tol 1e-5); {steps} SGD "
              f"steps: losses {losses} one device {ref_losses}, max relative "
              f"difference {loss_rel:.3e} (tol 1e-5); parameters max |diff| / "
              f"max |p| per tensor {rel[worst]:.3e} at {worst} (tol 1e-5); "
              f"flash launches {counts} against the one-device {ref_counts} "
              f"(want 4 x)")
        check(grad_rel[worst_g] <= 1e-5,
              f"{label}: gradient {worst_g} differs by {grad_rel[worst_g]}")
        check(loss_rel <= 1e-5, f"{label}: losses differ by {loss_rel}")
        check(rel[worst] <= 1e-5,
              f"{label}: parameter {worst} differs by {rel[worst]}")
        check(counts == tuple(4 * c for c in ref_counts),
              f"{label}: flash launches {counts}, want 4 x {ref_counts}")
        del state, train_step, ex
    gc.collect()
    torch.cuda.empty_cache()


def adam_bound(steps):
    """The most two runs of ``steps`` Adam steps (b1 0.9, b2 0.999) from
    the same parameters can part by, element by element: each step moves
    an element by lr x |m_hat| / sqrt(v_hat), at most lr x
    sqrt(sum_i a_i^2 / c_i) over the bias-corrected weights a of m and c
    of v (1 at step 1, 1.0013 at step 2), in either direction, so
    2 x lr x the sum of those.  Where a gradient is zero in exact
    arithmetic (a qkv bias's key third), rounding picks the direction."""
    b1, b2, total = 0.9, 0.999, 0.0
    for t in range(1, steps + 1):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        c = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        total += sum(x * x / y for x, y in zip(a, c)) ** 0.5
    return 2 * LR * total * (1 + 1e-6)


# Full-width bounds of phase 15 and --four-cards (bf16 compute), each set
# from phase 15's readings on one H100 (PERF.md section 6): the first loss
# (relative; read 8.404e-08); Adam's first moment after one step, 0.1 x
# the step-0 gradient through the plan that runs (max |diff| / max |mu|
# per tensor; read 5.282e-03, where the one-device step rounds the
# batch's weight gradient to bf16 once and each device its half); and the
# parameters after the steps whose step-0 gradient is at least 1e-2 of
# their tensor's largest (max |diff| / max |p| per tensor; read 0.110 and
# 0.127, both in biases that start at zero, whose largest entry after 2
# steps is about 2 x lr, and whose second Adam step turns a gradient's
# rounding into a share of lr); the other elements are held to
# ``adam_bound``.  A dropped reduction or a wrong gradient moves the
# first moment by a share of 1, not of 1e-2.
SPMD_LOSS_TOL = 1e-4
SPMD_GRAD_TOL = 1e-2
# the depth of phases 8-13, 15-18 and 21c: a quarter of GPT-1.3B's 24
# layers at its full width, so that the whole run stays inside its time
# limit on a slower host as phases are added (the plans and the checks do
# not depend on the depth; phase 6 and --four-cards keep 24); the
# pipeshard phases cut it into two stages at the middle.  12 layers read
# 880.5 s and, on a host 1.24x slower, 1088.0 s for the whole run
# (NVIDIA H100 80GB HBM3, 700.00 W)
SPMD_LAYERS = 6
PIPESHARD_LAYERS = 6
PIPESHARD_BOUNDARY = PIPESHARD_LAYERS // 2
# phase 10's automatic layers: AutoLayerOption's clustering keeps every
# layer within (1 + eps) of an equal share of the flops, and at 6 blocks
# the LM head's product alone takes a quarter of them, so 4 layers
AUTO_LAYER_NUM = 4
SPMD_PARAM_TOL = 0.25
# Phase 16's first-moment bound, at cuBLAS's default configuration.  The
# two-level step runs each stage's products on one device's rows where
# phase 8 runs them on the microbatch's, and cuBLAS picks a split-K kernel
# by row count: the logits' backward product (K = 51200) on one sequence
# of two differed from the two sequences' product in 84072 of 4194304
# elements.  Sound runs of phase 16 read 1.040e-02 (twice; 7.075e-03 and
# 7.277e-03 with cuBLAS's workspace turned off, which rules the split-K
# kernels out).  Faults read far above it: a dropped all-reduce 1.149
# (phase 15), the two-level step over four distinct cards 4.649e-02
# (ROADMAP C.4).  All on NVIDIA H100 80GB HBM3, 700.00 W.
TWO_LEVEL_GRAD_TOL = 2e-2


def lm_grad_step(state, batch):
    """The loss and step-0 gradients of ``state.params`` on ``batch``."""
    return alpa_tpu_torch.value_and_grad(
        lambda p: gpt_lm_loss(state.apply_fn, p, batch))(state.params)


def full_cpu(tree):
    """``{name: tensor}`` as full CPU tensors (a sharded leaf gathered)."""
    return {k: (v.gather("cpu") if isinstance(
        v, alpa_tpu_torch.DistributedArray)
        else v.detach().to("cpu", copy=True)) for k, v in tree.items()}


def gathered_mu(state):
    """Adam's first moment, as full CPU tensors."""
    return full_cpu(next(s["mu"] for s in state.opt_state
                         if isinstance(s, dict) and "mu" in s))


def one_device_grads(cfg, batch):
    """The one-device step-0 gradients from the seed state, on the CPU."""
    state = train_state(cfg)
    _, grads = alpa_tpu_torch.parallelize(
        lm_grad_step, method=shard_method(), donate_argnums=())(state, batch)
    out = full_cpu(grads)
    del state, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sync_cards(devices):
    for d in sorted({torch.device(x).index or 0 for x in devices}):
        torch.cuda.synchronize(d)


def spmd_step_run(label, cfg, method, batch, ref_loss, ref_mu, ref_params,
                  ref_grads, ref_per_step, n_params_devices, devices,
                  timed_steps=3, compare_after=2, profile=False):
    """``method``'s train step from the seed state on ``batch``, against
    the one-device step's: the first loss to ``ref_loss``; Adam's first
    moment after one step to ``ref_mu`` (0.1 x the step-0 gradient, so a
    gradient check of the plan that runs); the parameters after
    ``compare_after`` steps to ``ref_params`` (``param_diffs`` over
    ``ref_grads``, the one-device step-0 gradients: a relative bound where
    the gradient is at least 1e-2 of its tensor's largest, Adam's bound
    elsewhere); the flash launches per step to ``n_params_devices`` x
    ``ref_per_step``; then ``timed_steps`` timed steps, the clock read
    after every card of ``devices`` is done.  Returns the launches of the
    run and the metrics."""
    gc.collect()
    torch.cuda.empty_cache()
    state = train_state(cfg)
    paths = leaf_paths(state, batch)
    step = make_train_step(method)
    reset_launch_counts()
    tic = time.perf_counter()
    state, loss = step(state, batch)
    losses = [float(loss)]
    first_s = time.perf_counter() - tic
    ex = step.get_last_executable()
    grad_rel = max_rel_diff(gathered_mu(state), ref_mu)
    for _ in range(compare_after - 1):
        state, loss = step(state, batch)
        losses.append(float(loss))
    per_step = tuple(c // compare_after for c in launch_counts())
    bound = adam_bound(compare_after)
    param_rel, n_small, n_all, small_max = param_diffs(
        full_cpu(state.params), ref_params, ref_grads, bound)
    sync_cards(devices)
    tic = time.perf_counter()
    for _ in range(timed_steps):
        state, loss = step(state, batch)
        losses.append(loss)
    sync_cards(devices)
    latency = (time.perf_counter() - tic) / timed_steps
    losses = [float(x) for x in losses]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    spmd_plan_line(label, ex, paths)
    graph, choice = ex.plan["graph"]
    from alpa_tpu_torch.shard_parallel.ilp import solution_cost
    search = [(row["shape"], round(row.get("objective", float("nan")), 3))
              for row in getattr(graph, "search", [])]
    print(f"{label}: Adam's first moment after one step (0.1 x the step-0 "
          f"gradient) max |diff| / max |mu| per tensor "
          f"{grad_rel[worst_g]:.3e} at {worst_g} (tol {SPMD_GRAD_TOL:g}); "
          f"first loss {losses[0]:.6f} vs the one-device {ref_loss:.6f}: "
          f"{loss_rel:.3e} relative (tol {SPMD_LOSS_TOL:g}); parameters "
          f"after {compare_after} Adam steps max |diff| / max |p| per tensor "
          f"{param_rel[worst_p]:.3e} at {worst_p} (tol {SPMD_PARAM_TOL:g}) "
          f"over the elements whose step-0 gradient is at least 1e-2 of its "
          f"tensor's largest; the other {n_small} of {n_all} elements differ "
          f"by at most {small_max:.3e} (tol {bound:.4e}, adam_bound); flash "
          f"launches per step {per_step}, want {n_params_devices} x "
          f"{ref_per_step}; losses {['%.4f' % x for x in losses]}")
    segments = sum(st.kind == "segment"
                   for part in ex.program.parts.values() for st in part)
    print(f"{label} compile: plan {ex.plan_seconds:.3f} s (search "
          f"{search}, the objective of the plan that runs "
          f"{solution_cost(graph, choice):.3f}), trace "
          f"{ex.trace_seconds:.3f} s, partition and segments "
          f"{ex.compile_seconds:.3f} s, first call {first_s:.3f} s; "
          f"{segments} "
          f"segments, partitioner {ex.program.partitioner_stats}")
    slice_copy_line(label, [(ex.program, len(ex.program.devices))])
    strided = strided_scan([ex.program])
    print(f"{label} C.8 scan: {strided} strided local slices reach an op "
          f"other than mm, bmm, sum, add and add_")
    check(strided == 0, f"{label}: {strided} strided slices (C.8)")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(grad_rel[worst_g] <= SPMD_GRAD_TOL,
          f"{label}: first moment {worst_g} differs by "
          f"{grad_rel[worst_g]}")
    check(loss_rel <= SPMD_LOSS_TOL, f"{label}: first loss {losses[0]} vs "
          f"{ref_loss}: {loss_rel} relative")
    check(param_rel[worst_p] <= SPMD_PARAM_TOL,
          f"{label}: parameter {worst_p} differs by {param_rel[worst_p]}")
    check(small_max <= bound, f"{label}: parameters with near-zero "
          f"gradients differ by {small_max}, over Adam's bound {bound}")
    check(per_step == tuple(n_params_devices * c for c in ref_per_step),
          f"{label}: flash launches per step {per_step}, want "
          f"{n_params_devices} x {ref_per_step}")
    peak = ex.get_total_allocation_size()
    metrics = {"latency": latency, "peak": peak, "first_s": first_s,
               "objective": solution_cost(graph, choice),
               "collectives": ex.get_collective_counts()}
    if profile:
        box = [state]

        def run():
            box[0], loss_ = step(box[0], batch)
            return loss_

        metrics["nccl_s"] = nccl_seconds(run, label)
        state = box[0]
    counts = launch_counts()
    del state, step, ex
    gc.collect()
    torch.cuda.empty_cache()
    return counts, metrics


def nccl_seconds(run, label):
    """Device seconds of one step's NCCL kernels under ``torch.profiler``,
    and the step's device time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    with torch.profiler.profile(activities=activities) as prof:
        out = run()
        out.float().sum().item()
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    total = sum(e.self_device_time_total for e in kernels) / 1e6
    nccl = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower()) / 1e6
    print(f"{label} profile [{card_line()}]: one step, device time "
          f"{total:.5f} s summed over the cards, NCCL kernels {nccl:.5f} s "
          f"({nccl / max(total, 1e-30):.4f} of it)")
    return nccl


def phase_spmd(shard_profile):
    """Phase 15: GPT-1.3B at full width and ``SPMD_LAYERS`` of its 24
    layers (phase 6's model otherwise, batch 8) under ``ShardParallel``
    with the ILP's mesh-shape search and under
    ``Zero2Parallel``, both over the card named twice: the first loss,
    Adam's first moment after one step and the parameters after 2 steps
    against the one-device step from the same weights and batch
    (``spmd_step_run``'s checks), twice phase 6's flash launches per step,
    the plan, the collectives, peak memory and the step time (a one-card
    number: the two virtual devices share the card).  Returns the flash
    launches of the run."""
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.bfloat16,
                         attention_impl="flash", remat_blocks=True),
        num_layers=SPMD_LAYERS)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 8).items()}
    ref_grads = one_device_grads(cfg, batch)
    state = train_state(cfg)
    ref_step = make_train_step(shard_method())
    reset_launch_counts()
    ref_losses = []
    for i in range(2):
        state, loss = ref_step(state, batch)
        ref_losses.append(float(loss))
        if i == 0:
            ref_mu = gathered_mu(state)
    ref_per_step = tuple(c // 2 for c in launch_counts())
    ref_params = gathered_params(state)
    del state, ref_step
    gc.collect()
    torch.cuda.empty_cache()
    total = [0, 0, 0]
    card = card_line()
    devices = ["cuda:0"] * 2
    for label, method in (
            ("spmd ShardParallel",
             alpa_tpu_torch.ShardParallel(devices=devices)),
            ("spmd Zero2Parallel",
             alpa_tpu_torch.Zero2Parallel(devices=devices))):
        counts, m = spmd_step_run(label, cfg, method, batch, ref_losses[0],
                                  ref_mu, ref_params, ref_grads,
                                  ref_per_step, 2, devices)
        total = [a + b for a, b in zip(total, counts)]
        tflops = compute_gpt_tflops(8, cfg.seq_len, cfg.num_layers,
                                    cfg.hidden_size, cfg.vocab_size, 1,
                                    m["latency"])
        print(f"{label} metrics [{card}]: {cfg.num_layers} layers, step "
              f"{m['latency']:.5f} s on one card (two virtual devices share "
              f"it; phase 6's one-device step at 24 layers "
              f"{shard_profile['latency']:.5f} s), "
              f"{8 * cfg.seq_len / m['latency']:.1f} tokens/s, {tflops:.3f} "
              f"TFLOPS of the card, peak allocated "
              f"{m['peak'] / 2**30:.3f} GiB "
              f"(phase 6: {shard_profile['peak'] / 2**30:.3f} GiB)")
    del ref_params, ref_grads, ref_mu
    gc.collect()
    torch.cuda.empty_cache()
    return tuple(total)


def two_level_fidelity_methods(cards):
    """Phase 16a's methods over ``cards``: ``(label, method, layered)``,
    ``layered`` whether the model marks a boundary every 2 blocks."""
    from alpa_tpu_torch import AutoShardingOption
    eight, four = cards * (8 // len(cards)), cards * (4 // len(cards))
    return (
        ("two-level fidelity pipeshard (ILP per 4-device stage)",
         PipeshardParallel(devices=eight, num_micro_batches=2,
                           layer_option=ManualLayerOption(),
                           stage_option=UniformStageOption(num_stages=2)),
         True),
        ("two-level fidelity get_3d_parallel_method(2, 2, 1, 2)",
         get_3d_parallel_method(2, 2, 1, 2, devices=four), False),
        ("two-level fidelity pipeshard ZeRO-2",
         PipeshardParallel(devices=eight, num_micro_batches=2,
                           default_auto_sharding_option=AutoShardingOption(
                               zero_stage="2"),
                           layer_option=ManualLayerOption(),
                           stage_option=UniformStageOption(num_stages=2)),
         True))


def tile_move_check():
    """The tile executor's moving branch on one card: a (2048, 1024) fp32
    array under each pair of shardings of a (1, 2) mesh, from two devices
    to two others among the card and the host (host to card, card to host,
    and one of each to the other), each source shard read from the card
    behind a queued chain of products, each host shard read by the host
    as soon as the executor returns.  Every destination shard must equal
    the array sliced by its destination block.  Returns the count of
    shards checked."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr
    shape = (2048, 1024)
    full = torch.randn(shape, generator=torch.Generator().manual_seed(SEED))
    specs = (((1,), ()), ((), (1,)), ((), ()))
    checked = 0
    for src_devs, dst_devs in ((["cpu", "cpu"], ["cuda:0", "cuda:0"]),
                               (["cuda:0", "cuda:0"], ["cpu", "cpu"]),
                               (["cuda:0", "cpu"], ["cpu", "cuda:0"])):
        for sspec in specs:
            for dspec in specs:
                src = cmr.MeshSharding(sspec, (1, 2), (0, 1))
                dst = cmr.MeshSharding(dspec, (1, 2), (2, 3))
                plan = cmr.plan_resharding(shape, 4, src, dst,
                                           allow_allgather_rewrite=False)
                blocks = [cmr.VirtualDistributedArray.from_sharding(
                    shape, sh).device_tiles for sh in (src, dst)]
                busy = torch.randn(4096, 4096, device="cuda")
                for _ in range(20):
                    busy = busy @ busy / 64
                shards = [full[cmr._index(b.slices)].to(d).add(0)
                          for b, d in zip(blocks[0], src_devs)]
                outs, _ = cmr.ReshardingTask(plan, src_devs, dst_devs)(
                    shards)
                read = [o.clone() if o.device.type == "cpu" else o
                        for o in outs]
                torch.cuda.synchronize()
                for b, o, d in zip(blocks[1], read, dst_devs):
                    checked += 1
                    check(o.device.type == torch.device(d).type and
                          torch.equal(o.cpu(), full[cmr._index(b.slices)]),
                          f"tile move {src_devs} {sspec} -> {dst_devs} "
                          f"{dspec}: a destination shard differs")
    return checked


def phase_pipeshard_spmd_fidelity():
    """Phase 16a: a 4-layer GPT at narrow width (phase 14's) in fp32 on the
    flash kernels, batch 8, 2 SGD steps (momentum 0.9) under the two-level
    plan, against the one-device step from the same weights: pipeshard in
    two stages of four virtual devices (the card named 8 times), the ILP in
    each; ``get_3d_parallel_method(2, 2, 1, 2)`` on the card named 4 times
    (two stages on (2, 1) logical meshes, inputs replicated); the first
    with ZeRO-2 in each stage.  Losses to 1e-5 relative, parameters to
    1e-5 of each tensor's largest; each stage's devices launch the flash
    kernels on their shares.  Then the tile executor's moving branch
    (``tile_move_check``), and the first pipeshard with its first stage on
    the card named twice and its second on the host named twice, held to
    the same bounds.  Before them, the first pipeshard under each
    cross-mesh execution and the activation codecs
    (``reshard_variants_check``).  Then ``AutoStageOption`` on the card named 4 times:
    its partition, submeshes and solve seconds, and its first loss to 1e-5
    of the one-device step's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash"),
        num_layers=4, hidden_size=256, num_heads=4, seq_len=256,
        vocab_size=1024)
    layered = dataclasses.replace(base, pipeline_boundary_every=2)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in lm_batch(base, 8).items()}
    steps = 2
    state = sgd_state(base)
    train_step = make_train_step(shard_method())
    reset_launch_counts()
    ref_losses = []
    for _ in range(steps):
        state, loss = train_step(state, batch)
        ref_losses.append(float(loss))
    ref_counts = tuple(c // steps for c in launch_counts())
    ref_params = gathered_params(state)
    del state, train_step
    direct = None
    for label, method, with_boundaries in two_level_fidelity_methods(
            ["cuda:0"]):
        state = sgd_state(layered if with_boundaries else base)
        train_step = make_train_step(method)
        reset_launch_counts()
        losses = []
        for _ in range(steps):
            state, loss = train_step(state, batch)
            losses.append(float(loss))
        counts = tuple(c // steps for c in launch_counts())
        ex = train_step.get_last_executable()
        params = gathered_params(state)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        rel = max_rel_diff(params, ref_params)
        worst = max(rel, key=rel.get)
        devs, n_mb = ex.mesh_sizes[0], method.num_micro_batches
        want = tuple(devs * n_mb * c for c in ref_counts)
        print(f"{label}: fp32 GPT ({base.num_layers} layers, hidden "
              f"{base.hidden_size}, batch 8, flash) in {ex.num_meshes} "
              f"stages of {ex.mesh_sizes} virtual devices (logical "
              f"{[tuple(e.logical_mesh.shape) for e in ex.stage_execs]}); "
              f"{steps} SGD steps: losses {losses} one device {ref_losses}, "
              f"max relative difference {loss_rel:.3e} (tol 1e-5); "
              f"parameters max |diff| / max |p| per tensor {rel[worst]:.3e} "
              f"at {worst} (tol 1e-5); flash launches per step {counts}, "
              f"want {devs} devices x {n_mb} microbatches x {ref_counts}; "
              f"dispatch "
              f"{ex.last_dispatch_stats['meshes']}")
        check(loss_rel <= 1e-5, f"{label}: losses differ by {loss_rel}")
        check(rel[worst] <= 1e-5,
              f"{label}: parameter {worst} differs by {rel[worst]}")
        check(counts == want, f"{label}: flash launches {counts}, want "
              f"{want}")
        if direct is None:
            direct = (losses, params)
            reshard_line(label, ex)
        del state, train_step, ex
        gc.collect()
        torch.cuda.empty_cache()
    reshard_variants_check(layered, batch, *direct)
    checked = tile_move_check()
    # the moving branch inside the step: the first stage on the card named
    # twice, the second on the host named twice
    state = sgd_state(layered)
    step = make_train_step(PipeshardParallel(
        devices=["cuda:0", "cuda:0", "cpu", "cpu"], num_micro_batches=2,
        layer_option=ManualLayerOption(),
        stage_option=UniformStageOption(num_stages=2)))
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    moved = step.get_last_executable().executed_resharding_bytes
    rel = max_rel_diff(gathered_params(state), ref_params)
    worst = max(rel, key=rel.get)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    print(f"two-level fidelity tile moves between the card and the host: "
          f"{checked} destination shards equal the array sliced; pipeshard "
          f"with a stage on the card and a stage on the host (2 devices "
          f"each): {moved} bytes moved a step, losses {losses}, max "
          f"relative difference {loss_rel:.3e} (tol 1e-5), parameters max "
          f"|diff| / max |p| per tensor {rel[worst]:.3e} at {worst} (tol "
          f"1e-5)")
    check(moved > 0, "card/host pipeshard: no tile moved")
    check(loss_rel <= 1e-5, f"card/host pipeshard: losses differ by "
          f"{loss_rel}")
    check(rel[worst] <= 1e-5,
          f"card/host pipeshard: parameter {worst} differs by {rel[worst]}")
    del state, step
    gc.collect()
    state = sgd_state(base)
    step = make_train_step(auto_pipeshard_method(
        2, 4, devices=["cuda:0"] * 4, stage_option=AutoStageOption()))
    state, loss = step(state, batch)
    info = step.get_last_executable().stage_dp_info
    rel = abs(float(loss) - ref_losses[0]) / abs(ref_losses[0])
    print(f"two-level fidelity AutoStageOption on 4 virtual devices: "
          f"partition {info['partition']} (submeshes "
          f"{[p[2] for p in info['partition']]}), {info['ilp_solves']} stage "
          f"ILPs in {info['ilp_seconds']:.3f} s, DP solve "
          f"{info['solve_seconds']:.6f} s ({info['solver']}), "
          f"all {info['seconds']:.3f} s; first loss {float(loss):.6f} vs "
          f"one device {ref_losses[0]:.6f}: {rel:.3e} relative (tol 1e-5)")
    check(rel <= 1e-5, f"AutoStageOption: first loss differs by {rel}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()


def two_level_method(devices):
    """Phase 16's method: phase 8's pipeshard over ``devices`` (four),
    two stages of two devices, each planned by the ILP."""
    return PipeshardParallel(devices=devices, num_micro_batches=4,
                             layer_option=ManualLayerOption(),
                             stage_option=UniformStageOption(num_stages=2),
                             pipeline_schedule="1f1b")


def alloc_retries(devices) -> int:
    """The caching allocator's retries so far (an allocation that found no
    cached block, freed the cache, synchronising the card, and tried
    again), summed over the cards of ``devices``."""
    return sum(torch.cuda.memory_stats(d).get("num_alloc_retries", 0)
               for d in sorted(set(devices)))


def two_level_run(label, cfg, method, batch, ref, devices, timed_steps=3,
                  keep=False):
    """``method``'s step from the seed state, against ``ref`` (a
    pipeshard step with one device per stage: its first loss, Adam's
    first moment after one step, the parameters after 2 steps, the
    one-device step-0 gradients and the flash launches per step), by phase
    15's bounds; prints each stage's plan, the collectives and RESHARDs
    per step, the dispatch per mesh, the step time and the peak.  Returns
    the flash launches of the run and the metrics (with ``keep``, also the
    first moment after one step and the losses)."""
    gc.collect()
    torch.cuda.empty_cache()
    for d in sorted(set(devices)):
        torch.cuda.reset_peak_memory_stats(d)
    state = train_state(cfg)
    step = make_train_step(method)
    reset_launch_counts()
    tic = time.perf_counter()
    state, loss = step(state, batch)
    losses = [float(loss)]
    first_s = time.perf_counter() - tic
    ex = step.get_last_executable()
    mu = gathered_mu(state)
    mu_rel = max_rel_diff(mu, ref["mu"])
    if not keep:
        del mu
    state, loss = step(state, batch)
    losses.append(float(loss))
    per_step = tuple(c // 2 for c in launch_counts())
    bound = adam_bound(2)
    param_rel, n_small, n_all, small_max = param_diffs(
        full_cpu(state.params), ref["params"], ref["grads"], bound)
    sync_cards(devices)
    retries = alloc_retries(devices)
    tic = time.perf_counter()
    for _ in range(timed_steps):
        state, loss = step(state, batch)
        losses.append(loss)
    sync_cards(devices)
    latency = (time.perf_counter() - tic) / timed_steps
    retries = alloc_retries(devices) - retries
    losses = [float(x) for x in losses]
    peak = ex.get_total_allocation_size()
    loss_rel = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
    worst_m = max(mu_rel, key=mu_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    for e in ex.stage_execs + [a for a in ex.apply_execs if a is not None]:
        plan = getattr(e, "search", None) or []
        pinned = e.pinned_search[0]
        print(f"{label} stage {e.name} on mesh {e.mesh_id}: logical "
              f"{tuple(e.logical_mesh.shape)}; ILP search " + "; ".join(
                  f"{r['shape']} {r.get('solver')} "
                  f"{r.get('solve_seconds', 0.0):.3f} s objective "
                  f"{r.get('objective', float('nan')):.3f}" for r in plan) +
              f"; pinned {pinned['solver']} {pinned['solve_seconds']:.3f} s "
              f"objective {pinned['objective']:.3f}; planned "
              f"{e.plan_seconds:.3f} s")
    coll = ex.get_collective_counts()
    print(f"{label} collectives per step: " + ", ".join(
        f"{kind} {row['count']} calls {row['bytes']} bytes ({row['backend']})"
        for kind, row in sorted(coll.items())))
    rs = reshard_line(label, ex)
    programs = [(i.executable.program, i.executable.num_devices)
                for i in ex.instructions if i.opcode.name == "RUN" and
                getattr(i.executable, "program", None) is not None]
    slice_copy_line(label, programs)
    strided = strided_scan({id(p): p for p, _ in programs}.values())
    print(f"{label} C.8 scan: {strided} strided local slices reach an op "
          f"other than mm, bmm, sum, add and add_")
    check(strided == 0, f"{label}: {strided} strided slices (C.8)")
    print(f"{label} dispatch {ex.last_dispatch_stats['mode']} with meshes "
          f"{ex.last_dispatch_stats['meshes']}")
    print(f"{label}: Adam's first moment after one step max |diff| / max "
          f"|mu| per tensor {mu_rel[worst_m]:.3e} at {worst_m} (tol "
          f"{TWO_LEVEL_GRAD_TOL:g}); first loss {losses[0]:.6f} vs one device "
          f"per stage {ref['loss']:.6f}: {loss_rel:.3e} relative (tol "
          f"{SPMD_LOSS_TOL:g}); parameters after 2 Adam steps max |diff| / "
          f"max |p| per tensor {param_rel[worst_p]:.3e} at {worst_p} (tol "
          f"{SPMD_PARAM_TOL:g}) where the step-0 gradient is at least 1e-2 "
          f"of its tensor's largest; the other {n_small} of {n_all} "
          f"elements differ by at most {small_max:.3e} (tol {bound:.4e}); "
          f"flash launches per step {per_step} vs one device per stage "
          f"{ref['per_step']}; losses {['%.4f' % x for x in losses]}")
    print(f"{label} metrics [{card_line()}]: step {latency:.5f} s, "
          f"{8 * cfg.seq_len / latency:.1f} tokens/s, first call "
          f"{first_s:.3f} s (trace {ex.trace_seconds:.3f} s, planning, "
          f"partitioning and program {ex.compile_seconds:.3f} s), peak "
          f"allocated {peak / 2**30:.3f} GiB, allocator retries in the "
          f"timed steps {retries}")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(mu_rel[worst_m] <= TWO_LEVEL_GRAD_TOL,
          f"{label}: first moment {worst_m} differs by {mu_rel[worst_m]}")
    check(loss_rel <= SPMD_LOSS_TOL, f"{label}: first loss {losses[0]} vs "
          f"{ref['loss']}: {loss_rel} relative")
    check(param_rel[worst_p] <= SPMD_PARAM_TOL,
          f"{label}: parameter {worst_p} differs by {param_rel[worst_p]}")
    check(small_max <= bound, f"{label}: parameters with near-zero "
          f"gradients differ by {small_max}, over Adam's bound {bound}")
    devs = ex.mesh_sizes[0]
    check(per_step == tuple(devs * c for c in ref["per_step"]),
          f"{label}: flash launches per step {per_step}, want {devs} x "
          f"{ref['per_step']}")
    counts = launch_counts()
    metrics = {"latency": latency, "peak": peak, "first_s": first_s,
               "per_step": per_step, "collectives": coll, "resharding": rs,
               "split": rewrite_split(ex)}
    if keep:
        metrics.update(mu=mu, losses=losses)
    if label == "two-level":
        record_plan(label, ex, peak)
    del state, step, ex
    gc.collect()
    torch.cuda.empty_cache()
    return counts, metrics


def two_level_reference(cfg, batch, devices):
    """Phase 8's step (one device per stage) from the seed state: its
    first loss, Adam's first moment after one step, the parameters after
    two, the flash launches per step, and the one-device step-0
    gradients."""
    ref = {"grads": one_device_grads(cfg, batch)}
    state = train_state(cfg)
    step = make_train_step(PipeshardParallel(
        devices=devices, num_micro_batches=4,
        layer_option=ManualLayerOption(),
        stage_option=UniformStageOption(num_stages=2),
        pipeline_schedule="1f1b"))
    reset_launch_counts()
    state, loss = step(state, batch)
    ref["loss"], ref["mu"] = float(loss), gathered_mu(state)
    state, loss = step(state, batch)
    ref["per_step"] = tuple(c // 2 for c in launch_counts())
    ref["params"] = gathered_params(state)
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def phase_pipeshard_spmd(phase8):
    """Phase 16: phase 8's GPT-1.3B (6 layers, bf16 compute, fp32 params
    and Adam, flash, no remat, a boundary after 3 blocks, batch 8 in 4
    microbatches, 1F1B) under the two-level plan: two stages of two
    virtual devices each (the card named 4 times), each planned by the
    ILP and run by the SPMD partitioner, values moved between the stage
    meshes as tiles; held to phase 8's step (one device per stage) by
    phase 15's loss and parameter bounds and ``TWO_LEVEL_GRAD_TOL``
    (``two_level_run``).
    ``phase8``: phase 8's step, peak and pools, for the comparison line.
    Then phase 16b (``phase_two_level_tiled``).  Returns the flash
    launches of phase 16's run and of phase 16b's."""
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 8).items()}
    ref = two_level_reference(cfg, batch, ["cuda:0"] * 2)
    counts, m = two_level_run("two-level", cfg, two_level_method(
        ["cuda:0"] * 4), batch, ref, ["cuda:0"] * 4, timed_steps=2,
        keep=True)
    print(f"two-level vs phase 8 [{card_line()}]: step {m['latency']:.5f} s "
          f"(phase 8, one device per stage, CUDA graphs: "
          f"{phase8['latency']:.5f} s); peak allocated "
          f"{m['peak'] / 2**30:.3f} GiB (phase 8: "
          f"{phase8['peak'] / 2**30:.3f} GiB + pools "
          f"{(phase8['pool'] or 0) / 2**30:.3f} GiB); flash launches per "
          f"step {m['per_step']} (phase 8: {ref['per_step']})")
    tiled = timed("two-level tiled", phase_two_level_tiled, cfg, batch, ref,
                  m)
    del ref, m
    gc.collect()
    torch.cuda.empty_cache()
    return list(counts), list(tiled)



@contextlib.contextmanager
def knobs(**values):
    """``global_config`` with ``values`` set, restored after."""
    old = {k: getattr(global_config, k) for k in values}
    for k, v in values.items():
        setattr(global_config, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(global_config, k, v)


@contextlib.contextmanager
def wrapped(cls, name, make):
    """``cls.name`` replaced by ``make(original)``, restored after."""
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def reshard_line(label, ex):
    """The step's RESHARDs by executor, and the bytes their plans, the
    naive plans and their ``ExecutionReport``s give per step."""
    rs = ex.get_resharding_stats()
    print(f"{label} resharding per step: {rs['cross_mesh']} cross-mesh "
          f"RESHARDs, {rs['relayouts']} relayouts, executors "
          f"{rs['strategies']}; planned {rs['planned_bytes']:.0f} bytes, "
          f"naive {rs['naive_bytes']:.0f} (cross-mesh edges "
          f"{rs['naive_cross_mesh_bytes']:.0f}); executed cross-mesh "
          f"{rs['cross_mesh_bytes']:.0f}, intra-mesh "
          f"{rs['intra_mesh_bytes']:.0f}, between distinct devices "
          f"{rs['executed_bytes']}")
    return rs


def rewrite_split(ex):
    """The bytes a step's cross-mesh RESHARDs must move under the
    all-gather rewrite, counted from each edge's destination tiles (not
    from its requests): an edge planned with the rewrite to a block that
    k devices of its mesh replicate crosses once (its naive bytes / k),
    and its holders all-gather the other (k - 1) / k; any other edge
    crosses whole, and a relayout moves its plan inside its mesh.
    Returns the cross-mesh edges planned with the rewrite, the
    naive bytes of those and of the others, and the expected cross-mesh
    and intra-mesh bytes."""
    n_rewrite, replicated, other, cross, intra = 0, 0, 0, 0, 0
    for inst in ex.instructions:
        if inst.opcode.name != "RESHARD":
            continue
        plan = inst.resharding[0].plan
        if inst.src_mesh == inst.dst_mesh:
            intra += int(plan.transfer_bytes)    # a relayout, direct
            continue
        holders = {}
        for t in plan.dst_tiles:
            holders[t.slices] = holders.get(t.slices, 0) + 1
        naive = sum(t.size for t in plan.dst_tiles) * plan.itemsize
        k = max(holders.values())
        if plan.allgather_rewrite:
            n_rewrite += 1
            replicated += naive
            cross += naive // k
            intra += naive - naive // k
        else:
            other += naive
            cross += naive
    return {"rewrite_edges": n_rewrite, "replicated": replicated,
            "other": other, "cross": cross, "intra": intra}


def source_value(plan, shards):
    """The whole value from a plan's source shards, on the CPU."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr
    full = torch.empty(plan.shape, dtype=shards[0].dtype)
    for tile, shard in zip(plan.src_tiles, shards):
        full[cmr._index(tile.slices)] = shard.detach().cpu()
    return full


def blockmax(x):
    """Per element of ``x``, the largest magnitude of its 256-element
    block of the flattened value (the codecs' scaling block)."""
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import BLOCK
    flat = x.reshape(-1).float().abs()
    n = flat.numel()
    pad = torch.zeros(-(-n // BLOCK) * BLOCK)
    pad[:n] = flat
    return pad.view(-1, BLOCK).amax(1).repeat_interleave(BLOCK)[:n].view(
        x.shape)


def codec_checked(mode, worst):
    """A ``QuantizedTransfer.__call__`` that also appends, per call, the
    largest error of a destination element over ``ERROR_BOUND[mode]`` x
    its block's largest magnitude in the lossless value (<= 1 within the
    codec's bound) to ``worst``."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import ERROR_BOUND

    def make(orig):
        def call(self, shards):
            out, moved = orig(self, shards)
            full = source_value(self.plan, shards)
            bmax = blockmax(full)
            ratio = 0.0
            for tile, o in zip(self.dst_tiles, out):
                idx = cmr._index(tile.slices)
                err = (o.detach().cpu().float() - full[idx].float()).abs()
                ratio = max(ratio, float((err / (ERROR_BOUND[mode] *
                                                 bmax[idx]).clamp_min(
                                                     1e-38)).max()))
            worst.append(ratio)
            return out, moved
        return call
    return make


def narrow_run(method, cfg, batch, steps=2):
    """``method``'s SGD steps on the narrow model from the seed state:
    the losses, the parameters as CPU tensors and the executable."""
    state = sgd_state(cfg)
    step = make_train_step(method)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    ex = step.get_last_executable()
    params = gathered_params(state)
    del state, step
    return losses, params, ex


def reshard_variants_check(cfg, batch, base_losses, base_params):
    """Phase 16a's first pipeshard (two stages of four virtual devices, the
    ILP in each) under each cross-mesh execution the knobs select, against
    the default run (``base_*``): the planned tiled and broadcast modes and
    each forced collective strategy bit for bit in losses and parameters;
    the int8 and fp8 activation codecs with every quantized edge within
    ``ERROR_BOUND`` of its block's largest magnitude, no weight edge
    quantized, and their wire bytes against the lossless bytes."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import (
        ERROR_BOUND, QuantizedTransfer)

    def method():
        return two_level_fidelity_methods(["cuda:0"])[0][1]

    variants = [("planned tiled", dict(resharding_execution="planned")),
                ("planned broadcast", dict(resharding_execution="planned",
                                           resharding_mode="broadcast"))]
    variants += [(f"strategy {s}", dict(reshard_strategy=s))
                 for s in cmr.RESHARD_STRATEGIES[1:]]
    card = card_line()
    for label, values in variants:
        with knobs(**values):
            losses, params, ex = narrow_run(method(), cfg, batch)
        rs = reshard_line(f"two-level fidelity {label}", ex)
        same = [k for k in base_params
                if not torch.equal(params[k], base_params[k])]
        print(f"two-level fidelity {label} [{card}]: losses {losses} vs "
              f"direct_p2p {base_losses}; parameters differing from "
              f"direct_p2p's: {len(same)} of {len(base_params)}")
        check(losses == base_losses and not same,
              f"{label}: not bit-identical to direct_p2p ({same[:3]})")
        if "broadcast" in label or "tiled" in label:
            check(rs["cross_mesh_bytes"] > 0,
                  f"{label}: no cross-mesh bytes reported")
        del ex
        gc.collect()
    for mode in ("int8", "fp8"):
        worst = []
        with knobs(reshard_quantize=mode), wrapped(
                QuantizedTransfer, "__call__", codec_checked(mode, worst)):
            losses, params, ex = narrow_run(method(), cfg, batch)
        edges = [i for i in ex.instructions
                 if i.opcode.name == "RESHARD" and
                 isinstance(i.resharding[0], QuantizedTransfer)]
        weights = [i.var_key for i in edges if i.var_key[1] < 0]
        wire = sum(i.resharding[0].wire_nbytes for i in edges)
        lossless = sum(i.resharding[0].nbytes for i in edges)
        rs = reshard_line(f"two-level fidelity codec {mode}", ex)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(losses, base_losses))
        print(f"two-level fidelity codec {mode} [{card}]: {len(edges)} "
              f"activation edges quantized per step ({len(weights)} weight "
              f"edges), wire {wire} bytes vs lossless {lossless} bytes "
              f"({lossless / max(wire, 1):.3f}x fewer); per edge "
              f"{sorted({(i.resharding[0].wire_nbytes, i.resharding[0].nbytes) for i in edges})}; "
              f"worst element error over ERROR_BOUND['{mode}'] "
              f"({ERROR_BOUND[mode]:.4g}) x its block's largest magnitude "
              f"{max(worst, default=0.0):.6f} over {len(worst)} transfers "
              f"(tol 1 + 2^-14: the fp32 roundings of the encode's "
              f"division and the decode's product add up to 2 x 254 x "
              f"2^-24 of the bound); losses "
              f"{losses} vs lossless {base_losses} "
              f"({loss_rel:.3e} relative)")
        numerics = ex.get_plan_verdict().stats["numerics"]
        CODEC_RECORDS[mode] = (numerics["max_error_bound"],
                               max(worst, default=0.0),
                               numerics["lossy_edges"])
        check(edges and not weights, f"codec {mode}: {len(edges)} edges, "
              f"weight edges {weights}")
        check(worst and max(worst) <= 1.0 + 2.0 ** -14,
              f"codec {mode}: an activation "
              f"edge misses ERROR_BOUND by {max(worst, default=0.0)}")
        check(all(np.isfinite(losses)), f"codec {mode}: losses {losses}")
        del ex
        gc.collect()
    torch.cuda.empty_cache()


def phase_grad_codec():
    """Phase 16c, the gradient codec, on phase 14's narrow fp32 GPT (4
    layers at hidden 256) over the card named 4 times:
    ``Zero2Parallel(num_micro_batches=2)`` with ``grad_quantize="int8"``
    against the same step unquantized, Adam's first moment after one step
    within ``grad_error_bound("int8")`` of each tensor's largest (each
    microbatch's gradient through the codec, error feedback within the
    step; the two microbatches equal), at least one tensor quantized, the
    loss equal; then the ILP's
    plan of the same step (``ShardParallel`` on the 4 virtual devices with
    a memory budget of 0.66 of the state, as JAX's test of the flips),
    and the tensors it routes through the quantized reduce-scatter."""
    from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import (
        STATS, grad_error_bound)
    from alpa_tpu_torch.shard_parallel import AutoShardingOption
    from alpa_tpu_torch.shard_parallel.solver import (plan_auto_sharding,
                                                      quantized_choices)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash"),
        num_layers=4, hidden_size=256, num_heads=4, seq_len=256,
        vocab_size=1024)
    # one sequence 8 times: the two microbatches equal (each device's rows
    # split between them), so the mean's blocks bound each microbatch's and
    # the quantized mean misses by at most half the codec's bound of the
    # mean's largest (error feedback carries the rest)
    batch = {k: torch.as_tensor(x[:1], device="cuda").repeat(8, 1)
             for k, x in lm_batch(cfg, 8).items()}
    devices = ["cuda:0"] * 4

    def run():
        state = train_state(cfg)
        step = make_train_step(alpa_tpu_torch.Zero2Parallel(
            devices=devices, num_micro_batches=2))
        state, loss = step(state, batch)
        mu = gathered_mu(state)
        del state, step
        return float(loss), mu

    base_loss, base_mu = run()
    with knobs(grad_quantize="int8"):
        loss, mu = run()
    bound = grad_error_bound("int8")
    rel = max_rel_diff(mu, base_mu)
    changed = [k for k in mu if not torch.equal(mu[k], base_mu[k])]
    worst = max(rel, key=rel.get)
    card = card_line()
    print(f"gradient codec [{card}]: Zero2Parallel, 2 microbatches on 4 "
          f"virtual devices, fp32 GPT ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}), grad_quantize='int8': {len(changed)} of "
          f"{len(mu)} first-moment tensors quantized (gradients of at least "
          f"{global_config.grad_quantize_min_bytes} bytes); max |diff| / "
          f"max |mu| per tensor {rel[worst]:.3e} at {worst} (tol "
          f"grad_error_bound('int8') {bound:.4e}); loss {loss} vs "
          f"unquantized {base_loss}")
    check(changed, "gradient codec: no gradient was quantized")
    check(rel[worst] <= bound, f"gradient codec: first moment {worst} "
          f"differs by {rel[worst]}, over {bound}")
    check(loss == base_loss, f"gradient codec: loss {loss} vs {base_loss}")
    fun, avals, paths, bidx = planned_step(cfg, 8, "cuda")
    state_bytes = sum(int(np.prod(a[0])) * 4 for a, p in zip(avals, paths)
                      if p.startswith("[0]") and a[0])
    option = AutoShardingOption(memory_budget_per_device=int(
        state_bytes * 0.66))
    before = STATS["grad_tensors_int8"]
    with knobs(grad_quantize="int8", grad_quantize_min_bytes=1024):
        _, _, (graph, choice), shape = plan_auto_sharding(
            fun, avals, paths, bidx, PhysicalDeviceMesh(devices), option)
    flipped = [(paths[i], name) for i, name, _ in quantized_choices(graph,
                                                                   choice)]
    print(f"gradient codec ILP [{card}]: ShardParallel plan on (4 virtual "
          f"devices) logical mesh {shape}, memory budget 0.66 of the state, "
          f"grad_quantize='int8' (min 1024 bytes): {len(flipped)} tensors "
          f"routed through the quantized reduce-scatter "
          f"({STATS['grad_tensors_int8'] - before} counted), the first "
          f"8: {flipped[:8]}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_two_level_tiled(cfg, batch, ref, phase16):
    """Phase 16b: phase 16's step (GPT-1.3B, two stages of two virtual
    devices) with the cross-mesh RESHARDs run as their plans are
    (``resharding_execution="planned"``, ``ReshardingTask``'s "tiled"
    mode: each destination replica fetches a disjoint half across meshes
    and the destination mesh all-gathers the halves): the first two
    losses and Adam's first moment after one step bit for bit phase 16's
    (on one card every leg is a copy); the cross-mesh bytes of a step's
    ``ExecutionReport``s equal to the tile plans' (the rewrite halves each
    edge to a destination replicated over its mesh's two devices and
    leaves an edge to a sharded destination whole), and cross-mesh plus
    intra-mesh bytes equal to the naive plans' (each replica's other half
    comes over the all-gather); the step time and the peak.  Returns the
    flash launches of the run."""
    with knobs(resharding_execution="planned"):
        counts, m = two_level_run("two-level tiled", cfg, two_level_method(
            ["cuda:0"] * 4), batch, ref, ["cuda:0"] * 4, timed_steps=1,
            keep=True)
    rs, split = m["resharding"], m["split"]
    diff = [k for k in m["mu"] if not torch.equal(m["mu"][k],
                                                  phase16["mu"][k])]
    naive = rs["naive_cross_mesh_bytes"]
    ratio = rs["cross_mesh_bytes"] / max(naive, 1)
    print(f"two-level tiled vs phase 16 [{card_line()}]: losses "
          f"{m['losses'][:2]} vs {phase16['losses'][:2]}; first-moment "
          f"tensors differing {len(diff)} of {len(m['mu'])}; bytes per step: "
          f"planned {rs['planned_bytes']:.0f}, naive {rs['naive_bytes']:.0f} "
          f"(cross-mesh edges {rs['naive_cross_mesh_bytes']:.0f}), executed "
          f"cross-mesh {rs['cross_mesh_bytes']:.0f} ({ratio:.4f} of the "
          f"naive) and intra-mesh {rs['intra_mesh_bytes']:.0f}; from the "
          f"destination tiles: {split['rewrite_edges']} edges to replicated "
          f"blocks (naive {split['replicated']}), the others naive "
          f"{split['other']}, so cross-mesh {split['cross']} and intra-mesh "
          f"{split['intra']} expected "
          f"(phase 16, direct: cross-mesh "
          f"{phase16['resharding']['cross_mesh_bytes']:.0f}); step "
          f"{m['latency']:.5f} s (phase 16: {phase16['latency']:.5f} s), peak "
          f"{m['peak'] / 2**30:.3f} GiB (phase 16: "
          f"{phase16['peak'] / 2**30:.3f} GiB)")
    check(m["losses"][:2] == phase16["losses"][:2] and not diff,
          f"two-level tiled: not bit-identical to phase 16 ({diff[:3]})")
    # the rewrite applied (an all-gather inside each destination mesh
    # moved what no longer crosses), as the destination tiles say it must
    check(split["rewrite_edges"] > 0 and split["intra"] > 0 and
          split["replicated"] + split["other"] == naive and
          rs["cross_mesh_bytes"] == split["cross"] == rs["planned_bytes"] and
          rs["intra_mesh_bytes"] == split["intra"],
          f"two-level tiled: cross-mesh {rs['cross_mesh_bytes']} and "
          f"intra-mesh {rs['intra_mesh_bytes']} bytes vs {split} from the "
          f"destination tiles, planned {rs['planned_bytes']}, naive {naive}")
    return counts


def checked_collectives(violations):
    """``collectives.run_collective`` also run on CPU copies of its
    operands with the plain tensor ops: a gather or all-to-all must equal
    it bit for bit, a reduction to 1e-5 of the largest magnitude; each
    miss appended to ``violations``."""
    from alpa_tpu_torch.shard_parallel import collectives

    class OnHost:
        def __init__(self, mesh):
            self.mesh = mesh

        def flat_devices(self):
            return [torch.device("cpu")] * len(self.mesh.flat_devices())

        def axis_groups(self, axis):
            return self.mesh.axis_groups(axis)

    def make(orig):
        def run(record, values, logical_mesh):
            host = [v.detach().cpu() for v in values]
            out = orig(record, values, logical_mesh)
            want = orig(record, host, OnHost(logical_mesh))
            for p, (o, w) in enumerate(zip(out, want)):
                o = o.detach().cpu()
                scale = float(w.abs().max()) if w.numel() else 0.0
                err = float((o.double() - w.double()).abs().max()) \
                    if w.numel() else 0.0
                exact = record.kind in ("all_gather", "all_to_all")
                if (o.shape != w.shape or (err > 0 if exact else
                                           err > 1e-5 * scale)):
                    violations.append(f"{record.kind} axis {record.axis} "
                                      f"position {p}: {err:.3e} of "
                                      f"{scale:.3e}")
            return out
        return run
    return make


def checked_tiles(violations):
    """``ReshardingTask.__call__`` that also holds every destination shard
    to the source value sliced by its block, bit for bit."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr

    def make(orig):
        def call(self, shards, mode=None):
            out, moved = orig(self, shards, mode)
            full = source_value(self.plan, shards)
            for p, (tile, o) in enumerate(zip(self.plan.dst_tiles, out)):
                if not torch.equal(o.detach().cpu(),
                                   full[cmr._index(tile.slices)]):
                    violations.append(f"tile {tile.slices} to position {p} "
                                      f"of {self.dst_devices}")
            return out, moved
        return call
    return make


def host_rss_gib() -> float:
    """The process's peak resident host memory so far."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def c4_layouts(cards):
    """C.4's bisection layouts, the four-card one (the fault's) first:
    ``[c0, c1, c2, c3]``, ``[c0, c1, c0, c1]`` (NCCL inside each stage,
    both stages on one pair of cards) and ``[c0, c0, c1, c1]`` (each stage
    on one card named twice: plain collectives, tiles between cards)."""
    layouts = [list(cards[:4])] if len(cards) >= 4 else []
    return layouts + [[cards[0], cards[1], cards[0], cards[1]],
                      [cards[0], cards[0], cards[1], cards[1]]]


def c4_bisection(layouts):
    """ROADMAP C.4's bisection: phase 16a's pipeshard (fp32, 4 layers at
    hidden 256, two stages of two ILP-planned devices) over each of
    ``layouts`` (``c4_layouts``) in every dispatch mode ("threaded" last),
    against the same plan on ``cuda:0`` named as often: unchecked first
    (the fault as it shows), then with every collective held to the plain
    one on the host and every tile to its source
    (``checked_collectives``, ``checked_tiles``).  Losses within 1e-5
    relative, parameters within 1e-5 of each tensor's largest.  Returns
    the failures."""
    from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as cmr
    from alpa_tpu_torch.shard_parallel import collectives
    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash"),
        num_layers=4, hidden_size=256, num_heads=4, seq_len=256,
        vocab_size=1024, pipeline_boundary_every=2)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in lm_batch(base, 8).items()}
    modes = [m for m in DISPATCH_MODES if m != "threaded"] + ["threaded"]
    failures = []

    def method(devices):
        return PipeshardParallel(devices=devices, num_micro_batches=2,
                                 layer_option=ManualLayerOption(),
                                 stage_option=UniformStageOption(2))

    ref_losses, ref_params, _ = narrow_run(method(["cuda:0"] * 4), base,
                                           batch)
    card = card_line()
    for devices in layouts:
        for mode in modes:
            for checking in (False, True):
                violations = []
                with knobs(_pipeline_dispatch_mode=mode), \
                        contextlib.ExitStack() as stack:
                    if checking:
                        stack.enter_context(wrapped(
                            collectives, "run_collective",
                            checked_collectives(violations)))
                        stack.enter_context(wrapped(
                            cmr.ReshardingTask, "__call__",
                            checked_tiles(violations)))
                    try:
                        losses, params, ex = narrow_run(
                            method(devices), base, batch)
                    except Exception as e:  # reported, not swallowed
                        failures.append(f"{devices} {mode}: {e!r}")
                        print(f"C.4 bisection {devices} {mode}: raised "
                              f"{e!r}")
                        continue
                rel = max_rel_diff(params, ref_params)
                worst = max(rel, key=rel.get)
                loss_rel = max(abs(a - b) / abs(b)
                               for a, b in zip(losses, ref_losses))
                bad = loss_rel > 1e-5 or rel[worst] > 1e-5 or violations
                print(f"C.4 bisection [{card} x{len(set(devices))}] "
                      f"devices {devices} mode {mode} "
                      f"{'checked' if checking else 'unchecked'}: losses "
                      f"{loss_rel:.3e} relative (tol 1e-5), parameters "
                      f"{rel[worst]:.3e} at {worst} (tol 1e-5), collective "
                      f"and tile misses {len(violations)} "
                      f"{violations[:4]}; executed between cards "
                      f"{ex.executed_resharding_bytes} bytes, "
                      f"collectives {sorted((k, r['backend']) for k, r in ex.get_collective_counts().items())}; "
                      f"host peak RSS {host_rss_gib():.1f} GiB")
                if bad:
                    failures.append(f"{devices} {mode} "
                                    f"{'checked' if checking else ''}: "
                                    f"loss {loss_rel:.3e}, {worst} "
                                    f"{rel[worst]:.3e}, {violations[:2]}")
                del ex
                gc.collect()
    torch.cuda.empty_cache()
    return failures


def four_cards():
    """``--four-cards``: GPT-1.3B at batch 32 (8 per card) under
    ``DataParallel``, ``Zero2Parallel`` and the ILP's ``ShardParallel`` over
    four cards (collectives over NCCL), 3 steps each, the first against
    phase 12's one-card ``ShardParallel(num_micro_batches=4)`` step at batch
    32 (``spmd_step_run``'s checks)."""
    n = torch.cuda.device_count()
    check(n >= 4, f"--four-cards needs four cards, found {n}")
    cards = [f"cuda:{i}" for i in range(4)]
    failures = [f"C.4 bisection {f}" for f in c4_bisection(
        c4_layouts(cards))]
    cfg = config_from_spec("1.3B", dtype=torch.bfloat16,
                           attention_impl="flash", remat_blocks=True)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 32).items()}
    ref_grads = one_device_grads(cfg, batch)
    state = train_state(cfg)
    ref_step = make_train_step(
        alpa_tpu_torch.ShardParallel(devices=["cuda:0"], num_micro_batches=4))
    reset_launch_counts()
    state, loss = ref_step(state, batch)
    ref_loss = float(loss)
    ref_per_step = tuple(c // 4 for c in launch_counts())
    ref_params, ref_mu = gathered_params(state), gathered_mu(state)
    del state, ref_step
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    for label, method in (
            ("four cards DataParallel",
             alpa_tpu_torch.DataParallel(devices=cards)),
            ("four cards Zero2Parallel",
             alpa_tpu_torch.Zero2Parallel(devices=cards)),
            ("four cards ShardParallel",
             alpa_tpu_torch.ShardParallel(devices=cards))):
        try:
            _, m = spmd_step_run(label, cfg, method, batch, ref_loss, ref_mu,
                                 ref_params, ref_grads, ref_per_step, 4,
                                 cards, timed_steps=2, compare_after=1,
                                 profile=True)
        except SmokeFailure as e:
            # the other methods still run and print their readings
            failures.append(str(e))
            continue
        tflops = compute_gpt_tflops(32, cfg.seq_len, cfg.num_layers,
                                    cfg.hidden_size, cfg.vocab_size, 4,
                                    m["latency"])
        peaks = [torch.cuda.max_memory_allocated(d) / 2**30 for d in cards]
        coll = sum(row["bytes"] for row in m["collectives"].values())
        print(f"{label} metrics [{card} x4]: step {m['latency']:.5f} s, "
              f"{32 * cfg.seq_len / m['latency']:.1f} tokens/s, {tflops:.3f} "
              f"TFLOPS per card, MFU "
              f"{compute_mfu(tflops, SPEC['peak_bf16_tflops']):.4f} "
              f"of 4 x {SPEC['peak_bf16_tflops']} TFLOP/s bf16; collectives "
              f"{coll} bytes per step, NCCL kernels {m['nccl_s']:.5f} device s "
              f"per step (summed over the cards); ILP objective of the plan "
              f"{m['objective']:.3f} beside the measured step; peak allocated "
              f"per card {['%.3f' % p for p in peaks]} GiB")
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
    del ref_params, ref_grads, ref_mu
    gc.collect()
    torch.cuda.empty_cache()
    # phase 16 over the four cards (two stages of two cards each), direct
    # and tiled (ROADMAP C.4, repaired)
    failures += four_card_two_level(cards)
    check(not failures, "; ".join(failures))


def four_card_two_level(cards):
    """Phase 16 over four cards, the cross-mesh RESHARDs direct and then
    planned ("tiled"), each held to phase 8's step on one card by phase
    16's bounds; the bytes moved between cards per step of each.  Returns
    the failures."""
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 8).items()}
    ref = two_level_reference(cfg, batch, ["cuda:0"] * 2)
    failures = []
    for label, execution in (("four cards two-level", "device_put"),
                             ("four cards two-level tiled", "planned")):
        try:
            with knobs(resharding_execution=execution):
                _, m = two_level_run(label, cfg, two_level_method(cards),
                                     batch, ref, cards, timed_steps=2)
        except SmokeFailure as e:
            failures.append(str(e))
            continue
        rs = m["resharding"]
        print(f"{label} [{card_line()} x4]: bytes moved between cards per "
              f"step {rs['executed_bytes']}, cross-mesh "
              f"{rs['cross_mesh_bytes']:.0f}, intra-mesh "
              f"{rs['intra_mesh_bytes']:.0f}, naive "
              f"{rs['naive_cross_mesh_bytes']:.0f}; step "
              f"{m['latency']:.5f} s")
    return failures


# ---- phase 18: faults and state ----------------------------------------

# the serving swap's streams: prompts of 128 tokens, 48 greedy new tokens
SWAP_STREAMS = 8
SWAP_PROMPT = 128
SWAP_NEW_TOKENS = 48


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def disk_room(path, need, label):
    """Print the free space under ``path`` and fail, naming the bytes,
    where ``need`` do not fit."""
    import shutil
    free = shutil.disk_usage(path).free
    print(f"{label}: {free / 2**30:.1f} GiB free under {path}, "
          f"{need / 2**30:.1f} GiB needed")
    check(free >= need, f"{label}: the checkpoints need {need} bytes under "
          f"{path}; {free} are free")


def flip_chunk_byte(store, step, leaf):
    """Flip one byte of the first chunk of ``leaf`` in ``step``."""
    ent = store.read_manifest(step)["leaves"][leaf]["chunks"][0]
    with open(store.chunk_path(ent["hash"]), "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))


def phase_faults_pipeshard(cfg, batch, run):
    """Phase 18 (a)-(c) on phase 8's executable (``run``: what
    ``timed_pipeshard`` kept, the state put back by the phases before):
    (a) two steps from the seed state under a ``FaultPlan`` raising once
    at ``stage_launch`` and once at ``cross_mesh_send`` with a retry
    policy installed, against the same steps without faults; (b) two
    steps, an asynchronous ``CheckpointManager`` save, two more steps, the
    saved step restored into the live state and the two steps again, then
    a byte of a chunk flipped; (c) six steps under ``ElasticSupervisor``
    with a preemption notice at step 3, against six uninterrupted steps.
    Returns the flash launches of (a)-(c) and the numbers."""
    import os
    import shutil
    import tempfile
    from alpa_tpu_torch import elastic, fault
    from alpa_tpu_torch.checkpoint import (CheckpointManager,
                                           ChunkCorruptionError,
                                           RetentionPolicy)
    from alpa_tpu_torch.checkpoint import metrics as ckpt_metrics
    step, state, ex = run["step"], run.pop("state"), run["ex"]
    cards = sorted(set(str(d) for d in ex.mesh_devices))
    batch = {k: torch.as_tensor(v, device=cards[0]) for k, v in batch.items()}
    model = GPTModel(cfg, device=cards[0], param_dtype=torch.float32)
    init_random_(model, SEED)
    seed = {k: p.detach() for k, p in model.named_parameters()}
    del model
    card = card_line()
    captures = (ex.capture_count, ex.recapture_count)
    out = {}

    def steps(n, st):
        losses = []
        for _ in range(n):
            st, loss = step(st, batch)
            losses.append(float(loss))
        return st, losses

    def params_equal(st, ref):
        return all(torch.equal(p, ref[k]) for k, p in st.params.items())

    reset_launch_counts()
    # (a) retry on the training path
    state, ref_losses = steps(2, reset_state_(state, seed))
    ref_params = {k: p.clone() for k, p in state.params.items()}
    state = reset_state_(state, seed)
    fault.set_retry_policy(fault.RetryPolicy(max_attempts=3, base_delay=0.0,
                                             jitter=0.0))
    try:
        with fault.FaultPlan(
                fault.FaultSpec("stage_launch", times=1, after=5),
                fault.FaultSpec("cross_mesh_send", times=1, after=1)) as plan:
            state, losses = steps(2, state)
    finally:
        fault.set_retry_policy(None)
    same = losses == ref_losses and params_equal(state, ref_params)
    del ref_params
    print(f"faults (a) [{card}]: phase 8's step (dispatch "
          f"{ex.last_dispatch_stats['mode']}, CUDA graphs replayed) under a "
          f"FaultPlan raising once at stage_launch and once at "
          f"cross_mesh_send: events {[(s, k) for s, k, _ in plan.events]}, "
          f"retries {plan.retries}; losses {losses}, losses and parameters "
          f"bit-identical to the steps without faults: {same}; captures, "
          f"recaptures {(ex.capture_count, ex.recapture_count)} (before "
          f"{captures})")
    check(plan.retries == {"stage_launch": 1, "cross_mesh_send": 1},
          f"faults (a): retries {plan.retries}")
    check(same, "faults (a): the retried step differs from the plain one")
    check((ex.capture_count, ex.recapture_count) == captures,
          "faults (a): a retry captured the step again")

    root = tempfile.mkdtemp(prefix="alpa_port_ckpt_")
    try:
        nbytes = tensor_bytes((state.params, state.opt_state))
        disk_room(root, int(2.2 * nbytes), "faults (b)-(c)")
        # (b) checkpoint and resume at full width
        ckpt_metrics.reset()
        state, first = steps(2, reset_state_(state, seed))
        mgr = CheckpointManager(os.path.join(root, "b"),
                                policy=RetentionPolicy(keep_last_k=2))
        mgr.save(2, state, executable=ex)
        blocking = mgr.last_blocking_seconds
        state, later = steps(2, state)
        later_params = {k: p.clone() for k, p in state.params.items()}
        mgr.wait()
        write_s = mgr.last_write_seconds
        written = ckpt_metrics.snapshot().get("bytes_written", 0)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        state = mgr.restore(state, step=2, executable=ex, in_place=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - tic
        state, again = steps(2, state)
        same = again == later and params_equal(state, later_params)
        del later_params
        leaf = "params.wte.weight"
        flip_chunk_byte(mgr.store, 2, leaf)
        report = mgr.store.verify_step(2)
        wte = state.params["wte.weight"].clone()
        try:
            mgr.restore(state, step=2, executable=ex, in_place=True)
            refused = None
        except ChunkCorruptionError as e:
            refused = e
        untouched = torch.equal(state.params["wte.weight"], wte)
        del wte
        print(f"faults (b) [{card}]: GPT-1.3B state of {nbytes} bytes "
              f"(fp32 parameters and Adam) saved at step 2 asynchronously: "
              f"{mgr.last_bytes} bytes staged, {written} bytes written in "
              f"chunks; save {blocking:.3f} s blocking (the device-to-host "
              f"copies), {blocking + write_s:.3f} s total ({write_s:.3f} s "
              f"writing in the background while steps 3-4 ran); restore "
              f"into the live state {restore_s:.3f} s; steps 3-4 "
              f"{later}, again after the restore {again}, losses and "
              f"parameters bit-identical: {same}; captures, recaptures "
              f"{(ex.capture_count, ex.recapture_count)}; a flipped byte: "
              f"verify_step ok {report['ok']}, bad leaves "
              f"{sorted({b['leaf'] for b in report['bad']})}, restore "
              f"refused: {type(refused).__name__}, state untouched: "
              f"{untouched}")
        check(same, "faults (b): the restored steps differ")
        check((ex.capture_count, ex.recapture_count) == captures,
              "faults (b): the restore made the step captured again")
        check(not report["ok"] and
              {b["leaf"] for b in report["bad"]} == {leaf},
              f"faults (b): verify_step reported {report['bad'][:2]}")
        check(refused is not None and untouched,
              "faults (b): a corrupt step was restored")
        out.update(save_blocking_s=blocking, save_total_s=blocking + write_s,
                   restore_s=restore_s, bytes_written=written)
        shutil.rmtree(os.path.join(root, "b"))

        # (c) an elastic episode
        state, base = steps(6, reset_state_(state, seed))
        state = reset_state_(state, seed)
        mgr = CheckpointManager(os.path.join(root, "c"),
                                policy=RetentionPolicy(keep_last_k=2),
                                async_save=False)
        tic = time.perf_counter()
        sup = elastic.ElasticSupervisor(
            lambda devices: step, state, manager=mgr,
            devices=[str(d) for d in ex.mesh_devices],
            snapshot_interval=100, register_globally=False)
        initial_s = time.perf_counter() - tic
        state = None
        notice = fault.FaultSpec(
            "preemption_notice", times=1, after=3,
            exc=lambda: elastic.PreemptionNotice(
                grace_s=global_config.elastic_grace_period_s))
        with fault.FaultPlan(notice):
            losses = [float(sup.step(batch)) for _ in range(6)]
        ep = sup.episodes[0] if sup.episodes else {}
        ELASTIC_VERDICTS["18c"] = ep.get("verdict")
        print(f"faults (c) [{card}]: ElasticSupervisor over phase 8's step, "
              f"step-0 restore point in {initial_s:.3f} s, a preemption "
              f"notice at step 3: episode {json.dumps(ep, default=str)}; "
              f"wall clock {ep.get('seconds')} s (grace "
              f"{global_config.elastic_grace_period_s} s, budget "
              f"{global_config.elastic_time_budget_s} s), replay distance "
              f"{ep.get('replay_steps')} steps; losses {losses}, an "
              f"uninterrupted run {base}: bit-identical {losses == base}; "
              f"captures, recaptures {(ex.capture_count, ex.recapture_count)}")
        check(len(sup.episodes) == 1 and
              ep["reason"] == "preemption_notice" and
              ep["quiesced"] is True and ep["snapshot"] == "grace" and
              ep["snapshot_before_kill"] is True and
              ep["replan"] == "reused" and ep["restored_step"] == 3 and
              ep["within_step_budget"] and ep["within_time_budget"],
              f"faults (c): episode {ep}")
        check(losses == base, f"faults (c): losses {losses}, want {base}")
        check((ex.capture_count, ex.recapture_count) == captures,
              "faults (c): the episode made the step captured again")
        out.update(episode_s=ep["seconds"], replay=ep["replay_steps"],
                   snapshot_s=ep.get("snapshot_seconds"))
        state = sup.state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    run["state"] = state
    del seed
    return launch_counts(), out


def phase_faults_zero2():
    """Phase 18 (d): phase 14's narrow fp32 GPT on the flash kernels under
    ``Zero2Parallel`` on the card named 4 times, supervised: a worker lost
    after step 2 leaves the card named twice; the episode re-solves there,
    restores the state into the new plan's layout (each block through
    ``read_leaf_slice``) and resumes.  The later losses must equal the
    same step restored directly at degree 2, bit for bit, and a restore
    checked against the degree-2 plan's fingerprint must raise
    ``PlanFingerprintMismatch``.  Returns the flash launches."""
    import tempfile
    from alpa_tpu_torch import elastic, fault
    from alpa_tpu_torch.checkpoint import (CheckpointManager,
                                           PlanFingerprintMismatch)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        config_from_spec("1.3B", dtype=torch.float32, attention_impl="flash",
                         remat_blocks=True), num_layers=4, hidden_size=256,
        num_heads=4, seq_len=256, vocab_size=1024)
    batch = {k: torch.as_tensor(x, device="cuda")
             for k, x in lm_batch(cfg, 8).items()}
    cache = {}

    def solve(devices):
        if len(devices) not in cache:
            cache[len(devices)] = make_train_step(
                alpa_tpu_torch.Zero2Parallel(devices=list(devices)))
        return cache[len(devices)]

    devices = ["cuda:0"] * 4
    reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="alpa_port_zero2_") as root:
        sup = elastic.ElasticSupervisor(
            solve, sgd_state(cfg), checkpoint_root=root, devices=devices,
            register_globally=False)
        losses = {}
        with fault.FaultPlan(fault.FaultSpec(
                "worker_lost", times=1, after=2,
                exc=lambda: elastic.WorkerLost(survivors=devices[:2]))):
            while sup.step_index < 5:
                loss = sup.step(batch)
                losses[sup.step_index] = float(loss)
        ep = sup.episodes[0]
        r = ep["restored_step"]
        mgr = CheckpointManager(root, async_save=False)
        direct = solve(devices[:2])
        ex2, _ = direct.get_executable(sgd_state(cfg), batch)
        try:
            mgr.restore(sgd_state(cfg), step=r, executable=ex2)
            mismatch = None
        except PlanFingerprintMismatch as e:
            mismatch = e
        c_state = mgr.restore(sgd_state(cfg), step=r)
        direct_losses = {}
        for i in range(r + 1, 6):
            c_state, loss = direct(c_state, batch)
            direct_losses[i] = float(loss)
    counts = launch_counts()
    later = {i: losses[i] for i in direct_losses}
    print(f"faults (d) [{card_line()}]: phase 14's narrow GPT under "
          f"Zero2Parallel on the card named 4 times, a worker lost after "
          f"step 2: episode reason {ep['reason']}, replan {ep['replan']}, "
          f"verdict {ep['verdict']}, devices {ep['devices_before']} -> "
          f"{ep['devices_after']}, restored step {r}, replay "
          f"{ep['replay_steps']}, {ep['seconds']:.3f} s; losses after the "
          f"episode {later}, restored directly at degree 2 {direct_losses}: "
          f"bit-identical {later == direct_losses}; a restore checked "
          f"against the degree-2 plan raised "
          f"{type(mismatch).__name__}")
    check(ep["replan"] == "accepted" and ep["devices_after"] == 2,
          f"faults (d): episode {ep}")
    check(later == direct_losses, "faults (d): resumed losses differ")
    check(mismatch is not None, "faults (d): a silent restore across plans")
    return counts


def phase_serving_swap():
    """Phase 18 (e): OPT-1.3B (bf16, flash, random weights from the seed)
    through the port's controller.  Weights of seed 1 saved with
    ``CheckpointManager``; ``POST /admin/reload`` while 8 streamed requests
    run: every stream finishes, and batched requests after the swap give
    the greedy tokens of a fresh ``Generator`` on the new weights.  A
    reload from a checkpoint with a flipped byte is refused and serving
    goes on with the weights it has.  Errors injected at
    ``scheduler_tick`` make a ``RecoveryManager`` (probing with a one-token
    request) shed load: ``/health`` 503, ``/healthz`` naming
    ``last_flight_dump``; with the plan cleared it recovers and serves.
    ``check_alive`` and ``WedgeDetector`` read ``ok`` for the card.
    Returns the flash launches."""
    import os
    import shutil
    import tempfile
    import urllib.error
    from alpa_tpu_torch import fault, monitoring
    from alpa_tpu_torch.checkpoint import CheckpointManager
    from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
    from alpa_tpu_torch.elastic import WedgeDetector
    from alpa_tpu_torch.telemetry import flight
    label = "faults (e)"
    card = card_line()
    cfg = config_from_opt_spec("1.3b", dtype=torch.bfloat16,
                               attention_impl="flash")
    gc.collect()
    torch.cuda.empty_cache()
    model = GPTModel(cfg, device="cuda")
    init_random_(model, SEED)
    gen = Generator(model, cfg)
    new_model = GPTModel(cfg, device="cuda")
    init_random_(new_model, 1)
    fresh = Generator(new_model, cfg)
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(0, cfg.vocab_size, SWAP_PROMPT)
               for _ in range(SWAP_STREAMS + 3)]
    root = tempfile.mkdtemp(prefix="alpa_port_swap_")
    server = run_controller(port=0)
    name = "opt-1.3b-swap"

    def status(path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}{path}",
                    timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def post_json(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def want(p):
        return fresh.generate([p], GenerationConfig(
            max_new_tokens=NEW_TOKENS))[0].tolist()

    try:
        disk_room(root, 3 * tensor_bytes(dict(new_model.state_dict())),
                  label)
        mgr = CheckpointManager(os.path.join(root, "new"), async_save=False)
        tic = time.perf_counter()
        mgr.save(1, dict(new_model.state_dict()))
        save_s = time.perf_counter() - tic
        server.controller.register_model(name, gen)
        # warm-up: the engine's capture and one batched request
        read_sse(server.port, {"model": name,
                               "prompt_ids": prompts[0].tolist(),
                               "max_new_tokens": 4}, [])
        post(server.port, {"model": name, "prompt_ids": prompts[0].tolist(),
                           "max_new_tokens": 4})
        # the reference tokens first: their launches are not the path's
        wanted = [want(p) for p in prompts[SWAP_STREAMS:]]
        reset_launch_counts()
        times = [[] for _ in range(SWAP_STREAMS)]
        results = [None] * SWAP_STREAMS
        errors = []

        def stream(i):
            try:
                results[i] = read_sse(server.port, {
                    "model": name, "prompt_ids": prompts[i].tolist(),
                    "max_new_tokens": SWAP_NEW_TOKENS}, times[i])
            except Exception as e:  # pylint: disable=broad-except
                errors.append(e)

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(SWAP_STREAMS)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while not all(times) and time.monotonic() < deadline:
            time.sleep(0.005)
        tic = time.perf_counter()
        code, swapped = post_json("/admin/reload", {
            "model": name, "ckpt_dir": os.path.join(root, "new")})
        reload_s = time.perf_counter() - tic
        for t in threads:
            t.join(timeout=600)
        finished = [r is not None and r[1] == {"done": True} and
                    len(r[0]) == SWAP_NEW_TOKENS for r in results]
        after = [post(server.port, {"model": name, "prompt_ids": p.tolist(),
                                    "max_new_tokens": NEW_TOKENS})
                 for p in prompts[SWAP_STREAMS:]]
        print(f"{label} [{card}]: OPT-1.3B bf16 seed-1 weights saved in "
              f"{save_s:.3f} s; POST /admin/reload while {SWAP_STREAMS} "
              f"streams of {SWAP_NEW_TOKENS} tokens ran: {code} {swapped} "
              f"in {reload_s:.3f} s; streams finished {sum(finished)} of "
              f"{SWAP_STREAMS}, errors {errors[:1]}; batched requests after "
              f"the swap equal a fresh Generator on the new weights: "
              f"{after == wanted}")
        check(code == 200 and swapped["step"] == 1,
              f"{label}: reload answered {code} {swapped}")
        check(all(finished) and not errors,
              f"{label}: streams finished {finished}, errors {errors[:1]}")
        check(after == wanted, f"{label}: tokens after the swap differ from "
              "the new weights' greedy tokens")

        # a corrupt checkpoint is refused and touches nothing
        mgr_bad = CheckpointManager(os.path.join(root, "bad"),
                                    async_save=False)
        mgr_bad.save(1, dict(model.state_dict()))
        flip_chunk_byte(mgr_bad.store, 1, "wte.weight")
        code, refused = post_json("/admin/reload", {
            "model": name, "ckpt_dir": os.path.join(root, "bad")})
        still = post(server.port, {"model": name,
                                   "prompt_ids": prompts[-1].tolist(),
                                   "max_new_tokens": NEW_TOKENS})
        print(f"{label} [{card}]: reload from a checkpoint with a flipped "
              f"byte: {code} {refused.get('error', '')[:80]}; reloads "
              f"{len(server.controller.reloads)}; serving the swapped "
              f"weights still: {still == wanted[-1]}")
        check(code == 500 and "ChunkCorruptionError" in refused["error"] and
              len(server.controller.reloads) == 1 and still == wanted[-1],
              f"{label}: a corrupt reload was not refused cleanly")

        # load shedding under scheduler_tick faults, then recovery
        engine = server.controller._models[name][0].engine

        def probe(_mesh):
            engine.submit(prompts[0][:16], GenerationConfig(
                max_new_tokens=1))
            return True

        rm = fault.RecoveryManager(
            ["cuda:0"], retry_policy=fault.RetryPolicy(
                max_attempts=2, base_delay=0.0, jitter=0.0), probe=probe)
        server.controller.attach_recovery(rm)
        with fault.FaultPlan(fault.FaultSpec("scheduler_tick", times=-1)):
            degraded = rm.tick().value
            health = status("/health")
            healthz = status("/healthz")
            shed = post_json("/completions", {
                "model": name, "prompt_ids": prompts[-1].tolist(),
                "max_new_tokens": 4})
        recovered = rm.tick().value
        served = post(server.port, {"model": name,
                                    "prompt_ids": prompts[-1].tolist(),
                                    "max_new_tokens": NEW_TOKENS})
        transitions = [(o.value, n.value) for o, n, _ in rm.transitions]
        alive = monitoring.check_alive("cuda:0", timeout=60.0)
        wedge = WedgeDetector(mesh_group=[PhysicalDeviceMesh(["cuda:0"])],
                              probe_timeout_s=60.0).check()
        print(f"{label} [{card}]: scheduler_tick faults: recovery "
              f"{transitions}, state {degraded}; GET /health {health[0]} "
              f"{health[1]}; GET /healthz {healthz[0]} {healthz[1]}; POST "
              f"/completions {shed[0]}; plan cleared: {recovered}, serving "
              f"again {served == wanted[-1]}; check_alive {alive}, "
              f"WedgeDetector {wedge}; engine step failures "
              f"{engine.step_failures}, flight dump "
              f"{flight.last_dump_path()}")
        check(degraded == "degraded" and health[0] == 503 and
              health[1]["status"] == "shedding" and healthz[0] == 503 and
              "last_flight_dump" in healthz[1] and shed[0] == 503,
              f"{label}: shedding {degraded} {health} {healthz} {shed[0]}")
        check(recovered == "healthy" and served == wanted[-1],
              f"{label}: recovery {recovered}, served {served[:4]}")
        check(alive and wedge == {0: "ok"},
              f"{label}: check_alive {alive}, WedgeDetector {wedge}")
        counts = launch_counts()
    finally:
        server.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    del model, new_model, gen, fresh
    gc.collect()
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
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
    batch = lm_batch(cfg, 8)
    ref_loss = shard_first_loss(cfg, batch)
    run = timed_pipeshard("pipeshard two cards", cfg, pipeshard_method(4),
                          batch, ref_loss, 1e-2, {}, keep=True)
    phase_dispatch(cfg, batch, run, label="pipeshard two cards dispatch")


# phase 19: the rest of serving.  19a-b on OPT-1.3B with OPT-125M as the
# draft; 19c the disaggregated handoff over phase 4b's request mix; 19d the
# router over three replicas; 19e a params directory round trip
SPEC_PROMPTS = 4
SPEC_NEW_TOKENS = 64
SPEC_DRAFT = 4
BEAM_NEW_TOKENS = 32
DISAGG_NEW_TOKENS = 32
ROUTER_REQUESTS = 32
ROUTER_NEW_TOKENS = 16
# the self-draft's least acceptance: the verify leg's logits (k + 1 rows at
# once) and the draft's (one row) are two bf16 paths through the same
# weights, which may order a near-tie differently
SELF_DRAFT_MIN_ACCEPT = 0.75
# phase 19's depth: 6 of OPT-1.3B's 24 layers at its full width since
# phase 21 joined the run (its host-bound decodes scale with the depth;
# its checks do not depend on it), so that the whole run stays well
# inside its time limit on a slower host: 979.4 s with 24 layers, 880.5 s
# with 12 and 1088.0 s with 12 on a host 1.24x slower (NVIDIA H100 80GB
# HBM3, 700.00 W)
SERVING_REST_LAYERS = 6


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def same_or_near_tie(model, prompt, got, want, label):
    """Check ``got`` equals ``want`` or parts from it at a near-tie
    (``NEAR_TIE``), phase 4b's rule for two bf16 paths; the parting or
    None."""
    # the near-tie forward is the check's, not the path's: its launches
    # are taken back out of the counts
    saved = launch_counts()
    tie = near_tie_divergence(model, prompt, list(got), list(want))
    (fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
     fa.FLASH_BWD_DKV_LAUNCHES) = saved
    check(tie is None or tie[1] <= NEAR_TIE, f"{label}: tokens part beyond "
          f"a near-tie at (position, logit gap) {tie}")
    return tie


def count_prefills(*gens):
    return sum(g.prefill_calls * g.config.num_layers
               for g in {id(g): g for g in gens}.values())


def serving_models(device, cfg=None, draft_cfg=None):
    """OPT-1.3B (seed 0, ``SERVING_REST_LAYERS`` layers) and OPT-125M
    (seed 1), bf16, flash attention."""
    cfg = cfg or dataclasses.replace(
        config_from_opt_spec("1.3b", dtype=torch.bfloat16,
                             attention_impl="flash"),
        num_layers=SERVING_REST_LAYERS)
    draft_cfg = draft_cfg or config_from_opt_spec(
        "125m", dtype=torch.bfloat16, attention_impl="flash")
    model = GPTModel(cfg, device=device)
    init_random_(model, SEED)
    draft = GPTModel(draft_cfg, device=device)
    init_random_(draft, 1)
    return cfg, model, draft_cfg, draft


def phase_speculative(device, cfg, model, draft_cfg, draft_model):
    """19a-b: greedy speculation with the draft and with the target as
    its own draft against plain greedy ``generate``, a sampled run, beam
    search with 1 and 4 beams.  Returns the launches of each path."""
    label = "serving rest (a)"
    card = card_line()
    gen = Generator(model, cfg, device=device)
    dgen = Generator(draft_model, draft_cfg, device=device)
    rng = np.random.default_rng(SEED + 19)
    lengths = rng.integers(32, 481, SPEC_PROMPTS)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    greedy = GenerationConfig(max_new_tokens=SPEC_NEW_TOKENS)
    # warm-up: each path once (cuBLAS handles, the allocator)
    gen.generate(prompts[0][None], GenerationConfig(max_new_tokens=4))
    gen.generate_speculative(dgen, prompts[0], GenerationConfig(
        max_new_tokens=8), num_draft=SPEC_DRAFT)
    plain, plain_s = [], 0.0
    for p in prompts:
        sync(device)
        tic = time.perf_counter()
        plain.append(gen.generate(p[None], greedy)[0][len(p):])
        sync(device)
        plain_s += time.perf_counter() - tic
    reset_launch_counts()
    calls0 = {k: (g.prefill_calls, g.decode_calls, g.verify_calls)
              for k, g in (("target", gen), ("draft", dgen))}
    rows = {}
    for name, drafter in (("opt-125m draft", dgen), ("self draft", gen)):
        stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        forwards0 = gen.prefill_calls + gen.decode_calls + gen.verify_calls
        if drafter is gen:
            forwards0 = gen.prefill_calls + gen.verify_calls
        secs, ties = 0.0, []
        for p, want in zip(prompts, plain):
            sync(device)
            tic = time.perf_counter()
            out, st = gen.generate_speculative(drafter, p, greedy,
                                               num_draft=SPEC_DRAFT)
            sync(device)
            secs += time.perf_counter() - tic
            for k in stats:
                stats[k] += st[k]
            tie = same_or_near_tie(model, p, out[len(p):], want,
                                   f"{label} {name}")
            if tie is not None:
                ties.append(tie)
        # target forwards: prefills, verify legs and plain decodes (a
        # self-draft's decodes are the draft's, not counted)
        forwards = gen.prefill_calls + gen.verify_calls - forwards0
        if drafter is not gen:
            forwards += gen.decode_calls
        tokens = SPEC_PROMPTS * SPEC_NEW_TOKENS
        rows[name] = (stats, forwards / tokens, secs / tokens * 1e3, ties)
        print(f"{label} {name}: {SPEC_PROMPTS} prompts of {sorted(lengths)} "
              f"tokens, {SPEC_NEW_TOKENS} greedy new tokens, num_draft "
              f"{SPEC_DRAFT}: {stats}, acceptance "
              f"{stats['accepted'] / max(1, stats['proposed']):.4f}, target "
              f"forwards per token {forwards / tokens:.4f}, "
              f"{secs / tokens * 1e3:.3f} ms per token [{card}]; tokens equal "
              f"plain greedy for {SPEC_PROMPTS - len(ties)} of "
              f"{SPEC_PROMPTS}, parted at (position, logit gap) {ties}")
    self_stats = rows["self draft"][0]
    accept = self_stats["accepted"] / max(1, self_stats["proposed"])
    check(accept >= SELF_DRAFT_MIN_ACCEPT, f"{label}: the target as its own "
          f"draft accepted {accept:.4f} of its proposals")
    print(f"{label} plain greedy decode: {plain_s / (SPEC_PROMPTS * SPEC_NEW_TOKENS) * 1e3:.3f} "
          f"ms per token (the same prompts, B=1) [{card}]")
    sampled = GenerationConfig(max_new_tokens=SPEC_NEW_TOKENS,
                               do_sample=True, temperature=0.8, top_k=50)
    out, st = gen.generate_speculative(dgen, prompts[0], sampled,
                                       num_draft=SPEC_DRAFT, seed=SEED)
    again, _ = gen.generate_speculative(dgen, prompts[0], sampled,
                                        num_draft=SPEC_DRAFT, seed=SEED)
    new = out[len(prompts[0]):]
    check(len(new) == SPEC_NEW_TOKENS and (0 <= new).all() and
          (new < cfg.vocab_size).all() and np.array_equal(out, again),
          f"{label}: the sampled run gave {len(new)} tokens or differed "
          "under one seed")
    print(f"{label} sampled (temperature 0.8, top-k 50, seed {SEED}): "
          f"{st}, acceptance {st['accepted'] / max(1, st['proposed']):.4f}, "
          f"reproducible under its seed")
    launches_spec = launch_counts()
    target_prefills = gen.prefill_calls - calls0["target"][0]
    draft_prefills = dgen.prefill_calls - calls0["draft"][0]
    check(launches_spec == (cfg.num_layers * target_prefills +
                            draft_cfg.num_layers * draft_prefills, 0, 0),
          f"{label}: flash launches {launches_spec} for {target_prefills} "
          f"target and {draft_prefills} draft prefill calls")
    # 19b: beam search
    label = "serving rest (b)"
    p = prompts[0]
    want = gen.generate(p[None], GenerationConfig(
        max_new_tokens=BEAM_NEW_TOKENS))[0]
    gen.generate_beam(p, num_beams=4, max_new_tokens=4)     # warm-up
    reset_launch_counts()
    prefills0 = gen.prefill_calls
    times = {}
    for beams in (1, 4):
        sync(device)
        tic = time.perf_counter()
        out = gen.generate_beam(p, num_beams=beams,
                                max_new_tokens=BEAM_NEW_TOKENS)
        sync(device)
        times[beams] = time.perf_counter() - tic
        check(out.shape == (1, len(p) + BEAM_NEW_TOKENS) and
              np.array_equal(out[0, :len(p)], p), f"{label}: beam search "
              f"with {beams} beams returned {out.shape}")
        if beams == 1:
            tie = same_or_near_tie(model, p, out[0, len(p):],
                                   want[len(p):], f"{label} beams=1")
    launches_beam = launch_counts()
    prefills = gen.prefill_calls - prefills0
    check(launches_beam == (cfg.num_layers * prefills, 0, 0) and
          prefills == 2, f"{label}: flash launches {launches_beam} for "
          f"{prefills} prefill calls (one per search)")
    print(f"{label}: a {len(p)}-token prompt, {BEAM_NEW_TOKENS} new tokens: "
          f"1 beam {times[1]:.3f} s (== greedy: {tie is None}, parted at "
          f"{tie}), 4 beams {times[4]:.3f} s; one prefill per search, "
          f"flash launches {launches_beam} [{card}]")
    return launches_spec, launches_beam


class CountingHandle:
    """A replica handle that counts the requests placed on it."""

    def __init__(self, inner):
        self.inner = inner
        self.placed = 0

    def completions(self, request):
        self.placed += 1
        return self.inner.completions(request)

    def completions_stream(self, request):
        self.placed += 1
        return self.inner.completions_stream(request)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def phase_disagg(device, cfg, model):
    """19c: a prefill and a decode controller in this process, behind a
    router in ``forced`` disaggregation, against the monolithic paged
    engine on phase 4b's request mix.  Returns the launches."""
    from alpa_tpu_torch.serve import Controller, LocalReplicaHandle, Router
    from alpa_tpu_torch.serve import disagg
    from alpa_tpu_torch.pipeline_parallel import reshard_codec
    label = "serving rest (c)"
    card = card_line()
    rng = np.random.default_rng(SEED + 4)
    system = rng.integers(0, cfg.vocab_size, ENGINE_PREFIX)
    suffix_lens = rng.integers(32, 481, ENGINE_REQUESTS)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
               for n in suffix_lens]
    saved = (global_config.kv_paged, global_config.kv_prefix_reuse,
             global_config.kv_block_size)
    global_config.kv_paged = global_config.kv_prefix_reuse = True
    global_config.kv_block_size = 16
    gcfg = GenerationConfig(max_new_tokens=DISAGG_NEW_TOKENS)
    mono_gen = Generator(model, cfg, prefill_chunk=ENGINE_CHUNK,
                         device=device)
    pool = KVBlockPool.for_generator(mono_gen, block_size=16)
    mono = ContinuousBatchingEngine(mono_gen, max_batch=ENGINE_ROWS,
                                    prompt_bucket=cfg.seq_len, kv_pool=pool)
    try:
        pool.warm_prefix(mono_gen, system)
        with mono._cv:
            streams = [mono.submit_stream(p, gcfg) for p in prompts]
        want = [list(s) for s in streams]
    finally:
        mono.shutdown()
    del mono, pool
    gc.collect()
    cp, cd = Controller(device=device), Controller(device=device)
    pgen = Generator(model, cfg, prefill_chunk=ENGINE_CHUNK, device=device)
    dgen = Generator(model, cfg, prefill_chunk=ENGINE_CHUNK, device=device)
    stage = {"prefill": [], "ingest": [], "bytes": []}
    try:
        cp.register_model("opt", pgen, prefix_ids=system)
        cd.register_model("opt", dgen, prefix_ids=system)
        router = Router(disagg_mode="forced")
        router.add_replica("p0", LocalReplicaHandle(cp), phase="prefill")
        router.add_replica("d0", LocalReplicaHandle(cd), phase="decode")
        body = {"model": "opt", "max_new_tokens": DISAGG_NEW_TOKENS}
        # warm-up: builds both engines; the decode engine captures here
        list(router.submit_stream(dict(body, prompt_ids=prompts[0][:300]
                                       .tolist())))
        engine = cd._models["opt"][0].engine

        def timing(key):
            def make(orig):
                def call(self, *args, **kwargs):
                    tic = time.perf_counter()
                    out = orig(self, *args, **kwargs)
                    stage[key].append(time.perf_counter() - tic)
                    if key == "prefill":
                        stage["bytes"].append(out[1]["payload_nbytes"])
                    return out
                return call
            return make
        reset_launch_counts()
        prefills0, dprefills0 = pgen.prefill_calls, dgen.prefill_calls
        results = [None] * len(prompts)
        errors = []

        def one(i):
            try:
                results[i] = list(router.submit_stream(
                    dict(body, prompt_ids=prompts[i].tolist())))
            except Exception as e:  # pylint: disable=broad-except
                errors.append(e)
        tic = time.perf_counter()
        with wrapped(Router, "_disagg_prefill", timing("prefill")), \
                wrapped(Router, "_disagg_ingest", timing("ingest")):
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        wall = time.perf_counter() - tic
        launches = launch_counts()
        check(not errors and all(r is not None for r in results),
              f"{label}: a disaggregated stream failed: {errors[:1]}")
        same = sum(r == w for r, w in zip(results, want))
        print(f"{label}: {len(prompts)} streams ({ENGINE_PREFIX}-token warmed "
              f"prefix + {sorted(suffix_lens)}), {DISAGG_NEW_TOKENS} greedy "
              f"new tokens: disaggregated == monolithic paged engine for "
              f"{same} of {len(prompts)}; {router.disagg_handoffs} handoffs, "
              f"decode engine captures {engine.decode_captures}, step "
              f"failures {engine.step_failures}, prefill-side prefix hits "
              f"{cp._models['opt'][0]._prefill_engine.pool.stats()['prefix_hits']}")
        check(same == len(prompts), f"{label}: disaggregated streams differ "
              "from the monolithic engine's")
        check(engine.decode_captures == (1 if engine._capture else 0) and
              engine.step_failures == 0, f"{label}: the decode engine "
              f"captured {engine.decode_captures} times")
        prefills = pgen.prefill_calls - prefills0
        check(launches == (cfg.num_layers * prefills, 0, 0) and
              dgen.prefill_calls == dprefills0, f"{label}: flash launches "
              f"{launches} for {prefills} prefill-side prefill calls, "
              f"{dgen.prefill_calls - dprefills0} on the decode side")
        nbytes = np.asarray(stage["bytes"], np.float64)
        print(f"{label} handoff [{card}]: prefill + artifact (router-side "
              f"call) mean {np.mean(stage['prefill']):.4f} s max "
              f"{max(stage['prefill']):.4f} s; ingest (check, land, join) "
              f"mean {np.mean(stage['ingest']):.4f} s max "
              f"{max(stage['ingest']):.4f} s; artifact payload mean "
              f"{nbytes.mean() / 2**20:.2f} MiB, total "
              f"{nbytes.sum() / 2**20:.2f} MiB; {len(prompts)} streams in "
              f"{wall:.3f} s")
        # a corrupt wire copy: refused, re-fetched, decoded right
        st = router._replicas["d0"]
        real = st.handle
        flips = []

        class Corrupting:
            def __getattr__(self, name):
                if name != "ingest":
                    return getattr(real, name)

                def ingest(wire):
                    if not flips:
                        flips.append(wire["request_id"])
                        wire = dict(wire, block_hashes=["f" * 64] +
                                    wire["block_hashes"][1:])
                    return real.ingest(wire)
                return ingest
        st.handle = Corrupting()
        reingests0 = router.disagg_reingests
        again = list(router.submit_stream(dict(
            body, prompt_ids=prompts[1].tolist())))
        st.handle = real
        # the prompt's own blocks now hit too: its suffix prefill starts
        # later than the monolithic engine's, so phase 4b's near-tie rule
        check(flips and router.disagg_reingests == reingests0 + 1,
              f"{label}: the corrupt artifact was not refused and "
              "re-fetched")
        same_or_near_tie(model, prompts[1], again, want[1],
                         f"{label} re-fetched")
        print(f"{label} corrupt artifact: refused (ArtifactCorruptError), "
              f"re-fetched and decoded; reingests "
              f"{router.disagg_reingests - reingests0}")
        # the int8 handoff of one prompt against the verbatim one, both
        # prefilled on the same path (fresh pools, a miss)
        arts = {}
        for codec in ("off", "int8"):
            small = KVBlockPool(cfg, num_blocks=64, block_size=16,
                                device=device)
            pe = disagg.PrefillEngine(pgen, kv_pool=small, codec=codec,
                                      model="opt")
            try:
                arts[codec] = disagg.KVHandoffArtifact.from_wire(
                    pe.prefill(prompts[2], gcfg).to_wire())
            finally:
                pe.shutdown()
        raw, art8 = arts["off"], arts["int8"]
        worst = 0.0
        for i, lay in enumerate(raw.layers):
            tail = tuple(lay["k"].shape[2:])
            for got, ref in zip(art8.dense_rows(i, tail), (lay["k"], lay["v"])):
                ref = ref.reshape((-1,) + tail).float()
                worst = max(worst, float((got.float() - ref).abs().max()) /
                            (float(ref.abs().max()) or 1.0))
        bound8 = 4 * reshard_codec.ERROR_BOUND["int8"]
        print(f"{label} int8 handoff: payload {art8.payload_nbytes} bytes "
              f"against {raw.payload_nbytes} verbatim "
              f"({raw.payload_nbytes / art8.payload_nbytes:.3f}x fewer); "
              f"largest error {worst:.3e} of a layer's largest magnitude "
              f"(bound {bound8:.3e})")
        check(worst <= bound8, f"{label}: int8 handoff error {worst}")
    finally:
        cp.shutdown()
        cd.shutdown()
        (global_config.kv_paged, global_config.kv_prefix_reuse,
         global_config.kv_block_size) = saved
    return launches


def phase_router(device, cfg, model):
    """19d: ``RouterServer`` over two local replicas and one
    ``HTTPReplicaHandle`` to a controller on localhost: concurrent batched
    and streamed requests against one replica's tokens, a rolling reload
    under traffic, a replica's health dropped and restored.  Returns the
    launches."""
    import copy
    import os
    import shutil
    import tempfile
    from alpa_tpu_torch.checkpoint import CheckpointManager
    from alpa_tpu_torch.serve import (Controller, HTTPReplicaHandle,
                                      LocalReplicaHandle, Router,
                                      RouterServer)
    from alpa_tpu_torch.serve import router as router_mod
    label = "serving rest (d)"
    card = card_line()
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, cfg.vocab_size, n)
               for n in rng.integers(32, 481, 8)]
    ref_gen = Generator(model, cfg, device=device)
    gcfg = GenerationConfig(max_new_tokens=ROUTER_NEW_TOKENS)
    want = [ref_gen.generate(p[None], gcfg)[0][len(p):].tolist()
            for p in prompts]
    gens = [Generator(copy.deepcopy(model), cfg, device=device)
            for _ in range(3)]
    locals_ = [Controller(device=device) for _ in range(2)]
    remote = run_controller(port=0, device=device)
    root = tempfile.mkdtemp(prefix="alpa_port_router_")
    server = None
    try:
        for c, g in zip(locals_ + [remote.controller], gens):
            c.register_model("opt", g)
        handles = {"local0": CountingHandle(LocalReplicaHandle(locals_[0])),
                   "local1": CountingHandle(LocalReplicaHandle(locals_[1])),
                   "remote": CountingHandle(HTTPReplicaHandle(
                       f"http://127.0.0.1:{remote.port}", timeout=600))}
        router = Router(policy="least_loaded")
        for name, h in handles.items():
            router.add_replica(name, h)
        server = RouterServer(router, port=0)
        server.start()
        body = {"model": "opt", "max_new_tokens": ROUTER_NEW_TOKENS}
        for i in range(3):      # warm-up: each replica's batcher and engine
            post(server.port, dict(body, prompt_ids=prompts[i].tolist()))
            read_sse(server.port, dict(body, prompt_ids=prompts[i].tolist()),
                     [])
        for h in handles.values():
            h.placed = 0
        reset_launch_counts()
        prefills0 = sum(g.prefill_calls for g in gens)
        results = [None] * ROUTER_REQUESTS
        errors = []

        def one(i):
            p = prompts[i % len(prompts)]
            try:
                if i % 2:
                    tokens, final = read_sse(server.port, dict(
                        body, prompt_ids=p.tolist()), [])
                    check(final == {"done": True}, f"stream ended {final}")
                    results[i] = tokens
                else:
                    results[i] = post(server.port, dict(
                        body, prompt_ids=p.tolist()))[len(p):]
            except Exception as e:  # pylint: disable=broad-except
                errors.append(e)
        tic = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(ROUTER_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - tic
        launches = launch_counts()
        check(not errors and all(r is not None for r in results),
              f"{label}: a routed request failed: {errors[:1]}")
        ties = []
        for i, got in enumerate(results):
            p = prompts[i % len(prompts)]
            tie = same_or_near_tie(model, p, got, want[i % len(prompts)],
                                   label)
            if tie is not None:
                ties.append(tie)
        split = {n: h.placed for n, h in handles.items()}
        prefills = sum(g.prefill_calls for g in gens) - prefills0
        print(f"{label}: {ROUTER_REQUESTS} concurrent requests (half over "
              f"SSE) through RouterServer, {ROUTER_NEW_TOKENS} greedy new "
              f"tokens, in {wall:.3f} s [{card}]; placement {split}; equal "
              f"to one replica's tokens for {ROUTER_REQUESTS - len(ties)}, "
              f"parted at (position, logit gap) {ties}; flash launches "
              f"{launches} for {prefills} prefill calls")
        check(sum(split.values()) == ROUTER_REQUESTS and
              sum(1 for v in split.values() if v) >= 2,
              f"{label}: placement {split}")
        check(launches == (cfg.num_layers * prefills, 0, 0),
              f"{label}: flash launches {launches} for {prefills} prefills")
        # a rolling reload under traffic (the same weights: tokens stay)
        disk_room(root, 2 * tensor_bytes(dict(model.state_dict())), label)
        mgr = CheckpointManager(os.path.join(root, "ck"), async_save=False)
        mgr.save(1, dict(model.state_dict()))
        stop = threading.Event()
        served, errors = [], []

        def hammer(stream):
            i = 0
            while not stop.is_set():
                p = prompts[i % len(prompts)]
                i += 1
                try:
                    if stream:
                        got, final = read_sse(server.port, dict(
                            body, prompt_ids=p.tolist()), [])
                        check(final == {"done": True}, f"stream {final}")
                    else:
                        got = post(server.port, dict(
                            body, prompt_ids=p.tolist()))[len(p):]
                    served.append((p, got, want[(i - 1) % len(prompts)]))
                except Exception as e:  # pylint: disable=broad-except
                    errors.append(e)
                    return
        threads = [threading.Thread(target=hammer, args=(s,))
                   for s in (False, True, True)]
        for t in threads:
            t.start()
        tic = time.perf_counter()
        try:
            reload_out = json.loads(urllib.request.urlopen(
                urllib.request.Request(
                    f"http://127.0.0.1:{server.port}/admin/rolling_reload",
                    data=json.dumps({"model": "opt", "ckpt_dir": os.path.join(
                        root, "ck")}).encode(),
                    headers={"Content-Type": "application/json"}),
                timeout=600).read())
            reload_s = time.perf_counter() - tic
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=600)
        for p, got, w in served:
            same_or_near_tie(model, p, got, w, f"{label} during the reload")
        print(f"{label} rolling reload: {[r['replica'] for r in reload_out['reloads']]} "
              f"in {reload_s:.3f} s under traffic; {len(served)} requests "
              f"served during it, errors {len(errors)}")
        check(not errors and len(reload_out["reloads"]) == 3,
              f"{label}: the rolling reload saw errors {errors[:1]}")
        # one replica's health dropped and restored
        locals_[1].set_health("shedding", "drill")
        probes = [router.probe() for _ in range(
            router.health_fail_threshold)]
        placed0 = handles["local1"].placed
        for p in prompts[:4]:
            post(server.port, dict(body, prompt_ids=p.tolist()))
        dropped = handles["local1"].placed - placed0
        locals_[1].set_health("ok", "drill over")
        restored = router.probe()
        print(f"{label} health: probes {probes} -> restored {restored}; "
              f"requests placed on the dropped replica {dropped}")
        check(probes[-1]["local1"] is False and dropped == 0 and
              restored["local1"] is True, f"{label}: health drop and "
              f"restore: {probes}, {dropped}, {restored}")
        ok = {n: router_mod._ROUTER_REQS.labels(n, "ok").value
              for n in handles}
        print(f"{label} metrics: alpa_router_requests_total ok by replica "
              f"{ok}")
    finally:
        if server is not None:
            server.shutdown()
        remote.shutdown()
        for c in locals_:
            c.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_weight_loading(device, cfg, model):
    """19e: the target's weights through ``save_params_dir`` and
    ``load_params_dir`` (the JAX package's layout, fp32 files) under a
    temporary directory, served again.  Returns the launches."""
    import shutil
    import tempfile
    from alpa_tpu_torch.model.weight_loading import (load_params_dir,
                                                     save_params_dir)
    label = "serving rest (e)"
    card = card_line()
    root = tempfile.mkdtemp(prefix="alpa_port_params_")
    try:
        n_params = sum(p.numel() for p in model.parameters())
        disk_room(root, 4 * n_params + (1 << 30), label)
        tic = time.perf_counter()
        save_params_dir(model, root)
        save_s = time.perf_counter() - tic
        tic = time.perf_counter()
        loaded_sd = load_params_dir(root, dtype=cfg.dtype, device=device)
        sync(device)
        load_s = time.perf_counter() - tic
        loaded = GPTModel(cfg, device=device)
        loaded.load_state_dict(loaded_sd)
        del loaded_sd
        own = model.state_dict()
        check(all(torch.equal(t, own[k]) for k, t in
                  loaded.state_dict().items()), f"{label}: a weight differs "
              "after the round trip")
        p = np.random.default_rng(SEED + 21).integers(0, cfg.vocab_size, 200)
        gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
        want = Generator(model, cfg, device=device).generate(p[None], gcfg)
        reset_launch_counts()
        gen = Generator(loaded, cfg, device=device)
        got = gen.generate(p[None], gcfg)
        launches = launch_counts()
        check(np.array_equal(got, want), f"{label}: tokens differ after the "
              "round trip")
        check(launches == (cfg.num_layers * gen.prefill_calls, 0, 0),
              f"{label}: flash launches {launches}")
        print(f"{label}: {n_params} parameters saved in {save_s:.3f} s and "
              f"loaded onto {device} in {load_s:.3f} s (fp32 files, "
              f"{4 * n_params / 2**30:.2f} GiB, page cache warm); weights "
              f"bit-equal, {NEW_TOKENS} greedy tokens equal [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del loaded
    return launches


def phase_serving_rest(device="cuda", cfg=None, draft_cfg=None):
    """Phase 19, the rest of serving (19a-e).  Returns the launches of
    each path by name."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    cfg, model, draft_cfg, draft = serving_models(device, cfg, draft_cfg)
    with torch.inference_mode():
        spec, beam = timed("serving rest (a-b)", phase_speculative, device,
                           cfg, model, draft_cfg, draft)
    del draft
    out = {"serving_speculative": spec, "serving_beam": beam}
    out["serving_disagg"] = timed("serving rest (c)", phase_disagg, device,
                                  cfg, model)
    out["serving_router"] = timed("serving rest (d)", phase_router, device,
                                  cfg, model)
    out["serving_weight_loading"] = timed("serving rest (e)",
                                          phase_weight_loading, device, cfg,
                                          model)
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------
# phase 20: the plan analyses
# ---------------------------------------------------------------------

# what phase 20 reads of earlier phases: each pipeshard plan's verdict,
# recorded by the phase that built its executable while it lives (20a);
# the activation codecs' certified and measured errors of phase 16a
# (20b); phase 18c's elastic episode verdict (20d)
PLAN_RECORDS = []
CODEC_RECORDS = {}
ELASTIC_VERDICTS = {}


def strided_scan(programs) -> int:
    """ROADMAP C.8's scan: the (slice, reader) pairs of ``programs``
    (partitioned ``SpmdProgram``s) where a strided local slice reaches an
    op other than mm, bmm, sum, add and add_."""
    from alpa_tpu_torch.shard_parallel.spmd_partition import \
        strided_slice_readers
    return sum(len(strided_slice_readers(p.root)) for p in programs)


def slice_copy_line(label, runs):
    """C.8's cost: the contiguous copies of strided local slices that the
    partitioned programs of ``runs`` (one ``(program, devices)`` per run
    of a program in a step) make per step, and their bytes over the
    devices."""
    copies = sum(p.partitioner_stats["slice_copies"] for p, _ in runs)
    nbytes = sum(p.partitioner_stats["slice_copy_bytes"] * n
                 for p, n in runs)
    print(f"{label} C.8 [{card_line()}]: strided local slices copied "
          f"contiguous per step: {copies} copies, {nbytes} bytes over the "
          f"devices")
    return copies, nbytes


def record_plan(label, ex, measured_peak, pools=None):
    """Phase 20a's record of a pipeshard plan, taken by the phase that built
    ``ex`` while it lives: the verdict its first launch verified (cold:
    the analyses' seconds), the seconds of a second lowering of the same
    program, which replays the verdict from the ``plan_verdict`` cache
    (warm, the lowering included), how many times its fingerprint was
    verified, and the static peak per mesh beside the measured peak."""
    from alpa_tpu_torch import compile_cache
    from alpa_tpu_torch.analysis import plan_verifier
    verdict = ex.get_plan_verdict()
    fp = ex.get_plan_fingerprint()
    cache = compile_cache.get_compile_cache()

    def hits():
        return cache.stats()["namespaces"].get("plan_verdict", {}).get(
            "hits", 0)

    before = hits()
    context = dataclasses.replace(ex._plan_context(), plan_fingerprint=None)
    tic = time.perf_counter()
    ex._lower_for_analysis(ex.instructions, ex.verified_mode or "registers",
                           context)
    warm = time.perf_counter() - tic
    captured = ex._captured.programs if ex._captured is not None else {}
    PLAN_RECORDS.append({
        "label": label, "fingerprint": fp, "mode": ex.verified_mode,
        "verdict": verdict, "warm_s": warm, "warm_hit": hits() > before,
        "verifications": plan_verifier.verification_counts.get(fp, 0),
        "lowerings": len(ex._register_programs) + len(captured),
        "captures": ex.capture_count, "measured_peak": measured_peak,
        "pools": pools})


def by_code(findings):
    out = {}
    for f in findings:
        out[(f.analysis, f.code)] = out.get((f.analysis, f.code), 0) + 1
    return {f"{a}/{c}": n for (a, c), n in sorted(out.items())}


def phase_plan_verdicts():
    """Phase 20a: the verdict of each pipeshard plan phases 8, 8b, 10, 11
    and 16 ran, as recorded while their executables lived."""
    card = card_line()
    for r in PLAN_RECORDS:
        v = r["verdict"]
        check(v is not None, f"plan analyses {r['label']}: no verdict")
        st = v.stats
        mc = st.get("model_check")
        mc_text = (f"model check {mc['semantics']}, {mc['states']} states, "
                   f"partial {mc['partial']}" if mc else
                   f"model check skipped ({st['n_ops']} ops > "
                   f"FIXTURE_MAX_OPS)")
        num, eq = st.get("numerics", {}), st.get("equiv", {})
        peaks = {m: b / 2**30 for m, b in st["peak_bytes"].items()}
        print(f"plan analyses {r['label']} [{card}]: plan "
              f"{r['fingerprint'][:12]} ({r['mode']}), {st['n_ops']} ops "
              f"{st['by_opcode']}, ok {v.ok}; errors {by_code(v.errors)}, "
              f"warnings {by_code(v.warnings)}, notes {by_code(v.notes)}; "
              f"verified {r['verifications']} time(s) over "
              f"{r['lowerings']} lowerings and {r['captures']} capture(s); "
              f"cold {st['verify_seconds']:.4f} s (the analyses), warm "
              f"{r['warm_s']:.4f} s (a lowering that replays the verdict "
              f"from the cache: hit {r['warm_hit']}); {mc_text}; numerics "
              f"largest composed bound {num.get('max_error_bound', 0.0):.6g}"
              f"; equivalence {eq.get('n_proved', 0)}/"
              f"{eq.get('n_outputs', 0)} outputs proved, "
              f"{eq.get('n_terms', 0)} terms; static peak per mesh "
              + ", ".join(f"{m}: {g:.3f} GiB" for m, g in sorted(
                  peaks.items())) +
              f" (sum {sum(peaks.values()):.3f} GiB) vs the measured "
              f"allocated peak {r['measured_peak'] / 2**30:.3f} GiB"
              + (f" + the graphs' pools {r['pools'] / 2**30:.3f} GiB"
                 if r["pools"] else ""))
        check(v.ok, f"plan analyses {r['label']}: error findings "
              f"{[(f.code, f.message) for f in v.errors][:3]}")
        check(r["verifications"] == 1, f"plan analyses {r['label']}: "
              f"verified {r['verifications']} times")
        check(r["warm_hit"], f"plan analyses {r['label']}: the second "
              f"lowering did not replay the verdict")
    check(len(PLAN_RECORDS) >= 5, f"plan analyses: {len(PLAN_RECORDS)} "
          f"plans recorded, want phases 8, 8b, 10, 11 and 16")


def phase_codec_bounds():
    """Phase 20b: phase 16a's quantized edges, the numerics certification's
    largest composed bound against the worst element error 16a measured
    (both as a fraction of the block's largest magnitude)."""
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import ERROR_BOUND
    check(set(CODEC_RECORDS) == {"int8", "fp8"},
          f"codec bounds: recorded {sorted(CODEC_RECORDS)}")
    for mode, (certified, worst_ratio, lossy) in sorted(
            CODEC_RECORDS.items()):
        measured = worst_ratio * ERROR_BOUND[mode]
        print(f"plan analyses codec {mode} [{card_line()}]: phase 16a's "
              f"plan, lossy hops {lossy}, certified largest composed bound "
              f"{certified:.6g} ({certified / ERROR_BOUND[mode]:.6f} of the "
              f"per-hop bound {ERROR_BOUND[mode]:.6g}) vs the worst element "
              f"error measured {measured:.6g} ({worst_ratio:.6f} of the "
              f"per-hop bound)")
        check(certified >= measured, f"codec {mode}: certified bound "
              f"{certified} under the measured error {measured}")


def superopt_steps(cfg, batch, deoptimize, steps=2):
    """Phase 8's configuration from the seed state: ``steps`` steps (the
    first runs the stage graphs as they are, the second captures and
    replays them), with the instruction list replaced by its deoptimized
    order first when ``deoptimize``; then one more step timed by CUDA
    events on the launching stream.  Returns the losses, the parameters on
    the host, the executable, the step's device milliseconds and the
    step function and state (for 20d)."""
    from alpa_tpu_torch.analysis import superopt
    state = train_state(cfg)
    step = make_train_step(pipeshard_method(4))
    ex, _ = step.get_executable(state, batch)
    if deoptimize:
        ex._set_instructions(superopt.deoptimize_instructions(
            list(ex.instructions)), as_baseline=True)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(loss)
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    losses = [x.detach().cpu() for x in losses]
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    state, loss = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return losses, params, ex, start.elapsed_time(end), step, state


def phase_superopt():
    """Phase 20c: the superoptimizer on phase 8's configuration.  Under
    "suggest" on the plan as compiled: the simulated critical-path and
    peak ratios of the best rewrite; its two steps are the baseline.  Then
    the plan's list deoptimized (hazard-legal, ``deoptimize_instructions``)
    under "auto": the rewrite searched, gated and run, CUDA graphs captured
    from the rewritten list; losses and every parameter after two steps
    bit-identical to the baseline's.  A second decision on the same plan
    replays the rewrite from the ``superopt`` cache with zero search.
    Returns the flash launches of these steps, the "auto" executable, its
    step and state (for 20d)."""
    from alpa_tpu_torch import compile_cache
    cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in lm_batch(cfg, 8).items()}
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    with knobs(superopt_mode="suggest"):
        base_losses, base_params, ex, base_ms, step, state = superopt_steps(
            cfg, batch, deoptimize=False)
        out = ex._superopt_outcome
        base_pool = ex.get_graph_pool_bytes() or 0
        b, w = out.baseline_score, out.best_score
        print(f"superopt suggest [{card}]: phase 8's plan "
              f"({len(ex.instructions)} instructions), searched "
              f"{out.searched}, accepted {out.accepted}; simulated critical "
              f"path {b.makespan_us:.1f} -> {w.makespan_us:.1f} us (ratio "
              f"{w.makespan_us / max(b.makespan_us, 1e-9):.4f}), simulated "
              f"peak {b.total_peak / 2**30:.3f} -> {w.total_peak / 2**30:.3f}"
              f" GiB (ratio {w.total_peak / max(b.total_peak, 1e-9):.4f}); "
              f"the baseline list runs: step device time {base_ms:.3f} ms, "
              f"graph pools {base_pool / 2**30:.3f} GiB")
    del ex, step, state
    gc.collect()
    torch.cuda.empty_cache()
    with knobs(superopt_mode="auto"):
        losses, params, ex, ms, step, state = superopt_steps(
            cfg, batch, deoptimize=True)
        out = ex._superopt_outcome
        pool = ex.get_graph_pool_bytes() or 0
        same = [k for k in base_params
                if not torch.equal(params[k], base_params[k])]
        bitwise = all(torch.equal(a, b_) for a, b_ in zip(losses,
                                                          base_losses))
        clones = sum(1 for e in out.layout if not isinstance(e, int) and
                     e[0] == "clone")
        print(f"superopt auto [{card}]: the deoptimized list searched "
              f"{out.searched}, accepted {out.accepted} (rejected by "
              f"{out.rejected}); simulated critical path "
              f"{out.baseline_score.makespan_us:.1f} -> "
              f"{out.best_score.makespan_us:.1f} us, simulated peak "
              f"{out.baseline_score.total_peak / 2**30:.3f} -> "
              f"{out.best_score.total_peak / 2**30:.3f} GiB; recompute "
              f"clones {clones}; CUDA graphs captured "
              f"{ex.capture_count} time(s) from the rewritten list; step "
              f"device time {ms:.3f} ms vs the baseline list's "
              f"{base_ms:.3f} ms; graph pools {pool / 2**30:.3f} vs "
              f"{base_pool / 2**30:.3f} GiB; losses "
              f"{[float(x) for x in losses]} vs "
              f"{[float(x) for x in base_losses]}: bit-identical {bitwise}"
              f", parameters differing {len(same)} of {len(base_params)}")
        check(out.accepted and ex.instructions == list(out.instructions),
              f"superopt auto: the rewrite was not run ({out.rejected})")
        check(bitwise and not same, f"superopt auto: not bit-identical "
              f"to the baseline ({same[:3]})")
        stats = compile_cache.get_compile_cache().stats()["namespaces"]
        hits = stats.get("superopt", {}).get("hits", 0)
        tic = time.perf_counter()
        mode = ex.verified_mode
        ex._set_instructions(ex.baseline_instructions, as_baseline=True)
        ex.get_plan_verdict(mode)
        replay = ex._superopt_outcome
        replay_s = time.perf_counter() - tic
        # the replayed rewrite runs (and is captured) again
        state, loss = step(state, batch)
        check(bool(torch.isfinite(loss)), f"superopt replay: loss {loss}")
        stats = compile_cache.get_compile_cache().stats()["namespaces"]
        print(f"superopt replay [{card}]: a second decision on the same "
              f"plan: cache hit {replay.cache_hit}, searched "
              f"{replay.searched}, the same rewrite "
              f"{replay.fingerprint == out.fingerprint}, "
              f"{replay_s:.3f} s (lowering and verifying included); the "
              f"namespace's hits {hits} -> "
              f"{stats.get('superopt', {}).get('hits', 0)}")
        check(replay.cache_hit and not replay.searched and
              replay.fingerprint == out.fingerprint,
              "superopt: the second decision searched again")
    return ex, step, state, batch


def phase_verdict_paths(ex, step, state, batch):
    """Phase 20d: the verdict on the ported paths.  Phase 18c's elastic
    episode recorded a real verdict; under ``verify_plans="error"`` a real
    failure (not an ``InjectedFault``) injected at ``stage_launch``, a site
    the model checker classed unsafe, is refused, where "warn" retries
    it; ``dump_debug_info`` writes ``plan_verdict.txt`` and
    ``superopt.txt``."""
    import tempfile
    from alpa_tpu_torch import fault, monitoring
    card = card_line()
    verdict = ELASTIC_VERDICTS.get("18c")
    print(f"plan analyses elastic [{card}]: phase 18c's episode verdict "
          f"{verdict}")
    check(verdict == "checked", f"elastic: episode verdict {verdict}")
    mc = ex.get_plan_verdict().stats.get("model_check")
    if mc is None:
        # beyond FIXTURE_MAX_OPS "fixture" mode skips the model checker, as
        # the JAX package's does: check this plan on demand ("all")
        tic = time.perf_counter()
        with knobs(verify_plans_model_check="all"):
            mc = ex._lower_for_analysis(
                ex.instructions, ex.verified_mode or "registers",
                dataclasses.replace(ex._plan_context(),
                                    plan_fingerprint=None)
            ).verdict.stats["model_check"]
        print(f"plan analyses model check [{card}]: phase 8's plan "
              f"({len(ex.instructions)} instructions, beyond "
              f"FIXTURE_MAX_OPS) checked on demand: {mc['semantics']}, "
              f"{mc['states']} states, partial {mc['partial']}, "
              f"{time.perf_counter() - tic:.3f} s")
    sites = mc["retry_sites"]
    fault.install_retry_classification(sites)
    policy = fault.RetryPolicy(max_attempts=3, base_delay=0.0,
                               max_delay=0.0, jitter=0.0)
    tries = {}
    for mode in ("warn", "error"):
        with knobs(verify_plans=mode), fault.FaultPlan(fault.FaultSpec(
                "stage_launch", times=1,
                exc=lambda: RuntimeError("a real failure"))) as plan:
            fault.set_retry_policy(policy, site="stage_launch")
            try:
                state, loss = step(state, batch)
                raised = None
            except RuntimeError as e:
                raised = e
            finally:
                fault.set_retry_policy(None, site="stage_launch")
            tries[mode] = (plan.fired("stage_launch"),
                           plan.retries.get("stage_launch", 0)
                           if hasattr(plan, "retries") else None,
                           type(raised).__name__ if raised else None)
    print(f"plan analyses retry [{card}]: stage_launch classed "
          f"{sites['stage_launch']['classification']} "
          f"({sites['stage_launch']['reasons']}); a RuntimeError injected "
          f"once at the first RUN: under warn (fired, retried, raised) "
          f"{tries['warn']}, under error {tries['error']}")
    check(sites["stage_launch"]["classification"] == "unsafe",
          f"retry: stage_launch classed {sites['stage_launch']}")
    check(tries["warn"][2] is None and tries["error"][2] == "RuntimeError",
          f"retry: warn {tries['warn']}, error {tries['error']}")
    with tempfile.TemporaryDirectory(prefix="alpa_port_dump_") as d:
        monitoring.dump_debug_info(ex, d)
        import os
        files = sorted(os.listdir(d))
        head = open(os.path.join(d, "plan_verdict.txt"),
                    encoding="utf-8").readline().strip()
    print(f"plan analyses dump [{card}]: dump_debug_info wrote {files}; "
          f"plan_verdict.txt: {head}")
    check({"plan_verdict.txt", "superopt.txt"} <= set(files),
          f"dump: {files}")
    fault.install_retry_classification(None)


def phase_plan_analyses():
    """Phase 20: 20a-d.  Returns the flash launches of 20c's and 20d's
    steps."""
    phase_plan_verdicts()
    phase_codec_bounds()
    reset_launch_counts()
    ex, step, state, batch = phase_superopt()
    phase_verdict_paths(ex, step, state, batch)
    counts = launch_counts()
    del ex, step, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------
# phase 21: serving families and pipelined serving
# ---------------------------------------------------------------------

# the cached decode (rows of one token over the whole cache) against the
# full-context forward: two bf16 paths through 24 layers whose products
# run at other shapes, so their roundings part in the residual stream and
# every logit moves by a share of the logits' scale, small ones too; held
# to 2e-2 of the largest |logit| (five bf16 ulps of it); the same paths
# in fp32 (2 layers) to 1e-4.  A first bound of atol = rtol = 5e-2 per
# element read BLOOM-560m's 6.641e-02 at a logit near 0.1 (max |logit|
# 8.875; NVIDIA H100 80GB HBM3, 700.00 W), where the fp32 paths agree to
# 1.907e-05: the bf16 paths' rounding, not a fault
FAMILY_LOGIT_REL = 2e-2
FAMILY_PREFILL, FAMILY_DECODE = 64, 8


def serving_pipeshard():
    """21a's method: two stages of one device (phase 8's), one
    microbatch, the ``"inference"`` schedule."""
    return PipeshardParallel(devices=stage_devices(), num_micro_batches=1,
                             layer_option=ManualLayerOption(),
                             stage_option=UniformStageOption(num_stages=2),
                             pipeline_schedule="inference")


def family_prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENGTHS]


def timed_generate(gen, prompts):
    """``gen``'s greedy tokens for ``prompts`` (``NEW_TOKENS`` each) and
    the call's ms per new token (prefill included)."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = gen.generate(prompts, GenerationConfig(max_new_tokens=NEW_TOKENS))
    torch.cuda.synchronize()
    return out, (time.perf_counter() - tic) * 1e3 / NEW_TOKENS


def decode_step_ms(gen, b):
    """The device time of one decode call of ``b`` rows (CUDA events over
    20 calls after 3) on ``gen``'s caches, at the per-row index where the
    longest prompt's generation ends."""
    with torch.inference_mode():
        caches = gen._caches(b)
        tok = torch.ones(b, dtype=torch.int64, device="cuda")
        index = torch.full((b,), max(PROMPT_LENGTHS) + NEW_TOKENS,
                           dtype=torch.int64, device="cuda")
        return cuda_ms(lambda: gen._decode(tok, index, caches))


def hold_tokens(model, prompts, got, want, label):
    """Phase 4b's rule row by row; the rows that are equal."""
    same = 0
    for p, g, w in zip(prompts, got, want):
        tie = same_or_near_tie(model, p, list(g[len(p):]),
                               list(w[len(p):]), label)
        same += tie is None
    return same


def phase_pipelined_serving():
    """21a; returns its flash-forward launches."""
    label = "21a pipelined serving"
    gc.collect()
    torch.cuda.empty_cache()
    cfg = config_from_opt_spec("1.3b", dtype=torch.bfloat16,
                               attention_impl="flash",
                               pipeline_boundary_every=12)
    model = GPTModel(cfg, device="cuda")
    init_random_(model, SEED)
    prompts = family_prompts(cfg.vocab_size)
    plain = Generator(model, cfg, device="cuda")
    piped = Generator(model, cfg, device="cuda",
                      parallel_method=serving_pipeshard())
    reset_launch_counts()
    timed_generate(plain, prompts)
    want, plain_ms = timed_generate(plain, prompts)
    plain_launches = launch_counts()[0]
    check(plain_launches == 2 * cfg.num_layers,
          f"{label}: the plain prefills launched {plain_launches} times")
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    outs, times, traces = [], [], []
    for _ in range(3):
        got, ms = timed_generate(piped, prompts)
        outs.append(got)
        times.append(ms)
        traces.append((piped.prefill_traces, piped.decode_traces))
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()[0]
    calls = piped.prefill_calls
    dec, pre = piped.get_executable("decode"), piped.get_executable("prefill")
    traffic = {k: piped.get_cache_traffic(k) for k in ("prefill", "decode")}
    same = [hold_tokens(model, prompts, got, want, label) for got in outs]
    plain_step = decode_step_ms(plain, len(prompts))
    piped_step = decode_step_ms(piped, len(prompts))
    card = card_line()
    print(f"{label}: OPT-1.3B ({cfg.num_layers} layers, bf16, flash, a "
          f"boundary after 12 blocks), {len(prompts)} prompts of "
          f"{PROMPT_LENGTHS} tokens, {NEW_TOKENS} greedy new tokens, "
          f"{dec.num_fwd_stages} stages on {stage_devices()}; rows equal to "
          f"the plain Generator's per call {same} of {len(prompts)} (the "
          f"others part at a near-tie); traces (prefill, decode) after each "
          f"call {traces}; flash-forward launches {launches} over {calls} "
          f"prefill calls; cache traffic per call (RESHARDs, bytes copied) "
          f"{traffic}; decode RESHARDs {dec.get_instruction_counts()}, "
          f"captures {dec.capture_count}, recaptures {dec.recapture_count}; "
          f"prefill captures {pre.capture_count}, recaptures "
          f"{pre.recapture_count}; plan verdicts {pre.get_plan_verdict().ok}, "
          f"{dec.get_plan_verdict().ok}")
    print(f"{label} metrics [{card}]: ms per new token (prefill included) "
          f"plain {plain_ms:.3f}, pipelined per call "
          f"{['%.3f' % t for t in times]}; decode step (B={len(prompts)}, "
          f"CUDA events) plain {plain_step:.3f} ms, pipelined "
          f"{piped_step:.3f} ms; peak allocated over the pipelined calls "
          f"{peak / 2**30:.3f} GiB; trace seconds prefill "
          f"{pre.trace_seconds:.3f}, decode {dec.trace_seconds:.3f}")
    check(traces[1] == traces[0] and traces[2] == traces[0],
          f"{label}: trace counts moved across calls: {traces}")
    check(launches == cfg.num_layers * calls, f"{label}: {launches} "
          f"flash-forward launches over {calls} prefill calls")
    check(all(t == {"reshards": 0, "copied_bytes": 0}
              for t in traffic.values()),
          f"{label}: a step moved or copied a cache: {traffic}")
    check(dec.capture_count == 1 and dec.recapture_count == 0 and
          dec.last_dispatch_stats.get("graphs"),
          f"{label}: decode did not replay one capture: "
          f"{dec.last_dispatch_stats}")
    check(pre.get_plan_verdict().ok and dec.get_plan_verdict().ok,
          f"{label}: a plan failed the verifier")
    del plain, piped, model, dec, pre
    gc.collect()
    torch.cuda.empty_cache()
    return plain_launches + launches


def family_fidelity(make_cfg, model_cls, layers=None):
    """The cached decode (``FAMILY_PREFILL`` tokens prefilled, then
    ``FAMILY_DECODE`` one at a time) against the full-context forward at
    the same positions: the largest |diff|, the largest |logit| and the
    largest violation of atol = rtol = 1e-4."""
    cfg = make_cfg()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = model_cls(cfg, device="cuda")
    init_random_(model, SEED)
    ids = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, FAMILY_PREFILL + FAMILY_DECODE)),
        device="cuda")
    with torch.inference_mode():
        full = model(ids).float()
        logits, caches = model(ids[:, :FAMILY_PREFILL], None,
                               model.init_kv_caches(2, device="cuda"))
        steps = [logits.float()]
        for t in range(FAMILY_PREFILL, FAMILY_PREFILL + FAMILY_DECODE):
            step, caches = model(ids[:, t:t + 1], None, caches)
            steps.append(step.float())
    cached = torch.cat(steps, dim=1)
    diff = float((cached - full).abs().max())
    worst = max_violation(cached, full, atol=1e-4, rtol=1e-4)
    del model, caches
    torch.cuda.empty_cache()
    return diff, float(full.abs().max()), worst


def phase_serving_families():
    """21b; returns nothing (the families run the plain attention)."""
    label = "21b serving families"
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16 = torch.bfloat16
    families = (
        ("BLOOM-560m", lambda dtype=bf16: config_from_bloom_spec(
            "bloom-560m", dtype=dtype, pipeline_boundary_every=12),
         BloomModel),
        ("CodeGen-350M", lambda dtype=bf16: config_from_codegen_spec(
            "codegen-350m", dtype=dtype, pipeline_boundary_every=10),
         CodeGenModel))
    for name, make_cfg, model_cls in families:
        fp32 = family_fidelity(lambda: make_cfg(torch.float32), model_cls,
                               2)
        full = family_fidelity(make_cfg, model_cls)
        cfg = make_cfg()
        print(f"{label}: {name} (hidden {cfg.hidden_size}, "
              f"{cfg.num_layers} layers, {cfg.num_heads} heads): cached "
              f"decode ({FAMILY_PREFILL}-token prefill, {FAMILY_DECODE} "
              f"steps) vs full-context forward, bf16 at full depth max "
              f"|diff| {full[0]:.3e} = {full[0] / full[1]:.3e} of max "
              f"|logit| {full[1]:.3f} (tol {FAMILY_LOGIT_REL}); fp32 at 2 "
              f"layers max |diff| {fp32[0]:.3e}, violation {fp32[2]:.3e} "
              f"(atol 1e-4, rtol 1e-4)")
        check(full[0] <= FAMILY_LOGIT_REL * full[1] and fp32[2] <= 0,
              f"{label}: {name}'s cached decode differs from the "
              f"full-context forward: {full}, {fp32}")
        model = model_cls(cfg, device="cuda")
        init_random_(model, SEED)
        prompts = family_prompts(cfg.vocab_size)
        plain = Generator(model, cfg, device="cuda")
        want, plain_ms = timed_generate(plain, prompts)
        line = f"{label} metrics [{card_line()}]: {name} ms per new token " \
            f"(prefill included, {len(prompts)} prompts of " \
            f"{PROMPT_LENGTHS}) plain {plain_ms:.3f}"
        if model_cls is BloomModel:
            piped = Generator(model, cfg, device="cuda",
                              parallel_method=serving_pipeshard())
            times, same = [], []
            for _ in range(2):
                got, ms = timed_generate(piped, prompts)
                times.append(ms)
                same.append(hold_tokens(model, prompts, got, want, label))
            traffic = piped.get_cache_traffic("decode")
            line += (f", pipelined in 2 stages {['%.3f' % t for t in times]}"
                     f" (rows equal to plain per call {same} of "
                     f"{len(prompts)}; decode cache traffic {traffic})")
            check(traffic == {"reshards": 0, "copied_bytes": 0},
                  f"{label}: {name}'s decode moved or copied a cache: "
                  f"{traffic}")
            del piped
        print(line)
        del plain, model
        gc.collect()
        torch.cuda.empty_cache()


def packed_lm_batch(cfg, batch_size):
    """``lm_batch`` with each row packed: segments of 64-511 tokens, the
    positions restarting at each, the last 16 tokens padding (-1)."""
    batch = lm_batch(cfg, batch_size)
    rng = np.random.default_rng(SEED + 1)
    seg = np.full((batch_size, cfg.seq_len), -1, np.int64)
    pos = np.zeros((batch_size, cfg.seq_len), np.int64)
    for r in range(batch_size):
        start, i = 0, 0
        while start < cfg.seq_len - 16:
            end = min(start + int(rng.integers(64, 512)), cfg.seq_len - 16)
            seg[r, start:end] = i
            pos[r, start:end] = np.arange(end - start)
            start, i = end, i + 1
    batch["segment_ids"], batch["position_ids"] = seg, pos
    return batch


def packed_loss(apply_fn, params, batch):
    logits = apply_fn(params, batch["input_ids"], batch["position_ids"],
                      segment_ids=batch["segment_ids"])
    return cross_entropy_loss(logits.float(), batch["labels"])


def remat_policy_run(label, cfg, batch, method, loss, steps):
    """One Adam step from the seed state eagerly and ``steps`` under the
    pipeshard ``method``: both first losses, the first moment's max |diff|
    / max |mu| per tensor after one step, the replayed steps' time and the
    run's flash launches."""
    state = train_state(cfg)
    ref_step = make_train_step(shard_method(), loss_of=loss)
    state, ref_loss = ref_step(state, batch)
    ref_loss, ref_mu = float(ref_loss), gathered_mu(state)
    del state, ref_step
    gc.collect()
    torch.cuda.empty_cache()
    state = train_state(cfg)
    step = make_train_step(method, loss_of=loss)
    reset_launch_counts()
    state, first = step(state, batch)
    first = float(first)
    mu = max_rel_diff(gathered_mu(state), ref_mu)
    counts = launch_counts()
    times = []
    for _ in range(steps - 1):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        state, loss_t = step(state, batch)
        float(loss_t)
        times.append(time.perf_counter() - tic)
    ex = step.get_last_executable()
    out = dict(loss=first, ref=ref_loss, mu=mu,
               step=min(times) if times else float("nan"),
               trace=ex.trace_seconds, counts=launch_counts(),
               first_counts=counts)
    del state, step, ex
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_pipeshard_remat_policy(phase8):
    """21c; returns its (fwd, dq, dkv) launches."""
    label = "21c pipeshard remat policy and packing"
    total = (0, 0, 0)
    variants = (("dots", dict(remat_blocks=True, remat_policy="dots"),
                 gpt_lm_loss, lm_batch),
                ("packed", dict(remat_blocks=True), packed_loss,
                 packed_lm_batch))
    for name, kw, loss, make_batch in variants:
        cfg = pipeshard_config(pipeline_boundary_every=PIPESHARD_BOUNDARY,
                               **kw)
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in make_batch(cfg, 8).items()}
        run = remat_policy_run(label, cfg, batch, pipeshard_method(4), loss,
                               5)
        rel = abs(run["loss"] - run["ref"]) / abs(run["ref"])
        worst = max(run["mu"], key=run["mu"].get)
        print(f"{label}: {name}, GPT-1.3B at {cfg.num_layers} layers (bf16, "
              f"flash), batch 8 in 4 microbatches, 1F1B: first loss "
              f"{run['loss']:.6f} vs eager {run['ref']:.6f} (relative "
              f"{rel:.3e}, tol 1e-2); first moment max |diff| / max |mu| "
              f"{run['mu'][worst]:.3e} at {worst} (tol "
              f"{TWO_LEVEL_GRAD_TOL}); launches (fwd, dq, dkv) of the first "
              f"step {run['first_counts']}; trace {run['trace']:.3f} s")
        print(f"{label} metrics [{card_line()}]: {name} step "
              f"{run['step']:.5f} s (replayed, best of 4) vs phase 8's "
              f"{phase8['latency']:.5f} s (no remat, unpacked)")
        check(rel <= 1e-2 and run["mu"][worst] <= TWO_LEVEL_GRAD_TOL,
              f"{label}: {name} differs from the eager step")
        if name == "dots":
            want = (2 * cfg.num_layers * 4, cfg.num_layers * 4,
                    cfg.num_layers * 4)
            check(run["first_counts"] == want, f"{label}: dots launches "
                  f"{run['first_counts']}, want {want}")
        total = tuple(a + b for a, b in zip(total, run["counts"]))
    return total


def phase_families(phase8):
    """Phase 21 (a-c): the launches of 21a and of 21c by path."""
    served = timed("serving families (a)", phase_pipelined_serving)
    timed("serving families (b)", phase_serving_families)
    trained = timed("serving families (c)", phase_pipeshard_remat_policy,
                    phase8)
    return {"serving_pipelined": (served, 0, 0),
            "pipeshard_remat_policy": trained}


def timed(name, fn, *args):
    """``fn(*args)``, printing its wall time as the phase's; its start goes
    to standard error too, so that the error stream's end names the phase
    a stopped run was in."""
    print(f"phase start: {name}", file=sys.stderr, flush=True)
    tic = time.perf_counter()
    out = fn(*args)
    print(f"phase time: {name} {time.perf_counter() - tic:.2f} s")
    return out


def main(args) -> int:
    modes = {"--two-cards": lambda: two_cards(),
             "--four-cards": lambda: four_cards()}
    if args and (len(args) != 1 or args[0] not in modes):
        print("usage: chip_smoke.py [--two-cards | --four-cards]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    if not args:
        # a run past its own limit prints every thread's stack to standard
        # error and exits with 1, before the 1200 s it is given run out
        faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    print(f"setup: {card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_kernels()
    if args:
        try:
            modes[args[0]]()
        except SmokeFailure as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    try:
        fwd_entry, fwd_train = timed("kernel", phase_kernel)
        bwd_entries = timed("bwd kernel", phase_bwd_kernel)
        serving = timed("serving", phase_serving)
        engine, fwd_engine = timed("serving engine", phase_engine)
        timed("fidelity", phase_fidelity)
        (train_fwd, train_dq, train_dkv), shard_profile = timed(
            "training", phase_training,
            (fwd_train["ms"], *(e["ms"] for e in bwd_entries)))
        timed("train fidelity", phase_train_fidelity)
        timed("pipeshard fidelity", phase_pipeshard_fidelity)
        timed("pipeshard auto fidelity", phase_pipeshard_auto_fidelity)
        phase8, ref_loss = timed("pipeshard", phase_pipeshard, shard_profile)
        pipe = phase8["counts"]
        remat = timed("pipeshard remat blocks", phase_pipeshard_remat_blocks,
                      shard_profile, phase8)
        auto = timed("pipeshard auto", phase_pipeshard_auto, shard_profile,
                     ref_loss)
        infer = timed("pipeshard infer", phase_pipeshard_infer)
        timed("shard grad-acc fidelity", phase_grad_acc_fidelity)
        acc = timed("shard grad-acc", phase_shard_grad_acc, shard_profile)
        timed("planner", phase_planner)
        timed("spmd fidelity", phase_spmd_fidelity)
        spmd = timed("spmd", phase_spmd, shard_profile)
        timed("two-level fidelity", phase_pipeshard_spmd_fidelity)
        two_level, tiled = timed("two-level", phase_pipeshard_spmd, phase8)
        timed("gradient codec", phase_grad_codec)
        timed("telemetry calibration", phase_calibration, phase8["joined"])
        timed("telemetry compile cache", phase_compile_cache)
        zero2 = timed("faults and state (d)", phase_faults_zero2)
        swap = timed("faults and state (e)", phase_serving_swap)
        rest = timed("serving rest", phase_serving_rest)
        analyses = timed("plan analyses", phase_plan_analyses)
        families = timed("serving families and pipelined serving",
                         phase_families, phase8)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    traced = phase8["traced_counts"]
    faults = tuple(a + b for a, b in zip(phase8["fault_counts"], zero2))
    fwd_entry["launches"] = (serving + engine[0] + train_fwd + pipe[0]
                             + remat[0] + auto[0] + infer + acc[0] + spmd[0]
                             + two_level[0] + tiled[0] + traced[0]
                             + faults[0] + swap[0] + analyses[0]
                             + sum(v[0] for v in rest.values())
                             + sum(v[0] for v in families.values()))
    fwd_entry["launches_by_path"] = {"serving": serving,
                                     "serving_engine": engine[0],
                                     "training": train_fwd,
                                     "pipeshard": pipe[0],
                                     "pipeshard_remat_blocks": remat[0],
                                     "pipeshard_auto": auto[0],
                                     "pipeshard_infer": infer,
                                     "shard_grad_acc": acc[0],
                                     "shard_spmd": spmd[0],
                                     "pipeshard_spmd": two_level[0],
                                     "pipeshard_spmd_tiled": tiled[0],
                                     "pipeshard_traced": traced[0],
                                     "fault_recovery": faults[0],
                                     "serving_swap": swap[0],
                                     "pipeshard_superopt": analyses[0],
                                     **{k: v[0] for k, v in rest.items()},
                                     **{k: v[0] for k, v in
                                        families.items()}}
    fwd_entry["at_training_shape"] = fwd_train
    fwd_entry["at_engine_suffix_shape"] = fwd_engine
    for part, (entry, e, n, p, r, a, g, m, t, b, tr, fr, sw,
               so) in enumerate(zip(
            bwd_entries, engine[1:], (train_dq, train_dkv), pipe[1:],
            remat[1:], auto[1:], acc[1:], spmd[1:], two_level[1:],
            tiled[1:], traced[1:], faults[1:], swap[1:], analyses[1:])):
        served = {k: v[1 + part] for k, v in
                  list(rest.items()) + list(families.items())}
        entry["launches"] = (e + n + p + r + a + g + m + t + b + tr + fr + sw
                             + so + sum(served.values()))
        entry["launches_by_path"] = {"serving_engine": e,
                                     "training": n, "pipeshard": p,
                                     "pipeshard_remat_blocks": r,
                                     "pipeshard_auto": a,
                                     "pipeshard_infer": 0,
                                     "shard_grad_acc": g,
                                     "shard_spmd": m,
                                     "pipeshard_spmd": t,
                                     "pipeshard_spmd_tiled": b,
                                     "pipeshard_traced": tr,
                                     "fault_recovery": fr,
                                     "serving_swap": sw,
                                     "pipeshard_superopt": so, **served}
    faulthandler.cancel_dump_traceback_later()
    print(f"run time: {time.perf_counter() - t_start:.1f} s, the kernels' "
          f"build included")
    print(card_line())
    print(json.dumps({"kernels": [fwd_entry, *bwd_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
