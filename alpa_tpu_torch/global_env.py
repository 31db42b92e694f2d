"""Process-global knobs of the pipeshard runtime, the auto-sharding
planner and serving.

The port's own copy of the knobs of ``alpa_tpu/global_env.py`` that its
pipeshard runtime, its planner and its serving stack read, with the JAX package's names,
environment variables and defaults:

* ``overlap_resharding``: whether dispatch may take the overlap mode, which
  launches cross-mesh RESHARDs as soon as their producers retire.
* ``debug_dispatch_races``: threaded dispatch reports every instruction's
  value accesses to a race checker, which raises on a conflict.
* ``kv_paged``: controller replicas build their streaming engines over a
  ``serve.kv_cache.KVBlockPool``.
* ``kv_block_size``: tokens per KV block (16); it must divide ``seq_len``.
* ``kv_cache_blocks``: the pool's capacity in blocks; 0 sizes it for two
  engine batches of sequences.
* ``kv_prefix_reuse``: full prompt and output blocks are published to a
  hash-chain index, so admissions sharing a token prefix skip them.
* ``router_policy`` ("least_loaded" or "round_robin"),
  ``router_shed_ttft_ms`` (0: off) and ``router_shed_queue_depth`` (64):
  ``serve.router``'s placement and the per-replica saturation it routes
  around; ``router_health_fail_threshold`` (3) failed probes drop a
  replica; ``router_autoscale_window_s`` (30),
  ``router_autoscale_hi_queue`` (8) and ``router_autoscale_lo_queue`` (1):
  the autoscale callbacks' window and mean depths.
* ``disagg_mode`` ("off", "auto" or "forced"): split prefill and decode
  over replica pools (``serve.disagg``); ``disagg_codec`` ("off", "int8",
  "fp8"): the handoff payload's codec; ``disagg_backpressure_depth`` (0:
  off): the decode pool's depth above which new prefills shed;
  ``disagg_ttft_slo_ms`` and ``disagg_itl_slo_ms`` (0: off): the pools'
  SLO steers; ``disagg_retain_artifacts`` (64): artifacts a prefill engine
  keeps for re-ingest.
* ``ilp_time_limit``: seconds the auto-sharding ILP may take per mesh
  shape (600) when ``AutoShardingOption.solver_timeout`` is not given.
* ``zero_stage``: the default of ``AutoShardingOption.zero_stage``
  ("auto", "0", "2" or "3").
* ``resharding_execution``: how a cross-mesh RESHARD runs: "device_put"
  (each destination shard assembled from its pieces, through the edge's
  strategy or codec) or "planned" (the tile plan as it is, with its
  intra-mesh leg: ``ReshardingTask``'s "tiled" mode, or "broadcast" where
  ``resharding_mode`` is "broadcast"; no strategy, no codec).
* ``resharding_mode``: "send_recv" or "broadcast".
* ``resharding_loadbalance_mode``: "normal" balances source selection,
  broadcast routing and the send order; "no_loadbalance" takes the first
  holder and plan order.
* ``reshard_strategy``: "auto" (per edge by the cost model) or one of
  ``RESHARD_STRATEGIES``, forced where eligible.
* ``reshard_quantize``: "off", "int8" or "fp8": the activation codec on
  cross-mesh fp32/bf16 edges of at least ``reshard_quantize_min_bytes``
  (65536), never on weights.
* ``grad_quantize``: "off", "int8" or "fp8": the ILP may route a ZeRO
  gradient's reduce-scatter through the gradient codec, and gradient
  accumulation compresses each microbatch's eligible gradient (at least
  ``grad_quantize_min_bytes``) with error feedback
  (``grad_error_feedback``, on).
* ``resharding_transfer_latency_s``, ``resharding_wire_model`` ("call" or
  "link") and ``resharding_wire_bandwidth`` (bytes/s, 0 = off): the wire
  model the strategy cost reads.  JAX also idles for it to emulate a
  link; the port runs on real links and only prices with it.

Measurement (the telemetry layer, ``telemetry/``):

* ``collect_trace``: the dispatch records one span per replayed op even
  with tracing off (``get_perf_report`` and
  ``dump_stage_execution_trace`` read them).
* ``telemetry_enabled`` (``ALPA_TPU_TRACE``), ``telemetry_trace_dir`` and
  ``telemetry_max_events``: span tracing, where traces are dropped, the
  cap on buffered events.
* ``flight_recorder`` (on), ``flight_recorder_capacity`` (4096) and
  ``flight_dump_dir``: the ring of the last replayed ops, dumped when a
  step raises.
* ``device_peak_tflops``: the peak MFU is taken against; 0 reads
  ``telemetry.perf.GPU_SPECS`` for the detected card.
* ``compile_cache_dir``, ``compile_cache_enabled`` and
  ``compile_cache_memory_entries``: the compile cache's disk tier (unset:
  memory only), its switch and its in-memory capacity.
* ``profiling_database_filename`` (``ALPA_TPU_PROF_DATABASE``): a
  ``mesh_profiling.ProfilingResultDatabase`` whose fit prices logical
  meshes of its backend in seconds.
* ``replan_mode`` ("off", "suggest", "auto"), ``calibration_min_samples``
  (3) and ``calibration_dir``: profile-guided replanning and the
  calibration store's disk tier.  Under "auto" ``consider_replan`` raises:
  the port's strategy chooser does not read the store yet (ROADMAP A.6).

The plan analyses (``analysis/``):

* ``verify_plans`` (``ALPA_TPU_VERIFY_PLANS``: "error", "warn" or "off";
  "warn"): the pipeshard executable verifies each plan it lowers (slot
  typing, deadlock freedom, liveness and leaks, structure); "error" raises
  ``PlanVerificationError`` on any error finding before the first launch,
  and ``call_with_retry`` then refuses a retry at a site the model checker
  classed unsafe.
* ``verify_plans_model_check`` (``ALPA_TPU_VERIFY_MODEL_CHECK``: "all",
  "fixture" or "off"; "fixture": plans of at most
  ``model_check.FIXTURE_MAX_OPS`` instructions) and
  ``model_check_state_budget`` (``ALPA_TPU_MODEL_CHECK_BUDGET``, 50000).
* ``verify_plans_numerics`` (``ALPA_TPU_VERIFY_NUMERICS``, "warn") and
  ``numerics_error_budget`` (``ALPA_TPU_NUMERICS_ERROR_BUDGET``, 0.05 of a
  block's largest magnitude).
* ``verify_plans_equiv`` (``ALPA_TPU_VERIFY_EQUIV``, "warn") and
  ``equiv_term_budget`` (``ALPA_TPU_EQUIV_TERM_BUDGET``, 100000).
  "error" on numerics or equivalence refuses a launch on those findings
  even where ``verify_plans`` only warns.
* ``superopt_mode`` (``ALPA_TPU_SUPEROPT_MODE``: "off", "suggest" or
  "auto"; "off"): the certified superoptimizer searches rewrites of the
  instruction list and reports ("suggest") or runs the accepted one
  ("auto"); ``superopt_beam_width`` (4), ``superopt_step_budget`` (32),
  ``superopt_verify_budget`` (2) and ``superopt_max_group`` (0: no cap on a
  batched group of RESHARDs; ``ALPA_TPU_SUPEROPT_BEAM``, ``_STEPS``,
  ``_VERIFY_BUDGET``, ``_MAX_GROUP``).

Fault tolerance and state (``fault.py``, ``elastic.py``,
``serialization.py``):

* ``elastic_step_budget`` (4), ``elastic_time_budget_s`` (300),
  ``elastic_grace_period_s`` (30), ``elastic_quiesce_timeout_s`` (60) and
  ``elastic_snapshot_interval`` (1): ``ElasticSupervisor``'s budgets, its
  preemption grace window, how long ``quiesce()`` waits for launches in
  flight, and its checkpoint cadence.
* ``wedge_probe_timeout_s`` (120): seconds a ``WedgeDetector`` probe may
  take before its device is classed wedged.
* ``checkpoint_cache_dir`` (``ALPA_TPU_CKPT_CACHE``): a local directory
  ``save_checkpoint`` writes first and drains to its target in the
  background.

The dispatch mode is the JAX driver's "auto" choice: overlap where it is
eligible, else register-file replay.  ``_pipeline_dispatch_mode`` is a
private switch for the tests and ``chip_smoke.py``, which force each of
the JAX package's other modes ("registers", "overlap", "sequential",
"threaded") to hold them to "auto" bit for bit; no user path sets it.
"""
import os


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.lower() in ("1", "true", "yes", "on")


class GlobalConfig:
    """The dispatch, planner and serving knobs, seeded from the
    environment."""

    def __init__(self):
        self._pipeline_dispatch_mode = "auto"
        self.overlap_resharding = _env_bool(
            "ALPA_TPU_OVERLAP_RESHARDING", True)
        self.debug_dispatch_races = _env_bool(
            "ALPA_TPU_DEBUG_DISPATCH_RACES", False)
        self.kv_paged = _env_bool("ALPA_TPU_KV_PAGED", False)
        self.kv_block_size = int(os.environ.get("ALPA_TPU_KV_BLOCK_SIZE",
                                                "16"))
        self.kv_cache_blocks = int(os.environ.get(
            "ALPA_TPU_KV_CACHE_BLOCKS", "0"))
        self.kv_prefix_reuse = _env_bool("ALPA_TPU_KV_PREFIX_REUSE", True)
        # the multi-replica router
        self.router_policy = os.environ.get("ALPA_TPU_ROUTER_POLICY",
                                            "least_loaded")
        self.router_shed_ttft_ms = float(os.environ.get(
            "ALPA_TPU_ROUTER_SHED_TTFT_MS", "0"))
        self.router_shed_queue_depth = int(os.environ.get(
            "ALPA_TPU_ROUTER_SHED_QUEUE_DEPTH", "64"))
        self.router_health_fail_threshold = int(os.environ.get(
            "ALPA_TPU_ROUTER_HEALTH_FAILS", "3"))
        self.router_autoscale_window_s = float(os.environ.get(
            "ALPA_TPU_ROUTER_AUTOSCALE_WINDOW", "30"))
        self.router_autoscale_hi_queue = float(os.environ.get(
            "ALPA_TPU_ROUTER_AUTOSCALE_HI_QUEUE", "8"))
        self.router_autoscale_lo_queue = float(os.environ.get(
            "ALPA_TPU_ROUTER_AUTOSCALE_LO_QUEUE", "1"))
        # disaggregated prefill/decode
        self.disagg_mode = os.environ.get("ALPA_TPU_DISAGG_MODE", "off")
        self.disagg_codec = os.environ.get("ALPA_TPU_DISAGG_CODEC", "off")
        self.disagg_backpressure_depth = int(os.environ.get(
            "ALPA_TPU_DISAGG_BACKPRESSURE_DEPTH", "0"))
        self.disagg_ttft_slo_ms = float(os.environ.get(
            "ALPA_TPU_DISAGG_TTFT_SLO_MS", "0"))
        self.disagg_itl_slo_ms = float(os.environ.get(
            "ALPA_TPU_DISAGG_ITL_SLO_MS", "0"))
        self.disagg_retain_artifacts = int(os.environ.get(
            "ALPA_TPU_DISAGG_RETAIN_ARTIFACTS", "64"))
        self.ilp_time_limit = int(os.environ.get("ALPA_TPU_ILP_TIME_LIMIT",
                                                 "600"))
        self.zero_stage = os.environ.get("ALPA_TPU_ZERO_STAGE", "auto")
        # cross-mesh resharding
        self.resharding_mode = os.environ.get("ALPA_TPU_RESHARDING_MODE",
                                              "send_recv")
        self.resharding_execution = os.environ.get(
            "ALPA_TPU_RESHARDING_EXEC", "device_put")
        self.resharding_loadbalance_mode = os.environ.get(
            "ALPA_TPU_RESHARDING_LOADBALANCE", "normal")
        self.resharding_transfer_latency_s = float(os.environ.get(
            "ALPA_TPU_TRANSFER_LATENCY", "0"))
        self.resharding_wire_model = os.environ.get("ALPA_TPU_WIRE_MODEL",
                                                    "call")
        self.resharding_wire_bandwidth = float(os.environ.get(
            "ALPA_TPU_WIRE_BANDWIDTH", "0"))
        self.reshard_strategy = os.environ.get("ALPA_TPU_RESHARD_STRATEGY",
                                               "auto")
        self.reshard_quantize = os.environ.get("ALPA_TPU_RESHARD_QUANTIZE",
                                               "off")
        self.reshard_quantize_min_bytes = int(os.environ.get(
            "ALPA_TPU_RESHARD_QUANTIZE_MIN_BYTES", "65536"))
        # quantized gradient collectives
        self.grad_quantize = os.environ.get("ALPA_TPU_GRAD_QUANTIZE", "off")
        self.grad_quantize_min_bytes = int(os.environ.get(
            "ALPA_TPU_GRAD_QUANTIZE_MIN_BYTES", "65536"))
        self.grad_error_feedback = os.environ.get(
            "ALPA_TPU_GRAD_ERROR_FEEDBACK", "on") != "off"
        # the profiling database the cost model is calibrated from
        self.profiling_database_filename = os.environ.get(
            "ALPA_TPU_PROF_DATABASE", None)
        # measurement
        self.collect_trace = _env_bool("ALPA_TPU_COLLECT_TRACE", False)
        self.telemetry_enabled = _env_bool("ALPA_TPU_TRACE", False)
        self.telemetry_trace_dir = os.environ.get("ALPA_TPU_TRACE_DIR",
                                                  None)
        self.telemetry_max_events = int(os.environ.get(
            "ALPA_TPU_TRACE_MAX_EVENTS", "200000"))
        self.flight_recorder = _env_bool("ALPA_TPU_FLIGHT", True)
        self.flight_recorder_capacity = int(os.environ.get(
            "ALPA_TPU_FLIGHT_CAPACITY", "4096"))
        self.flight_dump_dir = os.environ.get("ALPA_TPU_FLIGHT_DIR", None)
        self.device_peak_tflops = float(os.environ.get(
            "ALPA_TPU_DEVICE_PEAK_TFLOPS", "0"))
        # compile cache
        self.compile_cache_dir = os.environ.get("ALPA_TPU_CACHE_DIR", None)
        self.compile_cache_enabled = _env_bool("ALPA_TPU_COMPILE_CACHE",
                                               True)
        self.compile_cache_memory_entries = int(os.environ.get(
            "ALPA_TPU_COMPILE_CACHE_MEM_ENTRIES", "128"))
        # profile-guided replanning
        self.replan_mode = os.environ.get("ALPA_TPU_REPLAN_MODE", "off")
        self.calibration_min_samples = int(os.environ.get(
            "ALPA_TPU_CALIBRATION_MIN_SAMPLES", "3"))
        self.calibration_dir = os.environ.get("ALPA_TPU_CALIBRATION_DIR",
                                              None)
        # the plan analyses
        self.verify_plans = os.environ.get("ALPA_TPU_VERIFY_PLANS", "warn")
        self.verify_plans_model_check = os.environ.get(
            "ALPA_TPU_VERIFY_MODEL_CHECK", "fixture")
        self.model_check_state_budget = int(os.environ.get(
            "ALPA_TPU_MODEL_CHECK_BUDGET", "50000"))
        self.verify_plans_numerics = os.environ.get(
            "ALPA_TPU_VERIFY_NUMERICS", "warn")
        self.numerics_error_budget = float(os.environ.get(
            "ALPA_TPU_NUMERICS_ERROR_BUDGET", "0.05"))
        self.verify_plans_equiv = os.environ.get("ALPA_TPU_VERIFY_EQUIV",
                                                 "warn")
        self.equiv_term_budget = int(os.environ.get(
            "ALPA_TPU_EQUIV_TERM_BUDGET", "100000"))
        # the certified superoptimizer
        self.superopt_mode = os.environ.get("ALPA_TPU_SUPEROPT_MODE", "off")
        self.superopt_beam_width = int(os.environ.get(
            "ALPA_TPU_SUPEROPT_BEAM", "4"))
        self.superopt_step_budget = int(os.environ.get(
            "ALPA_TPU_SUPEROPT_STEPS", "32"))
        self.superopt_verify_budget = int(os.environ.get(
            "ALPA_TPU_SUPEROPT_VERIFY_BUDGET", "2"))
        self.superopt_max_group = int(os.environ.get(
            "ALPA_TPU_SUPEROPT_MAX_GROUP", "0"))
        # fault tolerance and state
        self.elastic_step_budget = int(os.environ.get(
            "ALPA_TPU_ELASTIC_STEP_BUDGET", "4"))
        self.elastic_time_budget_s = float(os.environ.get(
            "ALPA_TPU_ELASTIC_TIME_BUDGET", "300"))
        self.elastic_grace_period_s = float(os.environ.get(
            "ALPA_TPU_ELASTIC_GRACE", "30"))
        self.elastic_quiesce_timeout_s = float(os.environ.get(
            "ALPA_TPU_ELASTIC_QUIESCE_TIMEOUT", "60"))
        self.elastic_snapshot_interval = int(os.environ.get(
            "ALPA_TPU_ELASTIC_SNAPSHOT_INTERVAL", "1"))
        self.wedge_probe_timeout_s = float(os.environ.get(
            "ALPA_TPU_WEDGE_PROBE_TIMEOUT", "120"))
        self.checkpoint_cache_dir = os.environ.get("ALPA_TPU_CKPT_CACHE",
                                                   None)


global_config = GlobalConfig()
