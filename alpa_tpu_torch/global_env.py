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
* ``ilp_time_limit``: seconds the auto-sharding ILP may take per mesh
  shape (600) when ``AutoShardingOption.solver_timeout`` is not given.
* ``zero_stage``: the default of ``AutoShardingOption.zero_stage``
  ("auto", "0", "2" or "3").

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
        self.ilp_time_limit = int(os.environ.get("ALPA_TPU_ILP_TIME_LIMIT",
                                                 "600"))
        self.zero_stage = os.environ.get("ALPA_TPU_ZERO_STAGE", "auto")


global_config = GlobalConfig()
