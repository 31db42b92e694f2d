"""Process-global knobs of the pipeshard runtime.

The port's own copy of the two knobs of ``alpa_tpu/global_env.py`` that
its pipeshard driver reads, with the JAX package's names, environment
variables and defaults:

* ``overlap_resharding``: whether dispatch may take the overlap mode, which
  launches cross-mesh RESHARDs as soon as their producers retire.
* ``debug_dispatch_races``: threaded dispatch reports every instruction's
  value accesses to a race checker, which raises on a conflict.

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
    """The dispatch knobs, seeded from the environment."""

    def __init__(self):
        self._pipeline_dispatch_mode = "auto"
        self.overlap_resharding = _env_bool(
            "ALPA_TPU_OVERLAP_RESHARDING", True)
        self.debug_dispatch_races = _env_bool(
            "ALPA_TPU_DEBUG_DISPATCH_RACES", False)


global_config = GlobalConfig()
