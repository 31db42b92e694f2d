"""Analysis over measured pipeshard steps (counterpart of
``alpa_tpu/analysis``): the critical-path walk and the dependency-DAG
re-simulation under ``telemetry.perf``.  The plan verifier, its
analyses and the superoptimizer are ROADMAP A.7."""
from alpa_tpu_torch.analysis.critical_path import (  # noqa: F401
    CriticalPathReport, MemSpec, PathStep, TimedOp, longest_path,
    measured_critical_path, simulate_dag)
