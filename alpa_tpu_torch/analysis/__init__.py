"""Analysis over compiled and measured pipeshard plans (counterpart of
``alpa_tpu/analysis``):

* ``plan_verifier`` -- the seven-analysis verdict over every lowered
  register-file program (typing, deadlock, liveness, structure, and the
  three below), cached by plan fingerprint and gating a launch behind
  ``global_config.verify_plans``;
* ``model_check`` -- the explicit-state model checker over the streams'
  interleavings, with the static retry classification;
* ``numerics`` -- the precision-flow certification composing the codecs'
  error bounds;
* ``equivalence`` -- translation validation of the lowered program
  against the serial stage decomposition;
* ``superopt`` -- the certified rewrite engine behind ``superopt_mode``;
* ``critical_path`` -- the critical-path walk and the dependency-DAG
  re-simulation under ``telemetry.perf``.

The JAX package's ``analysis/lint.py`` checks that package's own source and
has no port.
"""
from alpa_tpu_torch.analysis.critical_path import (  # noqa: F401
    CriticalPathReport, MemSpec, PathStep, TimedOp, longest_path,
    measured_critical_path, simulate_dag)
from alpa_tpu_torch.analysis.model_check import (  # noqa: F401
    ModelCheckResult, check_model, load_fixture, model_from_dict,
    model_to_dict)
from alpa_tpu_torch.analysis.numerics import (  # noqa: F401
    NumericsResult, PrecisionValue, check_numerics)
from alpa_tpu_torch.analysis.plan_verifier import (  # noqa: F401
    Finding, PlanModel, PlanVerdict, PlanVerificationError,
    verify_model)
from alpa_tpu_torch.analysis.superopt import (  # noqa: F401
    PlanScore, SuperoptOutcome, reshard_group_extent, run_superopt,
    superopt_search, verdict_diff, verdict_new_findings)
