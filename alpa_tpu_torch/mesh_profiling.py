"""The static stage memory model of the stage DP.

Counterpart of ``estimate_stage_memory_split`` in
``alpa_tpu/mesh_profiling.py``.  The profiling of collectives, the
calibrated cost model and the stage cost's communication term come with the
intra-op ILP (ROADMAP A.3).
"""
from typing import Tuple

import torch

#: optimizer-state bytes per parameter byte (Adam-family: mu + nu)
OPT_STATE_MULT = 2.0


def _bytes(v) -> float:
    val = v.meta.get("val")
    if not isinstance(val, torch.Tensor):
        return 0.0
    return float(max(val.numel(), 1)) * val.element_size()


def estimate_stage_memory_split(stage_comps, num_devices: int,
                                objective: str = "training"
                                ) -> Tuple[float, float]:
    """(per-device parameter bytes, per-device bytes of one microbatch's
    activations) of the layer computations ``stage_comps`` on a submesh of
    ``num_devices``, which the stage DP combines as ``param + inflight(s) *
    act``.

    Parameters are the stage's inputs that none of its computations
    produce, each counted once; activations are the values its
    computations produce, each counted once, except those that merely pass
    through (an input of the stage).  For ``objective="training"`` the
    parameter term carries the optimizer state (``OPT_STATE_MULT`` x the
    parameter bytes), divided over the submesh as the JAX package's
    default, ZeRO "auto", divides it; a forward-only pipeline
    (``"inference"``) holds none.  Both terms divide by the submesh's
    devices."""
    produced = {v for c in stage_comps for v in c.outvars}
    stage_inputs = set()
    param_bytes = 0.0
    for c in stage_comps:
        for v in c.invars:
            if v in produced or v in stage_inputs:
                continue
            stage_inputs.add(v)
            param_bytes += _bytes(v)
    act_bytes, counted = 0.0, set()
    for c in stage_comps:
        for v in c.outvars:
            if v in counted or v in stage_inputs:
                continue
            counted.add(v)
            act_bytes += _bytes(v)
    n = max(num_devices, 1)
    opt_bytes = (OPT_STATE_MULT * param_bytes / n if objective == "training"
                 else 0.0)
    return param_bytes / n + opt_bytes, act_bytes / n
