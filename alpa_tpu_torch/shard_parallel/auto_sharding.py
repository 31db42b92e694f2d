"""Auto-sharding options and the rule-based plans.

Counterpart of ``alpa_tpu/shard_parallel/auto_sharding.py``:
``AutoShardingOption`` with the JAX package's fields and defaults, the
classification of flat argument paths into parameters and optimizer
state, the ``zero_stage`` knob, and ``plan_rule_based``, the plans of
``DataParallel``, ``Zero2Parallel`` and ``Zero3Parallel``.  Plans are a
``Spec`` per flat argument (``sharding_spec.py``), which the SPMD
partitioner (``spmd_partition.py``) realises.

Paths are those of ``torch.utils._pytree.keystr`` over the parallelized
function's arguments, e.g. ``[0].params['h.0.attn.qkv.weight']`` or
``[0].opt_state[0]['mu']['wte.weight']`` for the port's ``TrainState``.

Two fields mean GSPMD constraint emission in the JAX package.  The port
realises every plan the same way, whatever ``emit_sharding_constraints``
says: the program's strategy graph is built again with its inputs
pinned to their final specs and every value takes the Spec it decides:
solved by the ILP for an ILP plan (``solver.solve_pinned``; with nothing
forced, the ILP's own plan), propagated from the inputs for a
rule-based one (``solver.propagate_pinned``, GSPMD's part in JAX).
``constrain_min_elements`` is accepted at its default, and any other
value raises: the partitioner constrains small values too, and a size
below which values are left to propagation is not ported.
"""
import dataclasses
import re
from typing import Optional, Sequence, Tuple

from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.shard_parallel.sharding_spec import (Spec, make_spec,
                                                         replicated_spec)

_PATH_COMPONENT_RE = re.compile(r"[A-Za-z0-9_]+")

# path components of an optimizer-state leaf: the ``opt_state`` subtree,
# Adam moments, SGD momentum
_OPT_STATE_COMPONENTS = frozenset(
    ("opt_state", "mu", "nu", "momentum", "trace"))


def path_components(path: str) -> Tuple[str, ...]:
    """Identifier components of a ``keystr`` path."""
    return tuple(_PATH_COMPONENT_RE.findall(path or ""))


def is_opt_state_path(path: str) -> bool:
    """Whether a flat argument's path names an optimizer-state leaf:
    ``opt_state`` anywhere wins; outside it, a ``params`` component wins; a
    bare moment component names an optimizer state passed on its own."""
    comps = set(path_components(path))
    if "opt_state" in comps:
        return True
    if "params" in comps:
        return False
    return bool(comps & _OPT_STATE_COMPONENTS)


def is_param_path(path: str) -> bool:
    """Whether a flat argument's path names a parameter leaf (and not an
    optimizer-state mirror of one)."""
    comps = set(path_components(path))
    return "params" in comps and "opt_state" not in comps


def resolved_zero_stage(option: "AutoShardingOption") -> int:
    """``zero_stage`` and the forcing flags as 0 (off), 2, 3 (forced) or -1
    (auto: the ILP weighs the memory term against all-gather traffic)."""
    z = str(getattr(option, "zero_stage", "auto") or "auto")
    if z == "auto":
        if option.force_zero_stage_3:
            return 3
        if option.prefer_reduce_scatter:
            return 2
        return -1
    if z not in ("0", "2", "3"):
        raise ValueError(
            f"zero_stage must be one of auto|0|2|3, got {z!r} "
            "(set via AutoShardingOption.zero_stage or "
            "ALPA_TPU_ZERO_STAGE)")
    return int(z)


@dataclasses.dataclass
class AutoShardingOption:
    """Options of the auto-sharding planner
    (``alpa_tpu/shard_parallel/auto_sharding.py:95``)."""
    # search the strategies with the ILP (False: rule-based)
    enable_auto_sharding: bool = True
    # batch-dim data parallelism only
    force_data_parallel: bool = False
    # ZeRO-2: reduce-scattered gradients, sharded optimizer state
    prefer_reduce_scatter: bool = False
    # ZeRO-3: sharded parameters too
    force_zero_stage_3: bool = False
    force_zero_stage_3_all_gather_threshold: int = 1 << 26
    # map the batch dim onto this logical mesh dim (None: the ILP decides)
    force_batch_dim_to_mesh_dim: Optional[int] = None
    allow_all_to_all: bool = True
    allow_all_gather: bool = True
    allow_mixed_mesh_shape: bool = False
    # per-device byte budget of the resident inputs (None: unlimited)
    memory_budget_per_device: Optional[int] = None
    # seconds the ILP may take per mesh shape
    solver_timeout: int = 600
    # the logical mesh shape, e.g. (2, 4); None: search the candidates
    logical_mesh_shape: Optional[Tuple[int, ...]] = None
    # accepted either way: every plan is realised through the pinned solve
    emit_sharding_constraints: bool = True
    constrain_min_elements: int = 1 << 16
    mesh_shape_search: bool = False
    # weight-update (ZeRO) sharding: "auto", "0", "2" or "3"
    zero_stage: str = dataclasses.field(
        default_factory=lambda: global_config.zero_stage)

    def __post_init__(self):
        if self.constrain_min_elements != 1 << 16:
            raise NotImplementedError(
                "AutoShardingOption.constrain_min_elements="
                f"{self.constrain_min_elements!r}: the SPMD partitioner "
                "gives every value its planned spec, whatever its size; a "
                "size below which values are left to propagation is not "
                "ported")

    def copy(self):
        return dataclasses.replace(self)


def _largest_divisible_dim(shape, size: int) -> Optional[int]:
    """The largest dim divisible by ``size`` (the later one on ties)."""
    best, best_len = None, 0
    for i, s in enumerate(shape):
        if s % size == 0 and s >= best_len and s >= size:
            best, best_len = i, s
    return best


def plan_rule_based(mesh_shape: Sequence[int], avals, in_paths: Sequence[str],
                    batch_flat_idx: Sequence[int],
                    option: AutoShardingOption) -> Tuple[Spec, ...]:
    """The rule-based plan (``alpa_tpu/shard_parallel/auto_sharding.py:163``)
    on a logical mesh of ``mesh_shape``: a batch argument's dim 0 sharded
    over every mesh axis (data parallelism); under ZeRO-2 each
    optimizer-state leaf, under ZeRO-3 each parameter leaf too, sharded
    over mesh axis 0 on its largest divisible dim; the rest replicated."""
    axes = tuple(range(len(mesh_shape)))
    dp_size = 1
    for s in mesh_shape:
        dp_size *= s
    zero = resolved_zero_stage(option)
    batch_set = set(batch_flat_idx)
    specs = []
    for i, (aval, path) in enumerate(zip(avals, in_paths)):
        shape = tuple(aval.shape)
        ndim = len(shape)
        if i in batch_set and ndim >= 1 and shape[0] % dp_size == 0:
            specs.append(make_spec(ndim, {0: axes}))
            continue
        shard_it = ((zero in (2, 3) and is_opt_state_path(path)) or
                    (zero == 3 and is_param_path(path)))
        if shard_it:
            d = _largest_divisible_dim(shape, mesh_shape[0])
            if d is not None:
                specs.append(make_spec(ndim, {d: 0}))
                continue
        specs.append(replicated_spec(ndim))
    return tuple(specs)
