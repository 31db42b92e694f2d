"""Serializable record of a full parallelization decision.

Counterpart of ``alpa_tpu/parallel_plan.py`` (the reference's
``alpa/parallel_plan.py``): enough of the solved plan (cluster shape,
logical mesh, stage partition, chosen input specs) to rebuild a
``ParallelMethod`` that replays it without searching (``plan_to_method``).
A plan carries no weights.  An input spec is the port's ``Spec`` tuple
(per dimension, the mesh axes it is sharded over).
"""
import dataclasses
import pickle
from typing import Any, List, Optional, Tuple


@dataclasses.dataclass
class PlacementSpec:
    """Where one tensor lives (ref :14)."""
    aval_shape: Tuple[int, ...]
    mesh_ids: List[int]
    partition_specs: List[Any]  # Spec per mesh


@dataclasses.dataclass
class StagePlan:
    """Intra-op decisions of one stage (ref :22)."""
    logical_mesh_shape: Tuple[int, ...]
    input_partition_specs: Optional[List[Any]] = None
    auto_sharding_solution: Optional[List[int]] = None


@dataclasses.dataclass
class PipelinePlan:
    """Inter-op decisions (ref :34)."""
    pipeline_schedule: str
    layer_option: Any
    forward_stage_layer_ids: List[List[int]]
    submesh_physical_shapes: List[Tuple[int, int]]
    submesh_logical_shapes: List[Optional[Tuple[int, int]]]


@dataclasses.dataclass
class ClusterInfo:
    num_hosts: int
    num_devices_per_host: int


@dataclasses.dataclass
class ParallelPlan:
    """The whole decision (ref :48)."""
    cluster_info: ClusterInfo
    num_micro_batches: Optional[int]
    pipeline_plan: Optional[PipelinePlan] = None
    stage_plans: Optional[List[StagePlan]] = None
    input_placement_specs: Optional[List[PlacementSpec]] = None

    def save(self, filename: str):
        with open(filename, "wb") as f:
            pickle.dump(self, f)

    def fingerprint(self) -> str:
        """A stable content hash of the plan (dataclass reprs are
        value-based, so two equal plans hash alike across processes)."""
        import hashlib
        return hashlib.sha256(repr(self).encode()).hexdigest()

    @classmethod
    def load(cls, filename: str) -> "ParallelPlan":
        with open(filename, "rb") as f:
            return pickle.load(f)


def plan_to_method(plan: ParallelPlan, devices=None):
    """A ``ParallelMethod`` replaying a saved plan on ``devices`` (None:
    the method's default)."""
    from alpa_tpu_torch.parallel_method import PipeshardParallel, ShardParallel
    from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption

    if plan.pipeline_plan is None:
        shape = (plan.stage_plans[0].logical_mesh_shape
                 if plan.stage_plans else None)
        return ShardParallel(
            devices=devices, num_micro_batches=plan.num_micro_batches,
            auto_sharding_option=AutoShardingOption(
                logical_mesh_shape=shape))
    from alpa_tpu_torch.pipeline_parallel.stage_construction import (
        ManualStageOption)
    pp = plan.pipeline_plan
    kwargs = {"layer_option": pp.layer_option} \
        if pp.layer_option is not None else {}
    return PipeshardParallel(
        devices=devices,
        num_micro_batches=plan.num_micro_batches or 1,
        pipeline_schedule=pp.pipeline_schedule,
        stage_option=ManualStageOption(
            forward_stage_layer_ids=pp.forward_stage_layer_ids,
            submesh_physical_shapes=[list(s) for s in
                                     pp.submesh_physical_shapes],
            submesh_logical_shapes=list(pp.submesh_logical_shapes),
            submesh_autosharding_option_dicts=[{} for _ in
                                               pp.forward_stage_layer_ids]),
        **kwargs)


def executable_to_plan(executable, num_micro_batches=None) -> ParallelPlan:
    """A replayable plan of a compiled executable, as the JAX package
    extracts it: a pipeshard executable's schedule, forward stages, stage
    mesh shapes and microbatches; a sharded executable's mesh shape and
    input specs."""
    from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import (
        PipeshardDriverExecutable)

    if isinstance(executable, PipeshardDriverExecutable):
        shapes = executable.mesh_shapes
        pp = PipelinePlan(
            pipeline_schedule=executable.schedule_name,
            layer_option=None,
            forward_stage_layer_ids=[[i] for i in range(
                executable.num_fwd_stages)],
            submesh_physical_shapes=[tuple(s) for s in shapes],
            submesh_logical_shapes=[None] * len(shapes),
        )
        cluster = ClusterInfo(sum(s[0] for s in shapes),
                              shapes[0][1] if shapes else 1)
        return ParallelPlan(cluster_info=cluster,
                            num_micro_batches=executable.num_micro_batches,
                            pipeline_plan=pp)
    mesh = executable.physical_mesh
    specs = getattr(executable, "in_specs", None)
    sp = StagePlan(logical_mesh_shape=tuple(mesh.shape),
                   input_partition_specs=(list(specs) if specs is not None
                                          else None))
    return ParallelPlan(
        cluster_info=ClusterInfo(mesh.num_hosts,
                                 mesh.num_devices_per_host),
        num_micro_batches=num_micro_batches,
        stage_plans=[sp])
