"""Intra-operator (sharding) parallelization.

Counterpart of ``alpa_tpu/shard_parallel/``: the spec algebra, the
strategy graph over the traced aten graph, the ILP, the mesh-shape search,
the rule-based plans of the data-parallel and ZeRO methods, manual specs,
and gradient accumulation.  Executing a plan over more than one device is
ROADMAP A.3.2.
"""
from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption
from alpa_tpu_torch.shard_parallel.manual_sharding import \
    ManualShardingOption
