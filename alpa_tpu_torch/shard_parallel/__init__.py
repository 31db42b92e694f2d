"""Intra-operator (sharding) parallelization.

Counterpart of ``alpa_tpu/shard_parallel/``: the spec algebra, the
strategy graph over the traced aten graph, the ILP, the mesh-shape search,
the rule-based plans of the data-parallel and ZeRO methods, manual specs,
gradient accumulation, and the execution of a plan over the devices of
one host: the SPMD partitioner (``spmd_partition.py``) and the
collectives it runs (``collectives.py``).
"""
from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption
from alpa_tpu_torch.shard_parallel.manual_sharding import \
    ManualShardingOption
