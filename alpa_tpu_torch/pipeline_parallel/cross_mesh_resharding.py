"""Cross-mesh resharding between one-device stage meshes.

Counterpart of the case of ``alpa_tpu/pipeline_parallel/
cross_mesh_resharding.py`` that one-device meshes create: a whole tensor
moves from one stage mesh to another.  Between two physical devices it is
one ``to(dst, non_blocking=True)``: PyTorch orders a copy between CUDA
devices after the work queued on both devices' current streams and before
the work queued after it (a two-way stream-event barrier), so the
destination's next stage reads the value only once it has arrived.  When
both meshes name the same physical device (``devices=["cuda:0"] * 2``) the
graphs are functional, so the tensor itself is handed over and no byte
moves.  The tile planner and ``reshard_codec.py`` come with intra-op
sharding (ROADMAP A.3.2).
"""
from typing import Tuple

import torch


def reshard(x: torch.Tensor, dst: torch.device) -> Tuple[torch.Tensor, int]:
    """``(x on dst, bytes moved)``."""
    if x.device == dst:
        return x, 0
    return x.to(dst, non_blocking=True), x.numel() * x.element_size()
