"""Inter-operator (pipeline) parallelism: the port of
``alpa_tpu/pipeline_parallel`` over traced ``torch.fx`` graphs."""
from alpa_tpu_torch.pipeline_parallel.layer_construction import (
    AutoLayerOption, FollowLayerOption, ManualLayerOption, automatic_remat,
    manual_remat)
from alpa_tpu_torch.pipeline_parallel.stage_construction import (
    AutoStageOption, ManualStageOption, UniformStageOption)
