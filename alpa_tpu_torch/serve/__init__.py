"""Model serving: generation loop + HTTP controller (counterpart of
``alpa_tpu/serve``)."""
from alpa_tpu_torch.serve.generation import (GenerationConfig, Generator,
                                             get_model)
from alpa_tpu_torch.serve.controller import (Controller, ControllerServer,
                                             RequestBatcher, run_controller)
from alpa_tpu_torch.serve.scheduler import FIFOQueue
