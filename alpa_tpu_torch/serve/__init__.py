"""Model serving: generation loop (greedy, sampling, speculative, beam),
continuous-batching engine, paged KV, disaggregated prefill/decode, the
HTTP controller, the multi-replica router and the HF-style wrapper
(counterpart of ``alpa_tpu/serve``)."""
from alpa_tpu_torch.serve.generation import (GenerationConfig, Generator,
                                             PrefixHandle, get_model)
from alpa_tpu_torch.serve.controller import (Controller, ControllerServer,
                                             RequestBatcher, run_controller)
from alpa_tpu_torch.serve.engine import ContinuousBatchingEngine
from alpa_tpu_torch.serve.hf_wrapper import WrappedInferenceModel, get_hf_model
from alpa_tpu_torch.serve.kv_cache import KVBlockPool, KVPoolExhaustedError
from alpa_tpu_torch.serve.packed import PackedPrefill, pack_prompts
from alpa_tpu_torch.serve.router import (HTTPReplicaHandle, LocalReplicaHandle,
                                         Router, RouterServer)
from alpa_tpu_torch.serve.scheduler import (FIFOQueue, NestedScheduler,
                                            WeightedFairQueue)
