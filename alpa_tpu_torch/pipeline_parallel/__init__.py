"""Inter-operator (pipeline) parallelism: the port of
``alpa_tpu/pipeline_parallel`` over traced ``torch.fx`` graphs."""
