"""Weights of the flax models as the port's state dicts."""
from typing import Any, Dict

import numpy as np
import torch

from alpa_tpu_torch.model.gpt_model import GPTConfig


def gpt_params_from_flax(tree: Dict[str, Any], config: GPTConfig,
                         device=None, param_dtype=None
                         ) -> Dict[str, torch.Tensor]:
    """Map a flax ``GPTModel`` parameter tree (arrays or numpy arrays,
    with or without the outer ``params`` key) to a state dict for
    ``alpa_tpu_torch.model.gpt_model.GPTModel``.

    Flax ``Dense`` kernels are (in, out) and become (out, in) ``Linear``
    weights.  Linear and embedding weights are stored in ``param_dtype``,
    by default ``config.dtype`` (flax casts its fp32 params to that dtype at
    use; pass ``torch.float32`` to train, with ``GPTModel(...,
    param_dtype=torch.float32)``); LayerNorm parameters stay fp32."""
    p = tree["params"] if "params" in tree else tree
    param_dtype = param_dtype or config.dtype

    def tensor(x, dtype, transpose=False):
        a = np.array(x, np.float32)     # a writable copy
        if transpose:
            a = np.ascontiguousarray(a.T)
        return torch.from_numpy(a).to(
            device=device, dtype=dtype)

    def dense(prefix, node):
        return {f"{prefix}.weight": tensor(node["kernel"], param_dtype,
                                           transpose=True),
                f"{prefix}.bias": tensor(node["bias"], param_dtype)}

    def layer_norm(prefix, node):
        return {f"{prefix}.weight": tensor(node["scale"], torch.float32),
                f"{prefix}.bias": tensor(node["bias"], torch.float32)}

    sd = {"wte.weight": tensor(p["wte"]["embedding"], param_dtype),
          "wpe.weight": tensor(p["wpe"]["embedding"], param_dtype)}
    for i in range(config.num_layers):
        blk = p[f"h{i}"]
        sd.update(layer_norm(f"h.{i}.ln1", blk["ln1"]))
        sd.update(layer_norm(f"h.{i}.ln2", blk["ln2"]))
        sd.update(dense(f"h.{i}.attn.qkv", blk["attn"]["qkv"]))
        sd.update(dense(f"h.{i}.attn.out", blk["attn"]["out"]))
        sd.update(dense(f"h.{i}.mlp.fc_in", blk["mlp"]["fc_in"]))
        sd.update(dense(f"h.{i}.mlp.fc_out", blk["mlp"]["fc_out"]))
    sd.update(layer_norm("ln_f", p["ln_f"]))
    if "lm_head" in p:
        sd["lm_head.weight"] = tensor(p["lm_head"]["kernel"], param_dtype,
                                      transpose=True)
    return sd


def mlp_params_from_flax(tree: Dict[str, Any], device=None
                         ) -> Dict[str, torch.Tensor]:
    """Map the parameter tree of ``alpa_tpu.testing.MLPModel`` (``Dense_i``
    kernels (in, out) and biases, with or without the outer ``params`` key)
    to the state dict of ``alpa_tpu_torch.testing.MLPModel`` (``layers.i``
    ``Linear`` weights (out, in) and biases), as fp32 tensors."""
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for i in range(len(p)):
        dense = p[f"Dense_{i}"]
        kernel = np.array(dense["kernel"], np.float32)
        sd[f"layers.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T)).to(device)
        sd[f"layers.{i}.bias"] = torch.from_numpy(
            np.array(dense["bias"], np.float32)).to(device)
    return sd
