"""Weights from HuggingFace checkpoints and from params directories
(counterpart of ``alpa_tpu/model/weight_loading.py``).

* ``convert_opt_state_dict`` / ``convert_gpt2_state_dict``: an HF OPT or
  GPT-2 state dict (torch tensors or numpy arrays) as a state dict of the
  port's ``GPTModel``; ``config_from_hf_opt`` / ``config_from_hf_gpt2``
  read an HF config object's fields.  ``load_opt`` / ``load_gpt2`` take an
  HF model object or a local directory (``config.json`` and
  ``pytorch_model.bin`` or ``model.safetensors``) and never download.
* ``save_params_dir``, ``synthesize_params_dir`` and ``load_params_dir``:
  the JAX package's on-disk layout, one ``.npy`` per flax leaf named by
  its tree path (``params.h0.attn.qkv.kernel.npy``, kernels ``(in, out)``)
  and an ``index.txt``, so a directory written by either package loads in
  the other.  Loading memory-maps each file and moves it straight onto a
  device, or, where ``specs`` are given, reads only each device's block of
  it into a ``DistributedArray`` over ``logical_mesh``.
"""
import concurrent.futures
import json
import os
import re
import types
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from alpa_tpu_torch.model.gpt_model import GPTConfig, GPTModel
from alpa_tpu_torch.platform import get_device

_LINEARS = (("attn", "qkv"), ("attn", "out"), ("mlp", "fc_in"),
            ("mlp", "fc_out"))
# leaf files written or read at once (each thread holds one leaf)
_IO_THREADS = 8
# the tree path's root: ``model.init`` nests the weights under "params"
_PREFIX = "params."


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def _is_layer_norm(port_name: str) -> bool:
    return ".ln" in port_name or port_name.startswith("ln_")


def _put(arr: np.ndarray, port_name: str, dtype, device) -> torch.Tensor:
    """A host array as the port's parameter: LayerNorm parameters in fp32,
    the others in ``dtype``."""
    t = torch.from_numpy(np.array(arr, np.float32))
    return t.to(device=device,
                dtype=torch.float32 if _is_layer_norm(port_name) else dtype)


# ---- HuggingFace checkpoints ----------------------------------------


def convert_gpt2_state_dict(state_dict: Dict[str, Any], config: GPTConfig,
                            device=None) -> Dict[str, torch.Tensor]:
    """An HF GPT-2 state dict as the port's, in ``config.dtype`` on
    ``device`` (the CPU unless given).  GPT-2's ``Conv1D`` weights are
    ``(in, out)`` and become ``(out, in)`` Linear weights."""
    sd = {k: v for k, v in state_dict.items()}

    def get(key):
        out = sd.get(key, sd.get("transformer." + key))
        if out is None:
            raise KeyError(
                f"state dict has neither {key!r} nor "
                f"{'transformer.' + key!r}: not a GPT-2-family checkpoint?")
        return _np(out)

    hf = {"attn.qkv": "attn.c_attn", "attn.out": "attn.c_proj",
          "mlp.fc_in": "mlp.c_fc", "mlp.fc_out": "mlp.c_proj"}
    host = {"wte.weight": get("wte.weight"),
            "wpe.weight": get("wpe.weight")[:config.seq_len],
            "ln_f.weight": get("ln_f.weight"), "ln_f.bias": get("ln_f.bias")}
    for i in range(config.num_layers):
        p = f"h.{i}."
        for ln, src in (("ln1", "ln_1"), ("ln2", "ln_2")):
            host[f"{p}{ln}.weight"] = get(f"{p}{src}.weight")
            host[f"{p}{ln}.bias"] = get(f"{p}{src}.bias")
        for ours, theirs in hf.items():
            host[f"{p}{ours}.weight"] = get(f"{p}{theirs}.weight").T
            host[f"{p}{ours}.bias"] = get(f"{p}{theirs}.bias")
    return {k: _put(v, k, config.dtype, device) for k, v in host.items()}


def convert_opt_state_dict(state_dict: Dict[str, Any], config: GPTConfig,
                           device=None) -> Dict[str, torch.Tensor]:
    """An HF ``OPTForCausalLM`` state dict as the port's, in
    ``config.dtype`` on ``device`` (the CPU unless given).  The separate
    q, k and v projections are stacked into the fused ``qkv`` weight; the
    positional table keeps its ``pos_offset`` reserved rows."""
    sd = {k: v for k, v in state_dict.items()}

    def get(key):
        out = sd.get("model.decoder." + key, sd.get("decoder." + key))
        if out is None:
            raise KeyError(f"state dict misses decoder key {key!r}: not an "
                           "OPT-family checkpoint?")
        return _np(out)

    host = {"wte.weight": get("embed_tokens.weight"),
            "wpe.weight": get("embed_positions.weight")
            [:config.seq_len + config.pos_offset],
            "ln_f.weight": get("final_layer_norm.weight"),
            "ln_f.bias": get("final_layer_norm.bias")}
    for i in range(config.num_layers):
        src, p = f"layers.{i}.", f"h.{i}."
        host[f"{p}ln1.weight"] = get(src + "self_attn_layer_norm.weight")
        host[f"{p}ln1.bias"] = get(src + "self_attn_layer_norm.bias")
        host[f"{p}ln2.weight"] = get(src + "final_layer_norm.weight")
        host[f"{p}ln2.bias"] = get(src + "final_layer_norm.bias")
        host[f"{p}attn.qkv.weight"] = np.concatenate(
            [get(f"{src}self_attn.{x}_proj.weight") for x in "qkv"], axis=0)
        host[f"{p}attn.qkv.bias"] = np.concatenate(
            [get(f"{src}self_attn.{x}_proj.bias") for x in "qkv"])
        for ours, theirs in (("attn.out", "self_attn.out_proj"),
                             ("mlp.fc_in", "fc1"), ("mlp.fc_out", "fc2")):
            host[f"{p}{ours}.weight"] = get(f"{src}{theirs}.weight")
            host[f"{p}{ours}.bias"] = get(f"{src}{theirs}.bias")
    return {k: _put(v, k, config.dtype, device) for k, v in host.items()}


def config_from_hf_gpt2(hf_config, **kwargs) -> GPTConfig:
    """A GPT-2 config object's fields as a ``GPTConfig`` (``kwargs``: the
    port's own fields, e.g. ``dtype`` or ``attention_impl``)."""
    return GPTConfig(vocab_size=hf_config.vocab_size,
                     hidden_size=hf_config.n_embd,
                     num_layers=hf_config.n_layer,
                     num_heads=hf_config.n_head,
                     seq_len=hf_config.n_positions,
                     tie_embeddings=True, **kwargs)


def config_from_hf_opt(hf_config, **kwargs) -> GPTConfig:
    """An OPT config object's fields as a ``GPTConfig``.  OPT-350m's
    post-norm layout is refused."""
    if not getattr(hf_config, "do_layer_norm_before", True):
        raise ValueError("OPT-350m's post-norm layout is not supported; use "
                         "a pre-norm OPT size (125m, 1.3b, 2.7b, ...)")
    if hf_config.ffn_dim % hf_config.hidden_size:
        raise ValueError(f"ffn_dim {hf_config.ffn_dim} is not a multiple "
                         f"of hidden_size {hf_config.hidden_size}")
    return GPTConfig(vocab_size=hf_config.vocab_size,
                     hidden_size=hf_config.hidden_size,
                     num_layers=hf_config.num_hidden_layers,
                     num_heads=hf_config.num_attention_heads,
                     seq_len=hf_config.max_position_embeddings,
                     mlp_ratio=hf_config.ffn_dim // hf_config.hidden_size,
                     activation=hf_config.activation_function,
                     pos_offset=2, tie_embeddings=True, **kwargs)


def _read_hf_dir(path: str):
    """(config object, state dict) of a local HF checkpoint directory."""
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        hf_config = types.SimpleNamespace(**json.load(f))
    bin_path = os.path.join(path, "pytorch_model.bin")
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.exists(st_path):
        from safetensors.torch import load_file
        sd = load_file(st_path)
    else:
        raise FileNotFoundError(
            f"{path} holds neither pytorch_model.bin nor model.safetensors")
    return hf_config, sd


def _hf_source(model_or_dir):
    if isinstance(model_or_dir, (str, os.PathLike)):
        if not os.path.isdir(model_or_dir):
            raise ValueError(
                f"{model_or_dir!r} is not a local directory; checkpoints "
                "are never downloaded: pass a model object or a directory")
        return _read_hf_dir(str(model_or_dir))
    return model_or_dir.config, model_or_dir.state_dict()


def hf_family(model_or_dir) -> str:
    """``"opt"`` or ``"gpt2"``: from a directory's ``config.json``
    ``model_type``, else the object's class name or config."""
    if isinstance(model_or_dir, (str, os.PathLike)):
        with open(os.path.join(model_or_dir, "config.json"),
                  encoding="utf-8") as f:
            kind = json.load(f).get("model_type", "")
    else:
        kind = (type(model_or_dir).__name__ + " " + str(getattr(
            getattr(model_or_dir, "config", None), "model_type", "")))
    return "opt" if "opt" in kind.lower() else "gpt2"


def _load(model_or_dir, configure, convert, dtype, device, config_kwargs):
    device = get_device(device)
    hf_config, sd = _hf_source(model_or_dir)
    config = configure(hf_config, dtype=dtype or torch.float32,
                       **config_kwargs)
    params = convert(sd, config, device=device)
    model = GPTModel(config, device=device)
    model.load_state_dict(params)
    return model, params, config


def load_opt(model_or_dir, dtype=None, device=None, **config_kwargs):
    """``(GPTModel, state dict, GPTConfig)`` of an HF OPT model object or
    local directory, on ``device`` (CUDA unless the caller asks for the
    CPU), weights in ``dtype`` (fp32 by default)."""
    return _load(model_or_dir, config_from_hf_opt, convert_opt_state_dict,
                 dtype, device, config_kwargs)


def load_gpt2(model_or_dir, dtype=None, device=None, **config_kwargs):
    """``(GPTModel, state dict, GPTConfig)`` of an HF GPT-2 model object or
    local directory, as ``load_opt``."""
    return _load(model_or_dir, config_from_hf_gpt2, convert_gpt2_state_dict,
                 dtype, device, config_kwargs)


# ---- params directories (the JAX package's layout) ------------------


def _flax_names(num_layers: int, lm_head: bool) -> List[Tuple[str, str, bool]]:
    """``(flax leaf name, port name, transposed)`` of every parameter."""
    out = [("wte.embedding", "wte.weight", False),
           ("wpe.embedding", "wpe.weight", False),
           ("ln_f.scale", "ln_f.weight", False),
           ("ln_f.bias", "ln_f.bias", False)]
    for i in range(num_layers):
        for ln in ("ln1", "ln2"):
            out += [(f"h{i}.{ln}.scale", f"h.{i}.{ln}.weight", False),
                    (f"h{i}.{ln}.bias", f"h.{i}.{ln}.bias", False)]
        for blk, sub in _LINEARS:
            out += [(f"h{i}.{blk}.{sub}.kernel", f"h.{i}.{blk}.{sub}.weight",
                     True),
                    (f"h{i}.{blk}.{sub}.bias", f"h.{i}.{blk}.{sub}.bias",
                     False)]
    if lm_head:
        out.append(("lm_head.kernel", "lm_head.weight", True))
    # the order of jax.tree_util's flattening: dict keys sorted per level
    return sorted(out, key=lambda e: e[0].split("."))


_LAYER = re.compile(r"^h(\d+)\.")


def _port_name(flax_name: str) -> Tuple[str, bool]:
    """The port's name of a flax leaf (without ``params.``) and whether its
    array is transposed on the way."""
    m = _LAYER.match(flax_name)
    layers = int(m.group(1)) + 1 if m else 0
    for f, p, tr in _flax_names(layers, flax_name.startswith("lm_head")):
        if f == flax_name:
            return p, tr
    raise KeyError(f"params dir leaf {flax_name!r} is not a GPT parameter")


def save_params_dir(params, path: str):
    """Write the port's weights (a ``GPTModel`` or its state dict) in the
    JAX package's layout: one fp32 ``.npy`` per flax leaf, named by its
    tree path under ``params.`` (as ``model.init`` nests them),
    and ``index.txt`` in flattening order.  Leaves are written by
    ``_IO_THREADS`` threads, each holding one leaf on the host."""
    sd = params.state_dict() if isinstance(params, torch.nn.Module) \
        else params
    layers = 1 + max((int(k.split(".")[1]) for k in sd
                      if k.startswith("h.")), default=-1)
    os.makedirs(path, exist_ok=True)
    leaves = _flax_names(layers, "lm_head.weight" in sd)

    def write(leaf):
        flax, port, tr = leaf
        arr = _np(sd[port]).astype(np.float32)
        np.save(os.path.join(path, _PREFIX + flax + ".npy"),
                np.ascontiguousarray(arr.T if tr else arr))
    with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
        list(pool.map(write, leaves))
    with open(os.path.join(path, "index.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(_PREFIX + flax for flax, _, _ in leaves))


def flax_param_shapes(config: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """Each flax leaf's shape (name without ``params.``) for ``config``."""
    model = GPTModel(config, device="meta")
    sd = model.state_dict()
    return {flax: tuple(reversed(sd[port].shape)) if tr
            else tuple(sd[port].shape)
            for flax, port, tr in _flax_names(config.num_layers,
                                              "lm_head.weight" in sd)}


def synthesize_params_dir(config: GPTConfig, path: str, std: float = 0.02):
    """Write a ``save_params_dir`` directory for ``config`` one leaf at a
    time (host memory of the largest leaf only), with the JAX package's
    values: LayerNorm scales 1, biases 0, other weights N(0, std) from
    ``np.random.RandomState(crc32(leaf name))``, so both packages
    synthesize the same files.  A leaf already on disk at its shape is
    kept (the synthesis resumes)."""
    os.makedirs(path, exist_ok=True)
    index = []
    for flax, shape in flax_param_shapes(config).items():
        name = _PREFIX + flax
        fpath = os.path.join(path, name + ".npy")
        index.append(name)
        if os.path.exists(fpath):
            try:
                if np.load(fpath, mmap_mode="r").shape == shape:
                    continue
            except (OSError, ValueError):
                pass
        if name.endswith("scale"):
            arr = np.ones(shape, np.float32)
        elif name.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        else:
            rs = np.random.RandomState(zlib.crc32(name.encode())
                                       & 0x7fffffff)
            arr = (rs.standard_normal(size=shape) * std).astype(np.float32)
        np.save(fpath, arr)
        del arr
    with open(os.path.join(path, "index.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(index))


def load_params_dir(path: str, dtype=None, device=None, specs=None,
                    logical_mesh=None) -> Dict[str, Any]:
    """A ``save_params_dir`` directory (either package's) as the port's
    state dict.  Each leaf file is memory-mapped; LayerNorm parameters
    load in fp32, the others in ``dtype`` (the file's fp32 by default).
    Without ``specs`` each lands whole on ``device`` (CUDA unless the
    caller asks for the CPU).  ``specs`` maps port names to
    ``ShardingSpec``-style specs over ``logical_mesh``: such a weight
    becomes a ``DistributedArray`` whose devices each read only their
    block of the file; weights without a spec are replicated.  Leaves are
    read by ``_IO_THREADS`` threads."""
    from alpa_tpu_torch.device_mesh import DistributedArray
    from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices
    if specs is None:
        device = get_device(device)
    with open(os.path.join(path, "index.txt"), encoding="utf-8") as f:
        names = [n for n in f.read().split("\n") if n]

    def read(name):
        flax = name[len(_PREFIX):] if name.startswith(_PREFIX) else name
        port, tr = _port_name(flax)
        mm = np.load(os.path.join(path, name + ".npy"), mmap_mode="r")
        arr = mm.T if tr else mm
        want = torch.float32 if _is_layer_norm(port) else (
            dtype or torch.float32)
        if specs is None:
            return port, torch.from_numpy(np.array(arr, np.float32)).to(
                device=device, dtype=want)
        spec = specs.get(port, tuple(() for _ in arr.shape))
        shards = []
        for p, dev in enumerate(logical_mesh.flat_devices()):
            idx = tuple(slice(o, o + n) for o, n in local_slices(
                arr.shape, spec, logical_mesh.coords(p), logical_mesh.shape))
            shards.append(torch.from_numpy(np.array(arr[idx], np.float32))
                          .to(device=dev, dtype=want))
        return port, DistributedArray(shards, spec, logical_mesh, arr.shape,
                                      want)
    with concurrent.futures.ThreadPoolExecutor(_IO_THREADS) as pool:
        return dict(pool.map(read, names))
