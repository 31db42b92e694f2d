"""Precision classification of a stage's aten graph (counterpart of
``alpa_tpu/shard_parallel/eqn_classify.py``; read by
``analysis.numerics``).

Walks a stage's ``GraphModule`` and types the operations that decide
numerical fate: contractions (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
``convolution`` and the port's flash ops), reductions (``sum``, ``mean``,
``prod``, ``cumsum``, ``var`` and the like) and casts (``_to_copy``,
``convert_element_type``).  The result is the small JSON-able dict the plan
verifier attaches to each RUN op (``OpModel.precision``): ``min_accum``,
the narrowest accumulation dtype of any contraction or reduction of the
stage, and ``below_fp32_accum``, True when a reduction accumulates below
fp32 (the ``numerics.bf16-accumulation`` trigger: partial sums need fp32
even where storage is bf16, Micikevicius et al., "Mixed Precision
Training").

A contraction or reduction accumulates in its output's dtype (or the
``dtype`` it is given), as XLA's do unless told otherwise; a flash op
accumulates in fp32 inside its CUDA kernel (JAX reaches the same answer by
walking into the ``pallas_call`` body's fp32 ``dot_general``s).  JAX's
``add_any``, the sum autograd forms for the cotangents of a value read more
than once, has no aten op of its own (the port's joint graph writes it as
a plain ``aten.add.Tensor``, indistinguishable from the model's adds), and
is not counted: where JAX's ``add_any`` accumulates in bf16, a bf16
reduction of the same backward stage (the ``sum`` of a bias or layer-norm
parameter gradient over the batch) already sets ``below_fp32_accum``, so
the flags agree without it.  ``tests/test_torch_numerics.py`` pins
``min_accum`` and ``below_fp32_accum`` per stage against JAX's on the
narrow GPT in fp32 and in bf16.  The counts (``n_matmul``, ``n_reduce``,
``n_cast``) differ from JAX's by design: aten splits and merges operations
unlike the jaxpr (one ``native_layer_norm`` for JAX's mean, variance and
scale; no ``add_any``).
"""
from typing import Any, Dict, Optional

import torch

__all__ = ["classify_stage_precision", "classify_graph_precision"]

aten = torch.ops.aten

# wider-is-better rank for accumulation dtypes; other dtypes (ints,
# bools) do not take part in min_accum
_DTYPE_RANK = {
    "float64": 4,
    "float32": 3,
    "bfloat16": 2,
    "float16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
}

_CONTRACTIONS = frozenset({
    aten.mm.default, aten.bmm.default, aten.addmm.default,
    aten.baddbmm.default, aten.convolution.default,
    aten.convolution_backward.default})
_FLASH = ("alpa_tpu_torch::flash_fwd", "alpa_tpu_torch::flash_bwd")
_REDUCTIONS = frozenset({
    aten.sum.default, aten.sum.dim_IntList, aten.mean.default,
    aten.mean.dim, aten.prod.default, aten.prod.dim_int,
    aten.cumsum.default, aten.var.correction, aten.var_mean.correction})
_CASTS = frozenset({aten._to_copy.default,
                    torch.ops.prims.convert_element_type.default})


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _rank(dtype: str) -> Optional[int]:
    return _DTYPE_RANK.get(str(dtype))


def _out_dtype(node) -> str:
    val = node.meta.get("val")
    if isinstance(val, (list, tuple)):
        val = next((v for v in val if isinstance(v, torch.Tensor)), None)
    return _dtype_name(val.dtype) if isinstance(val, torch.Tensor) else ""


def _is_flash(node) -> bool:
    return any(k in str(node.target) for k in _FLASH)


def _fold_accum(acc: Dict[str, Any], dtype: str, reduction: bool) -> None:
    r = _rank(dtype)
    if r is None:
        return
    cur = _rank(acc["min_accum"]) if acc["min_accum"] else None
    if cur is None or r < cur:
        acc["min_accum"] = str(dtype)
    if reduction and r < _DTYPE_RANK["float32"]:
        acc["below_fp32_accum"] = True


def classify_graph_precision(graph) -> Dict[str, Any]:
    """Classify one aten graph (a ``GraphModule`` or ``fx.Graph``).
    Deterministic and JSON-able (it joins the cached plan verdict)."""
    g = graph.graph if hasattr(graph, "graph") else graph
    acc: Dict[str, Any] = {
        "n_matmul": 0, "n_reduce": 0, "n_cast": 0,
        "min_accum": "", "below_fp32_accum": False,
    }
    for node in g.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if target in _CONTRACTIONS:
            acc["n_matmul"] += 1
            _fold_accum(acc, _out_dtype(node), reduction=False)
        elif _is_flash(node):
            acc["n_matmul"] += 1
            _fold_accum(acc, "float32", reduction=False)
        elif target in _REDUCTIONS:
            acc["n_reduce"] += 1
            dtype = node.kwargs.get("dtype")
            _fold_accum(acc, _dtype_name(dtype) if dtype is not None
                        else _out_dtype(node), reduction=True)
        elif target in _CASTS:
            acc["n_cast"] += 1
    return acc


def classify_stage_precision(ex) -> Optional[Dict[str, Any]]:
    """``classify_graph_precision`` over a stage executable's graph; None
    when the executable carries none (synthetic test stages), and the
    numerics analysis then skips the accumulation checks of that RUN."""
    module = getattr(ex, "module", None)
    if module is None or not hasattr(module, "graph"):
        return None
    try:
        return classify_graph_precision(module)
    except Exception:  # pylint: disable=broad-except
        return None
