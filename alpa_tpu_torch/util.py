"""Utilities of the port (counterpart of ``alpa_tpu/util.py``, in part)."""
import operator

import numpy as np
import torch


def compute_gpt_tflops(batch_size,
                       seq_len,
                       num_layers,
                       hidden_size,
                       vocab_size,
                       num_devices,
                       latency,
                       backward=True,
                       checkpoint_activations=False):
    """Analytic GPT TFLOPS per device, the formula of
    ``alpa_tpu.util.compute_gpt_tflops``."""
    factor = 24
    if backward:
        factor += 48
        if checkpoint_activations:
            factor += 24
    total_flop = (factor * batch_size * seq_len * (hidden_size**2) * num_layers *
                  (1 + seq_len / (6 * hidden_size)) +
                  (6 if backward else 2) * batch_size * seq_len * hidden_size * vocab_size)
    tflops = total_flop / latency / num_devices / 1e12
    return tflops


def _numel(val) -> float:
    return float(val.numel()) if hasattr(val, "numel") else 0.0


def _meta(arg):
    return arg.meta.get("val") if hasattr(arg, "meta") else None


PRODUCT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_FUSED_ADD = (torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def product_flops(node) -> float:
    """2 x numel(out) x the contracted size of a matrix product node (0 for
    any other node): what ``jaxpr_eqn_flops`` counts for a
    ``dot_general``."""
    if node.target not in PRODUCT_OPS:
        return 0.0
    lhs = _meta(node.args[1] if node.target in _FUSED_ADD else node.args[0])
    return 2.0 * _numel(_meta(node)) * int(lhs.shape[-1])


def node_flops(node) -> float:
    """Analytic flop count of one aten node of a traced graph: the
    counterpart of ``jaxpr_eqn_flops`` (``alpa_tpu/util.py``), so that the
    auto-layer DP weighs the port's graph as the JAX package weighs its
    jaxpr.

    A matrix product counts ``product_flops``, and ``addmm``/``baddbmm``
    also the numel of their output for the add that a jaxpr holds as an
    eqn of its own; a convolution 2 x numel(out) x prod(weight.shape[1:]),
    JAX's formula on the port's layout.  The flash op counts what
    ``jaxpr_eqn_flops`` counts inside the JAX package's ``flash_attention``
    call: its layout ops and the ``pallas_call`` at their outputs' sizes,
    5 numel(q) + 2 numel(k) + 2 numel(v), so it is nearly free, as there.
    Any other op counts the numel of its first tensor result, as a jaxpr
    eqn counts its first output.  Nodes a jaxpr lacks count 0: the item of
    a tuple result (``getitem``) and the transpose ``t`` that ``linear``
    puts before its product (``dot_general`` contracts either dimension);
    so does a 0-d result, as a jaxpr's scalars do."""
    aten = torch.ops.aten
    target = getattr(node, "target", None)
    out = _meta(node)
    if target in PRODUCT_OPS:
        extra = _numel(out) if target in _FUSED_ADD else 0.0
        return product_flops(node) + extra
    if target is aten.convolution.default:
        weight = _meta(node.args[1])
        return 2.0 * _numel(out) * float(np.prod(weight.shape[1:]))
    if isinstance(target, torch._ops.OpOverload) and \
            target.name() == "alpa_tpu_torch::flash_fwd":
        q, k, v = (_meta(a) for a in node.args[:3])
        return 5.0 * _numel(q) + 2.0 * _numel(k) + 2.0 * _numel(v)
    if target is operator.getitem or target is aten.t.default:
        return 0.0
    if isinstance(out, (tuple, list)):
        out = next((o for o in out if isinstance(o, torch.Tensor)), None)
    if isinstance(out, torch.Tensor) and out.dim() > 0:
        return _numel(out)
    return 0.0


def count_communication_primitives(executable,
                                   ignore_scalar_all_reduce: bool = False):
    """``(total, all_reduce, all_gather, reduce_scatter, all_to_all)``:
    the collectives of one run of a sharded executable's program, the
    counterpart of ``alpa_tpu.util.count_communication_primitives``,
    which counts them in the compiled HLO text.  With
    ``ignore_scalar_all_reduce`` an all-reduce of a 0-d value (a loss) is
    not counted.  An executable over one device has none."""
    program = getattr(executable, "program", None)
    records = getattr(program, "records", [])
    counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
              "all_to_all": 0}
    for rec in records:
        if ignore_scalar_all_reduce and rec.kind == "all_reduce" and \
                not rec.shape:
            continue
        counts[rec.kind] += 1
    return (sum(counts.values()), counts["all_reduce"], counts["all_gather"],
            counts["reduce_scatter"], counts["all_to_all"])
