"""Pipeline and gradient markers.

Counterpart of ``alpa_tpu/pipeline_parallel/primitive_def.py``.  The JAX
package's ``pipeline_p`` is an identity primitive whose transpose rule
emits the flipped marker; here it is the ``torch.library`` custom op
``alpa_tpu_torch::pipeline_marker`` (a list of tensors, a ``name`` and a
``mark_type``), whose registered autograd formula emits the marker named
``name + "_backward"`` with the flipped type.  Traced with
``torch.autograd.grad`` under ``make_fx``, a forward layer wrapped in
start/end markers therefore gives a backward layer wrapped in the flipped
pair, which is what the pipeline slicer cuts at.

A custom op may not return an alias of its input, so the op copies; it
runs only while the pipeshard compiler traces (on fake tensors), and its
nodes become stage boundaries that are never executed.  Outside such a
trace every marker function returns its values unchanged: a
``ShardParallel`` step never calls the op.

``mark_pipeline_boundary()`` takes no tensor: it is the op
``alpa_tpu_torch::pipeline_boundary`` with no output.  ``make_fx`` keeps
such a node (it records every op it dispatches), so the boundary is
recorded as an op, not on the side.

``remat_block`` wraps a block the model recomputes in the backward pass
(GPT's ``remat_blocks``) in a ``remat_start``/``remat_end`` marker pair,
the counterpart of the JAX package's ``checkpoint`` eqn: the layer
transform takes the nodes between the pair as one region, which the
auto-layer DP never cuts, and runs the region under
``torch.utils.checkpoint``.
"""
import itertools
import threading
from contextlib import contextmanager
from typing import List

import torch
from torch.utils import _pytree as pytree

_FLIP = {"start": "end", "end": "start", "grad": "grad",
         "boundary": "boundary", "remat_start": "remat_end",
         "remat_end": "remat_start"}


@torch.library.custom_op("alpa_tpu_torch::pipeline_marker", mutates_args=())
def pipeline_marker(xs: List[torch.Tensor], name: str,
                    mark_type: str) -> List[torch.Tensor]:
    """Identity on ``xs`` (as copies: a custom op may not alias)."""
    return [x.clone() for x in xs]


@pipeline_marker.register_fake
def _pipeline_marker_fake(xs, name, mark_type):
    del name, mark_type
    return [torch.empty_like(x) for x in xs]


def _marker_setup(ctx, inputs, output):
    del output
    ctx.name, ctx.mark_type = inputs[1], inputs[2]
    ctx.wanted = [x.requires_grad for x in inputs[0]]
    # an unused output's gradient stays None, as JAX's symbolic zero
    ctx.set_materialize_grads(False)


def _marker_backward(ctx, grads):
    """The transpose rule: mark the gradients that exist, of the inputs
    that want one, with the flipped marker named ``name + "_backward"``."""
    idx = [i for i, g in enumerate(grads)
           if g is not None and ctx.wanted[i]]
    out = [None] * len(grads)
    if idx:
        marked = pipeline_marker([grads[i] for i in idx],
                                 ctx.name + "_backward",
                                 _FLIP[ctx.mark_type])
        for i, g in zip(idx, marked):
            out[i] = g
    return out, None, None


pipeline_marker.register_autograd(_marker_backward,
                                  setup_context=_marker_setup)


@torch.library.custom_op("alpa_tpu_torch::pipeline_boundary", mutates_args=())
def pipeline_boundary(name: str) -> None:
    """A layer boundary: no operand, no result."""
    del name


@pipeline_boundary.register_fake
def _pipeline_boundary_fake(name):
    del name


_state = threading.local()
_boundary_counter = itertools.count()


def tracing_active() -> bool:
    """True while the pipeshard compiler traces a function."""
    return getattr(_state, "tracing", False)


@contextmanager
def pipeshard_tracing():
    """Make the marker functions emit their ops (the compiler's trace)."""
    prev = tracing_active()
    _state.tracing = True
    try:
        yield
    finally:
        _state.tracing = prev


def mark_pipeline_boundary():
    """Layer-boundary hint for ``ManualLayerOption``; a no-op outside a
    pipeshard trace."""
    if tracing_active():
        pipeline_boundary(str(next(_boundary_counter)))


def mark_pipeline_values(values, name: str, mark_type: str):
    """Wrap the tensor leaves of a pytree in one marker (inside a pipeshard
    trace; the values as they are outside one)."""
    if not tracing_active():
        return values
    leaves, spec = pytree.tree_flatten(values)
    idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    if not idx:
        return values
    marked = pipeline_marker([leaves[i] for i in idx], name, mark_type)
    for i, x in zip(idx, marked):
        leaves[i] = x
    return pytree.tree_unflatten(leaves, spec)


def remat_block(fn, x: torch.Tensor, name: str) -> torch.Tensor:
    """``fn(x)`` between a ``remat_start`` and a ``remat_end`` marker named
    ``name`` (inside a pipeshard trace only): the layer transform recomputes
    the nodes between them in the backward pass, as one region."""
    (x,) = pipeline_marker([x], name, "remat_start")
    (y,) = pipeline_marker([fn(x)], name, "remat_end")
    return y


def mark_gradient(grads):
    """Tag values as the split point of compute-grad and apply-grad."""
    return mark_pipeline_values(grads, "grad", "grad")


def is_marker(node, mark_type=None) -> bool:
    """Whether an fx node is a pipeline marker (of ``mark_type``, a type or
    a tuple of types)."""
    if not (node.op == "call_function" and
            node.target is torch.ops.alpa_tpu_torch.pipeline_marker.default):
        return False
    if mark_type is None:
        return True
    if isinstance(mark_type, tuple):
        return node.args[2] in mark_type
    return node.args[2] == mark_type


def is_boundary(node) -> bool:
    return (node.op == "call_function" and
            node.target is torch.ops.alpa_tpu_torch.pipeline_boundary.default)


def marker_name(node) -> str:
    return node.args[1]
