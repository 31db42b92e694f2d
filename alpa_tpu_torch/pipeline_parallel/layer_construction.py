"""Layer construction: cut a loss function's graph into pipeline layers.

Counterpart of ``alpa_tpu/pipeline_parallel/layer_construction.py``.  The
transform applies to the loss function before differentiation:
``alpa_tpu_torch.grad``/``value_and_grad`` consult the option that the
pipeshard compiler installs while it traces (``set_current_layer_option``).
``layer_level_transform`` traces the loss function with ``make_fx`` into an
aten graph, cuts it at the ``mark_pipeline_boundary()`` nodes
(``ManualLayerOption``), wraps every layer in start/end markers that carry
each value entering or leaving it, and runs the marked graph in the loss
function's place.  Run differentiably inside the compiler's trace, the
markers' autograd formula gives each backward layer its own flipped
markers.

Ported: ``ManualLayerOption``.  ``AutoLayerOption`` (the cost-based
clustering ``cluster_eqns_by_cost``), ``FollowLayerOption`` and
``remat_layer=True`` raise ``NotImplementedError`` (ROADMAP A.5).
"""
import dataclasses
import operator
import threading
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import (disable_proxy_modes_tracing,
                                                make_fx)
from torch.utils import _pytree as pytree

from alpa_tpu_torch.pipeline_parallel.primitive_def import is_boundary

_MARKER = torch.ops.alpa_tpu_torch.pipeline_marker.default


@dataclasses.dataclass
class LayerOption:
    """Base layer option."""
    remat_layer: bool = False


@dataclasses.dataclass
class ManualLayerOption(LayerOption):
    """Cut at the user's ``mark_pipeline_boundary()`` calls."""


@dataclasses.dataclass
class AutoLayerOption(LayerOption):
    """Cluster into ``layer_num`` layers by cost (not ported yet)."""
    layer_num: int = 2
    eps: float = 0.6
    cost_criteria: str = "flops"


@dataclasses.dataclass
class FollowLayerOption(LayerOption):
    """Take another executable's layer count (not ported yet)."""
    src_executable: Any = None
    layer_num: int = 2


def check_layer_option(layer_option: Optional[LayerOption]):
    """Raise on what this port does not run yet."""
    if not isinstance(layer_option, ManualLayerOption):
        name = ("layer_option=None (AutoLayerOption)" if layer_option is None
                else type(layer_option).__name__)
        raise NotImplementedError(
            f"{name}: only ManualLayerOption is ported; AutoLayerOption "
            "(cluster_eqns_by_cost) and FollowLayerOption are ROADMAP A.5")
    if layer_option.remat_layer:
        raise NotImplementedError(
            "remat_layer=True: remat layers are not ported yet (ROADMAP "
            "A.5)")


_layer_ctx = threading.local()


def set_current_layer_option(opt: Optional[LayerOption]):
    _layer_ctx.opt = opt


def current_layer_option() -> Optional[LayerOption]:
    return getattr(_layer_ctx, "opt", None)


def slice_nodes_by_boundary(graph: fx.Graph) -> List[List[fx.Node]]:
    """The compute nodes of ``graph`` in groups cut at boundary nodes;
    empty groups are dropped."""
    groups, cur = [], []
    for node in graph.nodes:
        if is_boundary(node):
            if cur:
                groups.append(cur)
            cur = []
        elif node.op == "call_function":
            cur.append(node)
    if cur:
        groups.append(cur)
    return groups


def _remove_dead_nodes(graph: fx.Graph):
    """Drop compute nodes nothing uses (autograd's saved-tensor detaches);
    boundaries stay."""
    for node in reversed(list(graph.nodes)):
        if (node.op == "call_function" and not node.users and
                not is_boundary(node)):
            graph.erase_node(node)


def add_pipeline_marks_for_sliced_nodes(gm: fx.GraphModule,
                                        sliced: List[List[fx.Node]]
                                        ) -> fx.GraphModule:
    """A copy of ``gm`` with each group of nodes wrapped in a start marker
    over every value it uses from outside and an end marker over every
    value it defines that a later layer or the output uses (named
    ``layer_<i>``)."""
    layer_of: Dict[fx.Node, int] = {n: li for li, group in enumerate(sliced)
                                    for n in group}
    output = next(n for n in gm.graph.nodes if n.op == "output")
    used_after: List[set] = [set() for _ in sliced]
    later: set = set(output.all_input_nodes)
    for li in range(len(sliced) - 1, -1, -1):
        used_after[li] = set(later)
        for node in sliced[li]:
            later.update(node.all_input_nodes)

    new = fx.Graph()
    outer: Dict[fx.Node, fx.Node] = {}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            outer[node] = new.node_copy(node)
    for li, group in enumerate(sliced):
        name = f"layer_{li}"
        invars = list(dict.fromkeys(
            v for n in group for v in n.all_input_nodes
            if layer_of.get(v) != li))
        start = new.call_function(_MARKER,
                                  ([outer[v] for v in invars], name, "start"))
        local = {v: new.call_function(operator.getitem, (start, i))
                 for i, v in enumerate(invars)}
        for node in group:
            local[node] = new.node_copy(node, lambda v: local[v])
        outvars = [n for n in group if n in used_after[li]]
        end = new.call_function(_MARKER,
                                ([local[v] for v in outvars], name, "end"))
        for i, v in enumerate(outvars):
            outer[v] = new.call_function(operator.getitem, (end, i))
    new.output(fx.node.map_arg(output.args[0], lambda v: outer[v]))
    return fx.GraphModule(gm, new)


def layer_level_transform(fn: Callable, layer_option: LayerOption
                          ) -> Callable:
    """``fn`` as its layer-marked traced graph (see the module docstring).
    Tensor leaves of the arguments become the graph's inputs; tensors
    ``fn`` closes over become its constants, which inside the compiler's
    trace are that trace's values."""
    check_layer_option(layer_option)

    def wrapped(*args, **kwargs):
        leaves, in_spec = pytree.tree_flatten((args, kwargs))
        idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        out_spec = []

        def flat_fn(*tensors):
            full = list(leaves)
            for i, t in zip(idx, tensors):
                full[i] = t
            a, kw = pytree.tree_unflatten(full, in_spec)
            out, spec = pytree.tree_flatten(fn(*a, **kw))
            out_spec.append(spec)
            return out

        tensors = [leaves[i] for i in idx]
        with disable_proxy_modes_tracing():
            gm = make_fx(flat_fn)(*tensors)
        _remove_dead_nodes(gm.graph)
        marked = add_pipeline_marks_for_sliced_nodes(
            gm, slice_nodes_by_boundary(gm.graph))
        return pytree.tree_unflatten(marked(*tensors), out_spec[0])

    return wrapped
