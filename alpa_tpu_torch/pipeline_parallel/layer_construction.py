"""Layer construction: cut a loss function's graph into pipeline layers.

Counterpart of ``alpa_tpu/pipeline_parallel/layer_construction.py``.  The
transform applies to the loss function before differentiation:
``alpa_tpu_torch.grad``/``value_and_grad`` consult the option that the
pipeshard compiler installs while it traces (``set_current_layer_option``).
``layer_level_transform`` traces the loss function with ``make_fx`` into an
aten graph and groups its nodes into layers: at the
``mark_pipeline_boundary()`` nodes (``ManualLayerOption``), or by the
cost-based DP ``cluster_nodes_by_cost`` (``AutoLayerOption``, and
``FollowLayerOption`` with another executable's stage count).  It wraps
every layer in start/end markers that carry each value entering or leaving
it and runs the marked graph in the loss function's place.  Run
differentiably inside the compiler's trace, the markers' autograd formula
gives each backward layer its own flipped markers.  With
``remat_layer=True`` each layer runs under non-reentrant
``torch.utils.checkpoint`` inside its markers, so the traced backward
recomputes the layer's forward between that layer's backward markers
(``_remat_by_layer``).

A block the model recomputes (GPT's ``remat_blocks``) reaches the traced
graph between ``remat_start``/``remat_end`` markers (``remat_block``).
``trace_loss`` drops the pair and tags the nodes between with their region
and its checkpoint policy, the counterpart of the JAX package's
``checkpoint`` eqn and its ``policy``: the auto-layer DP counts their flops
but takes no cut point among them, and the layer-marked graph runs each
region as one module under non-reentrant ``torch.utils.checkpoint``, so
the backward stage recomputes the block.  Under the ``"dots"`` policy
(``checkpoint_kwargs``) the region keeps the outputs of its ``mm`` and
``addmm`` nodes, as JAX's ``dots_with_no_batch_dims_saveable`` keeps the
dots without batch dimensions, and the backward recomputes the rest: a
policy sees aten ops here, and a product of a traced region is one of
those two.
"""
import dataclasses
import operator
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import fx
from torch.fx.experimental.proxy_tensor import (disable_proxy_modes_tracing,
                                                make_fx)
from torch.utils import _pytree as pytree
from torch.utils import checkpoint as torch_checkpoint
from torch.utils._python_dispatch import TorchDispatchMode

from alpa_tpu_torch.pipeline_parallel.computation import marker_outputs
from alpa_tpu_torch.pipeline_parallel.primitive_def import (
    is_boundary, is_marker, marker_name, pipeline_marker, pipeshard_tracing,
    tracing_active)
from alpa_tpu_torch.util import node_flops

_MARKER = torch.ops.alpa_tpu_torch.pipeline_marker.default
aten = torch.ops.aten


@dataclasses.dataclass
class LayerOption:
    """Base layer option."""
    remat_layer: bool = False


@dataclasses.dataclass
class ManualLayerOption(LayerOption):
    """Cut at the user's ``mark_pipeline_boundary()`` calls."""


@dataclasses.dataclass
class AutoLayerOption(LayerOption):
    """Cluster into ``layer_num`` layers by cost (``cluster_nodes_by_cost``):
    the fewest bytes crossing the cuts, each layer's flops within
    ``1 + eps`` of an equal share."""
    layer_num: int = 2
    eps: float = 0.6
    cost_criteria: str = "flops"


@dataclasses.dataclass
class FollowLayerOption(LayerOption):
    """Cluster automatically into as many layers as another pipeshard
    executable has forward stages, so that stage assignments line up."""
    src_executable: Any = None
    layer_num: int = 2

    def resolved_layer_num(self) -> int:
        ex = self.src_executable
        if ex is None:
            return self.layer_num
        n = getattr(ex, "num_fwd_stages", None)
        if n is None:
            raise ValueError(
                "FollowLayerOption.src_executable must be a pipeshard "
                f"executable (got {type(ex).__name__}, which has no "
                "stages to follow); pass layer_num explicitly instead")
        return int(n)


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


REMAT_REGION = "remat_region"
REMAT_POLICY = "remat_policy"
_REMAT_MARKS = ("remat_start", "remat_end")

# the products a "dots" region keeps: those without a batch dimension
_SAVED_DOTS = (aten.mm.default, aten.addmm.default)


class _KeepDots(TorchDispatchMode):
    """The forward of a ``"dots"`` region: keeps each ``mm``/``addmm``
    output, in order."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _SAVED_DOTS:
            self.kept.append(out)
        return out


class _ReuseDots(TorchDispatchMode):
    """The region's recomputation in the backward: each ``mm``/``addmm``
    hands back the forward's output, in order, and every other op runs
    again (attention's batched products and the flash forward included).
    Below autograd, so the products' gradients are recorded as usual."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept
        self.next = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SAVED_DOTS:
            self.next += 1
            return self.kept[self.next - 1]
        return func(*args, **(kwargs or {}))


def _dots_contexts():
    kept: list = []
    return _KeepDots(kept), _ReuseDots(kept)


def checkpoint_kwargs(policy: Optional[str]) -> dict:
    """The ``torch.utils.checkpoint`` keywords of a remat policy: None
    saves nothing, ``"dots"`` the products' outputs (``context_fn``: the
    forward keeps them, the recomputation reuses them).  The policy is
    applied by these dispatch modes, not by ``torch.utils.checkpoint``'s
    own selective checkpoint, which under a ``make_fx`` trace keeps every
    output and leaves the choice to a later partitioner: a region traced
    into a pipeshard or sharded step recomputes what the policy says."""
    if policy is None:
        return {}
    if policy == "dots":
        return dict(context_fn=_dots_contexts)
    raise ValueError(f"unknown remat_policy {policy!r}")


def collapse_remat_markers(graph: fx.Graph):
    """Drop the ``remat_block`` marker pairs of ``graph``, pointing each use
    of a marker's output at its operand, and tag every node between a pair
    with ``node.meta["remat_region"]`` (a name per region) and
    ``node.meta["remat_policy"]`` (the policy its marker names)."""
    region, policy, count = None, None, 0
    for node in list(graph.nodes):
        if is_marker(node, _REMAT_MARKS):
            for i, out in marker_outputs(node).items():
                out.replace_all_uses_with(node.args[0][i])
                graph.erase_node(out)
            if node.args[2] == "remat_start":
                name, _, policy = marker_name(node).partition("@")
                region, count = f"{name}#{count}", count + 1
                policy = policy or None
                checkpoint_kwargs(policy)   # an unknown policy raises here
            else:
                region = policy = None
            graph.erase_node(node)
        elif region is not None and node.op == "call_function":
            node.meta[REMAT_REGION] = region
            node.meta[REMAT_POLICY] = policy


def _remove_dead_nodes(graph: fx.Graph):
    """Drop compute nodes nothing uses (autograd's saved-tensor detaches);
    boundaries and in-place writes stay."""
    for node in reversed(list(graph.nodes)):
        schema = getattr(node.target, "_schema", None)
        if (node.op == "call_function" and not node.users and
                not is_boundary(node) and
                not (schema is not None and schema.is_mutable)):
            graph.erase_node(node)


########################################
# the auto-layer DP
########################################

HEAVY_OPS = frozenset({aten.mm.default, aten.addmm.default,
                       aten.bmm.default, aten.baddbmm.default,
                       aten.convolution.default})


def compute_nodes(graph: fx.Graph) -> List[fx.Node]:
    """The nodes the layer DP groups: every op but the boundaries."""
    return [n for n in graph.nodes
            if n.op == "call_function" and not is_boundary(n)]


def _segment_nodes(nodes: Sequence[fx.Node]) -> List[Tuple[int, int]]:
    """Coarsen nodes into segments that each end right after a heavy op,
    the only cut points (JAX's ``_segment_eqns``; the flash op is not one,
    as the JAX package's ``pallas_call`` is not, and neither is a product
    inside a remat region, as JAX's are inside its ``checkpoint`` eqn)."""
    bounds, start = [], 0
    for i, node in enumerate(nodes):
        if node.target in HEAVY_OPS and REMAT_REGION not in node.meta:
            bounds.append((start, i + 1))
            start = i + 1
    if start < len(nodes):
        bounds.append((start, len(nodes)))
    return bounds


def _value_bytes(node: fx.Node) -> Optional[float]:
    val = node.meta.get("val")
    if not isinstance(val, torch.Tensor):
        return None
    return float(val.numel()) * val.element_size()


def cluster_nodes_by_cost(nodes: Sequence[fx.Node], outputs: Any,
                          layer_num: int, eps: float = 0.6
                          ) -> List[List[fx.Node]]:
    """DP clustering of ``nodes`` into ``layer_num`` contiguous groups:
    ``cluster_eqns_by_cost`` of the JAX package over aten nodes.

    Minimizes, lexicographically, the bytes crossing the cuts and then the
    sum of squared layer flops (the tie-break toward balance), with every
    layer's flops (``node_flops``) within ``(1 + eps) * total /
    layer_num``.  Cuts fall only after heavy ops (``_segment_nodes``).  A
    value crosses each cut between its node and its last reader (the loss
    function's ``outputs`` read after the last segment), at numel x
    element size from its fake tensor.  Without a feasible clustering, an
    equal-flops split."""
    nodes = list(nodes)
    if not nodes or layer_num <= 1:
        return [nodes]
    segments = _segment_nodes(nodes)
    n = len(segments)
    if n <= layer_num:
        return [nodes[a:b] for a, b in segments]
    flops = np.array([sum(node_flops(v) for v in nodes[a:b])
                      for a, b in segments])
    total = flops.sum()
    budget = (1 + eps) * total / layer_num
    cum = np.concatenate([[0], np.cumsum(flops)]).tolist()

    seg_of = {}
    for si, (a, b) in enumerate(segments):
        for v in nodes[a:b]:
            seg_of[v] = si
    last_use = {}
    for v in nodes:
        for u in v.all_input_nodes:
            if u in seg_of:
                last_use[u] = seg_of[v]
    for v in pytree.tree_leaves(outputs):
        if isinstance(v, fx.Node) and v in seg_of:
            last_use[v] = n
    cut_bytes = np.zeros(n + 1)
    for v, d in seg_of.items():
        lu = last_use.get(v, d)
        nbytes = _value_bytes(v)
        if lu > d and nbytes is not None:
            cut_bytes[d + 1:lu + 1] += nbytes   # v crosses the cuts (d, lu]
    cut_bytes = cut_bytes.tolist()

    # f[k][i]: the lexicographic (cut bytes, sum of squared layer flops)
    # of the first i segments in k layers
    inf = float("inf")
    f = [[(inf, inf)] * (n + 1) for _ in range(layer_num + 1)]
    arg = [[0] * (n + 1) for _ in range(layer_num + 1)]
    f[0][0] = (0.0, 0.0)
    for k in range(1, layer_num + 1):
        for i in range(1, n + 1):
            for j in range(i):
                if cum[i] - cum[j] > budget or f[k - 1][j][0] == inf:
                    continue
                seg_fl = float(cum[i] - cum[j])
                c = (f[k - 1][j][0] + (cut_bytes[j] if j > 0 else 0.0),
                     f[k - 1][j][1] + seg_fl * seg_fl)
                if c < f[k][i]:
                    f[k][i] = c
                    arg[k][i] = j
    if f[layer_num][n][0] == inf:
        return _equal_flops_split(nodes, segments, flops, layer_num)
    cuts, i = [], n
    for k in range(layer_num, 0, -1):
        j = arg[k][i]
        cuts.append((j, i))
        i = j
    cuts.reverse()
    return [nodes[segments[a][0]:segments[b - 1][1]] for a, b in cuts
            if b > a]


def _equal_flops_split(nodes, segments, flops, layer_num):
    """Close a layer each time its flops reach an equal share."""
    target = flops.sum() / layer_num
    groups, cur, acc = [], [], 0.0
    for (a, b), fl in zip(segments, flops):
        cur.extend(nodes[a:b])
        acc += fl
        if acc >= target and len(groups) < layer_num - 1:
            groups.append(cur)
            cur, acc = [], 0.0
    if cur:
        groups.append(cur)
    return groups


########################################
# markers and remat
########################################


def _layer_io(gm: fx.GraphModule, sliced: List[List[fx.Node]]):
    """``(invars, outvars)`` of each group: every value it reads from
    outside, and every value it defines that a later group or the output
    reads."""
    layer_of: Dict[fx.Node, int] = {n: li for li, group in enumerate(sliced)
                                    for n in group}
    output = next(n for n in gm.graph.nodes if n.op == "output")
    later: set = set(output.all_input_nodes)
    io = []
    for li in range(len(sliced) - 1, -1, -1):
        used_after = set(later)
        for node in sliced[li]:
            later.update(node.all_input_nodes)
        invars = list(dict.fromkeys(
            v for n in sliced[li] for v in n.all_input_nodes
            if layer_of.get(v) != li))
        io.append((invars, [n for n in sliced[li] if n in used_after]))
    return io[::-1]


class _Checkpointed(torch.nn.Module):
    """A remat region's nodes, run under non-reentrant checkpoint with the
    region's policy when a gradient flows through them."""

    def __init__(self, inner: fx.GraphModule, policy: Optional[str] = None):
        super().__init__()
        self.inner = inner
        self.policy = policy

    def forward(self, *args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            return torch_checkpoint.checkpoint(
                self.inner, *args, use_reentrant=False,
                **checkpoint_kwargs(self.policy))
        return self.inner(*args)


def _copy_nodes(gm: fx.GraphModule, new: fx.Graph, group: List[fx.Node],
                local: Dict[fx.Node, fx.Node]):
    """Copy ``group`` into ``new`` (reading ``local``), each run of nodes of
    one remat region as a call of a ``_Checkpointed`` submodule of
    ``gm``."""
    i = 0
    while i < len(group):
        region = group[i].meta.get(REMAT_REGION)
        if region is None:
            local[group[i]] = new.node_copy(group[i], lambda v: local[v])
            i += 1
            continue
        j = i
        while j < len(group) and group[j].meta.get(REMAT_REGION) == region:
            j += 1
        members = group[i:j]
        inside = set(members)
        invars = list(dict.fromkeys(v for n in members
                                    for v in n.all_input_nodes
                                    if v not in inside))
        outvars = [n for n in members
                   if any(u not in inside for u in n.users)]
        sub = fx.Graph()
        env = {v: sub.placeholder(v.name) for v in invars}
        for n in members:
            env[n] = sub.node_copy(n, lambda v: env[v])
        sub.output([env[v] for v in outvars])
        name = f"_remat_{len([m for m in gm.children()])}"
        gm.add_submodule(name, _Checkpointed(
            fx.GraphModule(gm, sub), group[i].meta.get(REMAT_POLICY)))
        call = new.call_module(name, tuple(local[v] for v in invars))
        for k, v in enumerate(outvars):
            local[v] = new.call_function(operator.getitem, (call, k))
        i = j


def add_pipeline_marks_for_sliced_nodes(gm: fx.GraphModule,
                                        sliced: List[List[fx.Node]]
                                        ) -> fx.GraphModule:
    """A copy of ``gm`` with each group of nodes wrapped in a start marker
    over every value it uses from outside and an end marker over every
    value it defines that a later layer or the output uses (named
    ``layer_<i>``).  A remat region runs as one checkpointed module."""
    output = next(n for n in gm.graph.nodes if n.op == "output")
    new = fx.Graph()
    outer: Dict[fx.Node, fx.Node] = {}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            outer[node] = new.node_copy(node)
    for li, (group, (invars, outvars)) in enumerate(
            zip(sliced, _layer_io(gm, sliced))):
        name = f"layer_{li}"
        start = new.call_function(_MARKER,
                                  ([outer[v] for v in invars], name, "start"))
        local = {v: new.call_function(operator.getitem, (start, i))
                 for i, v in enumerate(invars)}
        _copy_nodes(gm, new, group, local)
        end = new.call_function(_MARKER,
                                ([local[v] for v in outvars], name, "end"))
        for i, v in enumerate(outvars):
            outer[v] = new.call_function(operator.getitem, (end, i))
    new.output(fx.node.map_arg(output.args[0], lambda v: outer[v]))
    return fx.GraphModule(gm, new)


def _mark(values: List[torch.Tensor], name: str, mark_type: str):
    """The marker over ``values`` inside a pipeshard trace; the values as
    they are outside one (``manual_remat`` on a plain call)."""
    if not tracing_active():
        return values
    return pipeline_marker(values, name, mark_type)


def _remat_by_layer(gm: fx.GraphModule, sliced: List[List[fx.Node]]
                    ) -> Callable:
    """``gm`` run layer by layer, each layer's nodes a ``GraphModule`` of
    their own under non-reentrant ``torch.utils.checkpoint`` between the
    layer's start and end markers: the counterpart of JAX's
    ``_remat_by_layer`` (``jax.checkpoint`` per layer).  Traced with its
    backward, each layer's forward is recomputed in that layer's backward
    section, between its flipped markers.  Remat regions inside a layer
    run inline: the layer is recomputed whole."""
    io = _layer_io(gm, sliced)
    layers = []
    for group, (invars, outvars) in zip(sliced, io):
        graph = fx.Graph()
        env = {v: graph.placeholder(v.name) for v in invars}
        for node in group:
            env[node] = graph.node_copy(node, lambda v: env[v])
        graph.output([env[v] for v in outvars])
        layers.append(fx.GraphModule(gm, graph))
    nodes = list(gm.graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]
    consts = {n: getattr(gm, n.target) for n in nodes if n.op == "get_attr"}
    output = nodes[-1]

    def run(*tensors):
        env = dict(consts)
        env.update(zip(placeholders, tensors))
        for li, (layer, (invars, outvars)) in enumerate(zip(layers, io)):
            name = f"layer_{li}"
            args = _mark([env[v] for v in invars], name, "start")
            outs = torch_checkpoint.checkpoint(layer, *args,
                                               use_reentrant=False)
            env.update(zip(outvars, _mark(list(outs), name, "end")))
        return fx.node.map_arg(output.args[0], lambda v: env[v])

    return run


########################################
# the loss-function transform
########################################


def slice_layers(gm: fx.GraphModule, layer_option: LayerOption
                 ) -> List[List[fx.Node]]:
    """The layer groups of a traced loss function under ``layer_option``
    (the dispatch of JAX's ``layer_level_transform``)."""
    output = next(n for n in gm.graph.nodes if n.op == "output")
    if isinstance(layer_option, AutoLayerOption):
        return cluster_nodes_by_cost(compute_nodes(gm.graph), output.args[0],
                                     layer_option.layer_num,
                                     layer_option.eps)
    if isinstance(layer_option, FollowLayerOption):
        return cluster_nodes_by_cost(compute_nodes(gm.graph), output.args[0],
                                     layer_option.resolved_layer_num())
    return slice_nodes_by_boundary(gm.graph)


def trace_loss(fn: Callable, *args, **kwargs):
    """``(gm, tensors, out_spec)``: ``fn`` traced by ``make_fx`` over the
    tensor leaves of its arguments, boundaries recorded, remat regions
    tagged (``collapse_remat_markers``), dead nodes dropped."""
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
    with disable_proxy_modes_tracing(), pipeshard_tracing():
        gm = make_fx(flat_fn)(*tensors)
    collapse_remat_markers(gm.graph)
    _remove_dead_nodes(gm.graph)
    return gm, tensors, out_spec[0]


def layer_level_transform(fn: Callable, layer_option: LayerOption
                          ) -> Callable:
    """``fn`` as its layer-marked traced graph (see the module docstring).
    Tensor leaves of the arguments become the graph's inputs; tensors
    ``fn`` closes over become its constants, which inside the compiler's
    trace are that trace's values."""

    def wrapped(*args, **kwargs):
        gm, tensors, out_spec = trace_loss(fn, *args, **kwargs)
        sliced = slice_layers(gm, layer_option)
        run = (_remat_by_layer(gm, sliced) if layer_option.remat_layer
               else add_pipeline_marks_for_sliced_nodes(gm, sliced))
        return pytree.tree_unflatten(run(*tensors), out_spec)

    return wrapped


def mark_traced_graph(gm: fx.GraphModule, layer_option: LayerOption
                      ) -> Callable:
    """What ``layer_level_transform`` runs, from a graph already traced
    with the markers on (flat tensors in, a flat list out): the
    compiler's first trace of a forward-only function, marked without
    tracing the function again."""
    _remove_dead_nodes(gm.graph)
    gm.recompile()
    sliced = slice_layers(gm, layer_option)
    return (_remat_by_layer(gm, sliced) if layer_option.remat_layer
            else add_pipeline_marks_for_sliced_nodes(gm, sliced))


def manual_remat(fun: Optional[Callable] = None):
    """Recompute each manually marked layer of ``fun`` (boundaries from
    ``mark_pipeline_boundary()``) in the backward pass, outside a pipeline
    compile too: JAX's ``manual_remat``.  A bare decorator, or called with
    the function."""

    def decorate(f):
        return layer_level_transform(f, ManualLayerOption(remat_layer=True))

    return decorate if fun is None else decorate(fun)


def automatic_remat(fun: Optional[Callable] = None, *, layer_num: int = 2,
                    eps: float = 0.6):
    """Recompute ``fun`` in the backward pass layer by layer, at the cuts
    of ``cluster_nodes_by_cost``: JAX's ``automatic_remat``."""

    def decorate(f):
        return layer_level_transform(
            f, AutoLayerOption(layer_num=layer_num, eps=eps,
                               remat_layer=True))

    return decorate if fun is None else decorate(fun)
