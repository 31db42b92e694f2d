"""Per-op sharding strategies and the strategy graph, over an aten graph.

Counterpart of ``alpa_tpu/shard_parallel/strategy.py``, with the joint
aten graph that ``make_fx`` traces (``shard_parallel.compile_executable
.trace_flat``) in place of a jaxpr.  The design is JAX's:

* **nodes** are decision points: graph inputs, products (``mm``,
  ``addmm``, ``bmm``), reductions, gathers and scatters (``embedding``,
  its backward, ``index_put``, ``scatter_add``), row-wise normalizations,
  and unknown ops.  A node has a list of strategies; a strategy fixes its
  output Spec, a communication cost and the Specs its operands must have.
  An unknown op (``split``, ``cat``, the flash custom ops, ``nll_loss``)
  is a replicated barrier, as JAX's split, concatenate and ``pallas_call``
  are.
* **follow chains**: elementwise ops, casts, transposes, ``expand``,
  views and squeezes create no node; they reuse their lead operand's
  decision through a dim-mapping (``follow_dimmap``).
* **edges** join a producer node to a consumer node with a dense
  resharding-cost matrix C[s_src, s_dst]; a side operand of a followed
  op is joined to the lead operand's node by a consistency edge.

The ILP (``ilp.py``) picks one strategy per node.

Where aten differs from a jaxpr, the port reads it as JAX 0.9 traces the
same model, so that the graphs and their costs agree:

* A product sees its operands before the views that merged the batch dim
  with another (aten's ``view(B*S, H)`` before a linear,
  ``(B*heads, S, D)`` before attention's ``bmm``), so its strategies are
  ``dot_general``'s on the unmerged tensors, and its output is seen
  unmerged by the view that follows.  Other merges and splits map as
  JAX's reshape rule maps them: a 1:1 dim maps, the rest does not.
* A side operand of a followed op is at its own size, and left out when
  8 times smaller than the lead (JAX 0.9 broadcasts size-1 dims
  implicitly); ``addmm``'s bias is such a side operand of its product.
* ``native_layer_norm``, ``_softmax``, ``_log_softmax`` and their
  backward ops are single aten ops where JAX has reductions and
  elementwise ops: their nodes and edges are those of JAX's trace of
  flax's LayerNorm, ``jax.nn.softmax`` and ``logsumexp`` (which value
  leads each elementwise op, which reductions run on which value).
* ``where`` and ``masked_fill`` follow their predicate, which JAX's
  ``jnp.where`` broadcasts to full size and puts first in ``select_n``;
  an elementwise op that broadcasts constants alone to a larger shape
  (aten's causal mask ``arange(S)[:, None] >= arange(S)[None]``) is a
  free node, as JAX's 2-D ``broadcasted_iota`` is.
* Multi-output ops: the flash ops charge their inputs' gathers once, as
  the JAX flash path does at its layout reshapes; ``split`` charges them
  per output, as JAX's split does.  ``nll_loss`` reads the gold logits
  (JAX's ``take_along_axis`` gather, a barrier); its backward writes them
  into a replicated zero tensor (JAX's scatter-add, a barrier) and reads
  only their shape from its ``self`` operand.

Remat regions need nothing: ``make_fx`` inlines a checkpointed block's
forward and its recomputation, as JAX's flattening inlines ``remat``.
The convolution handler waits for the models that use it (ROADMAP A.9).
A solved graph keeps, for every value, its decision node and dim-map
(``StrategyGraph.value_nodes``), which ``spmd_partition.py`` reads to
realise the plan, as JAX's ``make_constrained_fun`` reads its plan.
"""
import dataclasses
import itertools
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import fx

from alpa_tpu_torch.shard_parallel.sharding_spec import (
    Aval, Spec, enumerate_var_specs, make_spec, nbytes, num_shards,
    replicated_spec, resharding_cost, sharded_bytes, spec_valid)

aten = torch.ops.aten

DimMap = Tuple[Optional[int], ...]  # value dim -> node dim (None: fresh)


def _ops(*names) -> frozenset:
    """The overloads of the named aten ops."""
    out = set()
    for name in names:
        packet = getattr(aten, name)
        out.update(getattr(packet, o) for o in packet.overloads())
    return frozenset(out)


ELEMENTWISE_OPS = _ops(
    "add", "sub", "mul", "div", "rsub", "neg", "exp", "exp2", "log",
    "log1p", "expm1", "tanh", "sqrt", "rsqrt", "pow", "reciprocal", "abs",
    "sign", "floor", "ceil", "round", "sin", "cos", "erf", "sigmoid",
    "relu", "gelu", "silu", "gelu_backward", "threshold_backward",
    "sigmoid_backward", "tanh_backward", "silu_backward", "where",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "masked_fill",
    "eq", "ne", "ge", "gt", "le", "lt", "logical_and", "logical_or",
    "logical_not", "bitwise_not", "bitwise_and", "bitwise_or", "isfinite",
    "lerp", "addcmul", "addcdiv", "_to_copy", "clone", "alias", "detach",
    "copy", "copy_", "add_", "sub_", "mul_", "div_", "fill", "square",
    "_conj", "lift_fresh_copy")
VIEW_OPS = _ops("view", "_unsafe_view", "reshape")
DOT_OPS = _ops("mm", "addmm", "bmm")
REDUCE_OPS = _ops("sum", "mean", "amax", "amin", "prod", "any", "all",
                  "argmax", "argmin")
SOFTMAX_OPS = _ops("_softmax", "_log_softmax")
LOG_SOFTMAX_BWD = aten._log_softmax_backward_data.default
SOFTMAX_BWD = aten._softmax_backward_data.default
LAYER_NORM = aten.native_layer_norm.default
LAYER_NORM_BWD = aten.native_layer_norm_backward.default
EMBEDDING = aten.embedding.default
EMBEDDING_BWD = aten.embedding_dense_backward.default
INDEX_PUT = _ops("index_put", "index_put_", "_index_put_impl")
SCATTER_ADD = _ops("scatter_add")
NLL_FWD = aten.nll_loss_forward.default
NLL_BWD = aten.nll_loss_backward.default
# multi-output opaque ops charging their inputs' gathers once (the JAX
# flash path gathers at its layout reshapes, before the kernel)
_GATHER_ONCE = ("alpa_tpu_torch.flash_fwd", "alpa_tpu_torch.flash_bwd")
#: node meta key of a gradient accumulator's in-place add
#: (``pipeline_parallel.apply_grad.compute_grad_to_accumulate_grad``)
ACCUMULATES = "accumulates"
PIPELINE_MARKER = "alpa_tpu_torch.pipeline_marker"
PIPELINE_BOUNDARY = "alpa_tpu_torch.pipeline_boundary"


def identity_dimmap(ndim: int) -> DimMap:
    return tuple(range(ndim))


def compose_dimmap(outer: DimMap, inner: DimMap) -> DimMap:
    """outer: var<-mid, inner: mid<-node  =>  var<-node."""
    return tuple(inner[m] if m is not None else None for m in outer)


def map_spec(node_spec: Spec, dimmap: DimMap, ndim: int
             ) -> Tuple[Spec, Tuple[int, ...]]:
    """A node's spec seen through a dim-mapping, and the mesh axes of node
    dims the mapping does not carry (an edge charges their all-gather)."""
    mapped = [() for _ in range(ndim)]
    used_node_dims = set()
    for d, nd in enumerate(dimmap):
        if nd is not None and nd < len(node_spec):
            mapped[d] = node_spec[nd]
            used_node_dims.add(nd)
    dropped = []
    for nd, axes in enumerate(node_spec):
        if nd not in used_node_dims:
            dropped.extend(axes)
    return tuple(mapped), tuple(dropped)


@dataclasses.dataclass
class Strategy:
    name: str
    out_spec: Spec
    comm_cost: float
    # required operand specs, parallel to the node's operand list
    operand_specs: Tuple[Spec, ...] = ()
    # resident bytes per device (invar nodes; the ILP's memory budget)
    mem_bytes: float = 0.0
    comm_kind: str = "all_reduce"
    # an objective nudge breaking genuine ties; not a communication cost
    tie_bias: float = 0.0
    # a ZeRO leaf whose gradient reduce-scatter runs through the gradient
    # codec ("int8" or "fp8"; ``global_config.grad_quantize``)
    codec: Optional[str] = None


@dataclasses.dataclass
class Node:
    idx: int
    kind: str  # 'invar' | 'op'
    aval: Any
    strategies: List[Strategy]
    label: str = ""
    invar_idx: Optional[int] = None
    # op nodes: the fx node whose value the node decides
    outvar: Optional[fx.Node] = None


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    cost: np.ndarray   # cost[s_src, s_dst]
    # JAX's consistency edge of an elementwise op's side operand (not an
    # operand of the node it enters)
    consistency: bool = False


@dataclasses.dataclass
class StrategyGraph:
    """``value_nodes``: for every value of the traced graph (an fx node,
    or ``(fx node, output index)`` of a multi-output op), the decision
    node it belongs to and the dim-map it reaches it by (value dim ->
    node dim), from which the SPMD partitioner gives it a Spec
    (``make_constrained_fun``'s role).  ``dot_groups``: for each product
    node, per operand, the virtual dims (``dot_node``) that each of the
    aten operand's dims merges."""
    nodes: List[Node]
    edges: List[Edge]
    logical_mesh: Any
    graph: Optional[fx.Graph] = None
    value_nodes: Dict[Any, Tuple[int, DimMap]] = dataclasses.field(
        default_factory=dict)
    dot_groups: Dict[fx.Node, Tuple[List[List[Tuple[int, int]]], ...]] = \
        dataclasses.field(default_factory=dict)

    def stats(self):
        nvars = sum(len(n.strategies) for n in self.nodes)
        nevars = sum(e.cost.size for e in self.edges)
        return (f"{len(self.nodes)} nodes / {nvars} strategy vars / "
                f"{len(self.edges)} edges / {nevars} edge vars")


########################################
# values of the aten graph
########################################


def _val(x):
    """The fake value of an fx node (None for a non-tensor)."""
    if isinstance(x, fx.Node):
        v = x.meta.get("val")
        return v if isinstance(v, torch.Tensor) else None
    return None


def _aval(t) -> Aval:
    return Aval(tuple(t.shape), t.dtype)


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _tensor_args(node: fx.Node) -> List[fx.Node]:
    """The tensor-valued fx nodes among a node's arguments, in order."""
    return [a for a in node.all_input_nodes if _val(a) is not None]


########################################
# products
########################################


def _dot_dims(node: fx.Node):
    """``(lhs, rhs, lhs_b, rhs_b, lhs_c, rhs_c)`` of a product node: its two
    operands and the dims of ``dot_general``'s dimension numbers for the
    same product (``mm``: (M, K) x (K, N); ``bmm``: (B, M, K) x
    (B, K, N))."""
    if node.target is aten.addmm.default:
        lhs, rhs = node.args[1], node.args[2]
    else:
        lhs, rhs = node.args[0], node.args[1]
    if node.target is aten.bmm.default:
        return lhs, rhs, [0], [0], [2], [1]
    return lhs, rhs, [], [], [1], [0]


def dot_semantic_dims(lhs_shape, rhs_shape, lhs_b, rhs_b, lhs_c, rhs_c):
    """``_dot_semantic_dims`` (``alpa_tpu/shard_parallel/strategy.py:289``):
    (lhs_b, rhs_b, lhs_c, rhs_c, lhs_free, rhs_free), the output's dims
    being batch..., lhs free..., rhs free...."""
    lhs_free = [d for d in range(len(lhs_shape))
                if d not in lhs_c and d not in lhs_b]
    rhs_free = [d for d in range(len(rhs_shape))
                if d not in rhs_c and d not in rhs_b]
    return (list(lhs_b), list(rhs_b), list(lhs_c), list(rhs_c), lhs_free,
            rhs_free)


def enumerate_dot_strategies(lhs_av, rhs_av, out_av, dims,
                             logical_mesh) -> List[Strategy]:
    """The dot handler (``alpa_tpu/shard_parallel/strategy.py:303``): each
    non-trivial mesh axis takes one role, a batch dim (b), an lhs free dim
    (i), an rhs free dim (j) or a contracting dim (k, an all-reduce of the
    output on that axis).  ``dims``: ``dot_semantic_dims``'s tuple."""
    mesh_shape = logical_mesh.shape
    lhs_b, rhs_b, lhs_c, rhs_c, lhs_free, rhs_free = dims
    nb = len(lhs_b)
    lhs_nd, rhs_nd = len(lhs_av.shape), len(rhs_av.shape)
    out_ndim = len(out_av.shape)
    nontrivial = [a for a, s in enumerate(mesh_shape) if s > 1]
    replicated = Strategy("R", replicated_spec(out_ndim), 0.0,
                          (replicated_spec(lhs_nd), replicated_spec(rhs_nd)))
    if not nontrivial:
        return [replicated]
    role_choices = ([("b", i) for i in range(nb)] +
                    [("i", i) for i in range(len(lhs_free))] +
                    [("j", j) for j in range(len(rhs_free))] +
                    [("k", k) for k in range(len(lhs_c))])
    strategies, seen = [], set()
    for assignment in itertools.product(role_choices, repeat=len(nontrivial)):
        if len(set(assignment)) != len(assignment):
            continue
        lhs_map, rhs_map, out_map, ar_axes = {}, {}, {}, []
        for axis, (role, pos) in zip(nontrivial, assignment):
            if role == "b":
                lhs_map[lhs_b[pos]] = axis
                rhs_map[rhs_b[pos]] = axis
                out_map[pos] = axis
            elif role == "i":
                lhs_map[lhs_free[pos]] = axis
                out_map[nb + pos] = axis
            elif role == "j":
                rhs_map[rhs_free[pos]] = axis
                out_map[nb + len(lhs_free) + pos] = axis
            else:
                lhs_map[lhs_c[pos]] = axis
                rhs_map[rhs_c[pos]] = axis
                ar_axes.append(axis)
        lhs_spec = make_spec(lhs_nd, lhs_map)
        rhs_spec = make_spec(rhs_nd, rhs_map)
        out_spec = make_spec(out_ndim, out_map)
        if not (spec_valid(lhs_av, lhs_spec, mesh_shape) and
                spec_valid(rhs_av, rhs_spec, mesh_shape) and
                spec_valid(out_av, out_spec, mesh_shape)):
            continue
        key = (lhs_spec, rhs_spec, out_spec)
        if key in seen:
            continue
        seen.add(key)
        out_bytes = sharded_bytes(out_av, out_spec, mesh_shape)
        cost = sum(logical_mesh.all_reduce_cost(out_bytes, a)
                   for a in ar_axes)
        name = "".join(f"{r}{p}@{a}" for a, (r, p) in
                       zip(nontrivial, assignment))
        strategies.append(Strategy(name, out_spec, cost,
                                   (lhs_spec, rhs_spec)))
    return strategies or [replicated]


########################################
# reductions and normalizations
########################################


def _reduced_dims(node: fx.Node, ndim: int) -> Tuple[List[int], bool]:
    """(reduced dims, keepdim) of a reduction node."""
    args, kwargs = node.args, node.kwargs
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return list(range(ndim)), bool(keepdim)
    dims = [dim] if isinstance(dim, int) else list(dim)
    return sorted(d % max(ndim, 1) for d in dims), bool(keepdim)


def enumerate_reduce_strategies(in_av, out_av, red_dims: Sequence[int],
                                keepdim: bool, logical_mesh
                                ) -> List[Strategy]:
    """Strategies indexed by the operand's spec; a sharded reduced dim
    pays an all-reduce of the output (``alpa_tpu/shard_parallel/
    strategy.py:503``).  ``keepdim``: the output keeps reduced dims at
    size 1."""
    mesh_shape = logical_mesh.shape
    red = set(red_dims)
    kept = [d for d in range(len(in_av.shape)) if d not in red]
    strategies = []
    for in_spec in enumerate_var_specs(in_av, mesh_shape):
        out_map, ar_axes = {}, []
        for d, axes in enumerate(in_spec):
            if not axes:
                continue
            if d in red:
                ar_axes.extend(axes)
            else:
                out_map[d if keepdim else kept.index(d)] = (
                    tuple(axes) if len(axes) > 1 else axes[0])
        out_spec = make_spec(len(out_av.shape), out_map)
        if not spec_valid(out_av, out_spec, mesh_shape):
            continue
        out_bytes = sharded_bytes(out_av, out_spec, mesh_shape)
        cost = sum(logical_mesh.all_reduce_cost(out_bytes, a)
                   for a in ar_axes)
        strategies.append(Strategy(f"red{in_spec}", out_spec, cost,
                                   (in_spec,)))
    return strategies or [
        Strategy("R", replicated_spec(len(out_av.shape)), 0.0,
                 (replicated_spec(len(in_av.shape)),))]


########################################
# gathers and scatters
########################################


def enumerate_gather_strategies(op_av, idx_av, out_av, indexed_dim: int,
                                logical_mesh) -> List[Strategy]:
    """A row gather ``out[..i] = op[idx[..i], ...]`` (``embedding``), JAX's
    gather handler (``alpa_tpu/shard_parallel/strategy.py:537``) on the
    same ``take``: each non-trivial mesh axis takes one role,

      ('ib', k): the k-th index dim, with the output's k-th dim, free;
      ('pt', d): a passthrough operand dim, with its output dim, free;
      ('ix', d): the indexed operand dim (vocab-parallel): the partial
                 outputs all-reduce.

    Operand specs: (op, idx)."""
    mesh_shape = logical_mesh.shape
    op_nd, idx_nd, out_nd = (len(op_av.shape), len(idx_av.shape),
                             len(out_av.shape))
    passthrough = [d for d in range(op_nd) if d != indexed_dim]
    nontrivial = [a for a, s in enumerate(mesh_shape) if s > 1]
    replicated = Strategy("R", replicated_spec(out_nd), 0.0,
                          (replicated_spec(op_nd), replicated_spec(idx_nd)))
    if not nontrivial:
        return [replicated]
    role_choices = ([("ib", k) for k in range(idx_nd)] +
                    [("pt", d) for d in passthrough] +
                    [("ix", indexed_dim)])
    strategies, seen = [], set()
    for assignment in itertools.product(role_choices, repeat=len(nontrivial)):
        if len(set(assignment)) != len(assignment):
            continue
        op_map, idx_map, out_map, ar_axes = {}, {}, {}, []
        for axis, (role, pos) in zip(nontrivial, assignment):
            if role == "ib":
                idx_map[pos] = axis
                out_map[pos] = axis
            elif role == "pt":
                op_map[pos] = axis
                out_map[idx_nd + passthrough.index(pos)] = axis
            else:
                op_map[pos] = axis
                ar_axes.append(axis)
        op_spec = make_spec(op_nd, op_map)
        idx_spec = make_spec(idx_nd, idx_map)
        out_spec = make_spec(out_nd, out_map)
        if not (spec_valid(op_av, op_spec, mesh_shape) and
                spec_valid(idx_av, idx_spec, mesh_shape) and
                spec_valid(out_av, out_spec, mesh_shape)):
            continue
        key = (op_spec, idx_spec, out_spec)
        if key in seen:
            continue
        seen.add(key)
        out_bytes = sharded_bytes(out_av, out_spec, mesh_shape)
        cost = sum(logical_mesh.all_reduce_cost(out_bytes, a)
                   for a in ar_axes)
        name = "g" + "".join(f"{r}{p}@{a}" for a, (r, p) in
                             zip(nontrivial, assignment))
        strategies.append(Strategy(name, out_spec, cost, (op_spec, idx_spec)))
    return strategies or [replicated]


def enumerate_scatter_strategies(op_av, idx_av, upd_av, scattered_dim: int,
                                 window_pairs, upd_batch_dims,
                                 logical_mesh) -> List[Strategy]:
    """A scatter-add into ``op`` (its output has op's shape), JAX's scatter
    handler (``alpa_tpu/shard_parallel/strategy.py:637``): each
    non-trivial mesh axis takes one role,

      ('w', d):  an operand window dim with its update dim, free;
      ('sc', d): the scattered operand dim (vocab-parallel), free;
      ('ub', k): the k-th update batch dim with the index dim beside it:
                 the operand-shaped partial sums all-reduce.

    ``window_pairs``: (operand dim, update dim) of the full window dims;
    ``upd_batch_dims``: (update dim, index dim) pairs.  Operand specs:
    (op, idx, upd)."""
    mesh_shape = logical_mesh.shape
    op_nd, idx_nd, upd_nd = (len(op_av.shape), len(idx_av.shape),
                             len(upd_av.shape))
    nontrivial = [a for a, s in enumerate(mesh_shape) if s > 1]
    replicated = Strategy("R", replicated_spec(op_nd), 0.0,
                          (replicated_spec(op_nd), replicated_spec(idx_nd),
                           replicated_spec(upd_nd)))
    if not nontrivial:
        return [replicated]
    window = dict(window_pairs)
    role_choices = ([("w", d) for d in window] + [("sc", scattered_dim)] +
                    [("ub", k) for k in range(len(upd_batch_dims))])
    strategies, seen = [], set()
    for assignment in itertools.product(role_choices, repeat=len(nontrivial)):
        if len(set(assignment)) != len(assignment):
            continue
        op_map, idx_map, upd_map, ar_axes = {}, {}, {}, []
        for axis, (role, pos) in zip(nontrivial, assignment):
            if role == "w":
                op_map[pos] = axis
                upd_map[window[pos]] = axis
            elif role == "sc":
                op_map[pos] = axis
            else:
                ud, idim = upd_batch_dims[pos]
                upd_map[ud] = axis
                if idim is not None:
                    idx_map[idim] = axis
                ar_axes.append(axis)
        op_spec = make_spec(op_nd, op_map)
        idx_spec = make_spec(idx_nd, idx_map)
        upd_spec = make_spec(upd_nd, upd_map)
        if not (spec_valid(op_av, op_spec, mesh_shape) and
                spec_valid(idx_av, idx_spec, mesh_shape) and
                spec_valid(upd_av, upd_spec, mesh_shape)):
            continue
        key = (op_spec, idx_spec, upd_spec)
        if key in seen:
            continue
        seen.add(key)
        out_bytes = sharded_bytes(op_av, op_spec, mesh_shape)
        cost = sum(logical_mesh.all_reduce_cost(out_bytes, a)
                   for a in ar_axes)
        name = "s" + "".join(f"{r}{p}@{a}" for a, (r, p) in
                             zip(nontrivial, assignment))
        strategies.append(Strategy(name, op_spec, cost,
                                   (op_spec, idx_spec, upd_spec)))
    return strategies or [replicated]


########################################
# follow-through dim mappings
########################################


def _broadcast_dimmap(in_shape, out_shape) -> Optional[DimMap]:
    """Right-aligned broadcasting: out dim -> in dim where the sizes
    agree."""
    if len(in_shape) > len(out_shape):
        return None
    off = len(out_shape) - len(in_shape)
    return tuple(None if d < off or in_shape[d - off] != out_shape[d]
                 else d - off for d in range(len(out_shape)))


def reshape_dimmap(in_shape, out_shape) -> DimMap:
    """A view's dim-mapping.  Dims are grouped where their products meet.
    A 1:1 group maps (size-1 dims map nothing).  A group holding the
    leading dim (aten's batch merges: ``(B, S) -> B*S`` before a linear,
    ``(B, heads) -> B*heads`` before attention) keeps its leading part's
    sharding: a merged dim carries its leading input dim, a split dim
    gives it to its leading output dim.  Any other merge or split maps
    nothing, as JAX's reshape rule drops a dim it cannot map 1:1."""
    dm: List[Optional[int]] = [None] * len(out_shape)
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        gi, gj = [i], [j]
        pi, pj = in_shape[i], out_shape[j]
        while pi != pj:
            if pi < pj:
                i += 1
                if i >= len(in_shape):
                    return tuple(dm)
                gi.append(i)
                pi *= in_shape[i]
            else:
                j += 1
                if j >= len(out_shape):
                    return tuple(dm)
                gj.append(j)
                pj *= out_shape[j]
        nt_in = [d for d in gi if in_shape[d] > 1]
        nt_out = [d for d in gj if out_shape[d] > 1]
        one_to_one = len(nt_in) == 1 and len(nt_out) == 1
        leading = 0 in gi and 0 in gj
        if nt_in and nt_out and (one_to_one or (
                leading and (len(nt_in) == 1 or len(nt_out) == 1))):
            dm[nt_out[0]] = nt_in[0]
        i += 1
        j += 1
    return tuple(dm)


def follow_dimmap(node: fx.Node, operand: fx.Node) -> Optional[DimMap]:
    """If ``node``'s output can follow ``operand``'s sharding through a
    pure dim-mapping, return out_dim -> operand_dim, else None."""
    out, val = _val(node), _val(operand)
    if out is None or val is None:
        return None
    out_shape, in_shape = tuple(out.shape), tuple(val.shape)
    target = node.target
    if target in ELEMENTWISE_OPS:
        if in_shape == out_shape:
            return identity_dimmap(len(out_shape))
        return _broadcast_dimmap(in_shape, out_shape)
    if operand is not node.args[0]:
        return None
    if target in (aten.t.default, aten.transpose.int):
        nd = len(in_shape)
        if target is aten.t.default:
            d0, d1 = 0, nd - 1
        else:
            d0, d1 = node.args[1] % nd, node.args[2] % nd
        perm = list(range(nd))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return tuple(perm)
    if target is aten.permute.default:
        return tuple(d % len(in_shape) for d in node.args[1])
    if target is aten.expand.default:
        return _broadcast_dimmap(in_shape, out_shape)
    if target in VIEW_OPS:
        return reshape_dimmap(in_shape, out_shape)
    if target in (aten.squeeze.dim, aten.squeeze.dims, aten.squeeze.default,
                  aten.select.int):
        if target is aten.squeeze.default:
            dims = {d for d, s in enumerate(in_shape) if s == 1}
        elif target is aten.squeeze.dims:
            dims = {d % len(in_shape) for d in node.args[1]}
        else:
            dims = {node.args[1] % len(in_shape)}
            if target is aten.squeeze.dim and in_shape[
                    next(iter(dims))] != 1:
                dims = set()
        return tuple(d for d in range(len(in_shape)) if d not in dims)
    if target is aten.unsqueeze.default:
        at = node.args[1] % len(out_shape)
        return tuple(None if d == at else (d if d < at else d - 1)
                     for d in range(len(out_shape)))
    if target in (aten.slice.Tensor, aten.constant_pad_nd.default,
                  aten.roll.default, aten.flip.default, aten.cumsum.default):
        if len(in_shape) == len(out_shape):
            return identity_dimmap(len(out_shape))
    return None


# ``where(cond, x, y)`` and ``masked_fill(x, mask, value)``: JAX's
# ``jnp.where`` broadcasts its predicate to the full shape and makes it
# ``select_n``'s first operand, so the predicate leads
SELECT_OPS = _ops("where", "masked_fill")


def pick_lead_operand(node: fx.Node, predicate_leads: bool = True
                      ) -> Optional[fx.Node]:
    """The operand to follow: the largest tensor one (the first of
    equals); for a select (``SELECT_OPS``) the predicate, unless
    ``predicate_leads`` is off (GSPMD's propagation: a select follows its
    data, the predicate a constant broadcast to it).  An accumulator's
    in-place ``add_(acc, g)`` (tagged ``ACCUMULATES``) is read as JAX's
    functional ``add(g, acc)`` with the sum donated to ``acc``: the
    gradient leads."""
    if node.target in SELECT_OPS and predicate_leads:
        pred = node.args[0] if node.target in _ops("where") else node.args[1]
        if _val(pred) is not None:
            return pred
    args = node.args if node.target in ELEMENTWISE_OPS else node.args[:1]
    if node.meta.get(ACCUMULATES):
        args = args[::-1]
    best, best_size = None, -1
    for a in args:
        for v in (a if isinstance(a, (list, tuple)) else [a]):
            val = _val(v)
            if val is None:
                continue
            size = _numel(tuple(val.shape))
            if size > best_size:
                best, best_size = v, size
    return best


def _merge_groups(in_shape, out_shape) -> Optional[List[List[int]]]:
    """For a view that only merges dims (or keeps them): per output dim,
    the non-trivial input dims it covers; None if it splits one."""
    groups: List[List[int]] = [[] for _ in out_shape]
    i = 0
    for j, size in enumerate(out_shape):
        if size == 1:
            continue
        while i < len(in_shape) and in_shape[i] == 1:
            i += 1
        prod, group = 1, []
        while i < len(in_shape) and prod < size:
            prod *= in_shape[i]
            group.append(i)
            i += 1
        if prod != size:
            return None
        groups[j] = [d for d in group if in_shape[d] > 1]
    return groups


_THROUGH_OPS = frozenset({aten.clone.default, aten.alias.default,
                          aten._to_copy.default, aten.detach.default})


def unmerged_operand(v: fx.Node):
    """A product's operand seen before the views that merged its dims
    (aten's ``view(B*S, H)`` before a linear, ``(B*heads, S, D)`` before
    attention's ``bmm``): ``(value, dims)``, ``dims[j]`` the dims of
    ``value`` that the operand's dim j merges, through transposes and
    copies; None if no view merged a dim."""
    dims = [[d] for d in range(_val(v).dim())]
    cur, merged = v, False
    while isinstance(cur, fx.Node) and cur.op == "call_function" and \
            _val(cur.args[0] if cur.args else None) is not None:
        src = cur.args[0]
        target = cur.target
        if target in VIEW_OPS:
            groups = _merge_groups(tuple(_val(src).shape),
                                   tuple(_val(cur).shape))
            if groups is None:
                break
            merged = merged or any(len(g) > 1 for g in groups)
            dims = [[x for d in ds for x in groups[d]] for ds in dims]
        elif target in (aten.t.default, aten.transpose.int,
                        aten.permute.default):
            perm = follow_dimmap(cur, src)
            dims = [[perm[d] for d in ds] for ds in dims]
        elif target not in _THROUGH_OPS and not (
                target is aten.expand.default and
                tuple(_val(src).shape) == tuple(_val(cur).shape)):
            break
        cur = src
    return (cur, dims) if merged else None


########################################
# graph construction
########################################


def build_strategy_graph(graph: fx.Graph, in_avals: Sequence[Any],
                         logical_mesh, batch_flat_idx: Sequence[int],
                         option, in_paths: Sequence[str] = (),
                         pins: Optional[Dict[int, Spec]] = None,
                         realizable: bool = False,
                         propagation: bool = False) -> StrategyGraph:
    """The strategy graph of ``graph`` (traced at the shapes of
    ``in_avals``, one placeholder per flat argument) on ``logical_mesh``
    (``alpa_tpu/shard_parallel/strategy.py:853``).  ``pins``: flat input
    index -> the one Spec that input's node may take (a pinned solve).
    ``realizable``: the strategies the SPMD partitioner executes as they
    are (``spmd_partition.py``), for the plan that runs: a product shards
    a dim that aten merged (``B*S``) only on its outermost part, and the
    flash ops and a ``reduction="none"`` ``nll_loss`` may run on batch
    or row shards, ``split`` and ``cat`` on shards along their unsharded
    dim (JAX's graph has barriers there).  ``propagation``: the graph of
    a rule-based plan's propagation (``solver.propagate_pinned``), in
    which a select follows its data rather than its predicate."""
    pins = pins or {}
    from alpa_tpu_torch.shard_parallel.auto_sharding import (
        is_opt_state_path, is_param_path, resolved_zero_stage)
    mesh_shape = logical_mesh.shape
    nodes: List[Node] = []
    edges: List[Edge] = []
    # value (an fx node, or (fx node, output index)) -> (node, dimmap)
    var_node: Dict[Any, Tuple[int, DimMap]] = {}

    def new_node(kind, aval, strategies, label="", invar_idx=None,
                 outvar=None):
        n = Node(len(nodes), kind, aval, strategies, label, invar_idx, outvar)
        nodes.append(n)
        return n

    def barrier_node(aval, label):
        return new_node("op", aval, [Strategy(
            "R", replicated_spec(len(aval.shape)), 0.0)], label)

    # --- invar nodes ---
    from alpa_tpu_torch.global_env import global_config
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import grad_eligible
    gq_mode = global_config.grad_quantize
    zero = resolved_zero_stage(option)
    batch_set = set(batch_flat_idx)
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    for i, (ph, aval) in enumerate(zip(placeholders, in_avals)):
        aval = Aval(tuple(aval.shape), aval.dtype)
        ndim = len(aval.shape)
        specs = enumerate_var_specs(aval, mesh_shape)
        if i in batch_set and option.force_batch_dim_to_mesh_dim is not None:
            a = option.force_batch_dim_to_mesh_dim
            forced = (make_spec(ndim, {0: a}) if ndim and mesh_shape[a] > 1
                      else replicated_spec(ndim))
            if spec_valid(aval, forced, mesh_shape):
                specs = (forced,)
        path = in_paths[i] if i < len(in_paths) else ""
        zero_leaf = (zero != 0 and i not in batch_set and bool(path) and
                     (is_opt_state_path(path) or
                      (zero == 3 and is_param_path(path))))
        if zero_leaf and zero in (2, 3):
            sharded = tuple(s for s in specs if any(bool(d) for d in s))
            if sharded:
                specs = sharded
        if zero_leaf:
            size = nbytes(aval)
            strategies = []
            for s in specs:
                axes = [a for dim_axes in s for a in dim_axes]
                if axes:
                    # a sharded weight-update leaf trades the gradient
                    # all-reduce for a reduce-scatter (credit) but
                    # all-gathers the updated value back (charge)
                    charge = sum(logical_mesh.all_gather_cost(size, a)
                                 for a in axes)
                    credit = sum(logical_mesh.all_reduce_cost(size, a) -
                                 logical_mesh.reduce_scatter_cost(size, a)
                                 for a in axes)
                    strategies.append(Strategy(
                        f"zero{str(s)}", s, max(0.0, charge - credit),
                        mem_bytes=sharded_bytes(aval, s, mesh_shape),
                        comm_kind="reduce_scatter"))
                    # its twin through the gradient codec, priced by the
                    # quantized reduce-scatter, where the knob is on and
                    # the leaf eligible (so plans at "off" are unchanged)
                    if gq_mode != "off" and grad_eligible(
                            aval.shape, aval.dtype, gq_mode):
                        itemsize = torch.empty(
                            (), dtype=aval.dtype).element_size()
                        credit_q = sum(
                            logical_mesh.all_reduce_cost(size, a) -
                            logical_mesh.reduce_scatter_cost_quantized(
                                size, a, itemsize) for a in axes)
                        strategies.append(Strategy(
                            f"zero{str(s)}_q{gq_mode}", s,
                            max(0.0, charge - credit_q),
                            mem_bytes=sharded_bytes(aval, s, mesh_shape),
                            comm_kind="reduce_scatter", codec=gq_mode))
                else:
                    strategies.append(Strategy(
                        str(s), s, 0.0,
                        mem_bytes=sharded_bytes(aval, s, mesh_shape),
                        tie_bias=1e-6))
        else:
            # JAX's tie preferences: a batch invar prefers its leading dim
            # sharded, any other invar replication; a value a stage takes
            # from another stage (no path among inputs with paths) breaks
            # a tie between its sharded dims toward the leading one, where
            # JAX's solver takes the lower-indexed strategy
            value = bool(in_paths) and not path and i not in batch_set
            strategies = [
                Strategy(str(s), s, 0.0,
                         mem_bytes=sharded_bytes(aval, s, mesh_shape),
                         tie_bias=(1e-6 if (
                             (i in batch_set and ndim and
                              (not s or not s[0])) or
                             (i not in batch_set and
                              any(bool(d) for d in s))) else 0.0) + (
                             1e-7 * next((d for d, ax in enumerate(s) if ax),
                                         0) if value else 0.0))
                for s in specs]
        if i in pins:
            strategies = [Strategy(str(pins[i]), tuple(pins[i]), 0.0,
                                   mem_bytes=sharded_bytes(
                                       aval, pins[i], mesh_shape))]
        n = new_node("invar", aval, strategies, f"invar{i}", invar_idx=i)
        var_node[ph] = (n.idx, identity_dimmap(ndim))

    def edge_cost_matrix(src_node: Node, dimmap: DimMap, aval,
                         required: List[Spec]) -> np.ndarray:
        """cost[s_src, s_req] of delivering src's value (seen through
        dimmap) as each required operand spec."""
        ndim = len(aval.shape)
        size = nbytes(aval)
        C = np.zeros((len(src_node.strategies), len(required)))
        for si, st in enumerate(src_node.strategies):
            mapped, dropped = map_spec(st.out_spec, dimmap, ndim)
            drop_cost = sum(logical_mesh.all_gather_cost(size, a)
                            for a in dropped)
            for ri, req in enumerate(required):
                C[si, ri] = drop_cost + resharding_cost(aval, mapped, req,
                                                        logical_mesh)
        return C

    def get_source(v):
        """(node, dimmap) of a value; a replicated barrier for a value of
        unknown origin (a constant)."""
        if not isinstance(v, (fx.Node, tuple)):
            return None
        if v not in var_node:
            val = _val(v) if isinstance(v, fx.Node) else _val(v[0])
            if val is None:
                return None
            n = barrier_node(_aval(val), "opaque")
            var_node[v] = (n.idx, identity_dimmap(val.dim()))
        return var_node[v]

    def connect(dst: Node, operands, strategies):
        """An edge from each operand's source to ``dst``, requiring the
        strategies' operand specs."""
        for oi, v in enumerate(operands):
            val = _val(v)
            if val is None:
                continue
            src = get_source(v)
            if src is None:
                continue
            src_idx, dimmap = src
            req = [st.operand_specs[oi] for st in strategies]
            edges.append(Edge(src_idx, dst.idx, edge_cost_matrix(
                nodes[src_idx], dimmap, _aval(val), req)))

    def op_node(node, strategies, operands, label):
        out = _val(node)
        n = new_node("op", _aval(out), strategies, label, outvar=node)
        connect(n, operands, strategies)
        var_node[node] = (n.idx, identity_dimmap(out.dim()))
        return n

    def barrier(node, outputs, operands, once=False):
        """A replicated barrier per output (``(key, value)`` pairs), each
        charging the gather of every operand (only the first, with
        ``once``)."""
        for k, (key, val) in enumerate(outputs):
            n = barrier_node(_aval(val), f"barrier:{_name(node)}")
            var_node[key] = (n.idx, identity_dimmap(val.dim()))
            if once and k:
                continue
            for v in operands:
                vv = _val(v)
                if vv is None:
                    continue
                src = get_source(v)
                if src is None:
                    continue
                src_idx, dimmap = src
                edges.append(Edge(src_idx, n.idx, edge_cost_matrix(
                    nodes[src_idx], dimmap, _aval(vv),
                    [replicated_spec(vv.dim())])))

    def multi_outputs(node):
        """``((node, i), value)`` of each tensor output of a multi-output
        op that the graph reads."""
        vals = node.meta.get("val")
        used = sorted({u.args[1] for u in node.users
                       if u.target is operator.getitem})
        return [((node, i), vals[i]) for i in used
                if isinstance(vals[i], torch.Tensor)]

    def consistency(side, lead, shape, dtype):
        """JAX's consistency edge of an elementwise op whose lead operand
        follows ``lead`` and whose side operand (of ``shape``) follows
        ``side`` (both ``(node, dimmap to the op's dims)``): the cost of
        resharding the side operand to the lead's spec."""
        (o_idx, o_dm), (l_idx, l_dm) = side, lead
        if o_idx == l_idx:
            return
        ndim, aval = len(shape), Aval(tuple(shape), dtype)
        size = nbytes(aval)
        o_node, l_node = nodes[o_idx], nodes[l_idx]
        C = np.zeros((len(o_node.strategies), len(l_node.strategies)))
        for si, st_o in enumerate(o_node.strategies):
            o_spec, o_drop = map_spec(st_o.out_spec, o_dm, ndim)
            drop_cost = sum(logical_mesh.all_gather_cost(size, a)
                            for a in o_drop)
            for li, st_l in enumerate(l_node.strategies):
                l_spec, _ = map_spec(st_l.out_spec, l_dm, ndim)
                C[si, li] = drop_cost + resharding_cost(aval, o_spec, l_spec,
                                                        logical_mesh)
        edges.append(Edge(o_idx, l_idx, C, consistency=True))

    def side_edges(out, lead_val, sides, src_idx, composed,
                   select=False):
        """The consistency edges of a followed op's side operands
        (residual joins, optimizer updates; ``(value, dimmap to the
        output)`` pairs) to the lead's node.  As in JAX, an operand 8
        times smaller than the lead (a bias, a scalar) is left out: it
        broadcasts where it is, at its own size (JAX keeps size-1 dims
        where aten broadcasts implicitly)."""
        out_ndim = out.dim()
        lead_size = _numel(tuple(lead_val.shape))
        if select:
            # JAX's select_n reads its predicate broadcast to full size
            lead_size = _numel(tuple(out.shape))
        for v, side_dm in sides:
            val = _val(v)
            if val is None or _numel(tuple(val.shape)) * 8 < lead_size:
                continue
            osrc = get_source(v)
            if osrc is None:
                continue
            consistency(
                (osrc[0], compose_dimmap(side_dm or (None,) * out_ndim,
                                         osrc[1])), (src_idx, composed),
                (1,) * (out_ndim - val.dim()) + tuple(val.shape), val.dtype)

    def reduce_on(src, in_shape, red, label):
        """A reduction node over dims ``red`` of a value of ``in_shape``
        (fp32) that follows ``src`` ((node, dimmap)); its output drops the
        reduced dims."""
        in_av = Aval(tuple(in_shape), torch.float32)
        out_av = Aval(tuple(s for d, s in enumerate(in_shape)
                            if d not in red), torch.float32)
        strategies = enumerate_reduce_strategies(in_av, out_av, red, False,
                                                 logical_mesh)
        n = new_node("op", out_av, strategies, label)
        edges.append(Edge(src[0], n.idx, edge_cost_matrix(
            nodes[src[0]], src[1], in_av,
            [st.operand_specs[0] for st in strategies])))
        return n.idx

    def stats_node(src_idx, rows_shape, label):
        """JAX's reduction over the size-1 dim of broadcast statistics of
        ``rows_shape`` (no mesh axis can shard it): a node choosing the
        statistics' spec, fed by ``src_idx``'s output."""
        return reduce_on((src_idx, identity_dimmap(len(rows_shape))),
                         tuple(rows_shape) + (1,), [len(rows_shape)], label)

    def layer_norm(node, x, norm):
        """flax's LayerNorm as JAX traces it: the mean and the mean of
        squares reduce x over the normalized dims; rsqrt(var) times the
        scale is a side operand of ``(x - mean) * ...``; the output
        follows x."""
        xv = _val(x)
        xsrc = get_source(x)
        shape = tuple(xv.shape)
        rows = [d for d in range(xv.dim()) if d not in norm]
        to_rows = tuple(rows.index(d) if d in rows else None
                        for d in range(xv.dim()))
        r_mean = reduce_on(xsrc, shape, norm, "reduce_sum")
        r_sq = reduce_on(xsrc, shape, norm, "reduce_sum")
        rows_shape = tuple(shape[d] for d in rows)
        # var = mean2 - mean**2: lead mean2
        consistency((r_mean, identity_dimmap(len(rows))),
                    (r_sq, identity_dimmap(len(rows))), rows_shape,
                    torch.float32)
        weight = node.args[2] if len(node.args) > 2 else None
        wv = _val(weight)
        if wv is not None and _numel(tuple(wv.shape)) * 8 >= _numel(
                rows_shape):
            wsrc = get_source(weight)
            consistency((wsrc[0], compose_dimmap(_broadcast_dimmap(
                tuple(wv.shape), shape), wsrc[1])), (r_sq, to_rows),
                (1,) * len(rows) + tuple(wv.shape), wv.dtype)
        # (x - mean) * (rsqrt(var) * scale): lead x, side the statistics
        consistency((r_sq, to_rows), xsrc, shape, torch.float32)
        for key, val in multi_outputs(node):
            if key[1] == 0:
                var_node[key] = xsrc
            else:
                var_node[key] = (r_mean if key[1] == 1 else r_sq, to_rows)

    def layer_norm_backward(node, g, x, norm):
        """The vjp of flax's LayerNorm as JAX traces it: dx follows the
        cotangent g; the normalized dims are reduced once on x's node and
        once on g's; x joins g (``(x - mean) * g``), the statistics join
        x and g back; the scale's gradient reduces the rows on x's node,
        the bias's on g's."""
        gv, xv = _val(g), _val(x)
        gsrc, xsrc = get_source(g), get_source(x)
        shape = tuple(gv.shape)
        rows = [d for d in range(gv.dim()) if d not in norm]
        to_rows = tuple(rows.index(d) if d in rows else None
                        for d in range(gv.dim()))
        rows_shape = tuple(shape[d] for d in rows)
        consistency(gsrc, xsrc, shape, gv.dtype)
        rstd = node.args[4]
        if get_source(rstd) is not None:
            # g * (rsqrt(var) * scale): lead g
            r_sq = get_source(rstd)[0]
            consistency((r_sq, to_rows), gsrc, shape, torch.float32)
        r_x = reduce_on(xsrc, shape, norm, "reduce_sum")
        r_g = reduce_on(gsrc, shape, norm, "reduce_sum")
        c_x = stats_node(r_x, rows_shape, "reduce_sum")
        c_g = stats_node(r_g, rows_shape, "reduce_sum")
        consistency(xsrc, (c_x, to_rows), shape, torch.float32)
        consistency((c_g, to_rows), gsrc, shape, torch.float32)
        consistency((c_x, to_rows), gsrc, shape, torch.float32)
        for key, val in multi_outputs(node):
            if key[1] == 0:
                var_node[key] = gsrc
                continue
            src = xsrc if key[1] == 1 else gsrc
            idx = reduce_on(src, shape, rows, "reduce_sum")
            var_node[key] = (idx, identity_dimmap(val.dim()))

    def shard_choices(aval):
        """Specs of ``aval`` that shard its dim 0 only (and replicated)."""
        return [sp for sp in enumerate_var_specs(aval, mesh_shape)
                if not any(sp[1:])]

    def sharded_batch(node):
        """A flash op run on batch shards: one node choosing the batch
        dim's axes for its (B, S, H, D) operands and outputs, and for lse's
        (B*H, S) rows."""
        q = _val(node.args[0])
        operands = [a for a in node.args if _val(a) is not None]
        strategies = [Strategy(str(sp), sp, 0.0, tuple(
            (sp[0],) + ((),) * (_val(a).dim() - 1) for a in operands))
            for sp in shard_choices(_aval(q))]
        n = new_node("op", _aval(q), strategies, f"batch:{_name(node)}")
        connect(n, operands, strategies)
        for key, val in multi_outputs(node):
            var_node[key] = (n.idx, (0,) + (None,) * (val.dim() - 1))

    def sharded_rows(node):
        """``nll_loss`` with ``reduction="none"`` run on row shards of its
        (N, C) logits: one node choosing the rows' axes."""
        fwd = node.target is NLL_FWD
        logits = node.args[0] if fwd else node.args[1]
        operands = ([node.args[0], node.args[1]] if fwd else
                    [node.args[0], node.args[1], node.args[2]])
        strategies = [Strategy(str(sp), sp, 0.0, tuple(
            (sp[0],) + ((),) * (_val(a).dim() - 1) for a in operands))
            for sp in shard_choices(_aval(_val(logits)))]
        n = new_node("op", _aval(_val(logits)), strategies,
                     f"rows:{_name(node)}")
        connect(n, operands, strategies)
        if not fwd:
            var_node[node] = (n.idx, identity_dimmap(2))
            return
        for key, val in multi_outputs(node):
            if key[1] == 0:
                var_node[key] = (n.idx, (0,))
            else:
                barrier(node, [(key, val)], [])

    # values that depend on no graph input (factories and ops over them)
    constant = set()
    dot_groups: Dict[fx.Node, Tuple[List[List[Tuple[int, int]]], ...]] = {}
    # a softmax or log-softmax -> the node of its sum over the dim
    row_sums: Dict[fx.Node, int] = {}
    # a product's output -> (its node, its unmerged shape)
    virtual_out: Dict[fx.Node, Tuple[int, Tuple[int, ...]]] = {}

    def dot_node(node, out):
        """A product's node over its operands seen unmerged where aten
        merged what JAX keeps apart (the batch with the sequence before a
        linear, the batch with the heads before attention's ``bmm``: a
        merged group holding the source's leading dim), so that its
        strategies are JAX's ``dot_general``'s on the same tensors."""
        lhs, rhs, lhs_b, rhs_b, lhs_c, rhs_c = _dot_dims(node)
        ops = []   # per operand: (source value, per dim its virtual dims)
        for v in (lhs, rhs):
            found = unmerged_operand(v)
            src, groups = found or (v, [[d] for d in range(_val(v).dim())])
            sshape = tuple(_val(src).shape)
            vdims = []
            for j, g in enumerate(groups):
                if len(g) > 1 and 0 in g:
                    vdims.append([(sshape[d], d) for d in g])
                else:   # merged as JAX's reshape merges: unmapped
                    vdims.append([(int(_val(v).shape[j]),
                                   g[0] if len(g) == 1 else None)])
            ops.append((src, vdims))
        (ls, ldims), (rs, rdims) = ops
        # paired dims (batch, contracting) must unmerge alike
        for a, b in list(zip(lhs_b, rhs_b)) + list(zip(lhs_c, rhs_c)):
            if [x for x, _ in ldims[a]] != [x for x, _ in rdims[b]]:
                for dims_, j, v in ((ldims, a, lhs), (rdims, b, rhs)):
                    lead = next((d for x, d in dims_[j] if x > 1), None)
                    dims_[j] = [(int(_val(v).shape[j]), lead)]
        lflat = [vd for ds in ldims for vd in ds]
        rflat = [vd for ds in rdims for vd in ds]
        vl = Aval(tuple(x for x, _ in lflat), _val(lhs).dtype)
        vr = Aval(tuple(x for x, _ in rflat), _val(rhs).dtype)
        lstart = np.cumsum([0] + [len(ds) for ds in ldims]).tolist()
        rstart = np.cumsum([0] + [len(ds) for ds in rdims]).tolist()

        def span(start, dims_, j):
            return list(range(start[j], start[j] + len(dims_[j])))

        vb = ([i for a in lhs_b for i in span(lstart, ldims, a)],
              [i for b in rhs_b for i in span(rstart, rdims, b)])
        vc = ([i for a in lhs_c for i in span(lstart, ldims, a)],
              [i for b in rhs_c for i in span(rstart, rdims, b)])
        dims = dot_semantic_dims(vl.shape, vr.shape, vb[0], vb[1], vc[0],
                                 vc[1])
        lfree, rfree = dims[4], dims[5]
        vout = Aval(tuple(vl.shape[d] for d in vb[0]) +
                    tuple(vl.shape[d] for d in lfree) +
                    tuple(vr.shape[d] for d in rfree), out.dtype)
        strategies = enumerate_dot_strategies(vl, vr, vout, dims,
                                              logical_mesh)
        if realizable:
            outer = [st for st in strategies if all(
                _outer_only(spec, [[x for x, _ in g] for g in dims_], shape)
                for spec, dims_, shape in (
                    (st.operand_specs[0], ldims, vl.shape),
                    (st.operand_specs[1], rdims, vr.shape)))]
            strategies = outer or strategies[:1]
        n = new_node("op", vout, strategies, f"dot:{vout.shape}",
                     outvar=node)
        for oi, (src, flat, vaval) in enumerate(((ls, lflat, vl),
                                                 (rs, rflat, vr))):
            found = get_source(src)
            if found is None:
                continue
            src_idx, src_dm = found
            req = [st.operand_specs[oi] for st in strategies]
            edges.append(Edge(src_idx, n.idx, edge_cost_matrix(
                nodes[src_idx], tuple(None if d is None else src_dm[d]
                                      for _, d in flat), vaval, req)))
        # the product's own output: each dim carries the leading
        # non-trivial dim of its unmerged group
        groups, k = [], 0
        for dims_, js in ((ldims, lhs_b),
                          (ldims, [j for j in range(len(ldims))
                                   if j not in lhs_b and j not in lhs_c]),
                          (rdims, [j for j in range(len(rdims))
                                   if j not in rhs_b and j not in rhs_c])):
            for j in js:
                groups.append(list(range(k, k + len(dims_[j]))))
                k += len(dims_[j])
        var_node[node] = (n.idx, tuple(
            next((d for d in g if vout.shape[d] > 1), None) for g in groups))
        virtual_out[node] = (n.idx, vout.shape)
        dot_groups[node] = (
            [[(v, vl.shape[v]) for v in span(lstart, ldims, j)]
             for j in range(len(ldims))],
            [[(v, vr.shape[v]) for v in span(rstart, rdims, j)]
             for j in range(len(rdims))])
        bias = node.args[0] if node.target is aten.addmm.default else None
        bv = _val(bias)
        if bv is not None and _numel(tuple(bv.shape)) * 8 >= _numel(
                vout.shape):
            # the bias add after JAX's product, when the bias is not small
            bsrc = get_source(bias)
            consistency((bsrc[0], compose_dimmap(_broadcast_dimmap(
                tuple(bv.shape), vout.shape), bsrc[1])),
                (n.idx, identity_dimmap(len(vout.shape))),
                (1,) * (len(vout.shape) - bv.dim()) + tuple(bv.shape),
                bv.dtype)

    for node in graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "get_attr":
            continue    # a constant: a barrier at its first use
        target = node.target
        name = _name(node)
        if target is operator.getitem:
            src = node.args[0]
            key = (src, node.args[1])
            if _name(src) == PIPELINE_MARKER:
                s = get_source(src.args[0][node.args[1]])
                if s is not None:
                    var_node[node] = s
            elif key in var_node:
                var_node[node] = var_node[key]
            continue
        if name in (PIPELINE_MARKER, PIPELINE_BOUNDARY):
            continue    # markers: identity pass-through, via getitem
        out = _val(node)

        if target in DOT_OPS:
            dot_node(node, out)
            continue

        if target in REDUCE_OPS:
            x = node.args[0]
            xv = _val(x)
            red, keepdim = _reduced_dims(node, xv.dim())
            strategies = enumerate_reduce_strategies(
                _aval(xv), _aval(out), red, keepdim, logical_mesh)
            op_node(node, strategies, [x], name.split(".")[1])
            continue

        if target is LAYER_NORM:
            xv = _val(node.args[0])
            layer_norm(node, node.args[0], list(range(
                xv.dim() - len(node.args[1]), xv.dim())))
            continue

        if target is LAYER_NORM_BWD:
            gv = _val(node.args[0])
            layer_norm_backward(node, node.args[0], node.args[1], list(range(
                gv.dim() - len(node.args[2]), gv.dim())))
            continue

        if target in SOFTMAX_OPS:
            # JAX's softmax and logsumexp: the max and the sum of exp
            # reduce x over the dim; the output follows x
            x = node.args[0]
            xsrc = get_source(x)
            shape, dim = tuple(_val(x).shape), node.args[1] % _val(x).dim()
            found = None if realizable else unmerged_operand(x)
            if found is not None and len(found[1][dim]) == 1 and \
                    get_source(found[0]) is not None:
                # rows that a view merged (the loss's ``(B*S, V)``) are
                # reduced as JAX reduces its unmerged logits: each row's
                # statistics read only its row
                src, groups = found
                shape, dim = tuple(_val(src).shape), groups[dim][0]
                xsrc = get_source(src)
            reduce_on(xsrc, shape, [dim], "reduce_max")
            row_sums[node] = reduce_on(xsrc, shape, [dim], "reduce_sum")
            var_node[node] = get_source(x)
            continue

        if target is LOG_SOFTMAX_BWD and node.args[1] in row_sums:
            # JAX's gradient of logsumexp is ``broadcast(g / sum) *
            # exp(x - max)``, its lead the broadcast sum: the gradient
            # follows the forward's sum with the dim unsharded, and the
            # logits (through exp) and g reshard to it
            g, y = node.args[0], node.args[1]
            dim = node.args[2] % out.dim()
            lead = (row_sums[y], tuple(
                None if d == dim else (d if d < dim else d - 1)
                for d in range(out.dim())))
            var_node[node] = lead
            for side in (y.args[0], g):
                if get_source(side) is not None:
                    consistency(get_source(side), lead, tuple(out.shape),
                                torch.float32)
            continue

        if target is SOFTMAX_BWD and get_source(node.args[0]) is not None:
            # JAX's softmax vjp: the cotangent g leads; exp (following the
            # scores) joins it twice, and the sum over the dim of a value
            # following g joins it back
            g, y = node.args[0], node.args[1]
            gsrc = get_source(g)
            shape, dim = tuple(out.shape), node.args[2] % out.dim()
            to_rows = tuple(None if d == dim else (d if d < dim else d - 1)
                            for d in range(out.dim()))
            if get_source(y) is not None:
                for _ in range(2):
                    consistency(get_source(y), gsrc, shape, torch.float32)
            stats = stats_node(reduce_on(gsrc, shape, [dim], "reduce_sum"),
                               tuple(x for d, x in enumerate(shape)
                                     if d != dim), "reduce_sum")
            consistency((stats, to_rows), gsrc, shape, torch.float32)
            var_node[node] = gsrc
            continue

        if target is EMBEDDING:
            weight, ids = node.args[0], node.args[1]
            strategies = enumerate_gather_strategies(
                _aval(_val(weight)), _aval(_val(ids)), _aval(out), 0,
                logical_mesh)
            op_node(node, strategies, [weight, ids], f"gather:{tuple(out.shape)}")
            continue

        if target is EMBEDDING_BWD or target in INDEX_PUT or \
                target in SCATTER_ADD:
            made = _scatter_node(node, logical_mesh)
            if made is not None:
                strategies, operands = made
                op_node(node, strategies, operands,
                        f"scatter:{tuple(out.shape)}")
                continue

        if realizable and target in (NLL_FWD, NLL_BWD) and \
                node.args[3 if target is NLL_FWD else 4] == 0 and \
                node.args[2 if target is NLL_FWD else 3] is None and \
                _val(node.args[0 if target is NLL_FWD else 1]).dim() == 2:
            sharded_rows(node)
            continue
        if realizable and name in _GATHER_ONCE:
            sharded_batch(node)
            continue
        if target is NLL_FWD:
            outs = multi_outputs(node)
            gold = [o for o in outs if o[0][1] == 0]
            barrier(node, gold, [node.args[0], node.args[1]])
            for key, val in outs:
                if key[1] != 0:
                    barrier(node, [(key, val)], [])
            continue
        if target is NLL_BWD:
            barrier(node, [(node, out)], [node.args[0], node.args[2]])
            continue

        operands = _tensor_args(node)
        multi = out is None
        outputs = multi_outputs(node) if multi else [(node, out)]

        if realizable and target in _ops("split", "split_with_sizes", "cat"):
            # run along an unsharded dim, on the operands' shards: each
            # output follows the (first) operand, its split or cat dim
            # unmapped
            lead = node.args[0][0] if target in _ops("cat") else node.args[0]
            dim = (node.args[2] if target not in _ops("cat") else
                   node.args[1]) if len(node.args) > (
                       1 if target in _ops("cat") else 2) else 0
            src = get_source(lead)
            if src is not None:
                nd = _val(lead).dim()
                dim %= nd
                dm = tuple(None if d == dim else d for d in range(nd))
                for key, val in outputs:
                    var_node[key] = (src[0], compose_dimmap(dm, src[1]))
                if target in _ops("cat"):
                    side_edges(out, _val(lead),
                               [(v, dm) for v in node.args[0][1:]],
                               src[0], compose_dimmap(dm, src[1]))
                continue

        if not multi and all(v in constant for v in node.all_input_nodes):
            constant.add(node)
        # free: every input a literal or a scalar, or an elementwise op
        # that broadcasts values made of constants alone to a larger shape
        # (aten's ``arange(S)[:, None] >= arange(S)[None]`` is JAX's 2-D
        # ``broadcasted_iota``); any output spec is a free local slice, so
        # the ILP aligns it with its consumers
        if not multi and out.dim() and (all(
                _numel(tuple(_val(v).shape)) == 1 for v in operands) or (
                target in ELEMENTWISE_OPS and node in constant and
                len(operands) > 1 and all(
                    _numel(tuple(_val(v).shape)) < out.numel()
                    for v in operands))):
            specs = enumerate_var_specs(_aval(out), mesh_shape)
            n = new_node("op", _aval(out),
                         [Strategy(str(s), s, 0.0) for s in specs],
                         f"free:{name}")
            var_node[node] = (n.idx, identity_dimmap(out.dim()))
            continue

        if target in VIEW_OPS and node.args[0] in virtual_out:
            # a product's output viewed as (or from) its unmerged shape
            idx, vshape = virtual_out[node.args[0]]
            var_node[node] = (idx, reshape_dimmap(vshape, tuple(out.shape)))
            continue

        if not multi:
            lead = pick_lead_operand(node, not propagation)
            dm = follow_dimmap(node, lead) if lead is not None else None
            src = get_source(lead) if dm is not None else None
            if src is not None:
                src_idx, src_dm = src
                composed = compose_dimmap(dm, src_dm)
                var_node[node] = (src_idx, composed)
                side_edges(out, _val(lead), [(v, follow_dimmap(node, v))
                                             for v in node.all_input_nodes
                                             if v is not lead],
                           src_idx, composed, target in SELECT_OPS)
                continue

        barrier(node, outputs, operands, once=name in _GATHER_ONCE)

    return StrategyGraph(nodes, edges, logical_mesh, graph, var_node,
                         dot_groups)


def _outer_only(spec: Spec, groups, v_shape) -> bool:
    """Whether ``spec`` (over a product operand's virtual dims, of sizes
    ``v_shape``) shards each group of virtual dims that one aten dim
    merges (``groups``, one list per aten dim) on its outermost
    non-trivial dim only."""
    pos = 0
    for group in groups:
        span = list(range(pos, pos + len(group)))
        pos += len(group)
        lead = next((v for v in span if v_shape[v] > 1), span[0])
        if any(spec[v] for v in span if v != lead):
            return False
    return True


def _name(node: fx.Node) -> str:
    """``aten.mm``, ``alpa_tpu_torch.flash_fwd``: an op's name without its
    overload."""
    if isinstance(node.target, torch._ops.OpOverload):
        return str(node.target).rsplit(".", 1)[0]
    return str(node.target)


def _scatter_node(node: fx.Node, logical_mesh):
    """(strategies, operands) of a scatter-add: ``embedding``'s backward
    (rows of ``grad`` added at ``indices``), ``index_put`` with one index
    tensor on dim 0 and ``accumulate``, and ``scatter_add``; None for
    other forms (they become barriers)."""
    out = _val(node)
    target = node.target
    if target is EMBEDDING_BWD:
        grad, idx = node.args[0], node.args[1]
        gv, iv = _val(grad), _val(idx)
        op_av = _aval(out)
        k = iv.dim()
        # the zero operand is a free value: no edge
        strategies = enumerate_scatter_strategies(
            op_av, _aval(iv), _aval(gv), 0, [(1, k)],
            [(d, d) for d in range(k)], logical_mesh)
        return [dataclasses.replace(st, operand_specs=(
            st.operand_specs[2], st.operand_specs[1]))
            for st in strategies], [grad, idx]
    if target in INDEX_PUT:
        self_, indices, values = node.args[0], node.args[1], node.args[2]
        accumulate = node.args[3] if len(node.args) > 3 else False
        if (not accumulate or len(indices) != 1 or indices[0] is None):
            return None
        idx = indices[0]
        sv, iv, vv = _val(self_), _val(idx), _val(values)
        k = iv.dim()
        if vv.dim() != k + sv.dim() - 1:
            return None
        window = [(d, k + d - 1) for d in range(1, sv.dim())
                  if vv.shape[k + d - 1] == sv.shape[d]]
        strategies = enumerate_scatter_strategies(
            _aval(sv), _aval(iv), _aval(vv), 0, window,
            [(d, d) for d in range(k)], logical_mesh)
        return strategies, [self_, idx, values]
    if target in SCATTER_ADD:
        self_, dim, idx, src = node.args[:4]
        sv, iv, vv = _val(self_), _val(idx), _val(src)
        dim %= sv.dim()
        if iv.shape != vv.shape or vv.dim() != sv.dim():
            return None
        window = [(d, d) for d in range(sv.dim())
                  if d != dim and vv.shape[d] == sv.shape[d]]
        strategies = enumerate_scatter_strategies(
            _aval(sv), _aval(iv), _aval(vv), dim, window, [(dim, dim)],
            logical_mesh)
        return strategies, [self_, idx, src]
    return None
