"""The SPMD partitioner: a solved plan realised as a per-device program.

Counterpart of the JAX package's ``make_constrained_fun``
(``alpa_tpu/shard_parallel/strategy.py:1258``) and GSPMD's partitioner
together.  It takes the traced joint aten graph of the step
(``solver.trace_flat``), its solved strategy graph ``(graph, choice)``,
the inputs' Specs and the pinned state outputs' Specs, and writes one
program that every device of the logical mesh runs on its own blocks
(``sharding_spec.local_slices``):

* Every value has a layout: a Spec and, where its local values are
  partial sums (a product contracted over a sharded dim, a sum over a
  sharded dim), the mesh axes of the pending sum.  Each op's output is
  given the Spec its strategy fixes (``StrategyGraph.value_nodes``
  mapped through ``map_spec``); a product's operands take the specs of
  the strategy the ILP chose for it (its virtual dims, ``dot_groups``, as
  the aten operand's dims hold them).
* Where an operand's layout is not the one its consumer needs, the
  resharding is inserted: a local slice, an all-gather, an all-to-all,
  or an all-reduce (or reduce-scatter) of a partial sum.  A partial sum
  passes unreduced through linear ops (casts, views, transposes, adds of
  equally partial values, scaling by a number), so that gradients are
  reduced once, where the update reads them.
* Sizes that aten nodes carry (``view``/``_unsafe_view``/``reshape``,
  ``expand``, ``full``/``zeros``/``ones``/``empty``/``new_*``) are
  rewritten to the local sizes; ``mean`` over a sharded dim becomes a
  partial ``sum`` divided by the global count.
* A view keeps a sharded dim sharded where the merge or split it makes
  leaves the dim outermost in its group (a contiguous block); any other
  sharding of the group is gathered first.
* Barrier ops run on replicated inputs, as the strategy graph charges
  them: ``cat``'s and ``split``'s axis, ``nll_loss``'s classes and
  anything without a rule (unknown ops, ``arange``, scatters other than
  the embedding's).  Some barriers run on shards where the result is
  provably the same, and keep their operands' layouts: ``split`` and
  ``cat`` along an unsharded dim, ``nll_loss_forward``/``_backward``
  with ``reduction="none"`` on row shards (each row's loss reads only its
  row), and the flash ops (``alpa_tpu_torch::flash_fwd``/``flash_bwd``)
  on batch shards (each batch row's attention reads only its row); their
  sequence, head and head-dim axes are gathered.
* Each state output takes its input's Spec (``_pin_state_out_specs``),
  every other output is replicated, resharding at the exit.

The program is an ``fx.Graph`` in which each collective is one node;
``SpmdProgram`` splits it at the collectives into segments, compiles each
segment once per distinct device, and runs segment by segment over the
devices (launches are asynchronous, so distinct cards overlap), then the
collective over the list of per-device values
(``collectives.run_collective``).  With a gradient marker in the graph the
program has two parts, compute-grad and apply-grad, joined by the marked
values, so that gradient accumulation runs the first part once per
microbatch (``mesh_executable.GradAccMeshExecutable``).
"""
import dataclasses
import operator
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import fx

from alpa_tpu_torch.pipeline_parallel.primitive_def import is_marker
from alpa_tpu_torch.shard_parallel.collectives import (CollectiveRecord,
                                                       axis_backend,
                                                       run_collective)
from alpa_tpu_torch.shard_parallel.sharding_spec import (Spec, local_shape,
                                                         replicated_spec,
                                                         shard_index)
from alpa_tpu_torch.shard_parallel.strategy import (
    DOT_OPS, ELEMENTWISE_OPS, EMBEDDING, EMBEDDING_BWD, LAYER_NORM,
    LAYER_NORM_BWD, LOG_SOFTMAX_BWD, NLL_BWD, NLL_FWD, PIPELINE_BOUNDARY,
    PIPELINE_MARKER, SOFTMAX_BWD, SOFTMAX_OPS, VIEW_OPS, _broadcast_dimmap,
    _name, _ops, follow_dimmap, map_spec)

aten = torch.ops.aten

PERMUTE_OPS = frozenset({aten.t.default, aten.transpose.int,
                         aten.permute.default})
SQUEEZE_OPS = _ops("squeeze")
SUM_OPS = _ops("sum")
MEAN_OPS = _ops("mean")
MINMAX_OPS = _ops("amax", "amin")
FILL_FACTORIES = _ops("full", "zeros", "ones", "empty")
NEW_FACTORIES = _ops("new_zeros", "new_ones", "new_empty", "new_full")
LIKE_FACTORIES = _ops("zeros_like", "ones_like", "empty_like", "full_like")
SPLIT_OPS = _ops("split", "split_with_sizes")
CAT_OPS = _ops("cat")
# linear in their one tensor operand: a partial sum passes through
_LINEAR_UNARY = frozenset({aten._to_copy.default, aten.clone.default,
                           aten.alias.default, aten.neg.default}) | _ops(
                               "mul", "div")
_LINEAR_BINARY = frozenset({aten.add.Tensor, aten.sub.Tensor})
FLASH_FWD = "alpa_tpu_torch.flash_fwd"
FLASH_BWD = "alpa_tpu_torch.flash_bwd"


class Layout(NamedTuple):
    """A value's Spec and the mesh axes its local values are partial sums
    over (empty: complete)."""
    spec: Spec
    partial: Tuple[int, ...] = ()


def collective(index: int, x):
    """A collective node of the program (``SpmdProgram.records[index]``);
    the runner executes it over the devices, never as a function."""
    raise RuntimeError(f"collective {index} runs only in SpmdProgram")


def external(index: int):
    """A value the runner supplies between the program's parts (a marked
    value, accumulated)."""
    raise RuntimeError(f"external {index} is supplied by SpmdProgram")


def shard_start(coords, axes, mesh_shape, block: int) -> int:
    """The offset of the device's block along a dim newly sharded over
    ``axes`` (``block`` elements each)."""
    return shard_index(axes, coords, mesh_shape) * block


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _spec_axes(spec: Spec) -> Tuple[int, ...]:
    return tuple(a for axes in spec for a in axes)


def _view_groups(in_shape, out_shape):
    """The dims of a view grouped where their products meet:
    ``[(in dims, out dims), ...]``; None if they never meet."""
    groups = []
    i = j = 0
    while i < len(in_shape) or j < len(out_shape):
        gi, gj = [], []
        pi = pj = 1
        if i < len(in_shape):
            pi *= in_shape[i]
            gi.append(i)
            i += 1
        if j < len(out_shape):
            pj *= out_shape[j]
            gj.append(j)
            j += 1
        while pi != pj:
            if pi < pj and i < len(in_shape):
                pi *= in_shape[i]
                gi.append(i)
                i += 1
            elif pj < pi and j < len(out_shape):
                pj *= out_shape[j]
                gj.append(j)
                j += 1
            else:
                return None
        groups.append((gi, gj))
    return groups


@dataclasses.dataclass
class Step:
    """A run of program nodes (``kind="segment"``) or one collective."""
    kind: str
    nodes: List[fx.Node]
    invars: List[fx.Node] = dataclasses.field(default_factory=list)
    outvars: List[fx.Node] = dataclasses.field(default_factory=list)
    record: Optional[CollectiveRecord] = None
    dead: List[fx.Node] = dataclasses.field(default_factory=list)


class Partitioner:
    """Writes the per-device program of ``gm`` under ``(graph, choice)``
    (see the module docstring)."""

    def __init__(self, gm: fx.GraphModule, graph, choice, logical_mesh,
                 in_specs: Sequence[Spec],
                 out_specs: Sequence[Optional[Spec]],
                 natural_outputs: bool = False):
        self.gm = gm
        self.natural_outputs = natural_outputs
        self.result_specs: List[Spec] = []
        self.sg = graph
        self.choice = choice
        self.mesh = logical_mesh
        self.mesh_shape = tuple(logical_mesh.shape)
        self.in_specs = [self.nontrivial(s) for s in in_specs]
        self.out_specs = [None if s is None else self.nontrivial(s)
                          for s in out_specs]
        self.g = fx.Graph()
        self.env: Dict[Any, Tuple[Any, Layout]] = {}
        self.cache: Dict[Tuple[Any, Spec], fx.Node] = {}
        self.records: List[CollectiveRecord] = []
        self.part = "compute"
        self.pres: List[Tuple[Any, Layout]] = []
        self.placeholders: List[fx.Node] = []
        self.gather_views = 0
        # the contiguous copies of strided local slices (C.8), and their
        # bytes on one device, per run of the program
        self.slice_copies = 0
        self.slice_copy_bytes = 0
        self.barriers: Dict[str, int] = {}
        self.current = "input"

    # ------------------------------------------------------------ values

    def gval(self, key):
        """The traced (global) value of an fx node or ``(node, i)``."""
        if isinstance(key, tuple):
            return key[0].meta["val"][key[1]]
        return key.meta.get("val")

    def nontrivial(self, spec) -> Spec:
        """``spec`` without the mesh axes of size 1."""
        return tuple(tuple(a for a in axes if self.mesh_shape[a] > 1)
                     for axes in spec)

    def sole_user(self, key, node) -> bool:
        """Whether ``node`` is the only reader of ``key``: a partial sum
        read by more ops is reduced once, where the first reads it."""
        src = key[0] if isinstance(key, tuple) else key
        users = [u for u in src.users if u.op != "output"]
        if isinstance(key, tuple):
            users = [u for u in users if u.target is not operator.getitem]
        return len(src.users) == 1 and users == [node]

    def n_shards(self, axes) -> int:
        return int(np.prod([self.mesh_shape[a] for a in axes])) if axes \
            else 1

    def valid(self, spec, shape) -> Spec:
        """``spec`` with each mesh axis used once and every dim's shard
        count dividing its size (other dims replicated)."""
        used, out = set(), []
        for axes, size in zip(spec, shape):
            axes = tuple(a for a in axes if a not in used and
                         self.mesh_shape[a] > 1)
            if axes and size % self.n_shards(axes) == 0:
                used.update(axes)
                out.append(axes)
            else:
                out.append(())
        return tuple(out) + ((),) * (len(shape) - len(out))

    def want(self, key) -> Spec:
        """The Spec the plan gives a value."""
        val = self.gval(key)
        if not _is_tensor(val):
            return ()
        entry = self.sg.value_nodes.get(key)
        if entry is None:
            return replicated_spec(val.dim())
        idx, dimmap = entry
        node = self.sg.nodes[idx]
        spec, _ = map_spec(node.strategies[self.choice[idx]].out_spec,
                           dimmap, val.dim())
        return self.valid(spec, tuple(val.shape))

    def layout(self, key) -> Layout:
        return self.env[key][1]

    # ------------------------------------------------------------ emission

    def call(self, target, args, kwargs=None, val=None) -> fx.Node:
        node = self.g.call_function(target, tuple(args), dict(kwargs or {}))
        node.meta["part"] = self.part
        # the traced node whose realisation emitted this one
        node.meta["source"] = self.current
        if val is not None:
            node.meta["val"] = val
        return node

    def set(self, key, node, layout: Layout):
        self.env[key] = (node, layout)

    def emit_collective(self, kind, axis, x, shape, dtype, out_shape,
                        dim=None, concat_dim=None) -> fx.Node:
        item = torch.empty((), dtype=dtype).element_size()
        size = _numel(out_shape if kind == "all_gather" else shape) * item
        if kind == "all_to_all":
            # composed from an all-gather: each device receives every
            # operand of its group
            size *= self.mesh.shape[axis]
        rec = CollectiveRecord(kind, axis, tuple(shape), dtype, size,
                               axis_backend(self.mesh, axis), dim,
                               concat_dim)
        self.records.append(rec)
        return self.call(collective, (len(self.records) - 1, x),
                         val=_meta(out_shape, dtype))

    def reshard(self, node, src: Spec, dst: Spec, gshape, dtype) -> fx.Node:
        """``node`` (complete, under ``src``) under ``dst``."""
        cur = [tuple(a) for a in src]
        dst = [tuple(a) for a in dst]

        def lshape():
            return local_shape(_meta(gshape, dtype), tuple(cur),
                               self.mesh_shape)

        # an axis that leaves one dim for another: an all-to-all
        for d1 in range(len(cur)):
            while cur[d1] and cur[d1] != dst[d1][:len(cur[d1])]:
                a = cur[d1][-1]
                d2 = next((d for d in range(len(cur)) if d != d1 and
                           dst[d][:len(cur[d])] == cur[d] and
                           len(dst[d]) > len(cur[d]) and
                           dst[d][len(cur[d])] == a), None)
                if d2 is None or lshape()[d2] % self.mesh_shape[a]:
                    break
                before = lshape()
                cur[d1] = cur[d1][:-1]
                cur[d2] = cur[d2] + (a,)
                node = self.emit_collective("all_to_all", a, node, before,
                                            dtype, lshape(), d2, d1)
        # axes to drop: all-gathers, minor axis first
        for d in range(len(cur)):
            while cur[d] != dst[d][:len(cur[d])]:
                a = cur[d][-1]
                before = lshape()
                cur[d] = cur[d][:-1]
                node = self.emit_collective("all_gather", a, node, before,
                                            dtype, lshape(), d)
        # axes to add: local slices
        strided = False
        for d in range(len(cur)):
            while cur[d] != dst[d]:
                a = dst[d][len(cur[d])]
                block = lshape()[d] // self.mesh_shape[a]
                start = self.call(shard_start,
                                  (self.coords, (a,), self.mesh_shape, block))
                end = self.call(operator.add, (start, block))
                cur[d] = cur[d] + (a,)
                # a slice of dim d is a strided view unless every dim
                # before d has one element
                strided |= any(n > 1 for n in lshape()[:d])
                node = self.call(aten.slice.Tensor, (node, d, start, end),
                                 val=_meta(lshape(), dtype))
        if strided:
            # ROADMAP C.8: hand back the contiguous block the plain path
            # holds; ``native_layer_norm_backward`` reads its saved mean
            # and rstd as contiguous whatever their strides
            node = self.call(aten.clone.default, (node,),
                             {"memory_format": torch.contiguous_format},
                             val=_meta(lshape(), dtype))
            self.slice_copies += 1
            self.slice_copy_bytes += _numel(lshape()) * torch.empty(
                (), dtype=dtype).element_size()
        return node

    def resolve(self, key, target: Spec):
        """Complete a partial value: a reduce-scatter along a dim
        ``target`` shards next over the axis, else an all-reduce; the
        value's layout becomes the complete one."""
        node, lay = self.env[key]
        val = self.gval(key)
        cur = list(lay.spec)
        for a in lay.partial:
            before = local_shape(val, tuple(cur), self.mesh_shape)
            d = next((d for d in range(len(cur)) if
                      len(target[d]) > len(cur[d]) and
                      target[d][:len(cur[d])] == cur[d] and
                      target[d][len(cur[d])] == a and
                      before[d] % self.mesh_shape[a] == 0), None)
            if d is None:
                node = self.emit_collective("all_reduce", a, node, before,
                                            val.dtype, before)
            else:
                cur[d] = cur[d] + (a,)
                node = self.emit_collective(
                    "reduce_scatter", a, node, before, val.dtype,
                    local_shape(val, tuple(cur), self.mesh_shape), d)
        self.set(key, node, Layout(tuple(cur)))
        return node

    def value(self, key, spec: Optional[Spec] = None) -> fx.Node:
        """``key``'s program node under ``spec`` (complete), resharding
        once per (value, spec)."""
        if not isinstance(key, (fx.Node, tuple)):
            return key
        val = self.gval(key)
        if not _is_tensor(val):
            return self.env[key][0]
        if spec is None:
            spec = replicated_spec(val.dim())
        spec = tuple(tuple(a) for a in spec)
        node, lay = self.env[key]
        if lay.partial:
            node = self.resolve(key, self.demand(key) or spec)
            lay = self.layout(key)
        if lay.spec == spec:
            return node
        ck = (key, spec)
        if ck not in self.cache:
            self.cache[ck] = self.reshard(node, lay.spec, spec,
                                          tuple(val.shape), val.dtype)
        return self.cache[ck]

    def complete_spec(self, key) -> Spec:
        """The value's Spec once complete (its partial sums reduced)."""
        lay = self.layout(key)
        if lay.partial:
            self.resolve(key, self.demand(key) or lay.spec)
        return self.layout(key).spec

    def known_spec(self, a, shape, depth: int = 2) -> Optional[Spec]:
        """A sharded Spec that value ``a`` of ``shape`` has, or will have as
        an elementwise op over such values not emitted yet."""
        if not _is_tensor(self.gval(a)) or \
                tuple(self.gval(a).shape) != shape:
            return None
        if a in self.env:
            spec = self.layout(a).spec
            return spec if any(spec) else None
        if depth and a.op == "call_function" and \
                a.target in ELEMENTWISE_OPS:
            for b in a.all_input_nodes:
                spec = self.known_spec(b, shape, depth - 1)
                if spec is not None:
                    return spec
        return None

    def demand(self, key, depth: int = 6) -> Optional[Spec]:
        """Where a partial sum flows, through elementwise ops of its shape,
        into an op with another operand of that shape already sharded (a
        gradient into the update of optimizer state that ZeRO or the plan
        shards), that operand's Spec: the partial sum is then
        reduce-scattered to it, as XLA turns an all-reduce followed by a
        slice into a reduce-scatter."""
        src = key[0] if isinstance(key, tuple) else key
        shape = tuple(self.gval(key).shape)
        frontier = [u for u in src.users
                    if not (isinstance(key, tuple) and
                            u.target is operator.getitem and
                            u.args[1] != key[1])]
        seen = set()
        for _ in range(depth):
            nxt = []
            for u in frontier:
                if u in seen:
                    continue
                seen.add(u)
                if u.target is operator.getitem:
                    nxt.extend(u.users)
                    continue
                if u.op != "call_function" or \
                        u.target not in ELEMENTWISE_OPS or not _is_tensor(
                            self.gval(u)) or \
                        tuple(self.gval(u).shape) != shape:
                    continue
                for a in u.all_input_nodes:
                    spec = self.known_spec(a, shape)
                    if spec is not None:
                        return spec
                nxt.extend(u.users)
            frontier = nxt
        return None

    # ------------------------------------------------------------ rules

    def emit_same(self, node, args, spec_of_out):
        """``node`` re-emitted on ``args``; the output's layout."""
        val = self.gval(node)
        out = self.call(node.target, args, node.kwargs,
                        val=_meta(local_shape(val, spec_of_out,
                                              self.mesh_shape), val.dtype))
        self.set(node, out, Layout(spec_of_out))
        return out

    def barrier(self, node):
        """Replicated operands, the op as traced, replicated outputs."""
        name = _name(node)
        self.barriers[name] = self.barriers.get(name, 0) + 1
        args = fx.node.map_arg(node.args, lambda v: self.value(v))
        kwargs = fx.node.map_arg(node.kwargs, lambda v: self.value(v))
        val = self.gval(node)
        out = self.call(node.target, args, kwargs, val=_meta_like(val))
        self.set_outputs(node, out, lambda v: replicated_spec(v.dim()))

    def set_outputs(self, node, out, spec_fn):
        """The layout of each tensor output of ``node`` (``out`` its program
        node): ``spec_fn(global value) -> Spec``."""
        val = self.gval(node)
        if isinstance(val, (tuple, list)):
            for i, v in enumerate(val):
                if _is_tensor(v):
                    item = self.call(operator.getitem, (out, i),
                                     val=_meta(local_shape(
                                         v, spec_fn(v), self.mesh_shape),
                                         v.dtype))
                    self.set((node, i), item, Layout(spec_fn(v)))
            self.set(node, out, Layout(()))
        else:
            self.set(node, out, Layout(spec_fn(val)))

    def elementwise(self, node):
        val = self.gval(node)
        tensors = [a for a in node.all_input_nodes
                   if _is_tensor(self.gval(a))]
        lays = [self.layout(a) for a in tensors]
        linear = (node.target in _LINEAR_UNARY and len(tensors) == 1 and
                  val.is_floating_point() and
                  not any(isinstance(a, fx.Node) for a in node.args[1:]))
        if node.target in _LINEAR_BINARY and len(tensors) == 2 and \
                node.kwargs.get("alpha", 1) == 1 and \
                lays[0] == lays[1] and \
                all(tuple(self.gval(a).shape) == tuple(val.shape)
                    for a in tensors):
            linear = True
        if linear and lays[0].partial and tuple(
                self.gval(tensors[0]).shape) == tuple(val.shape) and all(
                self.sole_user(a, node) for a in tensors):
            args = fx.node.map_arg(node.args, lambda v: self.env[v][0])
            out = self.call(node.target, args, node.kwargs,
                            val=_meta(local_shape(val, lays[0].spec,
                                                  self.mesh_shape),
                                      val.dtype))
            self.set(node, out, lays[0])
            return
        spec = self.want(node)
        full = [a for a in tensors
                if tuple(self.gval(a).shape) == tuple(val.shape)]
        if full:
            common = {self.complete_spec(a) for a in full}
            if len(common) == 1:
                (mine,) = common
                if mine != spec and self.n_shards(_spec_axes(mine)) >= \
                        self.n_shards(_spec_axes(spec)):
                    spec = mine

        def operand(v):
            if not (isinstance(v, fx.Node) and _is_tensor(self.gval(v))):
                return self.value(v)
            vshape = tuple(self.gval(v).shape)
            dm = _broadcast_dimmap(vshape, tuple(val.shape)) or ()
            req = [()] * len(vshape)
            for od, vd in enumerate(dm):
                if vd is not None:
                    req[vd] = spec[od]
            return self.value(v, tuple(req))

        args = fx.node.map_arg(node.args, operand)
        self.emit_same(node, args, spec)

    def mapped(self, node, dimmap, src_key, op=None):
        """An op whose output dims map to its first operand's by
        ``dimmap`` (out dim -> in dim or None), on local operands: a
        partial operand passes through under its own Spec.  ``op``:
        ``(target, the arguments after the operand)`` to emit instead of
        the node's own."""
        val = self.gval(node)
        x = self.gval(src_key)
        lay = self.layout(src_key)
        target, rest = op or (node.target, tuple(node.args[1:]))

        def emit(arg, spec, partial=()):
            out = self.call(target, (arg,) + tuple(rest), node.kwargs,
                            val=_meta(local_shape(val, spec,
                                                  self.mesh_shape),
                                      val.dtype))
            self.set(node, out, Layout(spec, partial))

        if lay.partial and self.sole_user(src_key, node):
            inv = {i: o for o, i in enumerate(dimmap) if i is not None}
            if all(not axes or d in inv for d, axes in enumerate(lay.spec)):
                spec = tuple(lay.spec[dimmap[o]] if dimmap[o] is not None
                             else () for o in range(val.dim()))
                emit(self.env[src_key][0], spec, lay.partial)
                return
        spec = self.want(node)
        req = [()] * x.dim()
        for o, i in enumerate(dimmap):
            if i is not None:
                req[i] = spec[o]
        spec = tuple(spec[o] if dimmap[o] is not None else ()
                     for o in range(val.dim()))
        emit(self.value(src_key, tuple(req)), spec)

    def squeeze(self, node):
        """A squeeze of the dims of size 1, named explicitly: a local block
        may have size 1 where the whole dim has not."""
        x_key = node.args[0]
        shape = tuple(self.gval(x_key).shape)
        if node.target is aten.squeeze.default:
            dims = [d for d, n in enumerate(shape) if n == 1]
        else:
            arg = node.args[1]
            dims = [d % len(shape) for d in
                    (arg if isinstance(arg, (list, tuple)) else [arg])
                    if shape[d % len(shape)] == 1]
        if not dims:
            self.env[node] = self.env[x_key]
            return
        dm = tuple(d for d in range(len(shape)) if d not in dims)
        self.mapped(node, dm, x_key, (aten.squeeze.dims, (dims,)))

    def view(self, node):
        x_key = node.args[0]
        xval, val = self.gval(x_key), self.gval(node)
        in_shape, out_shape = tuple(xval.shape), tuple(val.shape)
        groups = _view_groups(in_shape, out_shape)
        lay = self.layout(x_key)

        def through(spec_in):
            """The output Spec of a view of a ``spec_in`` operand that is
            local, else None."""
            out = [()] * len(out_shape)
            for gi, gj in groups:
                nt_in = [d for d in gi if in_shape[d] > 1]
                nt_out = [d for d in gj if out_shape[d] > 1]
                sharded = [d for d in gi if spec_in[d]]
                if not sharded:
                    continue
                if sharded != nt_in[:1] or not nt_out:
                    return None
                axes = spec_in[sharded[0]]
                if out_shape[nt_out[0]] % self.n_shards(axes):
                    return None
                out[nt_out[0]] = axes
            return tuple(out)

        if groups is not None and lay.partial and \
                self.sole_user(x_key, node):
            spec = through(lay.spec)
            if spec is not None:
                self.emit_view(node, self.env[x_key][0], spec, lay.partial)
                return
        spec = self.want(node)
        req = [()] * len(in_shape)
        if groups is None:
            spec = replicated_spec(len(out_shape))
        else:
            spec = list(spec)
            for gi, gj in groups:
                nt_in = [d for d in gi if in_shape[d] > 1]
                nt_out = [d for d in gj if out_shape[d] > 1]
                lead = nt_out[0] if nt_out else None
                for d in gj:
                    if d != lead:
                        spec[d] = ()
                if lead is not None and spec[lead]:
                    if nt_in and in_shape[nt_in[0]] % self.n_shards(
                            spec[lead]) == 0:
                        req[nt_in[0]] = spec[lead]
                    else:
                        spec[lead] = ()
            spec = tuple(spec)
        if self.layout(x_key).spec != tuple(req) and any(
                self.layout(x_key).spec):
            self.gather_views += 1
        self.emit_view(node, self.value(x_key, tuple(req)), spec)

    def emit_view(self, node, x, spec, partial=()):
        val = self.gval(node)
        size = list(local_shape(val, spec, self.mesh_shape))
        out = self.call(node.target, (x, size), node.kwargs,
                        val=_meta(size, val.dtype))
        self.set(node, out, Layout(spec, tuple(partial)))

    def expand(self, node):
        x_key = node.args[0]
        xval, val = self.gval(x_key), self.gval(node)
        spec = self.want(node)
        dm = _broadcast_dimmap(tuple(xval.shape), tuple(val.shape))
        req = [()] * xval.dim()
        for o, i in enumerate(dm):
            if i is not None:
                req[i] = spec[o]
        size = list(local_shape(val, spec, self.mesh_shape))
        out = self.call(node.target, (self.value(x_key, tuple(req)), size),
                        node.kwargs, val=_meta(size, val.dtype))
        self.set(node, out, Layout(spec))

    def slice_like(self, node, dims):
        """``slice``/``select``-like ops over ``dims`` of their first
        operand: those dims replicated, the rest mapped."""
        dm = follow_dimmap(node, node.args[0])
        if dm is None:
            return self.barrier(node)
        xval = self.gval(node.args[0])
        spec = list(self.want(node))
        req = [()] * xval.dim()
        for o, i in enumerate(dm):
            if i is None or i in dims:
                spec[o] = ()
            else:
                req[i] = spec[o]
        args = (self.value(node.args[0], tuple(req)),) + tuple(node.args[1:])
        self.emit_same(node, args, tuple(spec))

    def product(self, node):
        """``mm``/``addmm``/``bmm`` on operands under the chosen strategy's
        specs (the leading virtual dim of each merged dim), contracted
        locally into a partial sum over the contracting dim's axes."""
        val = self.gval(node)
        fused = node.target is aten.addmm.default
        lhs, rhs = (node.args[1], node.args[2]) if fused else node.args[:2]
        batched = node.target is aten.bmm.default
        lspec, rspec = self.dot_operand_specs(node, lhs, rhs)
        nb = 1 if batched else 0
        # the paired dims agree, the output's axes are distinct
        if batched:
            rspec[0] = lspec[0]
        k_axes = lspec[nb + 1]
        if rspec[nb] != k_axes:
            k_axes = lspec[nb + 1] = rspec[nb] = ()
        used = set(_spec_axes(lspec))
        rspec[nb + 1] = tuple(a for a in rspec[nb + 1] if a not in used)
        lspec = self.valid(lspec, tuple(self.gval(lhs).shape))
        rspec = self.valid(rspec, tuple(self.gval(rhs).shape))
        if lspec[nb + 1] != rspec[nb]:
            lspec = lspec[:nb + 1] + ((),) + lspec[nb + 2:]
            rspec = rspec[:nb] + ((),) + rspec[nb + 1:]
        k_axes = lspec[nb + 1]
        out_spec = ((lspec[0],) if batched else ()) + (lspec[nb],
                                                        rspec[nb + 1])
        a, b = self.value(lhs, lspec), self.value(rhs, rspec)
        local = local_shape(val, out_spec, self.mesh_shape)
        if not fused:
            out = self.call(node.target, (a, b), node.kwargs,
                            val=_meta(local, val.dtype))
            self.set(node, out, Layout(out_spec, k_axes))
            return
        beta = node.kwargs.get("beta", 1)
        alpha = node.kwargs.get("alpha", 1)
        if beta != 1 or alpha != 1:
            return self.barrier(node)
        bias = node.args[0]
        bshape = tuple(self.gval(bias).shape)
        dm = _broadcast_dimmap(bshape, tuple(val.shape)) or ()
        breq = [()] * len(bshape)
        if not k_axes:
            for o, i in enumerate(dm):
                if i is not None:
                    breq[i] = out_spec[o]
            out = self.call(node.target, (self.value(bias, tuple(breq)), a,
                                          b), {}, val=_meta(local, val.dtype))
            self.set(node, out, Layout(out_spec))
            return
        # a partial product: reduce it, then add the bias once
        prod = self.call(aten.mm.default, (a, b), {},
                         val=_meta(local, val.dtype))
        self.set(node, prod, Layout(out_spec, k_axes))
        want = self.want(node)
        summed = self.value(node, want)
        for o, i in enumerate(dm):
            if i is not None:
                breq[i] = want[o]
        out = self.call(aten.add.Tensor,
                        (summed, self.value(bias, tuple(breq))), {},
                        val=_meta(local_shape(val, want, self.mesh_shape),
                                  val.dtype))
        self.set(node, out, Layout(want))

    def dot_operand_specs(self, node, lhs, rhs):
        """The chosen strategy's operand specs on the aten operands' dims
        (each dim takes the axes of the leading non-trivial virtual dim it
        merges); without a strategy node, the output's planned Spec read
        back through the product."""
        entry = self.sg.value_nodes.get(node)
        groups = self.sg.dot_groups.get(node)
        lnd, rnd = self.gval(lhs).dim(), self.gval(rhs).dim()
        if entry is None or groups is None:
            spec = self.want(node)
            if node.target is aten.bmm.default:
                return ([spec[0], spec[1], ()], [spec[0], (), spec[2]])
            return ([spec[0], ()], [(), spec[1]])
        idx, _ = entry
        sg_node = self.sg.nodes[idx]
        st = sg_node.strategies[self.choice[idx]]
        out = []
        for vspec, grp, nd in ((st.operand_specs[0], groups[0], lnd),
                               (st.operand_specs[1], groups[1], rnd)):
            spec = []
            for j in range(nd):
                vdims = grp[j] if j < len(grp) else []
                lead = next((v for v, size in vdims if size > 1),
                            vdims[0][0] if vdims else None)
                spec.append(tuple(vspec[lead]) if lead is not None else ())
            out.append(spec)
        return out

    def reduction(self, node):
        x_key = node.args[0]
        xval, val = self.gval(x_key), self.gval(node)
        nd = xval.dim()
        dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
        if dims is None or (isinstance(dims, (list, tuple)) and not dims) \
                or node.target in (aten.sum.default, aten.mean.default):
            red = list(range(nd))
            keepdim = False
        else:
            dims = [dims] if isinstance(dims, int) else list(dims)
            red = sorted(d % max(nd, 1) for d in dims)
            keepdim = bool(node.args[2] if len(node.args) > 2 else
                           node.kwargs.get("keepdim", False))
        kept = [d for d in range(nd) if d not in red]
        linear = node.target in SUM_OPS or node.target in MEAN_OPS
        lay = self.layout(x_key)
        if lay.partial and linear and self.sole_user(x_key, node):
            req, x = lay.spec, self.env[x_key][0]
            partial = list(lay.partial)
        else:
            req = self.reduce_operand_spec(node, kept, keepdim, nd, red)
            if not linear:
                req = tuple(() if d in red else req[d] for d in range(nd))
            x = self.value(x_key, req)
            partial = []
        out_spec = [req[d] for d in kept] if not keepdim else [
            () if d in red else req[d] for d in range(nd)]
        partial += [a for d in red for a in req[d]]
        out_spec = tuple(out_spec)
        local = local_shape(val, out_spec, self.mesh_shape)
        if node.target in MEAN_OPS and any(req[d] for d in red):
            count = float(_numel([xval.shape[d] for d in red]))
            args = (x, red, keepdim)
            s = self.call(aten.sum.dim_IntList, args,
                          {"dtype": node.kwargs.get("dtype")} if
                          node.kwargs.get("dtype") else {},
                          val=_meta(local, val.dtype))
            out = self.call(aten.div.Tensor, (s, count), {},
                            val=_meta(local, val.dtype))
        else:
            args = (x,) + tuple(node.args[1:])
            out = self.call(node.target, args, node.kwargs,
                            val=_meta(local, val.dtype))
        self.set(node, out, Layout(out_spec, tuple(partial)))

    def reduce_operand_spec(self, node, kept, keepdim, nd, red) -> Spec:
        entry = self.sg.value_nodes.get(node)
        if entry is not None:
            sg_node = self.sg.nodes[entry[0]]
            if sg_node.outvar is node and sg_node.strategies[
                    self.choice[entry[0]]].operand_specs:
                spec = sg_node.strategies[
                    self.choice[entry[0]]].operand_specs[0]
                return self.valid(spec, tuple(self.gval(node.args[0]).shape))
        spec = self.want(node)
        req = [()] * nd
        for j, d in enumerate(range(nd) if keepdim else kept):
            if d not in red:
                req[d] = spec[j]
        return tuple(req)

    def rows_spec(self, key, norm_dims) -> Spec:
        """The Spec of a row-wise op's rows: ``key``'s planned Spec with
        the normalized dims replicated."""
        spec = self.want(key)
        return tuple(() if d in norm_dims else spec[d]
                     for d in range(len(spec)))

    def layer_norm(self, node):
        x = node.args[0]
        xval = self.gval(x)
        k = len(node.args[1])
        norm = list(range(xval.dim() - k, xval.dim()))
        spec = self.rows_spec((node, 0), norm)
        stats = tuple(spec[:xval.dim() - k]) + ((),) * k
        args = [self.value(x, spec), node.args[1]] + [
            self.value(a) for a in node.args[2:4]] + list(node.args[4:])
        out = self.call(node.target, args, node.kwargs,
                        val=_meta_like(self.gval(node)))
        self.set_outputs(node, out, lambda v: spec if v.dim() == xval.dim()
                         and tuple(v.shape) == tuple(xval.shape) else stats)

    def layer_norm_backward(self, node):
        g, x = node.args[0], node.args[1]
        gval = self.gval(g)
        k = len(node.args[2])
        nd = gval.dim()
        norm = list(range(nd - k, nd))
        spec = self.rows_spec((node, 0), norm)
        stats = tuple(spec[:nd - k]) + ((),) * k
        args = [self.value(g, spec), self.value(x, spec), node.args[2],
                self.value(node.args[3], stats),
                self.value(node.args[4], stats)] + [
            self.value(a) for a in node.args[5:7]] + list(node.args[7:])
        out = self.call(node.target, args, node.kwargs,
                        val=_meta_like(self.gval(node)))
        row_axes = _spec_axes(spec)
        vals = self.gval(node)
        for i, v in enumerate(vals):
            if not _is_tensor(v):
                continue
            s = spec if i == 0 else replicated_spec(v.dim())
            item = self.call(operator.getitem, (out, i),
                             val=_meta(local_shape(v, s, self.mesh_shape),
                                       v.dtype))
            self.set((node, i), item,
                     Layout(s, () if i == 0 else row_axes))
        self.set(node, out, Layout(()))

    def softmax(self, node, operands, dim):
        val = self.gval(node)
        dim %= val.dim()
        spec = tuple(() if d == dim else a
                     for d, a in enumerate(self.want(node)))
        args = [self.value(a, spec) if a in operands else a
                for a in node.args]
        self.emit_same(node, args, spec)

    def embedding(self, node):
        weight, ids = node.args[0], node.args[1]
        val = self.gval(node)
        spec = self.want(node)
        k = self.gval(ids).dim()
        wspec = ((), spec[k]) if val.dim() == k + 1 else ((), ())
        args = (self.value(weight, wspec), self.value(ids, spec[:k])) + \
            tuple(node.args[2:])
        self.emit_same(node, args, tuple(spec[:k]) + (wspec[1],))

    def embedding_backward(self, node):
        grad, ids = node.args[0], node.args[1]
        k = self.gval(ids).dim()
        spec = self.complete_spec(grad)
        ids_spec = tuple(spec[:k])
        hidden = spec[k]
        args = (self.value(grad, spec), self.value(ids, ids_spec)) + \
            tuple(node.args[2:])
        out_spec = ((), hidden)
        out = self.emit_same(node, args, out_spec)
        self.set(node, out, Layout(out_spec, _spec_axes(ids_spec)))

    def nll(self, node):
        """``reduction="none"`` on row shards of the logits."""
        fwd = node.target is NLL_FWD
        reduction = node.args[3] if fwd else node.args[4]
        weight = node.args[2] if fwd else node.args[3]
        logits = node.args[0] if fwd else node.args[1]
        if reduction != 0 or weight is not None or \
                self.gval(logits).dim() != 2:
            return self.barrier(node)
        rows = self.complete_spec(logits)[0]
        if fwd:
            args = (self.value(logits, (rows, ())),
                    self.value(node.args[1], (rows,))) + tuple(node.args[2:])
            out = self.call(node.target, args, node.kwargs,
                            val=_meta_like(self.gval(node)))
            self.set_outputs(node, out, lambda v: (rows,) if v.dim() == 1
                             else replicated_spec(v.dim()))
            return
        args = (self.value(node.args[0], (rows,)),
                self.value(logits, (rows, ())),
                self.value(node.args[2], (rows,))) + tuple(node.args[3:6]) + (
                    self.value(node.args[6]),)
        self.emit_same(node, args, (rows, ()))

    def flash(self, node):
        """The flash ops on batch shards: each operand's batch dim under
        the query's axes, the other dims replicated."""
        fwd = _name(node) == FLASH_FWD
        q = node.args[0]
        batch = self.complete_spec(q)[0]
        nd = self.gval(q).dim()
        full = (batch,) + ((),) * (nd - 1)
        lse_spec = (batch, ())
        n_in = 3 if fwd else 6
        args = []
        for i, a in enumerate(node.args):
            if i < n_in and isinstance(a, fx.Node):
                args.append(self.value(a, lse_spec if (not fwd and i == 4)
                                       else full))
            else:
                args.append(a)
        out = self.call(node.target, args, node.kwargs,
                        val=_meta_like(self.gval(node)))
        self.set_outputs(node, out, lambda v: lse_spec if v.dim() == 2
                         else (batch,) + ((),) * (v.dim() - 1))

    def split(self, node):
        x_key = node.args[0]
        xval = self.gval(x_key)
        dim = (node.args[2] if len(node.args) > 2 else
               node.kwargs.get("dim", 0)) % xval.dim()
        spec = list(self.complete_spec(x_key))
        spec[dim] = ()
        spec = tuple(spec)
        out = self.call(node.target, (self.value(x_key, spec),) +
                        tuple(node.args[1:]), node.kwargs,
                        val=_meta_like(self.gval(node)))
        self.set_outputs(node, out, lambda v: spec)

    def cat(self, node):
        tensors = node.args[0]
        val = self.gval(node)
        dim = (node.args[1] if len(node.args) > 1 else
               node.kwargs.get("dim", 0)) % val.dim()
        spec = list(self.complete_spec(tensors[0]))
        spec[dim] = ()
        spec = self.valid(spec, tuple(val.shape))
        if any(self.gval(t).dim() != val.dim() for t in tensors):
            return self.barrier(node)
        args = ([self.value(t, spec) for t in tensors],) + tuple(
            node.args[1:])
        self.emit_same(node, args, spec)

    def like(self, node):
        """``*_like``: the operand's shape is all it reads, so its block
        under whatever layout it has (a partial sum's too)."""
        x_node, lay = self.env[node.args[0]]
        self.emit_same(node, (x_node,) + tuple(node.args[1:]), lay.spec)

    def factory(self, node, size_pos):
        val = self.gval(node)
        spec = self.want(node)
        size = list(local_shape(val, spec, self.mesh_shape))
        args = list(node.args)
        args[size_pos] = size
        if size_pos == 1:
            args[0] = self.env[args[0]][0]
        out = self.call(node.target, args, node.kwargs,
                        val=_meta(size, val.dtype))
        self.set(node, out, Layout(spec))

    # ------------------------------------------------------------ the walk

    def run(self):
        graph = self.gm.graph
        placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        for i, ph in enumerate(placeholders):
            p = self.g.placeholder(f"in_{i}")
            val = ph.meta.get("val")
            spec = self.in_specs[i] if _is_tensor(val) else ()
            if _is_tensor(val):
                p.meta["val"] = _meta(local_shape(val, spec,
                                                  self.mesh_shape),
                                      val.dtype)
            self.placeholders.append(p)
            self.set(ph, p, Layout(spec))
        self.coords = self.g.placeholder("coords")
        output = None
        for node in graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "output":
                output = node
                break
            if node.op == "get_attr":
                attr = self.g.get_attr(node.target)
                attr.meta["val"] = node.meta.get("val")
                self.set(node, attr, Layout(replicated_spec(
                    getattr(self.gm, node.target).dim())))
                continue
            self.handle(node)
        outs = []
        results = output.args[0]
        if not isinstance(results, (list, tuple)):
            results = [results]
        for i, v in enumerate(results):
            if not isinstance(v, fx.Node):
                outs.append(v)
                self.result_specs.append(())
                continue
            val = self.gval(v)
            self.current = f"output {i}"
            if i < len(self.out_specs) and self.out_specs[i] is not None:
                spec = self.out_specs[i]
            elif self.natural_outputs and _is_tensor(val):
                spec = self.complete_spec(v)
            else:
                spec = replicated_spec(val.dim()) if _is_tensor(val) else ()
            self.result_specs.append(tuple(spec))
            outs.append(self.value(v, spec) if _is_tensor(val)
                        else self.env[v][0])
        self.g.output(outs)
        return self.g

    def handle(self, node):
        self.current = node.name
        target = node.target
        name = _name(node)
        if target is operator.getitem:
            src = node.args[0]
            if is_marker(src, "grad") and self.part == "apply":
                self.env[node] = self.env[(src, node.args[1])]
            elif name == PIPELINE_MARKER or _name(src) == PIPELINE_MARKER:
                self.env[node] = self.env[src.args[0][node.args[1]]]
            else:
                self.env[node] = self.env[(src, node.args[1])]
            return
        if is_marker(node, "grad"):
            return self.boundary(node)
        if name in (PIPELINE_MARKER, PIPELINE_BOUNDARY):
            return
        val = self.gval(node)
        if target in DOT_OPS:
            return self.product(node)
        if target in VIEW_OPS:
            return self.view(node)
        if target in SQUEEZE_OPS:
            return self.squeeze(node)
        if target in PERMUTE_OPS or target is aten.unsqueeze.default:
            dm = follow_dimmap(node, node.args[0])
            if dm is not None:
                return self.mapped(node, dm, node.args[0])
        if target is aten.expand.default:
            return self.expand(node)
        if target in (aten.slice.Tensor, aten.select.int):
            dim = node.args[1] if len(node.args) > 1 else 0
            return self.slice_like(node, {dim % self.gval(
                node.args[0]).dim()})
        if target in SUM_OPS or target in MEAN_OPS or target in MINMAX_OPS:
            return self.reduction(node)
        if target is LAYER_NORM:
            return self.layer_norm(node)
        if target is LAYER_NORM_BWD:
            return self.layer_norm_backward(node)
        if target in SOFTMAX_OPS:
            return self.softmax(node, [node.args[0]], node.args[1])
        if target in (SOFTMAX_BWD, LOG_SOFTMAX_BWD):
            return self.softmax(node, [node.args[0], node.args[1]],
                                node.args[2])
        if target is EMBEDDING:
            return self.embedding(node)
        if target is EMBEDDING_BWD:
            return self.embedding_backward(node)
        if target in (NLL_FWD, NLL_BWD):
            return self.nll(node)
        if name in (FLASH_FWD, FLASH_BWD):
            return self.flash(node)
        if target in SPLIT_OPS:
            return self.split(node)
        if target in CAT_OPS:
            return self.cat(node)
        if target in FILL_FACTORIES:
            return self.factory(node, 0)
        if target in NEW_FACTORIES:
            return self.factory(node, 1)
        if target in LIKE_FACTORIES:
            return self.like(node)
        if target in ELEMENTWISE_OPS and _is_tensor(val):
            return self.elementwise(node)
        return self.barrier(node)

    def boundary(self, marker):
        """The gradient marker: its operands leave the compute-grad part as
        they are (partial sums unreduced), and the apply-grad part reads
        each as an external value of the same layout."""
        self.pres = []
        for j, v in enumerate(marker.args[0]):
            if isinstance(v, fx.Node) and _is_tensor(self.gval(v)):
                node, lay = self.env[v]
                self.pres.append((node, lay))
            else:
                self.pres.append((None, None))
        self.part = "apply"
        for j, (node, lay) in enumerate(self.pres):
            v = marker.args[0][j]
            if node is None:
                self.env[(marker, j)] = self.env.get(v, (v, Layout(())))
                continue
            ext = self.call(external, (j,), val=node.meta.get("val"))
            self.env[(marker, j)] = (ext, lay)


def _meta_like(val):
    """Meta tensors of a traced value's shapes (a tensor, or a tuple)."""
    if _is_tensor(val):
        return _meta(val.shape, val.dtype)
    if isinstance(val, (tuple, list)):
        return type(val)(_meta_like(v) for v in val)
    return val


#: the ops that read a strided operand by its strides (ROADMAP C.8's scan)
STRIDE_SAFE_OPS = (aten.mm.default, aten.bmm.default, aten.sum.default,
                   aten.sum.dim_IntList, aten.add.Tensor, aten.add_.Tensor)


def strided_slice_readers(root: fx.GraphModule
                          ) -> List[Tuple[fx.Node, fx.Node]]:
    """``(slice, reader)`` for every local slice of a partitioned program
    that leaves a strided view (a dim other than 0, with more than one
    element before it) and reaches an op other than ``STRIDE_SAFE_OPS``
    or the contiguous copy ``Partitioner.reshard`` makes of it."""
    out = []
    for n in root.graph.nodes:
        if n.op != "call_function" or n.target is not aten.slice.Tensor:
            continue
        d = n.args[1] if len(n.args) > 1 else 0
        val = n.meta.get("val")
        if val is None or not any(k > 1 for k in tuple(val.shape)[:d]):
            continue
        for u in n.users:
            if u.op == "call_function" and (
                    u.target in STRIDE_SAFE_OPS or
                    (u.target is aten.clone.default and
                     u.kwargs.get("memory_format") is
                     torch.contiguous_format)):
                continue
            out.append((n, u))
    return out


class SpmdProgram:
    """The partitioned program of a traced step: ``parts`` ("compute",
    "apply"; one "compute" part without a gradient marker) of ``Step``s,
    run over the logical mesh's devices by ``run_part``.  ``records``:
    every collective of one run of the program, in order (the executables'
    ``get_collective_counts()`` sums them per step)."""

    def __init__(self, gm: fx.GraphModule, graph, choice, logical_mesh,
                 in_specs, out_specs, donated: Sequence[bool] = (),
                 natural_outputs: bool = False):
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            alias_donated_inputs
        part = Partitioner(gm, graph, choice, logical_mesh, in_specs,
                           out_specs, natural_outputs)
        pg = part.run()
        # each output's Spec (``natural_outputs``: an output given no Spec
        # keeps the one the program computes it under, complete)
        self.out_specs = part.result_specs
        self.partitioner_stats = {"gather_views": part.gather_views,
                                  "slice_copies": part.slice_copies,
                                  "slice_copy_bytes": part.slice_copy_bytes,
                                  "barriers": dict(part.barriers)}
        self.logical_mesh = logical_mesh
        self.devices = logical_mesh.flat_devices()
        self.coords = [logical_mesh.coords(p)
                       for p in range(logical_mesh.num_devices)]
        self.records = part.records
        self.in_specs = part.in_specs
        self.pres = [node for node, _ in part.pres]
        self.pre_layouts = [lay for _, lay in part.pres]
        self.root = fx.GraphModule(gm, pg)
        donate = [i for i, d in enumerate(donated) if d]
        invals = [p.meta.get("val") for p in part.placeholders] + [None]
        self.aliased = alias_donated_inputs(self.root, donate, invals)
        graph = self.root.graph
        self.placeholders = part.placeholders
        self.coords_node = part.coords
        out_node = next(n for n in graph.nodes if n.op == "output")
        self.outputs = list(out_node.args[0])
        self.externals = {n.args[0]: n for n in graph.nodes
                          if n.op == "call_function" and n.target is external}
        for n in graph.nodes:   # copies into donated inputs join their part
            if n.op == "call_function" and "part" not in n.meta:
                n.meta["part"] = n.args[1].meta.get("part", "apply")
        self.parts = {"compute": [], "apply": []}
        for name in ("compute", "apply"):
            nodes = [n for n in graph.nodes if n.op == "call_function" and
                     n.target is not external and n.meta["part"] == name]
            self.parts[name] = self._steps(nodes)
        self._liveness()
        self._modules = {}

    def _steps(self, nodes) -> List[Step]:
        steps, cur = [], []
        for n in nodes:
            if n.target is collective:
                if cur:
                    steps.append(Step("segment", cur))
                    cur = []
                rec = self.records[n.args[0]]
                steps.append(Step("collective", [n], [n.args[1]], [n],
                                  record=rec))
            else:
                cur.append(n)
        if cur:
            steps.append(Step("segment", cur))
        return steps

    def _liveness(self):
        """Each segment's inputs and outputs, and the values each step is
        the last reader of."""
        order = self.parts["compute"] + self.parts["apply"]
        defined = {}
        for si, st in enumerate(order):
            for n in st.nodes:
                defined[n] = si
        readers: Dict[fx.Node, int] = {}
        held = set(self.outputs) | {n for n in self.pres if n is not None}
        for si, st in enumerate(order):
            if st.kind == "segment":
                inside = set(st.nodes)
                ins = []
                for n in st.nodes:
                    for v in n.all_input_nodes:
                        if v not in inside and v.op != "get_attr" and \
                                v not in ins:
                            ins.append(v)
                st.invars = ins
            for v in st.invars:
                readers[v] = si
        for si, st in enumerate(order):
            if st.kind == "segment":
                st.outvars = [n for n in st.nodes
                              if readers.get(n, si) > si or n in held]
        last: Dict[int, List[fx.Node]] = {}
        for v, si in readers.items():
            if v not in held and v.op != "placeholder":
                last.setdefault(si, []).append(v)
        for si, st in enumerate(order):
            st.dead = last.get(si, [])

    def _module(self, step: Step, device: torch.device):
        key = (id(step), device)
        if key not in self._modules:
            from alpa_tpu_torch.pipeline_parallel.computation import \
                PipelineComputation
            comp = PipelineComputation("segment", step.invars, step.outvars,
                                       step.nodes)
            self._modules[key] = comp.get_runnable(self.root, device)
        return self._modules[key]

    def initial_store(self, inputs: Sequence[Sequence[Any]]):
        """Per device, its values: ``inputs[p]`` the device's local input
        values, in the order of the flat inputs."""
        stores = []
        for p in range(len(self.devices)):
            store = dict(zip(self.placeholders, inputs[p]))
            store[self.coords_node] = self.coords[p]
            stores.append(store)
        return stores

    def run_part(self, name: str, stores):
        for step in self.parts[name]:
            if step.kind == "segment":
                for p, device in enumerate(self.devices):
                    store = stores[p]
                    module = self._module(step, device)
                    args = [store[v] for v in step.invars]
                    if device.type == "cuda":
                        with torch.cuda.device(device), torch.no_grad():
                            outs = module(*args)
                    else:
                        with torch.no_grad():
                            outs = module(*args)
                    for v, o in zip(step.outvars, outs):
                        store[v] = o
            else:
                (x,) = step.invars
                (node,) = step.nodes
                ys = run_collective(step.record, [s[x] for s in stores],
                                    self.logical_mesh)
                for s, y in zip(stores, ys):
                    s[node] = y
            for v in step.dead:
                for s in stores:
                    s.pop(v, None)

    def pre_values(self, stores) -> List[List[Any]]:
        """Per device, the marked values the compute part left."""
        return [[s[n] if n is not None else None for n in self.pres]
                for s in stores]

    def set_externals(self, stores, values):
        """Per device, the values the apply part reads for the marked
        ones."""
        for s, vals in zip(stores, values):
            for j, node in self.externals.items():
                s[node] = vals[j]

    def output_values(self, stores) -> List[List[Any]]:
        return [[s[o] if isinstance(o, fx.Node) else o
                 for o in self.outputs] for s in stores]
