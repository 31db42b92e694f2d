"""Unit cases of the port's SPMD partitioner and collectives, on the CPU.

Each case partitions a small traced function over a logical mesh of
``["cpu"] * N``, feeds every device its block of a random tensor (from a
seed) and holds every device's output block to the same block of the
function's unsharded result, exactly (float32 sums of two or four terms
in another order: to 1e-6 relative where a partial sum is reduced).
The resharding cases cover R->S, S->R, a move to another axis (S0->S1),
a move to another dim (an all-to-all), a dim over both axes (S01->R), a
partial sum completed (partial->R) or scattered (partial->S), and views
that merge a sharded dim (local where it is outermost, gathered first
where it is not).  The guards: a mesh naming one card twice never calls
NCCL (a mocked ``torch.cuda.nccl``), and distinct cards choose it.
"""
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.shard_parallel import collectives
from alpa_tpu_torch.shard_parallel.auto_sharding import AutoShardingOption
from alpa_tpu_torch.shard_parallel.sharding_spec import Aval, local_slices
from alpa_tpu_torch.shard_parallel.spmd_partition import SpmdProgram
from alpa_tpu_torch.shard_parallel.strategy import build_strategy_graph


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _program(fn, shapes, in_specs, out_specs, mesh_shape, choose=None):
    """``fn`` traced at ``shapes``, its strategy graph on ``mesh_shape``
    with the inputs pinned to ``in_specs``, every other node at its first
    strategy (or ``choose(node) -> index``), partitioned."""
    gm = make_fx(fn, tracing_mode="fake")(*[torch.empty(s) for s in shapes])
    n = int(np.prod(mesh_shape))
    mesh = PhysicalDeviceMesh(["cpu"] * n).get_logical_mesh(mesh_shape)
    graph = build_strategy_graph(
        gm.graph, [Aval(tuple(s), torch.float32) for s in shapes], mesh, [],
        AutoShardingOption(), pins=dict(enumerate(in_specs)))
    choice = [choose(node) if choose else 0 for node in graph.nodes]
    return SpmdProgram(gm, graph, choice, mesh, in_specs, out_specs), mesh


def _run(program, mesh, inputs, specs):
    per_pos = [[] for _ in range(mesh.num_devices)]
    for x, spec in zip(inputs, specs):
        for p, shard in enumerate(DistributedArray.from_full(
                x, spec, mesh).shards):
            per_pos[p].append(shard)
    stores = program.initial_store(per_pos)
    program.run_part("compute", stores)
    program.run_part("apply", stores)
    return program.output_values(stores)


def _assert_blocks(outs, full, spec, mesh, rtol=0.0):
    for p, vals in enumerate(outs):
        block = full
        for d, (off, size) in enumerate(local_slices(
                full.shape, spec, mesh.coords(p), mesh.shape)):
            block = block.narrow(d, off, size)
        torch.testing.assert_close(vals[0], block, rtol=rtol, atol=rtol)


def _kinds(program):
    return [r.kind for r in program.records]


RESHARDS = {
    # name: (mesh, shape, src, dst, collectives)
    "R->S0": ((2, 2), (8, 4), ((), ()), ((0,), ()), []),
    "S0->R": ((2, 2), (8, 4), ((0,), ()), ((), ()), ["all_gather"]),
    "S0->S1": ((2, 2), (8, 4), ((0,), ()), ((1,), ()),
               ["all_gather"]),
    "S0 dim 0->dim 1": ((2, 2), (8, 4), ((0,), ()), ((), (0,)),
                        ["all_to_all"]),
    "S01->R": ((2, 2), (8, 4), ((0, 1), ()), ((), ()),
               ["all_gather", "all_gather"]),
    "S0,S1->S1,S0": ((2, 2), (8, 4), ((0,), (1,)), ((1,), (0,)),
                     ["all_gather", "all_gather"]),
}


@pytest.mark.parametrize("case", sorted(RESHARDS))
def test_resharding_equals_the_unsharded_value(case):
    """The identity function with its output pinned to another spec: every
    device's block of the input, resharded, is its block of ``dst``."""
    mesh_shape, shape, src, dst, kinds = RESHARDS[case]
    program, mesh = _program(lambda x: x, [shape], [src], [dst], mesh_shape)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    _assert_blocks(_run(program, mesh, [x], [src]), x, dst, mesh)
    assert _kinds(program)[:len(kinds)] == kinds
    assert all(k in ("all_gather", "all_to_all") for k in _kinds(program))
    # an all-to-all is an all-gather and a slice: it moves the group's
    # operands, like an all-gather of them
    for rec in program.records:
        n = mesh.shape[rec.axis]
        operand = 4 * int(torch.Size(rec.shape).numel())
        assert rec.nbytes == n * operand, rec


@pytest.mark.parametrize("dst, kind", [(((),), "all_reduce"),
                                       (((0,),), "reduce_scatter")],
                         ids=["partial->R", "partial->S"])
def test_partial_sum_completes(dst, kind):
    """A sum over a dim sharded on mesh axis 0 leaves each device a partial
    sum; the output's spec completes it by an all-reduce (replicated) or a
    reduce-scatter (sharded on the axis)."""
    shape, src = (8, 12), ((0,), ())

    def choose(node):
        if node.label == "sum":   # the reduction over the sharded dim
            return next(i for i, st in enumerate(node.strategies)
                        if st.operand_specs[0] == src)
        return 0

    program, mesh = _program(lambda x: x.sum(0), [shape], [src], [dst],
                             (2, 2), choose)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    _assert_blocks(_run(program, mesh, [x], [src]), x.sum(0), dst, mesh,
                   rtol=1e-6)
    assert _kinds(program) == [kind]


def test_product_contracted_over_a_sharded_dim():
    """``x @ w`` with the contracting dim sharded on both operands: a local
    product, then one all-reduce."""
    src_x, src_w = ((), (1,)), ((1,), ())

    def choose(node):
        if node.label.startswith("dot:"):
            return next(i for i, st in enumerate(node.strategies)
                        if st.operand_specs == (src_x, src_w))
        return 0

    program, mesh = _program(lambda x, w: x @ w, [(8, 16), (16, 4)],
                             [src_x, src_w], [((), ())], (1, 2), choose)
    gen = torch.Generator().manual_seed(2)
    x, w = torch.randn(8, 16, generator=gen), torch.randn(16, 4,
                                                          generator=gen)
    _assert_blocks(_run(program, mesh, [x, w], [src_x, src_w]), x @ w,
                   ((), ()), mesh, rtol=1e-6)
    assert _kinds(program) == ["all_reduce"]


@pytest.mark.parametrize("src, gathers", [(((0,), (), ()), 0),
                                          (((), (0,), ()), 1)],
                         ids=["outermost", "inner"])
def test_merged_dim_view(src, gathers):
    """``view(B * S, H)`` of a (B, S, H) value: local when the sharded dim
    is outermost in the merge (the output's merged dim sharded), gathered
    first when it is not."""
    shape = (4, 6, 8)
    program, mesh = _program(lambda x: x.reshape(24, 8) * 2.0, [shape],
                             [src], [None], (2, 1))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    outs = _run(program, mesh, [x], [src])
    for vals in outs:
        torch.testing.assert_close(vals[0], x.reshape(24, 8) * 2.0)
    assert program.partitioner_stats["gather_views"] == gathers
    # one gather either way: before the view, or of its output at the exit
    assert _kinds(program) == ["all_gather"]


def test_duplicated_card_never_reaches_nccl(monkeypatch):
    """A group that names one card twice runs plain ops (NCCL refuses a
    duplicated GPU); distinct cards choose NCCL; the choice stands in the
    record."""
    class NoNccl:
        def __getattr__(self, name):
            raise AssertionError(f"torch.cuda.nccl.{name} was called")

    monkeypatch.setattr(torch.cuda, "nccl", NoNccl(), raising=False)
    monkeypatch.setitem(__import__("sys").modules, "torch.cuda.nccl",
                        NoNccl())
    assert collectives.backend_of(["cuda:0", "cuda:0"]) == "plain"
    assert collectives.backend_of(["cuda:0", "cuda:1"]) == "nccl"
    assert collectives.backend_of(["cpu", "cpu"]) == "plain"
    mesh = PhysicalDeviceMesh(["cuda:0"] * 4).get_logical_mesh((2, 2))
    assert collectives.axis_backend(mesh, 0) == "plain"
    xs = [torch.full((2, 3), float(i)) for i in range(4)]
    for kind, kw in (("all_reduce", {}), ("all_gather", {"dim": 1}),
                     ("reduce_scatter", {"dim": 0}),
                     ("all_to_all", {"dim": 0, "concat_dim": 1})):
        rec = collectives.CollectiveRecord(kind, 0, (2, 3), torch.float32,
                                           24, "plain", **kw)
        ys = collectives.run_collective(rec, xs, mesh)
        assert len(ys) == 4 and all(isinstance(y, torch.Tensor) for y in ys)
    # axis 0 pairs positions (0, 2) and (1, 3)
    rec = collectives.CollectiveRecord("all_reduce", 0, (2, 3),
                                       torch.float32, 24, "plain")
    ys = collectives.run_collective(rec, xs, mesh)
    assert [float(y[0, 0]) for y in ys] == [2.0, 4.0, 2.0, 4.0]
    # each result is its device's own tensor
    assert len({y.data_ptr() for y in ys}) == 4


class _CpuNccl:
    """``torch.cuda.nccl``'s all-gather and reduce-scatter (sum) on CPU
    tensors: the results NCCL writes, into the outputs it is given."""

    @staticmethod
    def all_gather(ins, outs):
        full = torch.cat(ins, 0)
        for o in outs:
            o.copy_(full)

    @staticmethod
    def reduce_scatter(ins, outs, op=0):
        total = sum(ins)
        for o, c in zip(outs, total.chunk(len(outs), 0)):
            o.copy_(c)


@pytest.mark.parametrize("kind,dim", [("all_gather", 0), ("all_gather", 1),
                                      ("reduce_scatter", 0),
                                      ("reduce_scatter", 1),
                                      ("all_to_all", 1)])
def test_nccl_and_plain_collectives_hand_back_one_layout(monkeypatch, kind,
                                                         dim):
    """ROADMAP C.4: NCCL's all-gather and reduce-scatter along a dim other
    than 0 handed back a moved view (strides (1, 2, 1) for a layer norm's
    mean of shape (2, 8, 1)) where the plain path hands back a contiguous
    tensor.  ``native_layer_norm_backward`` reads its saved mean and rstd
    as contiguous whatever their strides, so the same values in that
    layout gave other gradients: the two-level step over distinct cards
    missed its first-moment bound.  Both backends now give one layout, and
    the gradients from either are equal (the dim-0 cases and the
    all-to-all, contiguous before the repair too, are the controls)."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.cuda.nccl", _CpuNccl)
    monkeypatch.setattr(torch.cuda, "nccl", _CpuNccl, raising=False)
    gen = torch.Generator().manual_seed(5)
    b, s, h = 2, 8, 16
    x = torch.randn(b, s, h, generator=gen)
    w, bias = torch.randn(h, generator=gen), torch.randn(h, generator=gen)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [h], w, bias, 1e-5)
    g = torch.randn(b, s, h, generator=gen)

    def run(backend, value):
        monkeypatch.setattr(collectives, "backend_of",
                            lambda devices: backend)
        if kind == "all_gather":
            xs = list(value.chunk(2, dim))
            return collectives.all_gather(xs, ["cpu"] * 2, dim)[0]
        if kind == "all_to_all":
            # the batch rows in, halves of the sequence out
            xs = list(value.chunk(2, 0))
            return collectives.all_to_all(xs, ["cpu"] * 2, dim, 0)[0]
        # each device holds half of the sum: the scatter gives the value's
        # block along dim
        xs = [value / 2, value / 2]
        return collectives.reduce_scatter(xs, ["cpu"] * 2, dim)[0]

    for value in (mean, rstd):
        nccl, plain = run("nccl", value), run("plain", value)
        assert torch.equal(nccl, plain)
        assert nccl.stride() == plain.stride() and nccl.is_contiguous()
    if kind == "all_gather":
        grads = [torch.ops.aten.native_layer_norm_backward(
            g, x, [h], run(backend, mean), run(backend, rstd), w, bias,
            [True, True, True]) for backend in ("nccl", "plain")]
        for a, b_ in zip(*grads):
            assert torch.equal(a, b_)



def test_a_local_slice_off_dim_0_hands_back_a_contiguous_block():
    """ROADMAP C.8: ``Partitioner.reshard`` adds a mesh axis to a dim by a
    local ``aten.slice``; on dim 1 of a layer norm's saved mean and rstd
    (shape (2, 8, 1)) that is a view with strides (8, 1, 1), and
    ``native_layer_norm_backward`` reads its mean and rstd as contiguous
    whatever their strides: before the repair the input gradient was off
    by 1.59 and the weight gradient by 3.53 from the unsharded call.  The
    slice is now copied into a contiguous block (one copy of each, counted
    in ``partitioner_stats``), no strided slice reaches the backward, and
    the gradients equal the unsharded program's (exactly for the input
    gradient's rows; the weight gradient is a sum of two partial sums, to
    1e-6 relative)."""
    aten = torch.ops.aten
    b, s, h = 2, 8, 16

    def fn(g, x, mean, rstd, w, bias):
        return aten.native_layer_norm_backward(g, x, [h], mean, rstd, w,
                                               bias, [True, True, True])

    shapes = [(b, s, h), (b, s, h), (b, s, 1), (b, s, 1), (h,), (h,)]
    rows = ((), (0,), ())
    in_specs = [rows, rows, ((), (), ()), ((), (), ()), ((),), ((),)]
    program, mesh = _program(fn, shapes, in_specs,
                             [rows, ((),), ((),)], (2,))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(b, s, h, generator=gen)
    w, bias = torch.randn(h, generator=gen), torch.randn(h, generator=gen)
    _, mean, rstd = aten.native_layer_norm(x, [h], w, bias, 1e-5)
    g = torch.randn(b, s, h, generator=gen)
    full = fn(g, x, mean, rstd, w, bias)
    outs = _run(program, mesh, [g, x, mean, rstd, w, bias], in_specs)
    _assert_blocks([[o[0]] for o in outs], full[0], rows, mesh)
    for o in outs:
        torch.testing.assert_close(o[1], full[1], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(o[2], full[2], rtol=1e-6, atol=1e-6)
    slices = [n for n in program.root.graph.nodes
              if n.target is aten.slice.Tensor]
    assert [n.args[1] for n in slices] == [1, 1]
    from alpa_tpu_torch.shard_parallel.spmd_partition import \
        strided_slice_readers
    assert strided_slice_readers(program.root) == []
    assert program.partitioner_stats["slice_copies"] == 2
    assert program.partitioner_stats["slice_copy_bytes"] == 2 * b * s // 2 * 4
