"""The port's auto-sharding planner against the JAX package's.

Everything runs on the CPU without executing a plan: the JAX package plans
on the test session's 8 virtual CPU devices, the port on ``["cpu"] * 8``.

* The spec algebra and the alpha-beta collective costs equal JAX's
  exactly (``==`` on floats: the same formulas in the same order).
* The ILP, fed JAX's own strategy graph copied as numbers, returns JAX's
  choice and objective, with and without a memory budget; both raise on
  an infeasible budget, and both greedy fallbacks agree.
* ``mm``/``addmm``/``bmm`` have the strategies of JAX's
  ``enumerate_dot_strategies`` for the same ``dot_general``.
* Whole plans: the mesh shape and every input leaf's spec (through
  ``convert.py``'s transposes) equal JAX's, or, where they differ, the
  port's model costs JAX's assignment the same as its own (a tie: the
  port's graph solved with its inputs pinned to JAX's specs reaches the
  port's objective, to 1e-9 relative), for the MLP cases and the 2-layer
  GPT at GPT-1.3B's width on every mesh and attention.
* The rule-based plans of ``DataParallel``, ``Zero2Parallel`` and
  ``Zero3Parallel`` equal JAX's.
"""
import copy
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state as flax_train_state
from jax.tree_util import keystr, tree_flatten_with_path
from torch._subclasses.fake_tensor import FakeTensorMode

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.device_mesh import LogicalDeviceMesh as JaxLogicalMesh
from alpa_tpu.device_mesh import PhysicalDeviceMesh as JaxPhysicalMesh
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.shard_parallel import auto_sharding as jas
from alpa_tpu.shard_parallel import ilp as jilp
from alpa_tpu.shard_parallel import sharding_spec as jspec
from alpa_tpu.shard_parallel import solver as jsolver
from alpa_tpu.shard_parallel import strategy as jstrategy
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.device_mesh import LogicalDeviceMesh, PhysicalDeviceMesh
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.shard_parallel import auto_sharding as tas
from alpa_tpu_torch.shard_parallel import ilp as tilp
from alpa_tpu_torch.shard_parallel import sharding_spec as tspec
from alpa_tpu_torch.shard_parallel import solver as tsolver
from alpa_tpu_torch.shard_parallel import strategy as tstrategy

MESHES = [(1, 8), (2, 4), (8, 1)]
TIE_RTOL = 1e-9


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


class _Capture(alpa_tpu_torch.ParallelMethod):
    """Takes the flat function, avals and paths ``parallelize`` hands a
    method, and stops."""
    donates_in_place = False

    def compile_executable(self, fun, *, avals, batch_invars,
                           donated_invars):
        del donated_invars
        self.captured = (fun, list(avals), list(fun.in_paths),
                         [i for i, b in enumerate(batch_invars) if b])
        raise StopIteration


def _port_flat(step, *args):
    method = _Capture()
    with pytest.raises(StopIteration):
        alpa_tpu_torch.parallelize(step, method=method)(*args)
    return method.captured


def _jax_flat(step, state, batch):
    """JAX's flat function, avals, ``keystr`` paths and batch leaves, as
    ``alpa_tpu.parallelize`` makes them."""
    leaves, tree = tree_flatten_with_path((state, batch))
    avals = [jax.ShapeDtypeStruct(np.shape(x), jnp.asarray(x).dtype)
             if not isinstance(x, jax.ShapeDtypeStruct) else x
             for _, x in leaves]

    def flat(*xs):
        return jax.tree_util.tree_leaves(
            step(*jax.tree_util.tree_unflatten(tree, xs)))

    n_state = len(jax.tree_util.tree_leaves(state))
    return (flat, avals, [keystr(p) for p, _ in leaves],
            list(range(n_state, len(avals))))


def _port_key(jax_path):
    """(the port's path, whether its tensor is the transpose) of a JAX
    leaf path: flax ``Dense`` kernels are (in, out), ``Linear`` weights
    (out, in) (``convert.py``)."""
    toks = [a or b or c for a, b, c in
            re.findall(r"\['([^']*)'\]|\.(\w+)|\[(\d+)\]", jax_path)]
    if toks[0] == "1":
        return f"[1]['{toks[1]}']", False
    if toks[1] == "step":
        return "[0].step", False
    if toks[1] == "params":
        kind, rest = None, toks[3:]
    else:
        kind, rest = toks[3], toks[5:]
        if kind == "count":
            return "[0].opt_state[0]['count']", False
    mods = []
    for t in rest[:-1]:
        m = re.fullmatch(r"h(\d+)", t) or re.fullmatch(r"Dense_(\d+)", t)
        mods.append((f"h.{m.group(1)}" if t.startswith("h")
                     else f"layers.{m.group(1)}") if m else t)
    leaf = rest[-1]
    name = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(leaf, leaf)
    key = ".".join(mods + [name])
    if kind is None:
        return f"[0].params['{key}']", leaf == "kernel"
    return f"[0].opt_state[0]['{kind}']['{key}']", leaf == "kernel"


def _jax_spec(partition_spec, ndim, names=("mesh0", "mesh1")):
    """A ``PartitionSpec`` as the port's ``Spec``."""
    out = []
    for p in tuple(partition_spec):
        if p is None:
            out.append(())
        elif isinstance(p, str):
            out.append((names.index(p),))
        else:
            out.append(tuple(names.index(x) for x in p))
    return tuple(out + [()] * (ndim - len(out)))


def _pinned_cost(graph, pins):
    """The port's objective with each invar node in ``pins`` (invar index
    -> Spec) restricted to that spec and the rest solved again."""
    pinned = copy.copy(graph)
    pinned.nodes = [copy.copy(n) for n in graph.nodes]
    keep = {}
    for n, orig in zip(pinned.nodes, graph.nodes):
        if n.kind == "invar" and n.invar_idx in pins:
            n.strategies = [st for st in orig.strategies
                            if st.out_spec == pins[n.invar_idx]]
            assert n.strategies, (n.label, pins[n.invar_idx])
        keep[n.idx] = [orig.strategies.index(st) for st in n.strategies]
    pinned.edges = [tstrategy.Edge(e.src, e.dst,
                                   e.cost[np.ix_(keep[e.src], keep[e.dst])])
                    for e in graph.edges]
    return tilp.solution_cost(pinned, tilp.solve_strategy_graph(pinned))


def _compare_plans(jflat, tflat, option_kw, pin_all=True):
    """(JAX's shape, the port's shape, {port path: (JAX's spec, the port's
    spec)} of the leaves that differ, the port's objective, the port's
    objective with JAX's input specs (with ``pin_all``), the port's
    plan)."""
    jres = jsolver.plan_auto_sharding(
        jflat[0], jflat[1], jflat[2], jflat[3],
        JaxPhysicalMesh(np.array(jax.devices())),
        jas.AutoShardingOption(**option_kw))
    tres = tsolver.plan_auto_sharding(
        tflat[0], tflat[1], tflat[2], tflat[3],
        PhysicalDeviceMesh(["cpu"] * 8), tas.AutoShardingOption(**option_kw))
    port = dict(zip(tflat[2], tres[1]))
    index = {p: i for i, p in enumerate(tflat[2])}
    diffs, pins = {}, {}
    for path, sharding in zip(jflat[2], jres[1]):
        key, transposed = _port_key(path)
        want = _jax_spec(sharding.spec, len(port[key]))
        if transposed:
            want = want[::-1]
        pins[index[key]] = want
        if want != port[key]:
            diffs[key] = (want, port[key])
    graph, choice = tres[2]
    own = tilp.solution_cost(graph, choice)
    theirs = _pinned_cost(graph, pins) if diffs and pin_all else own
    return jres[3], tres[3], diffs, own, theirs, tres


########################################
# (a) the spec algebra and the collective costs
########################################


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("shape", [(8,), (16, 32), (4, 8, 16)])
def test_sharding_spec_equals_jax(shape, mesh_shape):
    """Every spec of the shape: the enumeration, validity, shard count,
    sharded bytes and the resharding cost of every (src, dst) pair."""
    jmesh = JaxLogicalMesh(None, np.arange(8).reshape(mesh_shape))
    tmesh = LogicalDeviceMesh(None, np.arange(8).reshape(mesh_shape))
    javal = jax.ShapeDtypeStruct(shape, jnp.float32)
    taval = tspec.Aval(shape, torch.float32)
    specs = jspec.enumerate_var_specs(javal, mesh_shape)
    assert tspec.enumerate_var_specs(taval, mesh_shape) == specs
    every = set(specs)
    for d in range(len(shape)):     # and the invalid ones
        for a in range(2):
            every.add(jspec.make_spec(len(shape), {d: a}))
        every.add(jspec.make_spec(len(shape), {d: (0, 1)}))
    for s in sorted(every):
        assert tspec.spec_valid(taval, s, mesh_shape) == \
            jspec.spec_valid(javal, s, mesh_shape)
        assert tspec.num_shards(s, mesh_shape) == \
            jspec.num_shards(s, mesh_shape)
        assert tspec.sharded_bytes(taval, s, mesh_shape) == \
            jspec.sharded_bytes(javal, s, mesh_shape)
        for dst in specs:
            assert tspec.resharding_cost(taval, s, dst, tmesh) == \
                jspec.resharding_cost(javal, s, dst, jmesh)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_collective_costs_equal_jax(mesh_shape):
    """The four collectives on each axis, and the meshes'
    ``get_logical_mesh`` constants."""
    jphys = JaxPhysicalMesh(np.array(jax.devices()))
    tphys = PhysicalDeviceMesh(["cpu"] * 8)
    pairs = [(jphys.get_logical_mesh(mesh_shape),
              tphys.get_logical_mesh(mesh_shape)),
             (JaxLogicalMesh(None, np.arange(8).reshape(mesh_shape),
                             mesh_beta=(0.1, 0.1)),
              LogicalDeviceMesh(None, np.arange(8).reshape(mesh_shape),
                                mesh_beta=(0.1, 0.1)))]
    virtual = alpa_tpu_torch.device_mesh.VirtualPhysicalMesh(["cpu"] * 8)
    assert virtual.get_logical_mesh(mesh_shape).mesh_beta == \
        pairs[0][0].mesh_beta
    for jm, tm in pairs:
        assert tm.shape == jm.shape and tm.mesh_alpha == jm.mesh_alpha \
            and tm.mesh_beta == jm.mesh_beta
        for axis in range(2):
            for nbytes in (0.0, 1e3, 3.3e7):
                for kind in ("all_gather", "all_reduce", "reduce_scatter",
                             "all_to_all"):
                    assert getattr(tm, f"{kind}_cost")(nbytes, axis) == \
                        getattr(jm, f"{kind}_cost")(nbytes, axis)


########################################
# (b) the ILP on JAX's own strategy graph
########################################


def _jax_mlp_graph(budget=None, batch_size=2048, dim=64):
    state, batch = jtesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=dim, hidden_dim=dim,
        output_dim=dim)

    def step(state, batch):
        def loss_fn(p):
            return jnp.mean((state.apply_fn(p, batch["x"]) - batch["y"])**2)
        loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    fun, avals, paths, bidx = _jax_flat(step, state, batch)
    closed = jax.make_jaxpr(fun)(*avals)
    mesh = JaxPhysicalMesh(np.array(jax.devices())).get_logical_mesh((2, 4))
    return jstrategy.build_strategy_graph(
        closed, avals, mesh, bidx, jas.AutoShardingOption(), in_paths=paths)


def _as_port_graph(g):
    """JAX's strategy graph, as numbers, in the port's classes."""
    nodes = [tstrategy.Node(
        n.idx, n.kind, n.aval,
        [tstrategy.Strategy(st.name, st.out_spec, st.comm_cost,
                            st.operand_specs, st.mem_bytes, st.comm_kind,
                            st.tie_bias) for st in n.strategies],
        n.label, n.invar_idx) for n in g.nodes]
    edges = [tstrategy.Edge(e.src, e.dst, e.cost.copy()) for e in g.edges]
    return tstrategy.StrategyGraph(nodes, edges, None)


@pytest.mark.parametrize("budget", [None, 150_000])
def test_ilp_equals_jax_on_the_same_graph(budget):
    g = _jax_mlp_graph()
    jchoice = jilp.solve_strategy_graph(g, 60, budget)
    info = {}
    tchoice = tilp.solve_strategy_graph(_as_port_graph(g), 60, budget, info)
    assert info["solver"] == "milp"
    assert tchoice == jchoice
    assert tilp.solution_cost(_as_port_graph(g), tchoice) == \
        jilp.solution_cost(g, jchoice)
    sizes = [len(n.strategies) for n in g.nodes]
    assert tilp._solve_greedy(_as_port_graph(g), sizes, budget) == \
        jilp._solve_greedy(g, sizes, budget)


def test_infeasible_budget_raises_in_both():
    g = _jax_mlp_graph()
    with pytest.raises(jilp.InfeasibleMemoryBudget):
        jilp.solve_strategy_graph(g, 60, 1000)
    with pytest.raises(tilp.InfeasibleMemoryBudget):
        tilp.solve_strategy_graph(_as_port_graph(g), 60, 1000)


def test_greedy_fallback_when_the_milp_fails(monkeypatch):
    """A failing MILP falls back to the greedy pass, which returns JAX's
    greedy choice, and says so."""
    g = _jax_mlp_graph()

    def fail(*args, **kwargs):
        raise RuntimeError("milp failed")

    monkeypatch.setattr(tilp, "_solve_milp", fail)
    monkeypatch.setattr(jilp, "_solve_milp", fail)
    info = {}
    assert tilp.solve_strategy_graph(_as_port_graph(g), 60, None, info) == \
        jilp.solve_strategy_graph(g, 60, None)
    assert info["solver"] == "greedy"


########################################
# (c) the dot handler
########################################


def _dot_node(fn, *shapes):
    """The port's strategy-graph node of the one product in ``fn``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, tracing_mode="fake")(*[torch.empty(s) for s in shapes])
    return gm


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("op", ["mm", "addmm", "bmm"])
def test_dot_strategies_equal_jax(op, mesh_shape):
    """As sets of (out spec, operand specs, communication cost)."""
    if op == "bmm":
        lhs, rhs, dims = (8, 16, 32), (8, 32, 16), (((2,), (1,)),
                                                    ((0,), (0,)))
        fn, shapes = torch.bmm, [lhs, rhs]
    else:
        lhs, rhs, dims = (64, 32), (32, 16), (((1,), (0,)), ((), ()))
        fn, shapes = torch.mm, [lhs, rhs]
        if op == "addmm":
            fn, shapes = (lambda b, x, w: torch.addmm(b, x, w)), \
                [(16,), lhs, rhs]
    closed = jax.make_jaxpr(lambda a, b: jax.lax.dot_general(a, b, dims))(
        jax.ShapeDtypeStruct(lhs, jnp.float32),
        jax.ShapeDtypeStruct(rhs, jnp.float32))
    jmesh = JaxLogicalMesh(None, np.arange(8).reshape(mesh_shape))
    want = {(st.out_spec, st.operand_specs, st.comm_cost) for st in
            jstrategy.enumerate_dot_strategies(closed.jaxpr.eqns[0], jmesh)}
    gm = _dot_node(fn, *shapes)
    tmesh = LogicalDeviceMesh(None, np.arange(8).reshape(mesh_shape))
    graph = tstrategy.build_strategy_graph(
        gm.graph, [tspec.Aval(s, torch.float32) for s in shapes], tmesh, [],
        tas.AutoShardingOption())
    (node,) = [n for n in graph.nodes if n.label.startswith("dot:")]
    got = {(st.out_spec, st.operand_specs, st.comm_cost)
           for st in node.strategies}
    assert got == want and len(node.strategies) == len(want)


def _port_op_node(fn, shapes, dtypes, prefix):
    """The port's node labelled ``prefix`` in the strategy graph of
    ``fn``, traced at ``shapes`` on a (2, 4) mesh."""
    from torch.fx.experimental.proxy_tensor import make_fx
    args = [torch.zeros(s, dtype=d) for s, d in zip(shapes, dtypes)]
    gm = make_fx(fn, tracing_mode="fake")(*args)
    graph = tstrategy.build_strategy_graph(
        gm.graph, [tspec.Aval(s, d) for s, d in zip(shapes, dtypes)],
        LogicalDeviceMesh(None, np.arange(8).reshape(2, 4)), [],
        tas.AutoShardingOption())
    (node,) = [n for n in graph.nodes if n.label.startswith(prefix)]
    return node


def _jax_eqn(fn, *avals, prim):
    closed = jax.make_jaxpr(fn)(*avals)
    (eqn,) = [e for e in jstrategy.flatten_jaxpr_eqns(closed.jaxpr)
              if e.primitive.name == prim]
    return eqn


JMESH_24 = JaxLogicalMesh(None, np.arange(8).reshape(2, 4))
TABLE, IDS = (64, 32), (8, 16)


def test_gather_strategies_equal_jax():
    """``embedding`` against JAX's gather of ``jnp.take(table, ids,
    axis=0)``: (out spec, table spec, ids spec, cost); JAX's ids carry a
    trailing index-vector dim of size 1, never sharded."""
    eqn = _jax_eqn(lambda t, i: jnp.take(t, i, axis=0),
                   jax.ShapeDtypeStruct(TABLE, jnp.float32),
                   jax.ShapeDtypeStruct(IDS, jnp.int32), prim="gather")
    want = {(st.out_spec, st.operand_specs[0], st.operand_specs[1][:-1],
             st.comm_cost) for st in
            jstrategy.enumerate_gather_strategies(eqn, JMESH_24)}
    node = _port_op_node(lambda t, i: torch.nn.functional.embedding(i, t),
                         [TABLE, IDS], [torch.float32, torch.int32],
                         "gather:")
    assert {(st.out_spec, *st.operand_specs, st.comm_cost)
            for st in node.strategies} == want


@pytest.mark.parametrize("op", ["embedding_backward", "index_put"])
def test_scatter_strategies_equal_jax(op):
    """The embedding's gradient (``embedding_dense_backward``) and
    ``index_put(accumulate=True)`` against JAX's scatter-add, the
    transpose of ``jnp.take``: (out spec, table spec, ids spec, update
    spec, cost)."""
    upd = IDS + TABLE[1:]
    eqn = _jax_eqn(lambda t, i, u: t.at[i].add(u),
                   jax.ShapeDtypeStruct(TABLE, jnp.float32),
                   jax.ShapeDtypeStruct(IDS, jnp.int32),
                   jax.ShapeDtypeStruct(upd, jnp.float32),
                   prim="scatter-add")
    want = {(st.out_spec, st.operand_specs[0], st.operand_specs[1][:-1],
             st.operand_specs[2], st.comm_cost) for st in
            jstrategy.enumerate_scatter_strategies(eqn, JMESH_24)}
    if op == "index_put":
        node = _port_op_node(
            lambda t, i, u: torch.ops.aten.index_put(t, [i], u, True),
            [TABLE, IDS, upd], [torch.float32, torch.int64, torch.float32],
            "scatter:")
        got = {(st.out_spec, *st.operand_specs, st.comm_cost)
               for st in node.strategies}
    else:
        node = _port_op_node(
            lambda u, i: torch.ops.aten.embedding_dense_backward(
                u, i, TABLE[0], -1, False),
            [upd, IDS], [torch.float32, torch.int64], "scatter:")
        got = {(st.out_spec, st.out_spec, st.operand_specs[1],
                st.operand_specs[0], st.comm_cost)
               for st in node.strategies}
    assert got == want


########################################
# (d) whole plans
########################################


def _mlp_pair(batch_size, dim, num_layers=2):
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=dim, hidden_dim=dim, output_dim=dim,
        num_layers=num_layers)
    tstate, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=dim, hidden_dim=dim, output_dim=dim,
        num_layers=num_layers,
        params=jax.tree_util.tree_map(np.asarray, jstate.params),
        x=np.asarray(jbatch["x"]), y=np.asarray(jbatch["y"]))

    def jstep(state, batch):
        def loss_fn(p):
            return jnp.mean((state.apply_fn(p, batch["x"]) - batch["y"])**2)
        loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    return (_jax_flat(jstep, jstate, jbatch),
            _port_flat(ttesting.get_mlp_train_step(None, True), tstate,
                       tbatch))


MLP_CASES = {
    # tests/shard_parallel/test_auto_sharding.py:52-92, 155
    "large_batch_data_parallel": (2048, 32, 2, {}),
    "wide_tensor_parallel": (8, 2048, 2, {}),
    "forced_8x1": (64, 64, 2, {"logical_mesh_shape": (8, 1)}),
    "force_batch_dim": (64, 64, 2, {"logical_mesh_shape": (8, 1),
                                    "force_batch_dim_to_mesh_dim": 0}),
    "memory_budget": (2048, 64, 2, {"memory_budget_per_device": 150_000}),
    "eight_layers": (256, 32, 8, {}),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_plan_equals_jax(case):
    batch_size, dim, layers, kw = MLP_CASES[case]
    jflat, tflat = _mlp_pair(batch_size, dim, layers)
    jshape, tshape, diffs, own, theirs, _ = _compare_plans(jflat, tflat, kw)
    assert tshape == jshape
    # every differing leaf (named in the message) is a tie
    assert theirs == pytest.approx(own, rel=TIE_RTOL), diffs


@functools.lru_cache(maxsize=None)
def _gpt_pair(attention_impl):
    """The 2-layer GPT at GPT-1.3B's width with Adam, batch 8, fp32, on
    fake tensors (JAX: abstract values); made once per attention."""
    kw = dict(num_layers=2)
    jcfg = dataclasses.replace(jgm.config_from_spec(
        "1.3B", dtype=jnp.float32, attention_impl=attention_impl), **kw)
    tcfg = dataclasses.replace(tgm.config_from_spec(
        "1.3B", dtype=torch.float32, attention_impl=attention_impl), **kw)
    jmodel = jgm.GPTModel(jcfg)
    ids = jax.ShapeDtypeStruct((8, jcfg.seq_len), jnp.int32)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ids)
    jstate = jax.eval_shape(lambda p: flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=p, tx=optax.adam(1e-3)), params)

    def jstep(state, batch):
        loss, grads = alpa_tpu.value_and_grad(lambda p: jmu.gpt_lm_loss(
            state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    model = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
    with FakeTensorMode(allow_non_fake_inputs=True):
        tparams = {k: torch.empty(p.shape) for k, p in
                   model.named_parameters()}
        tstate = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                       params=tparams, tx=tmu.adam(1e-3))
        ids_t = torch.zeros(8, tcfg.seq_len, dtype=torch.int32)

    def tstep(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(lambda p: tmu.gpt_lm_loss(
            state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    return (_jax_flat(jstep, jstate, {"input_ids": ids, "labels": ids}),
            _port_flat(tstep, tstate, {"input_ids": ids_t, "labels": ids_t}))


# Leaves of the 2-layer GPT whose specs may differ from JAX's without a
# tie, per (attention, logical mesh): none.  ROADMAP C.1 (the reference
# attention on (2, 4), the out projection's weight) was repaired by
# reading ``masked_fill``'s mask as the lead operand and the causal mask
# as a free 2-D node, as JAX's ``jnp.where`` and ``broadcasted_iota``
# trace.
GPT_OPEN_DIFFERENCES = {}


@functools.lru_cache(maxsize=None)
def _gpt_plans(attention_impl, shape):
    """``_compare_plans`` of the GPT on one logical mesh shape, and JAX's
    objective there; made once."""
    jflat, tflat = _gpt_pair(attention_impl)
    out = _compare_plans(jflat, tflat, {"logical_mesh_shape": shape},
                         pin_all=False)
    closed = jax.make_jaxpr(jflat[0])(*jflat[1])
    mesh = JaxPhysicalMesh(np.array(jax.devices())).get_logical_mesh(shape)
    graph = jstrategy.build_strategy_graph(
        closed, jflat[1], mesh, jflat[3], jas.AutoShardingOption(),
        in_paths=jflat[2])
    return out, jilp.solution_cost(graph, jilp.solve_strategy_graph(graph))


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_gpt_plan_equals_jax(attention_impl, shape):
    """The 2-layer GPT at GPT-1.3B's width, batch 8, on a forced logical
    mesh: every strategy graph solved by the MILP, and each leaf's spec
    equal to JAX's, a tie on its own (pinned alone to JAX's spec, the
    port's objective does not move), or one of the open fault's leaves."""
    jflat, tflat = _gpt_pair(attention_impl)
    (jshape, tshape, diffs, own, _, tres), _ = _gpt_plans(attention_impl,
                                                          shape)
    assert tshape == jshape == shape
    graph = tres[2][0]
    assert [row["solver"] for row in graph.search] == ["milp"]
    index = {p: i for i, p in enumerate(tflat[2])}
    not_tied = {key for key, (want, _) in diffs.items()
                if _pinned_cost(graph, {index[key]: want}) !=
                pytest.approx(own, rel=TIE_RTOL)}
    known = GPT_OPEN_DIFFERENCES.get((attention_impl, shape), set())
    assert not_tied <= known, sorted(not_tied - known)


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_gpt_mesh_shape_search_equals_jax(attention_impl):
    """The search over (1, 8) and (2, 4) picks JAX's shape (JAX's search
    takes the cheaper of its per-shape objectives, as the port's does), and
    the port's per-shape objectives are the forced shapes' ones."""
    jflat, tflat = _gpt_pair(attention_impl)
    shapes = [(1, 8), (2, 4)]
    plans = [_gpt_plans(attention_impl, s) for s in shapes]
    jax_pick = shapes[int(np.argmin([jcost for _, jcost in plans]))]
    res = tsolver.plan_auto_sharding(
        tflat[0], tflat[1], tflat[2], tflat[3],
        PhysicalDeviceMesh(["cpu"] * 8), tas.AutoShardingOption())
    assert res[3] == jax_pick
    search = res[2][0].search
    assert [row["shape"] for row in search] == shapes
    for row, ((_, _, _, own, _, _), _) in zip(search, plans):
        assert row["solver"] == "milp" and row["objective"] == \
            pytest.approx(own, rel=TIE_RTOL)


########################################
# (e) the rule-based plans
########################################


@pytest.mark.parametrize("method", ["DataParallel", "Zero2Parallel",
                                    "Zero3Parallel"])
def test_rule_based_plans_equal_jax(method):
    """On 8 devices (the default logical mesh (8, 1)), the MLP with Adam:
    non-square layers, so that the largest divisible dim is the same dim
    of a kernel and of its transposed weight."""
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=64, input_dim=16, hidden_dim=64, output_dim=32)
    jstate = flax_train_state.TrainState.create(
        apply_fn=jstate.apply_fn, params=jstate.params, tx=optax.adam(1e-3))
    tstate, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=64, input_dim=16, hidden_dim=64, output_dim=32,
        params=jax.tree_util.tree_map(np.asarray, jstate.params),
        x=np.asarray(jbatch["x"]), y=np.asarray(jbatch["y"]),
        tx=tmu.adam(1e-3))
    jflat = _jax_flat(lambda s, b: (s, b), jstate, jbatch)
    tflat = _port_flat(ttesting.get_mlp_train_step(None, True), tstate,
                       tbatch)
    joption = getattr(alpa_tpu, method)().as_option
    toption = getattr(alpa_tpu_torch, method)().as_option
    assert dataclasses.asdict(toption) == dataclasses.asdict(joption)
    jax_mesh = JaxPhysicalMesh(np.array(jax.devices())).get_logical_mesh(
        (8, 1)).get_jax_mesh(("mesh0", "mesh1"))
    want = jas.plan_rule_based(jax_mesh, jflat[1], jflat[2], jflat[3],
                               joption)
    got = dict(zip(tflat[2], tas.plan_rule_based(
        (8, 1), [tspec.Aval(s, d) for s, d in tflat[1]], tflat[2],
        tflat[3], toption)))
    for path, sharding in zip(jflat[2], want):
        key, transposed = _port_key(path)
        spec = _jax_spec(sharding.spec, len(got[key]))
        assert got[key] == (spec[::-1] if transposed else spec), path
