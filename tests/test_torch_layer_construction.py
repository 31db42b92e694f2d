"""The port's automatic layers against the JAX package's.

``node_flops`` is held to ``jaxpr_eqn_flops`` op kind by op kind (exactly),
and layer by layer: the products' flops exactly, each layer's total to 2e-2
relative (aten and the jaxpr split the elementwise work into different
ops: one ``gelu`` node against JAX's tanh polynomial, ``view`` nodes around
``mm`` where ``dot_general`` takes 3-D operands).  The auto-layer DP must
cut where JAX's cuts, counted as products before each boundary.  Remat
layers hold losses and gradients to the step without remat and to the JAX
package's pipeshard step with remat layers: fp32, MLP rtol 1e-5, atol 1e-6,
GPT rtol 1e-4, atol 1e-6 (sums in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state as flax_train_state

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.ops.flash_attention import flash_attention as jax_flash
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.util import jaxpr_eqn_flops
from alpa_tpu_torch import (AutoLayerOption, FollowLayerOption,
                            ManualLayerOption, PipeshardParallel,
                            UniformStageOption, automatic_remat,
                            manual_remat)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import (gpt_params_from_flax,
                                          mlp_params_from_flax)
from alpa_tpu_torch.ops.flash_attention import flash_attention
from alpa_tpu_torch.pipeline_parallel import layer_construction as tlc
from alpa_tpu_torch.pipeline_parallel import primitive_def
from alpa_tpu_torch.util import node_flops, product_flops

EPS = 0.6


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _port_graph(fn, *args):
    """The port's traced aten graph of ``fn`` (as the layer transform
    traces a loss function)."""
    gm, _, _ = tlc.trace_loss(fn, *args)
    return gm.graph


def _jax_eqns(fn, *args):
    return jax.make_jaxpr(fn)(*args).jaxpr.eqns


def _port_op(graph, name):
    return next(n for n in graph.nodes if n.op == "call_function" and
                name in str(n.target))


# ---- node_flops, op by op ----

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mm_case(rng):
    x, w = _rand(rng, 8, 16), _rand(rng, 16, 24)
    return (lambda a, b: a @ b, (x, w)), (lambda a, b: a @ b, (x, w)), "mm"


def _addmm_case(rng):
    x, w, b = _rand(rng, 8, 16), _rand(rng, 24, 16), _rand(rng, 24)
    return ((lambda a, k, c: a @ k + c, (x, w.T, b)),
            (torch.nn.functional.linear, (x, w, b)), "addmm")


def _bmm_case(rng):
    q, k = _rand(rng, 2, 8, 4, 16), _rand(rng, 2, 12, 4, 16)
    spec = "bqhd,bkhd->bhqk"
    return ((lambda a, b: jnp.einsum(spec, a, b), (q, k)),
            (lambda a, b: torch.einsum(spec, a, b), (q, k)), "bmm")


def _conv_case(rng):
    x, w = _rand(rng, 2, 3, 10, 10), _rand(rng, 5, 3, 3, 3)

    def jconv(a, b):   # NHWC x HWIO, the JAX package's layout
        return jax.lax.conv_general_dilated(
            a, b, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    return ((jconv, (x.transpose(0, 2, 3, 1), w.transpose(2, 3, 1, 0))),
            (torch.nn.functional.conv2d, (x, w)), "convolution")


def _add_case(rng):
    x, y = _rand(rng, 6, 7), _rand(rng, 6, 7)
    return (lambda a, b: a + b, (x, y)), (lambda a, b: a + b, (x, y)), "add"


@pytest.mark.parametrize("case", [_mm_case, _addmm_case, _bmm_case,
                                  _conv_case, _add_case],
                         ids=["mm", "addmm", "bmm", "convolution", "add"])
def test_node_flops_equals_jaxpr_eqn_flops_per_op_kind(case):
    """A product counts 2 x numel(out) x the contracted size (``addmm`` also
    its bias add, an eqn of its own in the jaxpr), a convolution JAX's
    formula on the port's layout, an elementwise op its numel: the port's
    node and the JAX package's eqns count the same."""
    (jfn, jargs), (tfn, targs), op = case(np.random.default_rng(0))
    want = sum(jaxpr_eqn_flops(e) for e in _jax_eqns(jfn, *jargs)
               if e.primitive.name in ("dot_general", "conv_general_dilated",
                                       "add"))
    node = _port_op(_port_graph(
        tfn, *[torch.from_numpy(np.ascontiguousarray(a)) for a in targs]),
        op)
    assert node_flops(node) == want > 0


@pytest.mark.parametrize("shape", [(2, 128, 4, 32), (1, 1024, 32, 64),
                                   (4, 512, 8, 128), (2, 64, 4, 32, 160)],
                         ids=["b2s128", "b1s1024", "b4s512", "sq64-sk160"])
def test_flash_op_counts_what_jax_counts_inside_flash_attention(shape):
    """The flash op counts what ``jaxpr_eqn_flops`` counts inside the JAX
    package's ``flash_attention`` call: its layout ops and the
    ``pallas_call`` at their outputs' sizes, 9 x numel(q) for self
    attention; 5 numel(q) + 2 numel(k) + 2 numel(v) when the lengths
    differ."""
    b, sq, h, d = shape[:4]
    sk = shape[4] if len(shape) > 4 else sq
    q = jax.ShapeDtypeStruct((b, sq, h, d), jnp.bfloat16)
    kv = jax.ShapeDtypeStruct((b, sk, h, d), jnp.bfloat16)
    want = sum(jaxpr_eqn_flops(e) for e in _jax_eqns(
        lambda q_, k_, v_: jax_flash(q_, k_, v_, causal=sq == sk), q, kv, kv))
    tq = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device="meta")
    tkv = torch.empty((b, sk, h, d), dtype=torch.bfloat16, device="meta")
    graph = _port_graph(lambda q_, k_, v_: flash_attention(
        q_, k_, v_, causal=sq == sk), tq, tkv, tkv)
    got = node_flops(_port_op(graph, "flash_fwd"))
    assert got == want
    if sq == sk:
        assert got == 9 * b * sq * h * d
    # as JAX's pallas_call, the op is no cut point
    assert _port_op(graph, "flash_fwd").target not in tlc.HEAVY_OPS


# ---- the auto-layer DP ----

GPT8 = dict(hidden_size=64, num_layers=8, num_heads=4, seq_len=64,
            vocab_size=512)


@functools.lru_cache(maxsize=None)
def _loss_graphs(model):
    """(JAX loss jaxpr, the port's loss graph) of one fixture: the MLP
    fixture at 8 layers, or an 8-layer GPT (hidden 64) with reference or
    flash attention."""
    if model == "mlp":
        jmodel = jtesting.MLPModel(hidden_dim=32, output_dim=32, num_layers=8)
        x = jnp.zeros((16, 32))
        params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)
        jloss = lambda p: jnp.mean((jmodel.apply(p, x) - x) ** 2)  # noqa
        tmodel = ttesting.MLPModel(32, 32, 32, num_layers=8, device="cpu")
        tx = torch.zeros(16, 32)
        apply = tmu.make_apply_fn(tmodel)
        tloss = lambda p: torch.mean((apply(p, tx) - tx) ** 2)  # noqa
    else:
        impl = model.split("-")[1]
        jmodel = jgm.GPTModel(jgm.GPTConfig(dtype=jnp.float32,
                                            attention_impl=impl, **GPT8))
        ids = jnp.zeros((2, GPT8["seq_len"]), jnp.int32)
        params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ids)
        jb = {"input_ids": ids, "labels": ids}
        jloss = lambda p: jmu.gpt_lm_loss(jmodel.apply, p, jb)  # noqa
        tmodel = tgm.GPTModel(tgm.GPTConfig(attention_impl=impl, **GPT8),
                              device="cpu", param_dtype=torch.float32)
        tids = torch.zeros((2, GPT8["seq_len"]), dtype=torch.int64)
        tb = {"input_ids": tids, "labels": tids}
        apply = tmu.make_apply_fn(tmodel)
        tloss = lambda p: tmu.gpt_lm_loss(apply, p, tb)  # noqa
    closed, _ = jlc._make_jaxpr_with_tree(jloss, params)
    gm, _, _ = tlc.trace_loss(
        tloss, {k: p.detach() for k, p in tmodel.named_parameters()})
    return closed, gm.graph


@pytest.mark.parametrize("layer_num", [2, 4, 8])
@pytest.mark.parametrize("model", ["mlp", "gpt-reference", "gpt-flash"])
def test_auto_layer_cuts_equal_jax(model, layer_num):
    """``cluster_nodes_by_cost`` cuts the port's aten graph where JAX's
    ``cluster_eqns_by_cost`` cuts its jaxpr: the same number of products in
    every layer, the same product flops, each layer's total flops within
    2e-2 of JAX's and within the (1 + eps) budget."""
    closed, graph = _loss_graphs(model)
    jlayers = jlc.cluster_eqns_by_cost(closed, layer_num, EPS)
    output = next(n for n in graph.nodes if n.op == "output")
    tlayers = tlc.cluster_nodes_by_cost(tlc.compute_nodes(graph),
                                        output.args[0], layer_num, EPS)

    def jheavy(e):
        return e.primitive.name in jlc.HEAVY_PRIMS

    def theavy(n):
        return n.target in tlc.HEAVY_OPS

    assert len(tlayers) == len(jlayers) == layer_num
    assert [sum(map(theavy, g)) for g in tlayers] == \
        [sum(map(jheavy, g)) for g in jlayers]
    assert [sum(map(product_flops, g)) for g in tlayers] == \
        [sum(jaxpr_eqn_flops(e) for e in g if jheavy(e)) for g in jlayers]
    tflops = np.array([sum(map(node_flops, g)) for g in tlayers])
    jflops = np.array([sum(map(jaxpr_eqn_flops, g)) for g in jlayers])
    np.testing.assert_allclose(tflops, jflops, rtol=2e-2)
    assert tflops.max() <= (1 + EPS) * tflops.sum() / layer_num


def test_equal_flops_split_when_the_budget_has_no_solution():
    """With eps so small that no clustering fits the budget, both packages
    fall back to the equal-flops split, and split alike."""
    closed, graph = _loss_graphs("mlp")
    jlayers = jlc.cluster_eqns_by_cost(closed, 3, -0.9)
    output = next(n for n in graph.nodes if n.op == "output")
    tlayers = tlc.cluster_nodes_by_cost(tlc.compute_nodes(graph),
                                        output.args[0], 3, -0.9)
    assert [sum(n.target in tlc.HEAVY_OPS for n in g) for g in tlayers] == \
        [sum(e.primitive.name in jlc.HEAVY_PRIMS for e in g)
         for g in jlayers]


# ---- pipeshard steps: follow layers, remat layers ----

BATCH, DIM = 16, 32


def _mlp_pair(tx_j, tx_t, num_layers=4, manual=False):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    y = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    jmodel = jtesting.MLPModel(hidden_dim=DIM, output_dim=DIM,
                               num_layers=num_layers,
                               manual_pipeline_layer=manual)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params), tx=tx_j)
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=BATCH, input_dim=DIM, hidden_dim=DIM, output_dim=DIM,
        num_layers=num_layers, manual_pipeline_layer=manual, params=params,
        x=x, y=y, tx=tx_t)
    return j_state, t_state, {"x": x, "y": y}


def _jax_grad_step(state, batch):
    return alpa_tpu.value_and_grad(
        lambda p: jnp.mean((state.apply_fn(p, batch["x"]) - batch["y"]) ** 2)
    )(state.params)


def _port_grad_step(state, batch):
    return alpa_tpu_torch.value_and_grad(
        lambda p: torch.mean((state.apply_fn(p, batch["x"]) - batch["y"]) ** 2)
    )(state.params)


def _jax_train_step(state, batch):
    loss, grads = _jax_grad_step(state, batch)
    return state.apply_gradients(grads=grads), loss


def _port_train_step(state, batch):
    loss, grads = _port_grad_step(state, batch)
    return state.apply_gradients(grads=grads), loss


def _port_pipeshard(layer_option, num_micro_batches=2):
    return PipeshardParallel(devices=["cpu"] * 2,
                             num_micro_batches=num_micro_batches,
                             layer_option=layer_option,
                             stage_option=UniformStageOption(2))


def _jax_pipeshard(layer_option, num_micro_batches=2):
    return alpa_tpu.PipeshardParallel(
        num_micro_batches=num_micro_batches, layer_option=layer_option,
        stage_option=jstage.ManualStageOption(
            forward_stage_layer_ids=[[0], [1]],
            submesh_physical_shapes=[(1, 1)] * 2))


def test_follow_layer_option_takes_the_source_stage_count():
    """``FollowLayerOption`` clusters into as many layers as its source
    executable has forward stages (JAX's ``resolved_layer_num``): following
    a 2-stage manual-layer step, the MLP's 2 SGD-momentum steps equal
    JAX's with its ``FollowLayerOption`` (losses and parameters rtol 1e-5,
    atol 1e-6).  A source that is no pipeshard executable raises."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = _mlp_pair(optax.sgd(1e-2, momentum=0.9),
                                        tmu.sgd(1e-2, momentum=0.9))
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    j_src = alpa_tpu.parallelize(
        lambda s, b: alpa_tpu.value_and_grad(
            lambda p: jnp.mean((s.apply_fn(p, b["x"]) - b["y"]) ** 2))(
                s.params), method=_jax_pipeshard(jlc.ManualLayerOption()),
        donate_argnums=())
    j_src(_mlp_pair(optax.sgd(1e-2), tmu.sgd(1e-2), manual=True)[0], jb)
    src = alpa_tpu_torch.parallelize(
        _port_train_step, method=_port_pipeshard(ManualLayerOption()))
    src(_mlp_pair(optax.sgd(1e-2), tmu.sgd(1e-2), manual=True)[1], batch)
    src_ex = src.get_last_executable()
    follow = FollowLayerOption(src_executable=src_ex)
    assert follow.resolved_layer_num() == src_ex.num_fwd_stages == \
        jlc.FollowLayerOption(
            src_executable=j_src.get_last_executable()).resolved_layer_num() \
        == 2
    assert FollowLayerOption(layer_num=3).resolved_layer_num() == 3
    step = alpa_tpu_torch.parallelize(_port_train_step,
                                      method=_port_pipeshard(follow))
    j_step = alpa_tpu.parallelize(
        _jax_train_step, method=_jax_pipeshard(jlc.FollowLayerOption(
            src_executable=j_src.get_last_executable())))
    for _ in range(2):
        t_state, loss = step(t_state, batch)
        j_state, j_loss = j_step(j_state, jb)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    ttesting.assert_allclose(
        t_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)),
        rtol=1e-5, atol=1e-6)
    assert step.get_last_executable().num_fwd_stages == 2
    with pytest.raises(ValueError, match="pipeshard executable"):
        FollowLayerOption(src_executable=object()).resolved_layer_num()


def _count_products(graph_module):
    return sum(n.target in tlc.HEAVY_OPS for n in graph_module.graph.nodes)


def _gpt_pair(lr=1e-3):
    shape = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)
    jmodel = jgm.GPTModel(jgm.GPTConfig(attention_impl="flash", **shape))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, shape["vocab_size"], (4, shape["seq_len"]))
             for k in ("input_ids", "labels")}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb["input_ids"])
    tcfg = tgm.GPTConfig(attention_impl="flash", **shape)

    def states():
        tmodel = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
        tmodel = tmodel.to_empty(device="cpu")
        tmodel.load_state_dict(gpt_params_from_flax(
            params, tcfg, "cpu", param_dtype=torch.float32))
        return tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                     params=dict(tmodel.named_parameters()),
                                     tx=tmu.adam(lr))

    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(lr))
    return j_state, states, batch, jb, tcfg


def _gpt_grad_steps():
    def j_step(state, batch):
        return alpa_tpu.value_and_grad(
            lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)

    def t_step(state, batch):
        return alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)

    return j_step, t_step


@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_remat_layers_match_no_remat_and_jax(model):
    """``AutoLayerOption(layer_num=2, remat_layer=True)`` under pipeshard (2
    stages, 2 microbatches): the loss and every gradient equal the same
    step without remat and the JAX package's pipeshard step with remat
    layers (MLP rtol 1e-5, GPT 1e-4; atol 1e-6).  The backward stage graphs
    hold the recomputed forward products: more products than without
    remat."""
    alpa_tpu.init(cluster="local")
    if model == "mlp":
        j_state, t_state, batch = _mlp_pair(optax.sgd(1e-2), tmu.sgd(1e-2))
        j_step, t_step, rtol = _jax_grad_step, _port_grad_step, 1e-5
        convert = mlp_params_from_flax
        jb = jax.tree_util.tree_map(jnp.asarray, batch)
        port_states = [t_state, _mlp_pair(optax.sgd(1e-2),
                                          tmu.sgd(1e-2))[1]]
    else:
        j_state, states, batch, jb, tcfg = _gpt_pair()
        j_step, t_step = _gpt_grad_steps()
        rtol = 1e-4
        convert = functools.partial(gpt_params_from_flax, config=tcfg,
                                    device="cpu", param_dtype=torch.float32)
        port_states = [states(), states()]
    jloss, jgrads = alpa_tpu.parallelize(
        j_step, method=_jax_pipeshard(
            jlc.AutoLayerOption(layer_num=2, remat_layer=True)),
        donate_argnums=())(j_state, jb)
    want = convert(jax.tree_util.tree_map(np.asarray, jgrads))
    runs = {}
    for remat, state in zip((True, False), port_states):
        step = alpa_tpu_torch.parallelize(
            t_step, method=_port_pipeshard(
                AutoLayerOption(layer_num=2, remat_layer=remat)),
            donate_argnums=())
        loss, grads = step(state, batch)
        runs[remat] = (float(loss), grads, step.get_last_executable())
    for remat, (loss, grads, _) in runs.items():
        np.testing.assert_allclose(loss, float(jloss), rtol=rtol)
        ttesting.assert_allclose(grads, want, rtol=rtol, atol=1e-6)
    ttesting.assert_allclose(runs[True][1], runs[False][1], rtol=rtol,
                             atol=1e-6)
    with_remat, without = runs[True][2], runs[False][2]
    for a, b in zip(with_remat.stage_execs, without.stage_execs):
        if "bwd" in a.name:
            assert _count_products(a.module) > _count_products(b.module)
        else:
            assert _count_products(a.module) == _count_products(b.module)


def test_remat_recompute_lands_between_the_layer_backward_markers():
    """In the joint graph traced with remat layers, each backward layer's
    markers enclose a recomputed forward product, and no product of a
    forward layer lies outside that layer's markers or its backward
    layer's."""
    _, t_state, batch = _mlp_pair(optax.sgd(1e-2), tmu.sgd(1e-2))
    graphs = []

    class Trace(alpa_tpu_torch.ParallelMethod):
        donates_in_place = False

        def compile_executable(self, fun, *, avals, batch_invars,
                               donated_invars):
            from alpa_tpu_torch.pipeline_parallel import compile_executable
            fake = compile_executable._fake_inputs(
                avals, batch_invars, 1, torch.device("cpu"))
            graphs.append(compile_executable.trace_train_step(
                fun, fake, AutoLayerOption(layer_num=2, remat_layer=True)))
            raise StopIteration

    with pytest.raises(StopIteration):
        alpa_tpu_torch.parallelize(_port_train_step, method=Trace())(
            t_state, batch)
    inside, where = {}, None
    for node in graphs[0].graph.nodes:
        if primitive_def.is_marker(node) and node.args[2] != "grad":
            where = (primitive_def.marker_name(node)
                     if node.args[2] == "start" else None)
        elif node.target is torch.ops.aten.addmm.default:
            assert where is not None, node
            inside[where] = inside.get(where, 0) + 1
    assert set(inside) == {"layer_0", "layer_1", "layer_0_backward",
                           "layer_1_backward"}, inside


def test_manual_and_automatic_remat_keep_values_and_gradients():
    """``manual_remat`` and ``automatic_remat`` on a plain call (no
    pipeshard trace, so no marker runs) give the loss function's value
    and gradients."""
    model = ttesting.MLPModel(DIM, DIM, DIM, num_layers=4,
                              manual_pipeline_layer=True, device="cpu")
    x = torch.randn(BATCH, DIM, generator=torch.Generator().manual_seed(1))
    apply = tmu.make_apply_fn(model)
    params = {k: p.detach() for k, p in model.named_parameters()}

    def loss(p):
        return torch.mean(apply(p, x) ** 2)

    want = alpa_tpu_torch.value_and_grad(loss)(params)
    for wrapped in (manual_remat(loss), automatic_remat(loss, layer_num=2),
                    automatic_remat(layer_num=3)(loss)):
        got = alpa_tpu_torch.value_and_grad(wrapped)(params)
        ttesting.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
