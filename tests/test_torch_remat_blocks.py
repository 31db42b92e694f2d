"""GPT's per-block remat inside a pipeshard trace, against the JAX package.

With ``remat_blocks=True`` the JAX GPT's jaxpr holds each block as one
``checkpoint`` eqn (``remat2`` on this JAX), whose products are no cut
points of ``cluster_eqns_by_cost``; the port marks each block with a
``remat_block`` marker pair, tags its nodes as one region, and takes no cut
point inside one either.  For K in {2, 4, 8} both DPs see two segments on
the 8-layer GPT (up to and including the lm head, then the loss) and return
those two layers; the top-level products per layer are equal.  On this
JAX, ``jaxpr_eqn_flops`` does not recurse into a ``remat2`` eqn (only into
``remat``/``checkpoint``) and counts it at its output's size, where the
port counts the region's nodes: the layer flops are held to JAX's with the
block eqns counted through their bodies (rtol 2e-2, as
``test_torch_layer_construction``; the loss layer alone differs more, as
aten and the jaxpr split the softmax cross-entropy into other ops).  Under
manual layers the losses and gradients equal JAX's pipeshard step with
``remat_blocks=True`` (fp32, rtol 1e-4, atol 1e-6) and the port's step
without remat (rtol 1e-6, atol 1e-7), and the backward stage graphs hold
the recomputed products.
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
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.util import jaxpr_eqn_flops
from alpa_tpu_torch import (AutoLayerOption, ManualLayerOption,
                            PipeshardParallel, UniformStageOption)
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.pipeline_parallel import layer_construction as tlc
from alpa_tpu_torch.util import node_flops, product_flops

GPT8 = dict(hidden_size=64, num_layers=8, num_heads=4, seq_len=64,
            vocab_size=512)
REMAT_PRIMS = ("remat2", "checkpoint", "remat")


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


def _body_flops(eqn) -> float:
    """``jaxpr_eqn_flops``, with a checkpoint eqn counted through its
    body."""
    if eqn.primitive.name in REMAT_PRIMS:
        sub = eqn.params["jaxpr"]
        sub = getattr(sub, "jaxpr", sub)
        return sum(_body_flops(e) for e in sub.eqns)
    return jaxpr_eqn_flops(eqn)


@functools.lru_cache(maxsize=None)
def _loss_graphs(impl):
    """(JAX loss jaxpr, the port's loss graph) of the 8-layer GPT with
    ``remat_blocks=True``."""
    jmodel = jgm.GPTModel(jgm.GPTConfig(dtype=jnp.float32, attention_impl=impl,
                                        remat_blocks=True, **GPT8))
    ids = jnp.zeros((2, GPT8["seq_len"]), jnp.int32)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ids)
    jb = {"input_ids": ids, "labels": ids}
    closed, _ = jlc._make_jaxpr_with_tree(
        lambda p: jmu.gpt_lm_loss(jmodel.apply, p, jb), params)
    tmodel = tgm.GPTModel(tgm.GPTConfig(attention_impl=impl, remat_blocks=True,
                                        **GPT8),
                          device="cpu", param_dtype=torch.float32)
    tids = torch.zeros((2, GPT8["seq_len"]), dtype=torch.int64)
    tb = {"input_ids": tids, "labels": tids}
    apply = tmu.make_apply_fn(tmodel)
    params = {k: p.detach() for k, p in tmodel.named_parameters()}
    with torch.enable_grad():
        gm, _, _ = tlc.trace_loss(lambda p: tmu.gpt_lm_loss(apply, p, tb),
                                  {k: p.requires_grad_() for k, p in
                                   params.items()})
    return closed, gm.graph


def _top_level_heavy(node):
    return node.target in tlc.HEAVY_OPS and tlc.REMAT_REGION not in node.meta


@pytest.mark.parametrize("layer_num", [2, 4, 8])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_remat_block_cuts_equal_jax(impl, layer_num):
    """The cuts of ``cluster_nodes_by_cost`` on the remat'ed GPT equal
    ``cluster_eqns_by_cost``'s: the same number of layers (2: JAX has one
    top-level product, the lm head, so two segments for every K), the same
    top-level products and product flops per layer, each layer's flops
    within 2e-2 of JAX's counted through the checkpoint bodies."""
    closed, graph = _loss_graphs(impl)
    jlayers = jlc.cluster_eqns_by_cost(closed, layer_num, 0.6)
    output = next(n for n in graph.nodes if n.op == "output")
    tlayers = tlc.cluster_nodes_by_cost(tlc.compute_nodes(graph),
                                        output.args[0], layer_num, 0.6)

    def jheavy(e):
        return e.primitive.name in jlc.HEAVY_PRIMS

    assert len(tlayers) == len(jlayers) == 2
    assert [sum(map(_top_level_heavy, g)) for g in tlayers] == \
        [sum(map(jheavy, g)) for g in jlayers] == [1, 0]
    assert [sum(product_flops(n) for n in g if _top_level_heavy(n))
            for g in tlayers] == \
        [sum(jaxpr_eqn_flops(e) for e in g if jheavy(e)) for g in jlayers]
    tflops = np.array([sum(map(node_flops, g)) for g in tlayers])
    jflops = np.array([sum(map(_body_flops, g)) for g in jlayers])
    # the second layer is the loss alone (about 2e5 flops), where aten and
    # the jaxpr split the softmax cross-entropy into different ops
    np.testing.assert_allclose(tflops[0], jflops[0], rtol=2e-2)
    np.testing.assert_allclose(tflops.sum(), jflops.sum(), rtol=2e-2)
    # this JAX counts each checkpoint eqn at its output's size only
    remat = [e for e in closed.jaxpr.eqns if e.primitive.name in REMAT_PRIMS]
    assert len(remat) == GPT8["num_layers"]
    for e in remat:
        if e.primitive.name == "remat2":
            assert jaxpr_eqn_flops(e) == np.prod(e.outvars[0].aval.shape)


def test_each_block_is_one_region_of_its_products():
    """Every block's nodes carry one region tag, its products are inside
    it, and the graph keeps no remat marker."""
    _, graph = _loss_graphs("flash")
    regions = {}
    for n in tlc.compute_nodes(graph):
        if tlc.REMAT_REGION in n.meta:
            regions.setdefault(n.meta[tlc.REMAT_REGION], []).append(n)
    assert len(regions) == GPT8["num_layers"]
    # the four Linear products of a block (flash attention has none)
    assert all(sum(n.target in tlc.HEAVY_OPS for n in r) == 4
               for r in regions.values())
    assert not any("pipeline_marker" in str(n.target) for n in graph.nodes)


def _gpt_pair(remat, shape, lr=1e-3):
    jmodel = jgm.GPTModel(jgm.GPTConfig(attention_impl="flash",
                                        remat_blocks=remat,
                                        pipeline_boundary_every=2, **shape))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, shape["vocab_size"], (4, shape["seq_len"]))
             for k in ("input_ids", "labels")}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb["input_ids"])
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(lr))
    tcfg = tgm.GPTConfig(attention_impl="flash", remat_blocks=remat,
                         pipeline_boundary_every=2, **shape)

    def state():
        model = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
        model = model.to_empty(device="cpu")
        model.load_state_dict(gpt_params_from_flax(
            params, tcfg, "cpu", param_dtype=torch.float32))
        return tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                     params=dict(model.named_parameters()),
                                     tx=tmu.adam(lr))

    return j_state, state, batch, jb, tcfg


def _port_grads(state, batch, layer_option):
    def step(state, batch):
        return alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)

    pstep = alpa_tpu_torch.parallelize(step, method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2, layer_option=layer_option,
        stage_option=UniformStageOption(2)), donate_argnums=())
    loss, grads = pstep(state, batch)
    return float(loss), grads, pstep.get_last_executable()


def _products(ex, which):
    return [sum(n.target in tlc.HEAVY_OPS for n in e.module.graph.nodes)
            for e in ex.stage_execs if ("bwd" in e.name) == (which == "bwd")]


def test_manual_layers_losses_and_grads_equal_jax_and_no_remat():
    """A 4-layer GPT (hidden 64, a boundary every 2 blocks) with
    ``remat_blocks=True`` under pipeshard, 2 stages x 2 microbatches: the
    loss and every gradient equal the JAX package's pipeshard step with
    ``remat_blocks=True`` (rtol 1e-4, atol 1e-6) and the port's step
    without remat (rtol 1e-6, atol 1e-7); the backward stages hold the
    recomputed products."""
    shape = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)
    alpa_tpu.init(cluster="local")
    j_state, state, batch, jb, tcfg = _gpt_pair(True, shape)
    jloss, jgrads = alpa_tpu.parallelize(
        lambda s, b: alpa_tpu.value_and_grad(
            lambda p: jmu.gpt_lm_loss(s.apply_fn, p, b))(s.params),
        method=alpa_tpu.PipeshardParallel(
            num_micro_batches=2, layer_option=jlc.ManualLayerOption(),
            stage_option=jstage.ManualStageOption(
                forward_stage_layer_ids=[[0], [1]],
                submesh_physical_shapes=[(1, 1)] * 2)),
        donate_argnums=())(j_state, jb)
    loss, grads, ex = _port_grads(state(), batch, ManualLayerOption())
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    want = gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads), tcfg, "cpu",
        param_dtype=torch.float32)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _, no_remat, _, _, _ = _gpt_pair(False, shape)
    loss0, grads0, ex0 = _port_grads(no_remat(), batch, ManualLayerOption())
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads0[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert _products(ex, "fwd") == _products(ex0, "fwd")
    # each stage's 2 blocks recompute the 3 products whose outputs their
    # backward reads (fc_out's output is not read)
    assert [a - b for a, b in zip(_products(ex, "bwd"),
                                  _products(ex0, "bwd"))] == [6, 6]


def test_auto_layers_keep_blocks_whole():
    """``AutoLayerOption(layer_num=4)`` on the remat'ed 4-layer GPT: two
    layers (the lm head's product is the one cut point), the loss and
    gradients of the step without remat (rtol 1e-6, atol 1e-7)."""
    shape = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)
    _, state, batch, _, _ = _gpt_pair(True, shape)
    _, no_remat, _, _, _ = _gpt_pair(False, shape)
    loss, grads, ex = _port_grads(state(), batch,
                                  AutoLayerOption(layer_num=4))
    assert len(ex.fwd_layer_comps) == 2
    loss0, grads0, _ = _port_grads(no_remat(), batch, ManualLayerOption())
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads0[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
