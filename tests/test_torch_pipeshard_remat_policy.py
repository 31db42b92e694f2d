"""GPT's ``remat_policy="dots"`` and packed ``segment_ids`` inside a
pipeshard trace, against the JAX package's pipeshard step.

A 4-layer GPT (hidden 64, a boundary every 2 blocks, fp32) in 2 stages of 2
microbatches, from the same weights and batch in both packages:

* ``remat_blocks=True, remat_policy="dots"``: the loss and every gradient
  equal JAX's pipeshard step with ``checkpoint_dots`` (atol 1e-5, rtol
  1e-4) and the port's own step without remat; the backward stages
  recompute no ``mm``/``addmm`` of a block (a region keeps its products'
  outputs), where ``remat_policy=None`` recomputes them, and recompute
  the rest of each block (its LayerNorms) under both policies.
* ``segment_ids`` with per-segment positions, with and without per-block
  remat: the loss and gradients equal JAX's (atol 1e-5, rtol 1e-4), and a
  second packing runs on the same executable (the segment bias is a value
  of the trace, not a constant).
"""
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
from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                            UniformStageOption)
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax

SHAPE = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
             vocab_size=128)
ATOL, RTOL = 1e-5, 1e-4
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
LAYER_NORM = (torch.ops.aten.native_layer_norm.default,)


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


def _packing(rng, b, s):
    """Segment ids (B, S) of 2-4 segments per row, the last few tokens
    padding (-1), and the positions restarting at each segment."""
    seg = np.full((b, s), -1, np.int64)
    pos = np.zeros((b, s), np.int64)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(4, s - 4), rng.integers(1, 4),
                                  replace=False))
        start = 0
        for i, end in enumerate(list(cuts) + [s - 3]):
            seg[r, start:end] = i
            pos[r, start:end] = np.arange(end - start)
            start = end
    return seg, pos


def _pair(**cfg):
    """(JAX state, the port's state, numpy batch, config) of the 4-layer
    GPT on the same weights."""
    jcfg = dict(cfg)
    if jcfg.get("remat_policy") is None:
        jcfg.pop("remat_policy", None)
    jmodel = jgm.GPTModel(jgm.GPTConfig(pipeline_boundary_every=2, **SHAPE,
                                        **jcfg))
    rng = np.random.default_rng(5)
    b, s = 4, SHAPE["seq_len"]
    batch = {k: rng.integers(0, SHAPE["vocab_size"], (b, s))
             for k in ("input_ids", "labels")}
    batch["segment_ids"], batch["position_ids"] = _packing(rng, b, s)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(batch["input_ids"], jnp.int32))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.sgd(1e-2))
    tcfg = tgm.GPTConfig(pipeline_boundary_every=2, **SHAPE, **cfg)
    model = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
    model = model.to_empty(device="cpu")
    model.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                               param_dtype=torch.float32))
    t_state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                    params=dict(model.named_parameters()),
                                    tx=tmu.sgd(1e-2))
    return j_state, t_state, batch, tcfg


def _jax_loss(packed):
    def loss(apply_fn, p, b):
        if not packed:
            return jmu.gpt_lm_loss(apply_fn, p, b)
        logits = apply_fn(p, b["input_ids"], b["position_ids"],
                          segment_ids=b["segment_ids"])
        return jmu.cross_entropy_loss(logits.astype(jnp.float32),
                                      b["labels"])
    return loss


def _port_loss(packed):
    def loss(apply_fn, p, b):
        if not packed:
            return tmu.gpt_lm_loss(apply_fn, p, b)
        logits = apply_fn(p, b["input_ids"], b["position_ids"],
                          segment_ids=b["segment_ids"])
        return tmu.cross_entropy_loss(logits.float(), b["labels"])
    return loss


def _jax_step(j_state, batch, packed):
    loss = _jax_loss(packed)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    if not packed:
        jb = {k: jb[k] for k in ("input_ids", "labels")}
    return alpa_tpu.parallelize(
        lambda s, b: alpa_tpu.value_and_grad(
            lambda p: loss(s.apply_fn, p, b))(s.params),
        method=alpa_tpu.PipeshardParallel(
            num_micro_batches=2, layer_option=jlc.ManualLayerOption(),
            stage_option=jstage.ManualStageOption(
                forward_stage_layer_ids=[[0], [1]],
                submesh_physical_shapes=[(1, 1)] * 2)),
        donate_argnums=())(j_state, jb)


def _port_step(packed):
    loss = _port_loss(packed)
    return alpa_tpu_torch.parallelize(
        lambda s, b: alpa_tpu_torch.value_and_grad(
            lambda p: loss(s.apply_fn, p, b))(s.params),
        method=PipeshardParallel(
            devices=["cpu"] * 2, num_micro_batches=2,
            layer_option=ManualLayerOption(),
            stage_option=UniformStageOption(2)),
        donate_argnums=())


def _check(loss, grads, jloss, jgrads, tcfg):
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    want = gpt_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads),
                                tcfg, "cpu", param_dtype=torch.float32)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def _bwd_dots(ex, ops=DOTS):
    """The ``ops`` nodes (by default mm/addmm) of each backward stage
    graph."""
    return [sum(n.target in ops for n in e.module.graph.nodes)
            for e in ex.stage_execs if "bwd" in e.name]


def test_dots_policy_equals_jax_and_recomputes_no_product():
    """``remat_policy="dots"``: the loss and gradients equal JAX's
    ``checkpoint_dots`` pipeshard step and the port's step without remat;
    the backward stages hold exactly the products of the step without
    remat (none recomputed), six fewer per stage than with
    ``remat_policy=None``, and, as that policy's, the blocks' LayerNorms
    recomputed (four more per stage than without remat)."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch, tcfg = _pair(remat_blocks=True,
                                          remat_policy="dots")
    jloss, jgrads = _jax_step(j_state, batch, packed=False)
    tb = {k: batch[k] for k in ("input_ids", "labels")}
    step = _port_step(False)
    loss, grads = step(t_state, tb)
    _check(loss, grads, jloss, jgrads, tcfg)
    dots = _bwd_dots(step.get_last_executable())

    _, plain, _, _ = _pair()
    step0 = _port_step(False)
    loss0, grads0 = step0(plain, tb)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), grads0[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert dots == _bwd_dots(step0.get_last_executable())

    _, whole, _, _ = _pair(remat_blocks=True)
    step1 = _port_step(False)
    step1(whole, tb)
    # each stage's 2 blocks recompute 3 products under remat_policy=None
    assert [a - b for a, b in zip(_bwd_dots(step1.get_last_executable()),
                                  dots)] == [6, 6]
    # and the rest of each block under both policies: its two LayerNorms
    norms = [_bwd_dots(s.get_last_executable(), LAYER_NORM)
             for s in (step, step0, step1)]
    assert norms[0] == norms[2] and \
        [a - b for a, b in zip(norms[0], norms[1])] == [4, 4]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_segment_ids_equal_jax(remat):
    """Packed rows (``segment_ids``, per-segment positions, padding) in a
    pipeshard step: the loss and gradients equal JAX's; a second packing
    reuses the executable and equals JAX's on it too."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch, tcfg = _pair(remat_blocks=remat)
    jloss, jgrads = _jax_step(j_state, batch, packed=True)
    step = _port_step(True)
    loss, grads = step(t_state, batch)
    _check(loss, grads, jloss, jgrads, tcfg)
    ex = step.get_last_executable()

    again = dict(batch)
    again["segment_ids"], again["position_ids"] = _packing(
        np.random.default_rng(9), *batch["input_ids"].shape)
    jloss, jgrads = _jax_step(j_state, again, packed=True)
    loss, grads = step(t_state, again)
    assert step.get_last_executable() is ex
    _check(loss, grads, jloss, jgrads, tcfg)
