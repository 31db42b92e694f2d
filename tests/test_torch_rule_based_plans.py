"""The rule-based plans propagate from their inputs, as GSPMD propagates
JAX's (ROADMAP C.3, repaired).

``DataParallel``, ``Zero2Parallel`` and ``Zero3Parallel`` fix only the
inputs' specs (batch sharded, ZeRO state sharded); the port realises them
with ``solver.propagate_pinned``, not a re-solve of the program's interior.
The narrow 2-layer GPT (hidden 64, vocab 128, batch 8) on 4 devices runs
on both packages from the same weights and batch; the kinds
of collective the port runs are held to those of JAX's optimized HLO
(``alpa_tpu.util.count_communication_primitives``).  Where JAX's CPU
pipeline all-reduces a gradient and slices it into ZeRO state, the port
reduce-scatters it: a port ``reduce_scatter`` counts as JAX's
``all-reduce``.  ``DataParallel`` runs all-reduces alone and no method
runs an all-to-all where JAX's HLO has none.  Two SGD steps (lr 0.1,
momentum 0.9), as ``tests/test_torch_spmd_gpt.py`` holds a sharded step:
losses rtol 1e-5, parameters within 1e-5 of each tensor's largest |value|
(Adam's ``m / sqrt(v)`` would turn a gradient at its rounding noise into a
step of lr).
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
from alpa_tpu.util import count_communication_primitives
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax

GPT = dict(hidden_size=64, num_layers=2, num_heads=2, seq_len=16,
           vocab_size=128)
LR, STEPS, BATCH = 0.1, 2, 8
_JAX_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _flax_params():
    dummy = jnp.ones((BATCH, GPT["seq_len"]), jnp.int32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jgm.GPTModel(jgm.GPTConfig(**GPT)).init)(jax.random.PRNGKey(0),
                                                 dummy))


def _jax_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(
        lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(
        lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


@pytest.mark.parametrize("method", ["DataParallel", "Zero2Parallel",
                                    "Zero3Parallel"])
def test_rule_based_plan_runs_jax_collective_kinds(method):
    params = _flax_params()
    jmodel = jgm.GPTModel(jgm.GPTConfig(**GPT))
    jstate = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.sgd(LR, momentum=0.9))
    tcfg = tgm.GPTConfig(**GPT)
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    tstate = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                   params=dict(tmodel.named_parameters()),
                                   tx=tmu.sgd(LR, momentum=0.9))
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(0, GPT["vocab_size"], (BATCH, GPT["seq_len"]))
             for n in ("input_ids", "labels")}
    jstep = alpa_tpu.parallelize(_jax_step, method=getattr(
        alpa_tpu, method)(devices=jax.devices()[:4]))
    tstep = alpa_tpu_torch.parallelize(_port_step, method=getattr(
        alpa_tpu_torch, method)(devices=["cpu"] * 4))
    jb = {n: jnp.asarray(v, jnp.int32) for n, v in batch.items()}
    tb = {n: torch.from_numpy(v) for n, v in batch.items()}
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        jstate, jloss = jstep(jstate, jb)
        tstate, tloss = tstep(tstate, tb)
        j_losses.append(float(jloss))
        t_losses.append(float(tloss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)

    want = gpt_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params), tcfg, "cpu", param_dtype=torch.float32)
    got = ttesting.gather_tree(tstate.params)
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name].numpy(), w.numpy(), rtol=0,
            atol=1e-5 * float(w.abs().max()), err_msg=name)

    ex = tstep.get_last_executable()
    assert ex.plan["rule_based"]
    assert ex.plan["graph"][0].search[0]["solver"] == "propagation"
    counts = count_communication_primitives(
        jstep.get_last_executable().get_hlo_text())[1:]
    jax_kinds = {k for k, n in zip(_JAX_KINDS, counts) if n}
    port_kinds = {"all_reduce" if k == "reduce_scatter" else k
                  for k in ex.get_collective_counts()}
    assert port_kinds <= jax_kinds, (port_kinds, jax_kinds)
    if method == "DataParallel":
        assert set(ex.get_collective_counts()) == {"all_reduce"}
    if method == "Zero2Parallel":
        assert "all_to_all" not in ex.get_collective_counts()
